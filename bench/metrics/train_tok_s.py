"""train_tok_s: tokens trained in the window (whole steps, run back to
back) over the window's seconds."""
from bench.portbench.readers import train_tokens


def read(run):
    span = run.window["t1"] - run.window["t0"]
    n = train_tokens(run)
    return n / span if span > 0 and n else None
