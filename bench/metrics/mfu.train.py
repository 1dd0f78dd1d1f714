"""mfu.train: model FLOPs of the window's steps (6 a matrix weight a token,
the head included, and three times the forward of attention's causal
products or of the WKV recurrence) over the window at the bf16 peak, in %."""
from bench.portbench.readers import train_mfu


def read(run):
    return train_mfu(run)
