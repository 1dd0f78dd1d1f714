"""output_tok_s: output tokens emitted in the window over the window's
seconds (each token stamped at the return of the step that carried it)."""


def read(run):
    t0, t1 = run.window["t0"], run.window["t1"]
    n = sum(1 for tr in run.tracks for s in tr.stamps if t0 < s <= t1)
    return n / (t1 - t0) if t1 > t0 and n else None
