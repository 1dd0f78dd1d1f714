"""itl_p95_ms: 95th percentile of every gap between consecutive output
tokens of one request, both inside the window."""
from bench.portbench.readers import p95


def read(run):
    t0, t1 = run.window["t0"], run.window["t1"]
    gaps = [b - a for tr in run.tracks for a, b in zip(tr.stamps, tr.stamps[1:])
            if a >= t0 and b <= t1]
    v = p95(gaps)
    return None if v is None else 1e3 * v
