"""ttft_p95_ms: 95th percentile, over every request due in the window, of
the time from when it was due to the step return that carried its first
token; a request without a token when the window closes enters at its
elapsed time, so a stall cannot hide."""
from bench.portbench.readers import p95


def read(run):
    t0, t1 = run.window["t0"], run.window["t1"]
    due = [tr for tr in run.tracks if t0 <= tr.due < t1]
    ttft = [(tr.stamps[0] if tr.stamps and tr.stamps[0] <= t1 else t1) - tr.due for tr in due]
    v = p95(ttft)
    return None if v is None else 1e3 * v
