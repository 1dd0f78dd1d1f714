"""queue_wait_p95_ms.code: the scheduler's queue, from a request's due time
to its admission (the program's ``t_admit``), p95 over the requests due in
the window; one not admitted by the close enters at its elapsed time."""
from bench.portbench.readers import p95


def read(run):
    t0, t1 = run.window["t0"], run.window["t1"]
    due = [tr for tr in run.tracks if t0 <= tr.due < t1]
    waits = [(tr.req.t_admit if tr.req.t_admit is not None and tr.req.t_admit <= t1 else t1)
             - tr.due for tr in due]
    v = p95(waits)
    return None if v is None else 1e3 * v
