"""slab_live_share.decode: rows that carried a prompt or output token (the
program's live-row count) over the rows the window's dispatches computed
(decode slots x slab width each), in %."""
from bench.portbench.readers import window_steps


def read(run):
    steps = window_steps(run)
    sp = run.serve_plan
    computed = len(steps) * sp.decode_batch * sp.mixed_slab_width
    live = sum(s.rows for s in steps)
    return 100.0 * live / computed if computed and live else None
