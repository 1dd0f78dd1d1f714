"""dispatch_ms.serve: the engine's dispatch span (host clock from the
dispatch to the token read-back, which waits for the device), mean over
the window's dispatches."""
from bench.portbench.readers import dispatch_ms


def read(run):
    return dispatch_ms(run)
