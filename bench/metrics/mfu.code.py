"""The model FLOPs of the window's live work (each live row through the
matrices, attention over each row's causal context, the head once for each
token emitted; dead rows never count) over the summed dispatch time at the
bf16 peak, in %."""
from bench.portbench.readers import serve_mfu


def read(run):
    return serve_mfu(run)
