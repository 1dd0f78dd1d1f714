"""The paged-attention kernel's share of its roofline: the bound of its
calls in the traced window (each live slot's pages, live q rows and
outputs once, and their FLOPs) over the kernels' device time, in %."""
from bench.portbench.readers import paged_roofline


def read(run):
    return paged_roofline(run)
