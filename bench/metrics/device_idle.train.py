"""device_idle.train: share of the traced window in which no kernel, copy
or set ran on the card, in %."""
from bench.portbench.readers import device_idle


def read(run):
    return device_idle(run)
