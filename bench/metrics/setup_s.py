"""setup_s: process start to the window's start (loading, drawing the
weights, building the engine or step, warming up, the code cell's
pre-roll), on the host's clock."""


def read(run):
    return run.setup_s
