"""Seconds from the start of the run's process to the window: the inputs
made from the seed and uploaded, the kernels loaded (built, in a
checkout's first run), the warm-up; by the host's clock."""


def read(run):
    return run.setup_s
