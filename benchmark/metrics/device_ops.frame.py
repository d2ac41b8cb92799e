"""Device ops (kernels, copies, sets) a cold frame launches, counted in
the device trace over the frames completed in the window."""

from benchmark import readers


def read(run):
    return readers.device_ops(run, "cold")
