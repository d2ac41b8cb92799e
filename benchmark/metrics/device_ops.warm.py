"""Device ops (kernels, copies, sets) a warm frame launches, MC-CNN
included, counted in the device trace."""

from benchmark import readers


def read(run):
    return readers.device_ops(run, "warm")
