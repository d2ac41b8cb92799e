"""Device ops (kernels, copies, sets) a frame kept in the replica cell
launches, counted in its worker's trace of its card over the worker's
frames."""

from benchmark import replica_trace


def read(run):
    return replica_trace.device_ops(run)
