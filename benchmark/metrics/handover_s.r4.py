"""Mean seconds from a frame's hand-over (the start of the pool's put,
``submit`` in its stamps) to the start of its energy build in its worker:
the put, the pickling through the queue, the worker's get and
unpickling."""

from benchmark import replica_trace


def read(run):
    return replica_trace.handover_s(run)
