"""Mean seconds from the end of a frame's solve in its worker to the end
of the pool's get of its result (``solve`` and ``collect`` in its stamps):
the results to numpy, the put, the pickling through the queue and the
get."""

from benchmark import replica_trace


def read(run):
    return replica_trace.return_s(run)
