"""The largest peak of allocated card memory of a replica worker
(``max_memory_allocated`` on its card, its warm-up included)."""

from benchmark import replica_trace


def read(run):
    return replica_trace.peak_gib(run)
