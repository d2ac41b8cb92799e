"""The workers' waits on their cards inside the sweeps (the program's
``syncs`` counter on each worker's ``sweep`` spans and the spans inside
them), per frame kept in the replica cell."""

from benchmark import replica_trace


def read(run):
    return replica_trace.sweep_syncs(run)
