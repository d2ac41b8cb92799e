"""The mean over the cards of the replica cell of the window's share in
which the card's worker ran no op: 1 - (union of its traced ops) / window,
from the workers' own traces (the harness's trace sees this process
only)."""

from benchmark import replica_trace


def read(run):
    return replica_trace.device_idle(run)
