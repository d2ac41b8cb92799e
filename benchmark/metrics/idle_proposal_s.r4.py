"""Seconds per frame kept in the replica cell in which a worker's card ran
no op, inside that worker's frames, while the program's ``proposal`` span was
the innermost open span on the worker's solving thread, summed over the
workers: the proposals (the cell-label windows, the proposer and its copies to the card)."""

from benchmark import replica_trace


def read(run):
    return replica_trace.idle_s(run, "proposal")
