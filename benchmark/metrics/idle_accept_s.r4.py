"""Seconds per frame kept in the replica cell in which a worker's card ran
no op, inside that worker's frames, while the program's ``accept`` span was
the innermost open span on the worker's solving thread, summed over the
workers: the acceptance (the halo windows and the expansion kernel, or the greedy test)."""

from benchmark import replica_trace


def read(run):
    return replica_trace.idle_s(run, "accept")
