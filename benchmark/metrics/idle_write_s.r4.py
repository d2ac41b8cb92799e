"""Seconds per frame kept in the replica cell in which a worker's card ran
no op, inside that worker's frames, while the program's ``write`` span was
the innermost open span on the worker's solving thread, summed over the
workers: the canvas write of the accepted labels and costs."""

from benchmark import replica_trace


def read(run):
    return replica_trace.idle_s(run, "write")
