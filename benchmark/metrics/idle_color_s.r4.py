"""Seconds per frame kept in the replica cell in which a worker's card ran
no op, inside that worker's frames, while the program's ``color`` span was
the innermost open span on the worker's solving thread, summed over the
workers: the color step's own work (its region origins' upload and its per-color windows)."""

from benchmark import replica_trace


def read(run):
    return replica_trace.idle_s(run, "color")
