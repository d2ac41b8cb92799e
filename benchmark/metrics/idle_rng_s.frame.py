"""Seconds per cold frame completed in the window in which the card ran no op
while the program's ``rng`` span was the innermost open span on the solving
thread: the host's threefry hash (every fold_in, split and draw)."""

from benchmark import spans


def read(run):
    return spans.idle_s(run, "cold", "rng")
