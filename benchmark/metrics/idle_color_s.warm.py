"""Seconds per warm frame completed in the window in which the card ran no op
while the program's ``color`` span was the innermost open span on the
solving thread: the color step's own work (its region origins' upload and
its per-color windows)."""

from benchmark import spans


def read(run):
    return spans.idle_s(run, "warm", "color")
