"""Seconds per warm frame completed in the window in which the card ran no op
while the program's ``write`` span was the innermost open span on the
solving thread: the canvas write of the accepted labels and costs."""

from benchmark import spans


def read(run):
    return spans.idle_s(run, "warm", "write")
