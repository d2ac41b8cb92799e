"""Seconds per warm frame completed in the window in which the card ran no op
while the program's ``unary`` span was the innermost open span on the
solving thread: the unary windows (the proposals' and the current costs')."""

from benchmark import spans


def read(run):
    return spans.idle_s(run, "warm", "unary")
