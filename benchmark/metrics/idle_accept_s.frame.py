"""Seconds per cold frame completed in the window in which the card ran no op
while the program's ``accept`` span was the innermost open span on the
solving thread: the acceptance (the halo windows and the expansion kernel,
or the greedy test)."""

from benchmark import spans


def read(run):
    return spans.idle_s(run, "cold", "accept")
