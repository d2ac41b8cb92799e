"""Seconds per warm frame completed in the window in which the card ran no op
while the program's ``proposal`` span was the innermost open span on the
solving thread: the proposals (the cell-label windows, the proposer and its
copies to the card)."""

from benchmark import spans


def read(run):
    return spans.idle_s(run, "warm", "proposal")
