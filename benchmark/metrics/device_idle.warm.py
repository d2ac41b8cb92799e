"""The share of the window in which no op ran on the card, in a cell of
warm stream frames: 1 - (union of the device trace's ops) / window."""

from benchmark import readers


def read(run):
    return readers.device_idle(run, "warm")
