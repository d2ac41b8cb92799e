"""The host's waits on the card inside the sweeps (the program's ``syncs``
counter on the ``sweep`` spans and the spans inside them), per cold frame
completed in the window."""

from benchmark import spans


def read(run):
    return spans.sweep_syncs(run, "cold")
