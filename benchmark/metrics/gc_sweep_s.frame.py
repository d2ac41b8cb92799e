"""Mean seconds of a graph-cut sweep of a cold frame, between the
evaluator's synchronized stamps."""

from benchmark import readers


def read(run):
    return readers.sweep_s(run, True) if run.kind == "cold" else None
