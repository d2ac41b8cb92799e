"""Mean seconds from a cold frame's start (its inputs handed over) to the
evaluator's first stamp: the energy build and the random init."""

from benchmark import readers


def read(run):
    return readers.build_init_s(run, "cold")
