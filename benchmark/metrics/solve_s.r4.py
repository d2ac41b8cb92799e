"""Mean seconds of a frame's solve in its worker (``solve`` in its stamps:
the init and the 2 greedy + 5 graph-cut sweeps, ``LocalExpansionSolver.run``,
to the card's completion)."""

from benchmark import replica_trace


def read(run):
    return replica_trace.solve_s(run)
