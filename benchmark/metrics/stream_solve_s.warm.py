"""Mean seconds of a warm frame's solve inside ``StereoStream.process``
(``last_timings["solve_s"]``: the warm start and the warm sweeps)."""

from benchmark import readers


def read(run):
    return readers.stream_timing(run, "solve_s")
