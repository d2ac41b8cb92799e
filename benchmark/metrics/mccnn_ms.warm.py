"""Mean milliseconds of the benchmark's own ``mccnn.cost_volume`` call, by
CUDA events around it, over the warm frames of the window."""

import statistics


def read(run):
    return statistics.fmean(run.mccnn_ms) if run.mccnn_ms else None
