"""The MC-CNN volume's least time (``roofline.mccnn_work``: both towers
and the correlation in float32, images read and volume written once)
over its mean time by CUDA events, in %."""

import statistics

from benchmark import roofline


def read(run):
    return (100.0 * roofline.mccnn_bound_s(run.config) * 1e3
            / statistics.fmean(run.mccnn_ms)) if run.mccnn_ms else None
