"""The least time of a cold frame's expansion moves, counted from the
configuration (``roofline.expansion_bound_s``), over the device time of
the kernels named ``expansion_accept`` in the frames, in %."""

from benchmark import readers


def read(run):
    return readers.expansion_roofline(run, "cold")
