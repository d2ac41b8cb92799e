"""Amortized seconds per cold frame (``window.frame_s``): the wall times
of the frames completed in the window, from their inputs handed over
to their map on the host, summed over (clients x frames)."""

from benchmark import window


def read(run):
    flog = window.completed([(0, f["start"], f["end"]) for f in run.frames],
                            run.t0, run.t1)
    if run.kind != "cold" or not flog:
        return None
    return window.frame_s(flog, 1)
