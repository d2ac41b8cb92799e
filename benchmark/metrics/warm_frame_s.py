"""The mean wall time of a warm stream frame (``window.warm_frame_s``):
its MC-CNN volume and ``StereoStream.process``, every frame completed
in the window."""

from benchmark import window


def read(run):
    flog = window.completed([(0, f["start"], f["end"]) for f in run.frames],
                            run.t0, run.t1)
    if run.kind != "warm" or not flog:
        return None
    return window.warm_frame_s(flog)
