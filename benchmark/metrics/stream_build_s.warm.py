"""Mean seconds of a warm frame's energy build inside
``StereoStream.process`` (``last_timings["build_s"]``, which the traced
run turns on)."""

from benchmark import readers


def read(run):
    return readers.stream_timing(run, "build_s")
