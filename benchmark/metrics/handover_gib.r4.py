"""GiB of arrays handed to the workers a frame: the pool's ``bytes_in``
counter over its ``submitted`` (the images and the float32 volume, each
array once)."""

from benchmark import replica_trace


def read(run):
    return replica_trace.handover_gib(run)
