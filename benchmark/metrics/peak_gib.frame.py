"""The process's peak of allocated device memory (``max_memory_allocated``,
set-up included), in a cell of cold frames."""

from benchmark import readers


def read(run):
    return readers.peak_gib(run, "cold")
