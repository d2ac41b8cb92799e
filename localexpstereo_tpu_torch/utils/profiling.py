"""Tracing and profiling helpers (counterpart of
``localexpstereo_tpu.utils.profiling``).

The reference's only tracing facility is the pausable ``TimeStamper`` wall
clock (``TimeStamper.h``). Here:

- :class:`PhaseTimer`: wall time accumulated by named phase; with
  ``block`` it waits for the device work of the phase's tensors first, so
  asynchronous launches do not move time between phases;
- :func:`trace`: a ``torch.profiler`` window over the CPU and, where there
  is one, the card, written as a Chrome trace (``chrome://tracing`` or
  Perfetto).
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Iterator

import torch


class PhaseTimer:
    """Accumulates wall time per named phase; ``block=True`` synchronizes
    the CUDA devices of the tensors passed to :meth:`phase` before the
    phase's clock stops."""

    def __init__(self, block: bool = True):
        self.block = block
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str, *sync_tensors) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.block:
                for dev in {t.device for t in sync_tensors
                            if isinstance(t, torch.Tensor) and t.is_cuda}:
                    torch.cuda.synchronize(dev)
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            lines.append(f"{name:<24} {self.totals[name]:8.3f}s "
                         f"({self.counts[name]} calls)")
        return "\n".join(lines)


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """``with trace(dir) as prof:`` profiles the block and writes
    ``dir/trace.json``; ``prof.key_averages()`` sums it by op."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
