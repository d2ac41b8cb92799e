"""Pausable wall-clock accumulator (reference ``TimeStamper.h``).

Measures *optimization* time while excluding evaluation/visualization, the
same semantics as the reference's ``Evaluator::start/stop`` wrapping
(``Evaluator.h:113-116,185-186``). On a CUDA device the caller is
responsible for calling :meth:`stop` only after ``torch.cuda.synchronize()``,
so asynchronous launches do not leak optimization work into eval time.
"""
from __future__ import annotations

import time


class TimeStamper:
    def __init__(self):
        self._accum = 0.0
        self._started_at = None

    def start(self) -> None:
        if self._started_at is None:
            self._started_at = time.perf_counter()

    def stop(self) -> None:
        if self._started_at is not None:
            self._accum += time.perf_counter() - self._started_at
            self._started_at = None

    def is_ticking(self) -> bool:
        return self._started_at is not None

    def get_current_time(self) -> float:
        extra = (time.perf_counter() - self._started_at
                 if self._started_at is not None else 0.0)
        return self._accum + extra
