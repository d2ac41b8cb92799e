"""The device trace of a traced run, and the arithmetic that reduces it.

:class:`DeviceTrace` runs ``torch.profiler`` over the card's activity alone
(kernels, copies, sets; the host's ops are not recorded, which keeps a
window of a few million device ops readable in seconds) and reads the
profiler's raw events, without building its event tree, into arrays of
(name, start, end) on the host's ``time.perf_counter`` clock, so that they
line up with the benchmark's own spans.

The functions below take plain arrays, so that a CPU test can feed them a
synthetic trace.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


class DeviceTrace:
    """The card's ops between :meth:`start` and :meth:`stop`."""

    def __init__(self):
        self._prof = None
        self.names: List[str] = []
        self.name_id = np.zeros(0, np.int32)
        self.start_s = np.zeros(0)
        self.end_s = np.zeros(0)

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()

    def stop(self) -> None:
        import torch
        from torch.autograd import DeviceType
        torch.cuda.synchronize()
        # The profiler stamps events in ns of the system clock.
        offset = time.time_ns() * 1e-9 - time.perf_counter()
        self._prof.__exit__(None, None, None)
        events = self._prof.profiler.kineto_results.events()
        ids: Dict[str, int] = {}
        rows = []
        for e in events:
            if e.device_type() != DeviceType.CUDA or e.is_user_annotation():
                continue
            nid = ids.setdefault(e.name(), len(ids))
            rows.append((nid, e.start_ns(), e.duration_ns()))
        self._prof = None
        arr = np.asarray(rows, np.float64).reshape(-1, 3)
        self.names = list(ids)
        self.name_id = arr[:, 0].astype(np.int32)
        self.start_s = arr[:, 1] * 1e-9 - offset
        self.end_s = self.start_s + arr[:, 2] * 1e-9


def union(start: np.ndarray, end: np.ndarray, t0: float, t1: float):
    """The union of intervals clipped to [t0, t1], as sorted disjoint
    (starts, ends) arrays."""
    s = np.clip(start, t0, t1)
    e = np.clip(end, t0, t1)
    keep = e > s
    s, e = s[keep], e[keep]
    if not len(s):
        return s, e
    order = np.argsort(s, kind="stable")
    s, e = s[order], np.maximum.accumulate(e[order])
    new = np.ones(len(s), bool)
    new[1:] = s[1:] > e[:-1]
    first = np.flatnonzero(new)
    last = np.append(first[1:] - 1, len(s) - 1)
    return s[first], e[last]


def busy_s(start, end, t0: float, t1: float) -> float:
    """Seconds of [t0, t1] in which at least one op ran."""
    s, e = union(start, end, t0, t1)
    return float((e - s).sum())


def idle_gaps(start, end, t0: float, t1: float):
    """(gap starts, gap lengths) of [t0, t1] in which no op ran, longest
    first."""
    s, e = union(start, end, t0, t1)
    gs = np.concatenate([[t0], e])
    ge = np.concatenate([s, [t1]])
    length = ge - gs
    keep = length > 0
    gs, length = gs[keep], length[keep]
    order = np.argsort(-length, kind="stable")
    return gs[order], length[order]


def span_at(spans: Sequence[Tuple[float, float, str]], t: float) -> str:
    """The name of the innermost span around time ``t`` ("outside" where
    none is)."""
    best: Optional[Tuple[float, str]] = None
    for s, e, name in spans:
        if s <= t < e and (best is None or e - s < best[0]):
            best = (e - s, name)
    return best[1] if best else "outside"


def in_intervals(t: np.ndarray, intervals: Sequence[Tuple[float, float]]):
    """Which of times ``t`` lie in one of the [start, end) intervals."""
    hit = np.zeros(len(t), bool)
    for s, e in intervals:
        hit |= (t >= s) & (t < e)
    return hit


def matching(names: Sequence[str], name_id: np.ndarray,
             patterns: Sequence[str]) -> np.ndarray:
    """Which events have a name that contains one of ``patterns``."""
    ids = [i for i, n in enumerate(names) if any(p in n for p in patterns)]
    return np.isin(name_id, ids)


def top_ops(names, name_id, start, end, t0, t1, k: int = 10):
    """[[name, seconds], ...] of the ``k`` op names that took the most
    device time inside [t0, t1]."""
    dur = np.clip(end, t0, t1) - np.clip(start, t0, t1)
    sums = np.bincount(name_id, weights=np.maximum(dur, 0.0),
                       minlength=len(names))
    order = np.argsort(-sums, kind="stable")[:k]
    return [[names[i][:120], float(sums[i])] for i in order if sums[i] > 0]
