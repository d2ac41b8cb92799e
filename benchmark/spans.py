"""The program's own spans in a traced run, set against the device trace.

The port records its spans (``localexpstereo_tpu_torch.utils.profiling``)
while a profiler window records in the process, as the traced run's
device trace does, on the clock that trace is mapped onto. Here the card's
idle time inside the completed frames is charged to the span that was the
innermost open one on the solving thread at that moment, and the host's
waits on the card (each span's ``syncs``) are summed over the sweeps.

Where the program records no spans (a checkout without the recorder), the
recorder dropped spans beyond its cap, or the run has no device trace,
every function here returns None.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from . import readers, trace

#: The spans of a color step whose idle seconds the ``idle_*_s`` metrics
#: read.
PHASES = ("color", "rng", "proposal", "unary", "accept", "write")


@dataclasses.dataclass
class Spans:
    """The recorded spans as arrays, in the order they opened: ``parent``
    is an index into them (-1 at the top of a thread)."""

    name: np.ndarray
    start: np.ndarray
    end: np.ndarray
    parent: np.ndarray
    thread: np.ndarray
    syncs: np.ndarray

    def depth(self) -> np.ndarray:
        depth = np.zeros(len(self.parent), np.int64)
        has = self.parent >= 0
        while True:
            new = np.where(has, depth[self.parent] + 1, 0)
            if np.array_equal(new, depth):
                return depth
            depth = new

    def within(self, names: Sequence[str]) -> np.ndarray:
        """Which spans are one of ``names`` or lie inside one."""
        hit = np.isin(self.name, list(names))
        while True:
            new = hit | ((self.parent >= 0) & hit[self.parent])
            if np.array_equal(new, hit):
                return hit
            hit = new


def recorded() -> Optional[Spans]:
    """The spans the program recorded in this process, or None: also where
    the window recorded more spans than the recorder keeps, since idle
    charged to a truncated record would be short without a sign."""
    try:
        from localexpstereo_tpu_torch.utils import profiling
        records = profiling.records()
        dropped = profiling.counts()["dropped"]
    except (ImportError, AttributeError):
        return None
    if not records or dropped:
        return None
    start = np.array([r.start for r in records])
    return Spans(name=np.array([r.name for r in records]), start=start,
                 end=np.array([getattr(r, "end", r.start) for r in records]),
                 parent=np.array([r.parent for r in records], np.int64),
                 thread=np.array([r.thread for r in records]),
                 syncs=np.array([r.syncs for r in records], np.int64))


def solving_thread(sp: Spans) -> Optional[int]:
    """The thread that ran the sweeps."""
    threads = sp.thread[sp.name == "sweep"]
    if not len(threads):
        return None
    ids, n = np.unique(threads, return_counts=True)
    return int(ids[np.argmax(n)])


def flat_timeline(sp: Spans, thread: int) -> Tuple[np.ndarray, np.ndarray]:
    """(times, label): from ``times[k]`` on, until the next time, the
    innermost open span of ``thread`` is ``label[k]`` (-1: none). Spans of
    one thread nest, so a span's start makes it the innermost and its end
    makes its parent the innermost again."""
    idx = np.flatnonzero(sp.thread == thread)
    depth = sp.depth()[idx]
    times = np.concatenate([sp.start[idx], sp.end[idx]])
    # At one time, ends come first, the deepest first, then starts, the
    # shallowest first.
    order_key = np.concatenate([depth + len(sp.name) + 1, -depth])
    label = np.concatenate([idx, sp.parent[idx]])
    order = np.lexsort((order_key, times))
    return times[order], label[order]


def _busy_before(us: np.ndarray, ue: np.ndarray, t: np.ndarray):
    """Busy seconds before each of ``t``, of the disjoint sorted
    intervals (us, ue)."""
    cum = np.concatenate([[0.0], np.cumsum(ue - us)])
    i = np.searchsorted(us, t, side="right")
    # The part of the last interval begun before t that lies after t.
    past = np.where(i > 0, np.maximum(ue[np.maximum(i - 1, 0)] - t, 0.0),
                    0.0)
    return cum[i] - past


def idle_pieces(sp: Spans, dev_start, dev_end, frames, t0: float,
                t1: float):
    """The card's idle seconds inside ``frames`` ([(start, end)], sorted,
    disjoint), cut at every span edge of the solving thread: (label,
    idle) a piece, ``label`` the innermost span (-1: none)."""
    thread = solving_thread(sp)
    if thread is None or not len(frames):
        return None
    times, label = flat_timeline(sp, thread)
    fs = np.array([f[0] for f in frames], np.float64)
    fe = np.array([f[1] for f in frames], np.float64)
    cuts = np.unique(np.clip(np.concatenate([times, fs, fe, [t0, t1]]),
                             t0, t1))
    a, b = cuts[:-1], cuts[1:]
    k = np.searchsorted(times, a, side="right") - 1
    lab = np.where(k >= 0, label[np.maximum(k, 0)], -1)
    j = np.searchsorted(fs, a, side="right") - 1
    inside = (j >= 0) & (a < fe[np.maximum(j, 0)])
    us, ue = trace.union(dev_start, dev_end, t0, t1)
    idle = (b - a) - (_busy_before(us, ue, b) - _busy_before(us, ue, a))
    return lab[inside], idle[inside]


def idle_by_phase(run: readers.Run, kind: str) -> Optional[Dict[str, float]]:
    """Idle seconds a completed frame of ``kind``, by the innermost span
    (each of :data:`PHASES`), and ``"sweep"``: all of them inside the
    sweeps."""
    frames = readers.frames_of(run, kind)
    sp = recorded()
    if run.device is None or not frames or sp is None:
        return None
    pieces = idle_pieces(sp, run.device.start_s, run.device.end_s,
                         [(f["start"], f["end"]) for f in frames],
                         run.t0, run.t1)
    if pieces is None:
        return None
    lab, idle = pieces
    named = lab >= 0
    names = np.where(named, sp.name[np.maximum(lab, 0)], "")
    out = {p: float(idle[names == p].sum()) / len(frames) for p in PHASES}
    in_sweep = named & sp.within(("sweep",))[np.maximum(lab, 0)]
    out["sweep"] = float(idle[in_sweep].sum()) / len(frames)
    return out


def idle_s(run: readers.Run, kind: str, phase: str) -> Optional[float]:
    by = idle_by_phase(run, kind)
    return None if by is None else by[phase]


def sweep_syncs(run: readers.Run, kind: str) -> Optional[float]:
    """The host's waits on the card inside the sweeps, a completed frame
    of ``kind``."""
    frames = readers.frames_of(run, kind)
    sp = recorded()
    if run.device is None or not frames or sp is None \
            or solving_thread(sp) is None:
        return None
    in_frame = trace.in_intervals(sp.start,
                                  [(f["start"], f["end"]) for f in frames])
    hit = in_frame & sp.within(("sweep",))
    return float(sp.syncs[hit].sum()) / len(frames)
