"""What the readers of the replica cell share: each kept frame's stamps,
and the traces of the pool's workers, which the client puts into the kept
frames' ``timings`` at its release (``clients/replica.py``).

``timings`` of a kept frame: ``b`` (its pair index in the pool),
``worker``, ``stamps`` (``ReplicaPool.next_result``'s: ``submit``,
``receive``, ``build``, ``solve`` and ``collect`` as (start, end), ``ret``
and ``marks``); after the release, ``workers`` (by worker: its ``spans``
as (name, attrs, start, end, parent, thread, syncs), ``dropped``, its
card's ``ops`` as (names, name index, start, end), ``peak_bytes``) and
``counts`` (the pool's counters), all on ``time.perf_counter``, the clock
of every process of one host.

A worker's spans and ops are read as :mod:`.spans` reads this process's
for one card: the card's idle seconds inside the worker's own frames,
charged to the innermost span of its solving thread, and its waits and
ops inside those frames; each summed over the workers and divided by the
frames kept.

Every function returns None where the run has none of it: a run without
the traces, a program without the pool or its spans.
"""
from __future__ import annotations

import statistics
from typing import Dict, List, Optional, Tuple

import numpy as np

from . import readers, spans, trace


def shared(run: readers.Run) -> Optional[dict]:
    """The timings that carry the workers' traces, or None."""
    for f in readers.frames_of(run, "cold"):
        t = f.get("timings") or {}
        if t.get("workers"):
            return t
    return None


def traced(run: readers.Run) -> Optional[List[dict]]:
    """The workers, where every one handed back its spans and ops."""
    t = shared(run)
    if t is None or not all("ops" in w and "spans" in w and not
                            w.get("dropped") for w in t["workers"]):
        return None
    return t["workers"]


def device_idle(run: readers.Run) -> Optional[float]:
    """The mean over the cards of the window's share with no op of the
    card's worker, in %."""
    workers = traced(run)
    if workers is None:
        return None
    window = run.t1 - run.t0
    return 100.0 * statistics.fmean(
        1.0 - trace.busy_s(w["ops"][2], w["ops"][3], run.t0, run.t1) / window
        for w in workers)


def peak_gib(run: readers.Run) -> Optional[float]:
    """The largest peak of allocated card memory of a worker, GiB."""
    t = shared(run)
    peaks = [w.get("peak_bytes") for w in t["workers"]] if t else []
    if not peaks or None in peaks:
        return None
    return max(peaks) / 2 ** 30


def per_frame(run: readers.Run, fn) -> Optional[float]:
    """The mean over the kept frames of ``fn(the frame's stamps)``."""
    values = [fn(f["timings"]["stamps"]) for f in readers.frames_of(run, "cold")
              if "stamps" in (f.get("timings") or {})]
    return statistics.fmean(values) if values else None


def handover_s(run: readers.Run) -> Optional[float]:
    return per_frame(run, lambda st: st["build"][0] - st["submit"][0])


def return_s(run: readers.Run) -> Optional[float]:
    return per_frame(run, lambda st: st["collect"][1] - st["solve"][1])


def solve_s(run: readers.Run) -> Optional[float]:
    return per_frame(run, lambda st: st["solve"][1] - st["solve"][0])


def handover_gib(run: readers.Run) -> Optional[float]:
    """Bytes handed to the workers a pair, GiB (the pool's counter)."""
    t = shared(run)
    c = (t or {}).get("counts") or {}
    if not c.get("submitted"):
        return None
    return c["bytes_in"] / c["submitted"] / 2 ** 30


def worker_spans(w: dict) -> Optional[spans.Spans]:
    """A worker's spans as :class:`.spans.Spans` (a span still open ends
    where it starts), or None where it has none or a solving thread."""
    rows = w.get("spans")
    if not rows:
        return None
    sp = spans.Spans(
        name=np.array([r[0] for r in rows]),
        start=np.array([r[2] for r in rows], np.float64),
        end=np.array([r[2] if r[3] is None else r[3] for r in rows],
                     np.float64),
        parent=np.array([r[4] for r in rows], np.int64),
        thread=np.array([r[5] for r in rows]),
        syncs=np.array([r[6] for r in rows], np.int64))
    return None if spans.solving_thread(sp) is None else sp


def by_worker(run: readers.Run) -> Optional[Tuple[list, int]]:
    """([(worker, its spans, its kept frames' sorted (start, end))] of the
    workers with a kept frame, the frames kept), or None."""
    workers = traced(run)
    frames = readers.frames_of(run, "cold")
    if workers is None or not frames:
        return None
    out = []
    for i, w in enumerate(workers):
        own = sorted((f["start"], f["end"]) for f in frames
                     if f["timings"].get("worker") == i)
        if not own:
            continue
        sp = worker_spans(w)
        if sp is None:
            return None
        out.append((w, sp, own))
    return out, len(frames)


def idle_by_phase(run: readers.Run) -> Optional[Dict[str, float]]:
    """Idle seconds of a worker's card a kept frame, by the innermost span
    of the worker's solving thread (each of :data:`.spans.PHASES`)."""
    got = by_worker(run)
    if got is None:
        return None
    total = dict.fromkeys(spans.PHASES, 0.0)
    for w, sp, own in got[0]:
        pieces = spans.idle_pieces(sp, w["ops"][2], w["ops"][3], own,
                                   run.t0, run.t1)
        if pieces is None:
            return None
        lab, idle = pieces
        names = np.where(lab >= 0, sp.name[np.maximum(lab, 0)], "")
        for p in spans.PHASES:
            total[p] += float(idle[names == p].sum())
    return {p: v / got[1] for p, v in total.items()}


def idle_s(run: readers.Run, phase: str) -> Optional[float]:
    by = idle_by_phase(run)
    return None if by is None else by[phase]


def sweep_syncs(run: readers.Run) -> Optional[float]:
    """The workers' waits on their cards inside the sweeps, a kept
    frame."""
    got = by_worker(run)
    if got is None:
        return None
    n = 0
    for _, sp, own in got[0]:
        hit = trace.in_intervals(sp.start, own) & sp.within(("sweep",))
        n += int(sp.syncs[hit].sum())
    return n / got[1]


def device_ops(run: readers.Run) -> Optional[float]:
    """Ops the workers' cards ran a kept frame (each card's ops that
    started inside its worker's frames)."""
    got = by_worker(run)
    if got is None:
        return None
    n = sum(int(trace.in_intervals(w["ops"][2], own).sum())
            for w, _, own in got[0])
    return n / got[1]
