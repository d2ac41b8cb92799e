"""What the metrics' readers (``metrics/<name>.py``) share: the run's
frames, stamps and, in a traced run, its device trace, reduced.

A reader takes the run (:class:`Run`) and returns a number, or None where
it finds nothing to read (no trace, no frame of its kind); the harness then
leaves the metric out of the line.
"""
from __future__ import annotations

import dataclasses
import statistics
from typing import List, Optional, Sequence

import numpy as np

from . import roofline, trace


@dataclasses.dataclass
class Run:
    """One run as the readers see it. ``frames``: the frames completed
    inside the window [t0, t1] (dicts with ``start``, ``end``, ``marks``
    [(evaluator index, time)], and ``timings`` / ``mccnn_events`` where
    the client has them); ``device``: the window's device trace."""

    config: dict
    kind: str
    frames: List[dict]
    t0: float
    t1: float
    device: Optional[trace.DeviceTrace]
    peak_bytes: int
    mccnn_ms: List[float] = dataclasses.field(default_factory=list)
    setup_s: float = 0.0


def frames_of(run: Run, kind: str) -> List[dict]:
    """The run's frames where they are of ``kind``, else none."""
    return run.frames if run.kind == kind else []


def in_frames(run: Run, frames: Sequence[dict]) -> np.ndarray:
    """Which device ops started inside one of ``frames``."""
    return trace.in_intervals(run.device.start_s,
                              [(f["start"], f["end"]) for f in frames])


def device_s(run: Run, frames, patterns: Sequence[str]) -> float:
    """Device seconds of the ops named like ``patterns`` inside
    ``frames``."""
    dev = run.device
    hit = in_frames(run, frames) & trace.matching(dev.names, dev.name_id,
                                                  patterns)
    return float((dev.end_s[hit] - dev.start_s[hit]).sum())


def device_idle(run: Run, kind: str) -> Optional[float]:
    if run.device is None or not frames_of(run, kind):
        return None
    busy = trace.busy_s(run.device.start_s, run.device.end_s, run.t0, run.t1)
    return 100.0 * (1.0 - busy / (run.t1 - run.t0))


def device_ops(run: Run, kind: str) -> Optional[float]:
    frames = frames_of(run, kind)
    if run.device is None or not frames:
        return None
    return float(in_frames(run, frames).sum()) / len(frames)


def peak_gib(run: Run, kind: str) -> Optional[float]:
    return run.peak_bytes / 2 ** 30 if frames_of(run, kind) else None


def expansion_roofline(run: Run, kind: str) -> Optional[float]:
    """The configuration's least time of the frames' expansion moves over
    the device time of the ``expansion_accept`` kernels in them, in %."""
    frames = frames_of(run, kind)
    if run.device is None or not frames:
        return None
    spent = device_s(run, frames, ("expansion_accept",))
    if spent <= 0:
        return None
    bound = roofline.expansion_bound_s(run.config, kind) * len(frames)
    return 100.0 * bound / spent


def sweep_s(run: Run, graph_cut: bool) -> Optional[float]:
    """The mean seconds of a greedy or a graph-cut sweep, from the
    evaluator's stamps (synchronized in a traced run)."""
    sched = run.config["schedule"][run.kind]
    g, c = sched["greedy"], sched["graph_cut"]
    lo, hi = (g + 1, g + c) if graph_cut else (1, g)
    if run.device is None or hi < lo:
        return None
    spans = []
    for f in run.frames:
        t = dict(f["marks"])
        spans += [t[i] - t[i - 1] for i in range(lo, hi + 1)]
    return statistics.fmean(spans) if spans else None


def build_init_s(run: Run, kind: str) -> Optional[float]:
    """Seconds from a frame's start to the evaluator's first stamp (the
    energy build and the init)."""
    frames = frames_of(run, kind)
    if run.device is None or not frames:
        return None
    return statistics.fmean(dict(f["marks"])[0] - f["start"] for f in frames)


def stream_timing(run: Run, key: str) -> Optional[float]:
    """The mean of one of ``StereoStream.last_timings`` (a traced run's)."""
    rows = [f["timings"][key] for f in frames_of(run, "warm")
            if f.get("timings")]
    return statistics.fmean(rows) if rows else None


def spans(run: Run):
    """(start, end, name) of the benchmark's spans in the window: each
    frame, its build and init, its sweeps and its output."""
    out = []
    sched = run.config["schedule"][run.kind]
    g = sched["greedy"]
    for f in run.frames:
        out.append((f["start"], f["end"], f"{run.kind}_frame"))
        marks = sorted(f["marks"])
        prev = f["start"]
        for i, t in marks:
            name = ("build_init" if i == 0 else
                    "greedy_sweep" if i <= g else "gc_sweep")
            out.append((prev, t, name))
            prev = t
        out.append((prev, f["end"], "output"))
    return out
