"""The measured window's arithmetic, from frame logs alone.

A frame log is a list of ``(client, start_s, end_s)``: the frames that a
client completed inside the window. A frame still running when the window
closes is not in it (it is dropped: neither counted nor timed).
"""
from __future__ import annotations

import statistics
from typing import Iterable, List, Sequence, Tuple

Frame = Tuple[int, float, float]


def completed(frames: Iterable[Frame], t0: float, t1: float) -> List[Frame]:
    """The frames that started at or after ``t0`` and ended by ``t1``."""
    return [f for f in frames if f[1] >= t0 and f[2] <= t1]


def frame_s(frames: Sequence[Frame], clients: int) -> float:
    """Amortized seconds per cold frame: the wall times of every completed
    frame summed, over (clients x frames completed). With one client, the
    mean frame time."""
    if not frames:
        raise ValueError("no frame completed in the window")
    return sum(e - s for _, s, e in frames) / (clients * len(frames))


def warm_frame_s(frames: Sequence[Frame]) -> float:
    """The mean wall time of a warm frame, every frame of every stream."""
    if not frames:
        raise ValueError("no frame completed in the window")
    return statistics.fmean(e - s for _, s, e in frames)


def pan_offset(k: int, positions: int, step: int) -> int:
    """Column offset of frame ``k`` of a pan over ``positions`` positions
    ``step`` px apart that runs back and forth (0, 1, .., P-1, P-2, .., 1,
    0, 1, ..), so that consecutive frames never jump."""
    if positions <= 1:
        return 0
    period = 2 * (positions - 1)
    i = k % period
    return step * (i if i < positions else period - i)
