"""Dense window extraction for regular region grids.

The regions of one color form a regular grid: window (m, k) has its top-left
at ``(oy0 + m*T, ox0 + k*T)`` with stride ``T = 4s`` (or ``s`` at init) and
side F. ``Tensor.unfold`` gives all windows as one strided view of the
bounding block, so extraction is exact and copies only when the caller
materializes it. The flat region index is ``m * nbx + k`` (row-major), as in
``grid.Layer.color_regions``.

Block origins are clamped into the array like ``jax.lax.dynamic_slice``
does, so out-of-range origins behave as in the JAX package.
"""
from __future__ import annotations

import torch


def _clamp_start(start: int, size: int, dim: int) -> int:
    return min(max(int(start), 0), dim - size)


def dense_windows(arr: torch.Tensor, oy0: int, ox0: int, nby: int, nbx: int,
                  t: int, f: int) -> torch.Tensor:
    """[Hp, Wp, ...] -> [nby * nbx, F, F, ...] windows on a regular grid."""
    trailing = tuple(arr.shape[2:])
    hblk = (nby - 1) * t + f
    wblk = (nbx - 1) * t + f
    y0 = _clamp_start(oy0, hblk, arr.shape[0])
    x0 = _clamp_start(ox0, wblk, arr.shape[1])
    blk = arr[y0:y0 + hblk, x0:x0 + wblk]
    x = blk.unfold(0, f, t).unfold(1, f, t)        # [nby, nbx, ..., F, F]
    nt = len(trailing)
    perm = (0, 1, 2 + nt, 3 + nt) + tuple(range(2, 2 + nt))
    return x.permute(perm).reshape((nby * nbx, f, f) + trailing)


def dense_windows_leading(arr: torch.Tensor, oy0: int, ox0: int, nby: int,
                          nbx: int, t: int, f: int) -> torch.Tensor:
    """[C, Hp, Wp] -> [nby * nbx, C, F, F] windows on a regular grid."""
    c = arr.shape[0]
    hblk = (nby - 1) * t + f
    wblk = (nbx - 1) * t + f
    y0 = _clamp_start(oy0, hblk, arr.shape[1])
    x0 = _clamp_start(ox0, wblk, arr.shape[2])
    blk = arr[:, y0:y0 + hblk, x0:x0 + wblk]
    x = blk.unfold(1, f, t).unfold(2, f, t)        # [C, nby, nbx, F, F]
    return x.permute(1, 2, 0, 3, 4).reshape(nby * nbx, c, f, f)
