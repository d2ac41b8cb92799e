"""Zero-padded (2R+1)^2 box sums by cumulative sums (the summed-area-table
form of ``localexpstereo_tpu.ops.boxfilter.boxsum2d``; reference
``cv::boxFilter`` with ``BORDER_CONSTANT``, ``GuidedFilter.h:40-45``).

The sums are accumulated in float64. A float32 prefix sum rounds by the
order of its scan, which differs between devices (a sequential scan on the
CPU, a parallel one on a GPU). Those last-bit differences in the filtered
costs flip near-tie moves, and a solve's trajectory then leaves the
tolerance of its CPU twin at narrow windows. In float64 the rounded float32
result does not depend on the scan order.
"""
from __future__ import annotations

import torch


def _box1d_cumsum(x: torch.Tensor, radius: int, dim: int) -> torch.Tensor:
    """``out[i] = c[min(i+r, n-1)] - c[i-r-1]`` with ``c[-1] = 0``."""
    n = x.shape[dim]
    r = min(radius, n - 1)
    c = torch.cumsum(x, dim=dim)
    last = c.narrow(dim, n - 1, 1)
    reps = [1] * x.dim()
    reps[dim] = r
    upper = torch.cat([c.narrow(dim, r, n - r), last.repeat(reps)], dim=dim)
    zshape = list(x.shape)
    zshape[dim] = r + 1
    lower = torch.cat([x.new_zeros(zshape), c.narrow(dim, 0, n - r - 1)],
                      dim=dim)
    return upper - lower


def boxsum2d(x: torch.Tensor, radius: int) -> torch.Tensor:
    """Unnormalized box sum over the last two axes, window clipped to the
    array bounds; accumulated in float64, returned in ``x``'s dtype."""
    wide = x.to(torch.float64)
    out = _box1d_cumsum(wide, radius, x.dim() - 2)
    return _box1d_cumsum(out, radius, x.dim() - 1).to(x.dtype)
