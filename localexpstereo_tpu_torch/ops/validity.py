"""Label validity: rejects extreme planes (``StereoEnergy.h:560-610``).

A plane is valid at pixel (x, y) iff its disparity is inside [MIN, MAX]
there and at the four probes ``d +- 5a +- 5b``.
"""
from __future__ import annotations

import torch


def valid_windows(proposals: torch.Tensor, ox: torch.Tensor, oy: torch.Tensor,
                  size: int, min_disp: float, max_disp: float) -> torch.Tensor:
    """[N, S, S] bool validity of each proposal over its window whose (0, 0)
    pixel sits at global (ox, oy)."""
    it = torch.arange(size, dtype=torch.float32, device=proposals.device)
    ys = oy.to(torch.float32)[:, None, None] + it[None, :, None]
    xs = ox.to(torch.float32)[:, None, None] + it[None, None, :]
    a = proposals[:, 0][:, None, None]
    b = proposals[:, 1][:, None, None]
    c = proposals[:, 2][:, None, None]
    ds = a * xs + b * ys + c
    a5 = a * 5.0
    b5 = b * 5.0
    ok = (ds >= min_disp) & (ds <= max_disp)
    for sa in (+1.0, -1.0):
        for sb in (+1.0, -1.0):
            probe = ds + sa * a5 + sb * b5
            ok &= (probe >= min_disp) & (probe <= max_disp)
    return ok
