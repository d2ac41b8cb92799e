"""Cost-volume data term: plane-indexed sampling of a [D, Hv, Wv] volume
(``CostVolumeEnergy::ComputeUnaryPotentialWithoutCheck``,
``CostVolumeEnergy.h:55-183``, linear interpolation).

Semantics of ``localexpstereo_tpu.ops.unary_volume.sample_slabs_aligned``:
the JAX package contracts each window's [D, F, F] slab with the tent
``max(0, 1 - |g - dv|)``, ``dv = clip(d - min_disp, 0, D-1)``. The tent has
at most two non-zero taps, ``floor(dv)`` and ``floor(dv) + 1``, so the port
gathers those two taps straight from the padded volume with the same tent
weights: the same sum (adding the zero taps is exact) without the slab.
"""
from __future__ import annotations

import torch

from ..config import COST_FOR_INVALID


def sample_windows_aligned(vol: torch.Tensor, vol_pad: int,
                           proposals: torch.Tensor, fox: torch.Tensor,
                           foy: torch.Tensor, size: int, height: int,
                           width: int, *, min_disp: float, th_col: float,
                           scale: float = 1.0,
                           zero: float = 0.0) -> torch.Tensor:
    """Raw matching cost of each proposal over its F x F window.

    Args:
      vol: [D, Hv, Wv] volume (float32, bfloat16 or uint8; widened to
        float32 exactly before the tent sum), spatially zero-padded by
        ``vol_pad``: image pixel (x, y) is ``vol[:, y + vol_pad, x + vol_pad]``.
      proposals: [N, 4]; fox, foy: [N] global window origins (may be < 0).
      scale, zero: uint8 decode ``q * scale + zero``, applied after the
        contraction (exact, the tent weights sum to 1).
    Returns:
      [N, F, F] float32 costs truncated at ``th_col``, 0 outside the image.
    """
    d_, hv, wv = vol.shape
    dev = proposals.device
    it = torch.arange(size, dtype=torch.float32, device=dev)
    xs = fox.to(torch.float32)[:, None, None] + it[None, None, :]
    ys = foy.to(torch.float32)[:, None, None] + it[None, :, None]
    a = proposals[:, 0][:, None, None]
    b = proposals[:, 1][:, None, None]
    c = proposals[:, 2][:, None, None]
    d = a * xs + b * ys + c
    dv = torch.clamp(d + float(-min_disp), 0.0, float(d_ - 1))
    finite = torch.isfinite(d)
    dv = torch.where(finite, dv, 0.0)
    lo = torch.floor(dv)
    w_lo = torch.clamp(1.0 - torch.abs(lo - dv), min=0.0)
    w_hi = torch.clamp(1.0 - torch.abs((lo + 1.0) - dv), min=0.0)
    ilo = lo.to(torch.int64)
    ihi = torch.clamp(ilo + 1, max=d_ - 1)

    iy = torch.clamp(foy.to(torch.int64)[:, None, None] + vol_pad
                     + torch.arange(size, device=dev)[None, :, None],
                     0, hv - 1)
    ix = torch.clamp(fox.to(torch.int64)[:, None, None] + vol_pad
                     + torch.arange(size, device=dev)[None, None, :],
                     0, wv - 1)
    pix = iy * wv + ix                                    # [N, F, F]
    flat = vol.reshape(-1)
    plane = hv * wv
    v_lo = flat[ilo * plane + pix].to(torch.float32)
    v_hi = flat[ihi * plane + pix].to(torch.float32)
    cost = (v_lo * w_lo + v_hi * w_hi) * scale + zero
    cost = torch.where(finite, cost, COST_FOR_INVALID)
    cost = torch.clamp(cost, max=th_col)
    in_image = (xs >= 0) & (xs < width) & (ys >= 0) & (ys < height)
    return torch.where(in_image, cost, 0.0)
