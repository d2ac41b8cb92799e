"""Whole-image guided aggregation with image height sharded and halo rows
exchanged (counterpart of ``localexpstereo_tpu.parallel.spatial``).

Every rank holds a band of image rows (:func:`.collectives.row_block`);
a box sum needs ``radius`` rows of each neighbour's band, which
:func:`.collectives.exchange_halo` brings (zero at the image's border).
Everything else the guided filter does is per pixel and stays on the
rank. The box sums are :func:`..ops.boxfilter.boxsum2d`'s, in float64.
"""
from __future__ import annotations

import torch

from ..ops import boxfilter
from . import collectives


def sharded_boxsum2d(block: torch.Tensor, radius: int) -> torch.Tensor:
    """This rank's rows of the zero-padded box sum of an [H, W] (or [C,
    H, W]) array whose rows are split over the ranks in order: ``block``
    is the rank's [Hs, W] (or [C, Hs, W]) rows, extended with ``radius``
    halo rows of each neighbour, box-summed, and cut back to its own."""
    moved = torch.movedim(block, -2, 0)
    ext = torch.movedim(collectives.exchange_halo(moved, radius), 0, -2)
    out = boxfilter.boxsum2d(ext, radius)
    return out.narrow(-2, radius, block.shape[-2])


def sharded_cost_aggregation(raw_cost: torch.Tensor, guide: torch.Tensor,
                             mean: torch.Tensor, inv: torch.Tensor,
                             radius: int) -> torch.Tensor:
    """This rank's rows of the whole-image guided filter
    (:func:`..ops.guided.filter_image`) of costs whose rows are split over
    the ranks: ``raw_cost`` [Hs, W], ``guide`` and ``mean`` [Hs, W, 3],
    ``inv`` [Hs, W, 6], the rank's rows of the image's statistics. Every
    box sum is :func:`sharded_boxsum2d`."""
    n = sharded_boxsum2d(torch.ones_like(raw_cost), radius)
    inv_n = 1.0 / torch.clamp(n, min=1e-8)
    gi = guide.permute(2, 0, 1)                            # [3, Hs, W]
    sums = sharded_boxsum2d(torch.cat([raw_cost[None], raw_cost[None] * gi]),
                            radius)
    mean_p = sums[0] * inv_n
    cov = sums[1:] * inv_n - mean.permute(2, 0, 1) * mean_p[None]
    a_r = inv[..., 0] * cov[0] + inv[..., 1] * cov[1] + inv[..., 2] * cov[2]
    a_g = inv[..., 1] * cov[0] + inv[..., 3] * cov[1] + inv[..., 4] * cov[2]
    a_b = inv[..., 2] * cov[0] + inv[..., 4] * cov[1] + inv[..., 5] * cov[2]
    b = (mean_p - a_r * mean[..., 0] - a_g * mean[..., 1]
         - a_b * mean[..., 2])
    ab = sharded_boxsum2d(torch.stack([a_r, a_g, a_b, b]), radius)
    return (ab[0] * guide[..., 0] + ab[1] * guide[..., 1]
            + ab[2] * guide[..., 2] + ab[3]) * inv_n
