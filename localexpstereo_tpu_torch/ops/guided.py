"""Guided image filter with global-statistics reuse (``GuidedFilter.h:58-326``).

The guide statistics (channel means and the 6 distinct entries of the
regularized inverse covariance) are computed once per view in float64 on
the image's device (:func:`compute_stats`); per-region filtering
(:func:`filter_windows`) then needs only window-local box sums of the cost
and cost-times-guide, on the device.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import boxfilter


class GuidedFilterStats(NamedTuple):
    """Global per-pixel guide statistics, float32 tensors [H, W, k]."""

    guide: torch.Tensor  # [H, W, 3] scaled guide (I / 255)
    mean: torch.Tensor   # [H, W, 3] windowed channel means
    inv: torch.Tensor    # [H, W, 6] inverse covariance (rr rg rb gg gb bb)


def compute_stats(image, radius: int, eps: float,
                  scaling: float = 1.0 / 255.0) -> GuidedFilterStats:
    """Global guide statistics on the image's device: the whole statistic
    (means, covariances, the 3x3 inverse) in float64, cast to float32 once
    at the end, so it equals the JAX package's float64 host path
    (``StereoEnergy.h:673-681``) up to the order of rounding. (The JAX
    device path runs in float32, where E[x^2] - mean^2 cancels in ``inv``
    wherever the variance is near ``eps``.) ``inv`` has ``nan_to_num``
    applied, as both JAX paths do.

    Args:
      image: [H, W, 3] float 0..255, a tensor (on any device) or a numpy
        array (on the CPU).
    """
    I = torch.as_tensor(image).to(torch.float64) * scaling
    n = boxfilter.boxsum2d(torch.ones(I.shape[:2], dtype=torch.float64,
                                      device=I.device), radius)
    mean = boxfilter.boxsum2d(I.permute(2, 0, 1), radius) / n   # [3, H, W]
    var = {}
    for name, i, j in [("rr", 0, 0), ("rg", 0, 1), ("rb", 0, 2),
                       ("gg", 1, 1), ("gb", 1, 2), ("bb", 2, 2)]:
        v = boxfilter.boxsum2d(I[..., i] * I[..., j], radius) / n \
            - mean[i] * mean[j]
        var[name] = v + eps if i == j else v
    inv_rr = var["gg"] * var["bb"] - var["gb"] * var["gb"]
    inv_rg = var["gb"] * var["rb"] - var["rg"] * var["bb"]
    inv_rb = var["rg"] * var["gb"] - var["gg"] * var["rb"]
    inv_gg = var["rr"] * var["bb"] - var["rb"] * var["rb"]
    inv_gb = var["rb"] * var["rg"] - var["rr"] * var["gb"]
    inv_bb = var["rr"] * var["gg"] - var["rg"] * var["rg"]
    det = inv_rr * var["rr"] + inv_rg * var["rg"] + inv_rb * var["rb"]
    inv = torch.stack([inv_rr, inv_rg, inv_rb, inv_gg, inv_gb, inv_bb],
                      -1) / det[..., None]
    return GuidedFilterStats(
        guide=I.to(torch.float32),
        mean=mean.permute(1, 2, 0).to(torch.float32),
        inv=torch.nan_to_num(inv.to(torch.float32)))


#: The JAX package's name of its device path: the port's one path serves
#: both.
compute_stats_device = compute_stats


def filter_windows(p: torch.Tensor, guide: torch.Tensor, mean: torch.Tensor,
                   inv: torch.Tensor, mask: torch.Tensor,
                   radius: int) -> torch.Tensor:
    """Guided-filters a batch of cost windows with precomputed global stats
    (``FastGuidedImageFilter``, ``GuidedFilter.h:142-247,301-326``).
    Out-of-image positions (mask == 0) contribute nothing.

    Args:
      p: [N, F, F] raw costs; guide, mean: [N, F, F, 3]; inv: [N, F, F, 6];
        mask: [N, F, F] (1 in-image).
    Returns:
      [N, F, F] filtered costs.
    """
    mask = mask.to(p.dtype)
    p0 = p * mask
    n = boxfilter.boxsum2d(mask, radius)
    inv_n = 1.0 / torch.clamp(n, min=1e-8)

    gi = guide.permute(0, 3, 1, 2)                        # [N, 3, F, F]
    stacked = torch.cat([p0[:, None], p0[:, None] * gi], dim=1)
    sums = boxfilter.boxsum2d(stacked, radius)            # [N, 4, F, F]
    mean_p = sums[:, 0] * inv_n
    cov = sums[:, 1:] * inv_n[:, None] - mean.permute(0, 3, 1, 2) \
        * mean_p[:, None]

    ir, ig, ib = cov[:, 0], cov[:, 1], cov[:, 2]
    a_r = inv[..., 0] * ir + inv[..., 1] * ig + inv[..., 2] * ib
    a_g = inv[..., 1] * ir + inv[..., 3] * ig + inv[..., 4] * ib
    a_b = inv[..., 2] * ir + inv[..., 4] * ig + inv[..., 5] * ib
    b = (mean_p - a_r * mean[..., 0] - a_g * mean[..., 1]
         - a_b * mean[..., 2])

    ab = torch.stack([a_r * mask, a_g * mask, a_b * mask, b * mask], dim=1)
    ab_sums = boxfilter.boxsum2d(ab, radius)              # [N, 4, F, F]
    return (ab_sums[:, 0] * guide[..., 0] + ab_sums[:, 1] * guide[..., 1]
            + ab_sums[:, 2] * guide[..., 2] + ab_sums[:, 3]) * inv_n


def filter_image(p: torch.Tensor, stats: GuidedFilterStats,
                 radius: int) -> torch.Tensor:
    """Whole-image guided filtering of [H, W] costs (the reference's
    ``filter_mat``; the JAX package's ``guided.filter_image``): one window
    the size of the image, every pixel in it."""
    mask = torch.ones_like(p)
    return filter_windows(p[None], stats.guide[None], stats.mean[None],
                          stats.inv[None], mask[None], radius)[0]
