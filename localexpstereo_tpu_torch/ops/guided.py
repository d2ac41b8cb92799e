"""Guided image filter with global-statistics reuse (``GuidedFilter.h:58-326``).

The guide statistics (channel means and the 6 distinct entries of the
regularized inverse covariance) are computed once per view on the host in
float64 numpy (:func:`compute_stats`, a copy of the JAX package's host
path, ``StereoEnergy.h:673-681``); per-region filtering
(:func:`filter_windows`) then needs only window-local box sums of the cost
and cost-times-guide, on the device.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import boxfilter


class GuidedFilterStats(NamedTuple):
    """Global per-pixel guide statistics (numpy float32, [H, W, k])."""

    guide: np.ndarray    # [H, W, 3] scaled guide (I / 255)
    mean: np.ndarray     # [H, W, 3] windowed channel means
    inv: np.ndarray      # [H, W, 6] inverse covariance (rr, rg, rb, gg, gb, bb)


def _np_boxsum(x: np.ndarray, radius: int) -> np.ndarray:
    """Zero-padded (2R+1)^2 box sum via a summed-area table (float64)."""
    h, w = x.shape
    sat = np.zeros((h + 1, w + 1), np.float64)
    sat[1:, 1:] = np.cumsum(np.cumsum(x, 0), 1)
    ys = np.arange(h)
    xs = np.arange(w)
    y0 = np.clip(ys - radius, 0, h)
    y1 = np.clip(ys + radius + 1, 0, h)
    x0 = np.clip(xs - radius, 0, w)
    x1 = np.clip(xs + radius + 1, 0, w)
    return (sat[y1[:, None], x1[None, :]] - sat[y0[:, None], x1[None, :]]
            - sat[y1[:, None], x0[None, :]] + sat[y0[:, None], x0[None, :]])


def compute_stats(image: np.ndarray, radius: int, eps: float,
                  scaling: float = 1.0 / 255.0) -> GuidedFilterStats:
    """Global guide statistics in float64 on the host; image [H, W, 3]
    float 0..255."""
    I = np.asarray(image, np.float64) * scaling
    n = _np_boxsum(np.ones(I.shape[:2], np.float64), radius)
    mean = np.stack([_np_boxsum(I[..., c], radius) / n for c in range(3)], -1)
    var = {}
    for name, i, j in [("rr", 0, 0), ("rg", 0, 1), ("rb", 0, 2),
                       ("gg", 1, 1), ("gb", 1, 2), ("bb", 2, 2)]:
        v = _np_boxsum(I[..., i] * I[..., j], radius) / n \
            - mean[..., i] * mean[..., j]
        var[name] = v + eps if i == j else v
    inv_rr = var["gg"] * var["bb"] - var["gb"] * var["gb"]
    inv_rg = var["gb"] * var["rb"] - var["rg"] * var["bb"]
    inv_rb = var["rg"] * var["gb"] - var["gg"] * var["rb"]
    inv_gg = var["rr"] * var["bb"] - var["rb"] * var["rb"]
    inv_gb = var["rb"] * var["rg"] - var["rr"] * var["gb"]
    inv_bb = var["rr"] * var["gg"] - var["rg"] * var["rg"]
    det = inv_rr * var["rr"] + inv_rg * var["rg"] + inv_rb * var["rb"]
    inv = np.stack([inv_rr, inv_rg, inv_rb, inv_gg, inv_gb, inv_bb],
                   -1) / det[..., None]
    return GuidedFilterStats(guide=I.astype(np.float32),
                             mean=mean.astype(np.float32),
                             inv=inv.astype(np.float32))


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
