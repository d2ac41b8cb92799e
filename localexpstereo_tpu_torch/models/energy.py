"""Energy construction and the unary pipeline, V3 cost-volume branch
(``CostVolumeEnergy``; counterpart of ``localexpstereo_tpu.models.energy``).

- :class:`EnergyData`: per-problem constant tensors (guide statistics,
  pairwise weights, the cost volume), padded where windows are cut from
  them, all on one device;
- :class:`EnergyConfig`: the static configuration.

Windows are fixed-shape slices of the margin-padded arrays; out-of-image
pixels are handled by masks, never by clipping.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..config import COST_FOR_INVALID, Parameters
from ..ops import guided, pairwise, unary_volume, validity, windows


class EnergyData(NamedTuple):
    """Constant tensors; leading axis V = views (L, R). Spatial arrays that
    feed window slices are padded with margin ``cfg.pad`` on each side; the
    volume with ``cfg.vol_pad``."""

    guide: torch.Tensor    # [V, Hp, Wp, 3] scaled guide
    gf_mean: torch.Tensor  # [V, Hp, Wp, 3]
    gf_inv: torch.Tensor   # [V, Hp, Wp, 6]
    coeff8: torch.Tensor   # [V, 8, Hp, Wp] pairwise weights (0 margin)
    vol: torch.Tensor      # [V, D, Hv, Wv] cost volumes (uint8 or float)


@dataclasses.dataclass(frozen=True)
class EnergyConfig:
    """Static energy configuration (volume kind, linear d-interpolation)."""

    width: int
    height: int
    pad: int
    params: Parameters
    min_disp: float
    max_disp: float
    max_vdisp: float = 0.0
    vol_pad: int = 0
    #: uint8 decode: cost = q * vol_scale + vol_zero (1.0 / 0.0: a float
    #: volume carried across by energy_from_numpy).
    vol_scale: float = 1.0
    vol_zero: float = 0.0


def _quantize_vol(stacked: np.ndarray, th_col: float):
    """uint8 linear quantization over [zero, 2*th_col] (values above th_col
    matter only through interpolation with a sub-th_col neighbor)."""
    zero = float(min(0.0, np.nanmin(stacked)))
    hi = max(2.0 * float(th_col), zero + 1e-6)
    scale = (hi - zero) / 255.0
    q = np.rint((np.clip(stacked, zero, hi) - zero) / scale)
    return q.astype(np.uint8), scale, zero


def build_energy(im0_bgr: np.ndarray, im1_bgr: np.ndarray,
                 params: Parameters, max_disp: float, pad: int,
                 vol0: np.ndarray, vol1: np.ndarray, min_disp: float = 0.0,
                 max_vdisp: float = 0.0, vol_pad: int = 0, device="cpu"):
    """Builds (EnergyData, EnergyConfig) for one stereo pair with cost
    volumes ([D, H, W] each), stored uint8-quantized (the JAX package's
    default ``vol_dtype``). Guide statistics are computed on the host in
    float64 (``StereoEnergy.h:673-681``); the tensors then move to
    ``device``."""
    r = params.guided_radius

    def pad_hw(arr, axes):
        widths = [(0, 0)] * arr.ndim
        for ax in axes:
            widths[ax] = (pad, pad)
        return np.pad(arr, widths)

    guides, means, invs, coeffs = [], [], [], []
    for im in (im0_bgr, im1_bgr):
        stats = guided.compute_stats(im, r, params.filter_param1)
        guides.append(pad_hw(stats.guide, (0, 1)))
        means.append(pad_hw(stats.mean, (0, 1)))
        invs.append(pad_hw(np.nan_to_num(stats.inv), (0, 1)))
        c8 = pairwise.smoothness_coeffs(
            torch.as_tensor(np.asarray(im, np.float32)), params.omega,
            params.epsilon).numpy()
        coeffs.append(pad_hw(c8, (1, 2)))

    stacked, vol_scale, vol_zero = _quantize_vol(np.stack([vol0, vol1]),
                                                 params.th_col)
    vp = int(vol_pad)
    vol = np.pad(stacked, ((0, 0), (0, 0), (vp, vp), (vp, vp)))

    h, w = im0_bgr.shape[:2]
    cfg = EnergyConfig(width=w, height=h, pad=pad, params=params,
                       min_disp=min_disp, max_disp=max_disp,
                       max_vdisp=max_vdisp, vol_pad=vp,
                       vol_scale=vol_scale, vol_zero=vol_zero)
    return _to_data(np.stack(guides), np.stack(means), np.stack(invs),
                    np.stack(coeffs), vol, device), cfg


def _to_data(guide, gf_mean, gf_inv, coeff8, vol, device) -> EnergyData:
    def dev(x, dtype=None):
        return torch.from_numpy(np.array(x, dtype)).to(device)

    return EnergyData(guide=dev(guide, np.float32),
                      gf_mean=dev(gf_mean, np.float32),
                      gf_inv=dev(gf_inv, np.float32),
                      coeff8=dev(coeff8, np.float32), vol=dev(vol))


def energy_from_numpy(data, cfg, device="cpu"):
    """Carries an energy across from another implementation.

    ``data`` is any object with array attributes ``guide``, ``gf_mean``,
    ``gf_inv``, ``coeff8`` and ``vol`` (e.g. the JAX package's
    ``EnergyData`` of the volume kind); ``cfg`` any object with the
    attributes ``width, height, pad, params, min_disp, max_disp, max_vdisp,
    vol_pad, vol_scale, vol_zero`` (its ``params`` a dataclass with the
    fields of :class:`Parameters`). Returns the port's (EnergyData,
    EnergyConfig) on ``device``."""
    params = Parameters(**dataclasses.asdict(cfg.params))
    new_cfg = EnergyConfig(
        width=int(cfg.width), height=int(cfg.height), pad=int(cfg.pad),
        params=params, min_disp=float(cfg.min_disp),
        max_disp=float(cfg.max_disp), max_vdisp=float(cfg.max_vdisp),
        vol_pad=int(cfg.vol_pad), vol_scale=float(cfg.vol_scale),
        vol_zero=float(cfg.vol_zero))
    arrays = [np.asarray(getattr(data, k)) for k in
              ("guide", "gf_mean", "gf_inv", "coeff8", "vol")]
    return _to_data(*arrays, device), new_cfg


def state_from_numpy(labeling_m, cost_m, device="cpu"):
    """(labeling_m [Hp, Wp, 4], cost_m [Hp, Wp]) padded state as float32
    tensors on ``device``."""
    return tuple(torch.from_numpy(np.array(x, np.float32)).to(device)
                 for x in (labeling_m, cost_m))


# ------------------------------------------------------------ windowing ----

def in_image_windows(cfg: EnergyConfig, ox: torch.Tensor, oy: torch.Tensor,
                     off: int, size: int) -> torch.Tensor:
    """[N, size, size] float32 in-image mask of windows at (o + off)."""
    it = torch.arange(size, device=ox.device)
    ys = oy[:, None, None] + off + it[None, :, None]
    xs = ox[:, None, None] + off + it[None, None, :]
    inside = (xs >= 0) & (xs < cfg.width) & (ys >= 0) & (ys < cfg.height)
    return inside.to(torch.float32)


def dense_filter_windows(data: EnergyData, cfg: EnergyConfig, mode: int,
                         ox: torch.Tensor, oy: torch.Tensor, ox0: int,
                         oy0: int, nby: int, nbx: int, stride: int,
                         target_off: int, target_size: int):
    """Guided-filter statistic windows of a regular region grid whose first
    region's unit origin is (ox0, oy0) (unpadded coords); ox/oy [N] give
    every region's origin for the in-image mask. Proposal-independent, so
    the engine cuts them once per color step (``StereoEnergy.h:616-626``)."""
    r = cfg.params.guided_radius
    fsize = target_size + 2 * r
    foff = target_off - r
    wy = oy0 + foff + cfg.pad
    wx = ox0 + foff + cfg.pad
    cut = [windows.dense_windows(a[mode], wy, wx, nby, nbx, stride, fsize)
           for a in (data.guide, data.gf_mean, data.gf_inv)]
    return (*cut, in_image_windows(cfg, ox, oy, foff, fsize))


def unary_windows(data: EnergyData, cfg: EnergyConfig, mode: int,
                  proposals: torch.Tensor, ox: torch.Tensor,
                  oy: torch.Tensor, target_off: int, target_size: int,
                  stat_windows) -> torch.Tensor:
    """Filtered unary costs of ``proposals`` over their target windows
    (``CostVolumeEnergy.h:55-183``): raw cost on the filter window (target
    + R margin), guided-filter aggregation, the target crop, and the
    validity clamp to ``COST_FOR_INVALID``.

    Args:
      ox, oy: [N] global coords of the regions' unit origins.
      target_off: target window offset from the unit origin (-s for shared
        windows, 0 for init-time unit windows); target_size: 3s or s.
      stat_windows: from :func:`dense_filter_windows` for the same regions.
    Returns:
      [N, T, T] float32 costs (0 outside the image).
    """
    r = cfg.params.guided_radius
    fsize = target_size + 2 * r
    foff = target_off - r
    raw = unary_volume.sample_windows_aligned(
        data.vol[mode], cfg.vol_pad, proposals, ox + foff, oy + foff, fsize,
        cfg.height, cfg.width, min_disp=cfg.min_disp,
        th_col=cfg.params.th_col, scale=cfg.vol_scale, zero=cfg.vol_zero)
    if cfg.params.filter_name in ("GF", "GFfloat"):
        gwin, mwin, iwin, fmask = stat_windows
        q = guided.filter_windows(raw, gwin, mwin, iwin, fmask, r)
    elif cfg.params.filter_name:
        raise NotImplementedError(
            f"filter {cfg.params.filter_name!r} is not ported yet")
    else:
        q = raw
    q = q[:, r:r + target_size, r:r + target_size]
    valid = validity.valid_windows(proposals, ox + target_off,
                                   oy + target_off, target_size,
                                   cfg.min_disp, cfg.max_disp)
    tmask = in_image_windows(cfg, ox, oy, target_off, target_size)
    q = torch.where(valid, q, COST_FOR_INVALID)
    return q * tmask
