"""Energy construction and the unary pipeline (counterpart of
``localexpstereo_tpu.models.energy``), of two kinds: the V3 cost-volume
energy (``CostVolumeEnergy``, kind "volume") and the V2 image-warp energy
(``NaiveStereoEnergy``, kind "naive").

- :class:`EnergyData`: per-problem constant tensors (guide statistics,
  pairwise weights, and the cost volumes or the feature images), padded
  where windows are cut from them, all on one device;
- :class:`EnergyConfig`: the static configuration, including the unary
  route of the volume kind (:func:`fused_unary`): the fused sampling +
  guided filter of :mod:`..ops.unary_cuda`, which reads the statistics
  itself (under the bilateral filter it samples only), or the plain
  2-tap sampler, then the filter on statistic windows the caller cuts.
  ``"auto"`` takes the fused kernel where the volume lives on a CUDA
  device and the kernel has a launch plan for the window, ``"dma"``
  always (its plain version on the CPU). The volume's d-interpolation
  (``interp``: methods 0 and 2) takes the plain method sampler on either
  route. The naive kind has one route, whatever the setting: the warp
  sampler of :mod:`..ops.unary_warp`, then the filter.

The filter is the parameters' ``filter_name``: the guided filter ("GF",
"GFfloat"; :mod:`..ops.guided`) at radius ``windR // 2`` or the joint
bilateral filter ("BF", "BL"; :mod:`..ops.bilateral`) at radius ``windR``
on the same windows.

Windows are fixed-shape slices of the margin-padded arrays; out-of-image
pixels are handled by masks, never by clipping.

A rank of a sharded solver (:mod:`..parallel.volume`,
:mod:`..parallel.dvolume`) holds one part of the padded volume
(:class:`VolumeWindow`, ``build_energy(vol_transform=)``), and its
configuration says so (``EnergyConfig.sharded``): the fused kernel, which
reads the whole padded volume, is then off.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import COST_FOR_INVALID, Parameters
from ..ops import (bilateral, guided, pairwise, unary_cuda, unary_volume,
                   unary_warp, validity, windows)
from ..parallel import collectives


class EnergyData(NamedTuple):
    """Constant tensors; leading axis V = views (L, R). Spatial arrays that
    feed window slices are padded with margin ``cfg.pad`` on each side; the
    volume with ``cfg.vol_pad``. The volume kind has ``vol``, the naive kind
    ``exi``."""

    guide: torch.Tensor    # [V, Hp, Wp, 3] scaled guide
    gf_mean: torch.Tensor  # [V, Hp, Wp, 3]
    gf_inv: torch.Tensor   # [V, Hp, Wp, 6]
    coeff8: torch.Tensor   # [V, 8, Hp, Wp] pairwise weights (0 margin)
    #: [V, D, Hv, Wv] cost volumes (uint8, bf16, f32)
    vol: Optional[torch.Tensor] = None
    #: [V, H, W, 4] float32 feature images (unpadded: the samplers clamp
    #: their coordinates into the image)
    exi: Optional[torch.Tensor] = None


@dataclasses.dataclass(frozen=True)
class EnergyConfig:
    """Static energy configuration."""

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
    #: Unary route of the sweeps' color steps: "auto" | "dma".
    unary_backend: str = "auto"
    #: "volume" (V3 cost volumes) or "naive" (V2 image warp).
    kind: str = "volume"
    #: The volume's d-interpolation (``CostVolumeEnergy.h:45-48``): 0
    #: nearest, 1 linear, 2 quadratic.
    interp: int = 1
    #: ``vol`` is one rank's part of the volume (a :class:`VolumeWindow`).
    sharded: bool = False


class VolumeWindow(NamedTuple):
    """The part of the padded volume one rank of a sharded solver holds:
    ``size`` planes (``axis`` 0; the plane axis has no padding) or padded
    rows (``axis`` 1) from ``start``, zero where they leave the volume."""

    axis: int
    start: int
    size: int


def _guided(cfg: EnergyConfig) -> bool:
    return cfg.params.filter_name in ("GF", "GFfloat")


def fused_unary(cfg: EnergyConfig, device, size: int) -> bool:
    """Whether a sweep's unary over filter windows of side ``size`` (F:
    the target and the filter radius on each side) runs the fused sampling
    kernel, :func:`..ops.unary_cuda.sample_windows`. The one routing point
    of the unary. Only the volume kind with linear interpolation (the
    kernel's only method) on a whole volume takes it: a shard's part is
    sampled by the plain sampler, as the JAX engine's ``use_vol_dma``
    excludes its sharded modes. Then the "dma" route always does (on the
    CPU the kernel's plain version), and the "auto" route where the volume
    lives on a CUDA ``device`` and the kernel has a launch plan for (F,
    the kernel's filter radius); elsewhere "auto" keeps the plain sampler,
    the JAX engine's on the CPU."""
    if cfg.kind != "volume" or cfg.interp != 1 or cfg.sharded:
        return False
    if cfg.unary_backend == "dma":
        return True
    r = cfg.params.guided_radius if _guided(cfg) else 0
    return (torch.device(device).type == "cuda"
            and unary_cuda.has_plan(int(size), r))


def kernel_filters(cfg: EnergyConfig, device, size: int) -> bool:
    """Whether the fused kernel also runs the filter, reading the
    statistics itself (the sweeps then cut no statistic windows): the
    guided filter on the :func:`fused_unary` route."""
    return _guided(cfg) and fused_unary(cfg, device, size)


def build_energy(im0_bgr, im1_bgr, params: Parameters, max_disp: float,
                 pad: int, vol0=None, vol1=None, min_disp: float = 0.0,
                 max_vdisp: float = 0.0, vol_pad: int = 0, device="cuda",
                 vol_dtype: str = "uint8", stats_backend: str = "host",
                 interp: int = 1,
                 vol_transform: Optional[VolumeWindow] = None):
    """Builds (EnergyData, EnergyConfig) for one stereo pair on ``device``
    (the card unless the caller asks for the CPU; see
    :func:`resolve_device`), from images and volumes given as numpy arrays
    or tensors (a tensor on ``device`` is read there): the guide
    statistics in float64 (:func:`..ops.guided.compute_stats`), the
    pairwise weights, the volumes or the feature images, the padding.

    With cost volumes ([D, H, W] each) the energy is of the volume kind
    (``main.cpp:386``); they are stored uint8-quantized (``vol_dtype``
    "uint8", the JAX package's default), as bfloat16 (float32 rounded to
    nearest even, as the JAX package's ``astype``) or as float32, and
    sampled by d-interpolation method ``interp``. Without
    them it is of the naive kind: the feature images of both views
    (``vol_pad`` and ``vol_dtype`` are not used).

    ``stats_backend`` names the JAX package's two builds; in the port both
    run on ``device`` and the name selects the uint8 range only. "host"
    (the JAX package's default and its command line's) quantizes over
    [min(0, min(vol)), 2 th_col]; "device" (its serving path's per-frame
    build, ``_build_energy_device``) over the static [0, 2 th_col], so that
    the configuration depends on the frame's shapes and the parameters
    only. The two differ for a volume with negative values.

    ``vol_transform``: store only this part of the padded volumes (a shard
    rank's; ``cfg.sharded`` is set). The volumes need only support slicing
    their leading two axes (numpy arrays, memory maps, tensors), and only
    the part is read; the uint8 range is the whole volume's."""
    device = resolve_device(device)
    if vol_dtype not in ("uint8", "bfloat16", "float32"):
        raise ValueError(f"vol_dtype {vol_dtype!r}: the port stores the "
                         f"volume as uint8, bfloat16 or float32")
    if stats_backend not in ("host", "device"):
        raise ValueError(f"stats_backend {stats_backend!r}: 'host' or "
                         f"'device'")
    ims = [torch.as_tensor(im, dtype=torch.float32, device=device)
           for im in (im0_bgr, im1_bgr)]
    h, w = ims[0].shape[:2]
    r = params.guided_radius
    guides, means, invs, coeffs = [], [], [], []
    for im in ims:
        stats = guided.compute_stats(im, r, params.filter_param1)
        guides.append(_padded(stats.guide, pad, 0))
        means.append(_padded(stats.mean, pad, 0))
        invs.append(_padded(stats.inv, pad, 0))
        coeffs.append(_padded(pairwise.smoothness_coeffs(
            im, params.omega, params.epsilon), pad, 1))
    cfg = EnergyConfig(width=w, height=h, pad=pad, params=params,
                       min_disp=min_disp, max_disp=max_disp,
                       max_vdisp=max_vdisp, interp=int(interp))
    vol = exi = None
    if vol0 is None:
        cfg = dataclasses.replace(cfg, kind="naive")
        exi = torch.stack([unary_warp.build_feature_image(im, params.alpha)
                           for im in ims])
    else:
        vol, vol_scale, vol_zero = _store_volumes(
            vol0, vol1, int(vol_pad), device, vol_dtype, params.th_col,
            static_range=stats_backend == "device", window=vol_transform)
        cfg = dataclasses.replace(cfg, vol_pad=int(vol_pad),
                                  vol_scale=vol_scale, vol_zero=vol_zero,
                                  sharded=vol_transform is not None)
    data = EnergyData(guide=torch.stack(guides), gf_mean=torch.stack(means),
                      gf_inv=torch.stack(invs), coeff8=torch.stack(coeffs),
                      vol=vol, exi=exi)
    return data, cfg


def _padded(x: torch.Tensor, pad: int, axis: int) -> torch.Tensor:
    """``x`` zero-padded by ``pad`` on both sides of axes ``axis`` and
    ``axis + 1``."""
    shape = list(x.shape)
    shape[axis] += 2 * pad
    shape[axis + 1] += 2 * pad
    out = x.new_zeros(shape)
    index = [slice(None)] * x.dim()
    index[axis] = slice(pad, pad + x.shape[axis])
    index[axis + 1] = slice(pad, pad + x.shape[axis + 1])
    out[tuple(index)] = x
    return out


def _nanmin(v: torch.Tensor) -> float:
    m = v.amin()
    return float(v[~torch.isnan(v)].amin() if torch.isnan(m) else m)


def _volume_part(vol, vol_pad: int, device: torch.device,
                 window: Optional[VolumeWindow]):
    """(shape of the stored view, float32 part of ``vol`` on ``device``,
    the part's index into the stored view): the view padded by
    ``vol_pad``, or ``window``'s part of the padded view. Only the part
    of ``vol`` is read; the rest of the stored view is zero."""
    nd, h, w = (int(x) for x in vol.shape)
    vp = vol_pad
    shape = [nd, h + 2 * vp, w + 2 * vp]
    if window is None:
        src, dst = (slice(None),), (slice(None), slice(vp, vp + h))
    elif window.axis == 0:
        lo, hi = max(window.start, 0), min(window.start + window.size, nd)
        hi = max(hi, lo)
        src = (slice(lo, hi),)
        dst = (slice(lo - window.start, hi - window.start), slice(vp, vp + h))
    else:
        # The window's padded rows that hold image rows.
        lo = max(window.start, vp)
        hi = max(min(window.start + window.size, vp + h), lo)
        src = (slice(None), slice(lo - vp, hi - vp))
        dst = (slice(None), slice(lo - window.start, hi - window.start))
    if window is not None:
        shape[window.axis] = window.size
    part = torch.as_tensor(vol[src], dtype=torch.float32, device=device)
    return shape, part, dst + (slice(vp, vp + w),)


def _store_volumes(vol0, vol1, vol_pad: int, device: torch.device,
                   vol_dtype: str, th_col: float, static_range: bool,
                   window: Optional[VolumeWindow] = None):
    """Both views' volumes as one [2, D, H + 2 vol_pad, W + 2 vol_pad]
    tensor of ``vol_dtype`` on ``device`` (zero margin), or ``window``'s
    part of it, with the uint8 decode (scale, zero). Each view is
    converted on its own into the output (``vol1`` the same object as
    ``vol0`` is converted once), so the peak is one float32 view beyond
    the inputs.

    uint8 is a linear quantization over [zero, 2 th_col] (values above
    th_col matter only through interpolation with a sub-th_col neighbor):
    zero 0 with ``static_range``, else min(0, min of both volumes). The
    float32 operations are the JAX package's, the divisor a tensor on the
    device (a CUDA division by a host scalar multiplies by its reciprocal,
    which rounds otherwise)."""
    parts = [_volume_part(v, vol_pad, device, window)
             for v in ((vol0,) if vol1 is vol0 else (vol0, vol1))]
    scale, zero = 1.0, 0.0
    if vol_dtype == "uint8":
        if not static_range:
            zero = min(0.0, *(_nanmin(v) for _, v, _ in parts
                              if v.numel()))
            if window is not None:
                # The uint8 range of the whole volume, not of this part.
                zero = collectives.reduce_min(zero)
        hi = max(2.0 * float(th_col), zero + 1e-6)
        scale = (hi - zero) / 255.0
        divisor = torch.tensor(scale, dtype=torch.float32, device=device)
    out = torch.zeros([2] + parts[0][0], dtype=getattr(torch, vol_dtype),
                      device=device)
    for k, (_, v, index) in enumerate(parts):
        if vol_dtype == "uint8":
            v = torch.clamp(v, zero, hi).sub_(zero).div_(divisor).round_()
        out[(k,) + index] = v
    if len(parts) == 1:
        out[1] = out[0]
    return out, scale, zero


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; raises for a CUDA device on a host
    without one (the port's entry points never fall back to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device cuda: no CUDA device is available "
                           "(pass device='cpu' to run on the CPU)")
    return device


def _volume_tensor(vol) -> torch.Tensor:
    """A volume as a CPU tensor of its own dtype; a numpy bfloat16 array
    (``ml_dtypes``' type, the JAX package's) is carried by its bits."""
    if isinstance(vol, torch.Tensor):
        return vol
    vol = np.array(vol)
    if vol.dtype.name == "bfloat16":
        return torch.from_numpy(vol.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(vol)


def _to_data(guide, gf_mean, gf_inv, coeff8, vol, exi,
             device) -> EnergyData:
    def dev(x):
        return torch.from_numpy(np.array(x, np.float32)).to(device)

    return EnergyData(
        guide=dev(guide), gf_mean=dev(gf_mean), gf_inv=dev(gf_inv),
        coeff8=dev(coeff8),
        vol=None if vol is None else _volume_tensor(vol).to(device),
        exi=None if exi is None else dev(exi))


def energy_from_numpy(data, cfg, device="cuda"):
    """Carries an energy across from another implementation.

    ``data`` is any object with array attributes ``guide``, ``gf_mean``,
    ``gf_inv``, ``coeff8``, ``vol`` and ``exi`` (e.g. the JAX package's
    ``EnergyData``: of the volume kind, built with or without
    ``dma_align``, trailing volume padding is never read, and a
    ``gf_stack`` is not needed; of the naive kind, ``vol`` is None and
    ``exi`` is padded by ``cfg.exi_pad``, which is cropped here); ``cfg``
    any object with the attributes ``kind, width, height, pad, params,
    min_disp, max_disp, max_vdisp, vol_pad, vol_scale, vol_zero,
    exi_pad, interp`` (its ``params`` a dataclass with the fields of
    :class:`Parameters`). Returns the port's (EnergyData, EnergyConfig,
    with the "auto" unary route) on ``device``."""
    params = Parameters(**dataclasses.asdict(cfg.params))
    h, w = int(cfg.height), int(cfg.width)
    new_cfg = EnergyConfig(
        width=w, height=h, pad=int(cfg.pad),
        params=params, min_disp=float(cfg.min_disp),
        max_disp=float(cfg.max_disp), max_vdisp=float(cfg.max_vdisp),
        vol_pad=int(cfg.vol_pad), vol_scale=float(cfg.vol_scale),
        vol_zero=float(cfg.vol_zero), kind=str(cfg.kind),
        interp=int(cfg.interp))
    device = resolve_device(device)
    arrays = [np.asarray(getattr(data, k)) for k in
              ("guide", "gf_mean", "gf_inv", "coeff8")]
    vol = exi = None
    if new_cfg.kind == "naive":
        ep = int(cfg.exi_pad)
        exi = np.asarray(data.exi)[:, ep:ep + h, ep:ep + w]
    else:
        vol = np.asarray(data.vol)
    return _to_data(*arrays, vol, exi, device), new_cfg


def state_from_numpy(labeling_m, cost_m, device="cuda"):
    """(labeling_m [Hp, Wp, 4], cost_m [Hp, Wp]) padded state as float32
    tensors on ``device``."""
    device = resolve_device(device)
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
                  stat_windows, clamp_slabs: bool = True,
                  kernel: bool = False, vol_row_base: Optional[int] = None,
                  dshard: Optional[unary_volume.DShard] = None
                  ) -> torch.Tensor:
    """Filtered unary costs of ``proposals`` over their target windows
    (``CostVolumeEnergy.h:55-183`` / ``StereoEnergy.h:694-753``): raw cost
    on the filter window (target + R margin, R = ``windR // 2``), the
    filter (guided at radius R, bilateral at ``windR``), the target crop,
    and the validity clamp to ``COST_FOR_INVALID``.

    Args:
      mode: 0 = left view, 1 = right.
      ox, oy: [N] global coords of the regions' unit origins.
      target_off: target window offset from the unit origin (-s for shared
        windows, 0 for init-time unit windows); target_size: 3s or s.
      stat_windows: from :func:`dense_filter_windows` for the same regions
        (the filters read them); None where the fused kernel filters
        (:func:`kernel_filters`), which reads the statistics itself.
      clamp_slabs: naive kind with v = 0: where the other view's slab of
        each window starts (:func:`..ops.unary_warp.slab_origin`). True is
        the JAX package's init and warm start, False its sweeps. The two
        differ only where a plane leaves [0, max_disp] near the image's
        border.
      kernel: a sweep's color step, which samples by the fused kernel,
        :func:`..ops.unary_cuda.sample_windows`, where :func:`fused_unary`
        says so for the energy's device and the filter window (the JAX
        engine's ``vol_dma``); else the plain sampler of the energy's kind
        and ``interp``, as the JAX init always does.
      vol_row_base: the volume's array row of image row 0 (a height
        shard's; default ``cfg.vol_pad``).
      dshard: ``(d_base, d_owned, d_total)`` of a disparity shard: each
        rank samples the pixels it owns, and the partials of all ranks are
        merged (:func:`..parallel.collectives.merge_owned`) before the
        filter, into the unsharded raw cost bit for bit.
    Returns:
      [N, T, T] float32 costs (0 outside the image).
    """
    r = cfg.params.guided_radius
    fsize = target_size + 2 * r
    foff = target_off - r
    fox, foy = ox + foff, oy + foff
    fused = kernel and fused_unary(cfg, data.coeff8.device, fsize)
    in_kernel = fused and _guided(cfg)
    if stat_windows is None and cfg.params.filter_name and not in_kernel:
        raise ValueError(
            f"no fused unary route filters this call (the {cfg.kind} "
            f"energy, filter {cfg.params.filter_name!r}, interp "
            f"{cfg.interp}): pass its statistic windows")
    if fused:
        q = unary_cuda.sample_windows(
            data.vol[mode], cfg.vol_pad, proposals, fox, foy, fsize,
            cfg.height, cfg.width, min_disp=cfg.min_disp,
            th_col=cfg.params.th_col, scale=cfg.vol_scale, zero=cfg.vol_zero,
            stats=((data.guide[mode], data.gf_mean[mode], data.gf_inv[mode])
                   if in_kernel else None), pad=cfg.pad,
            r_gf=r if in_kernel else 0)
    elif cfg.kind == "volume":
        part = dict(row_base=vol_row_base, dshard=dshard,
                    min_disp=cfg.min_disp, th_col=cfg.params.th_col,
                    scale=cfg.vol_scale, zero=cfg.vol_zero)
        if cfg.interp == 1:
            q = unary_volume.sample_windows_aligned(
                data.vol[mode], cfg.vol_pad, proposals, fox, foy, fsize,
                cfg.height, cfg.width, **part)
        else:
            q = unary_volume.sample_windows(
                data.vol[mode], cfg.vol_pad, proposals, fox, foy, fsize,
                cfg.height, cfg.width, max_disp=cfg.max_disp,
                method=cfg.interp, **part)
        if dshard is not None:
            q = collectives.merge_owned(q)
    else:
        q = _warp_windows(data, cfg, mode, proposals, fox, foy, fsize,
                          clamp_slabs)
    if _guided(cfg) and not in_kernel:
        gwin, mwin, iwin, fmask = stat_windows
        q = guided.filter_windows(q, gwin, mwin, iwin, fmask, r)
    elif cfg.params.filter_name in ("BF", "BL"):
        # The raw 0..255 guide (GuidedFilter.h:329-374): the scaled guide
        # windows, scaled back.
        gwin, _, _, fmask = stat_windows
        q = bilateral.filter_windows(q, gwin * 255.0, fmask,
                                     cfg.params.windR,
                                     cfg.params.filter_param1)
    q = q[:, r:r + target_size, r:r + target_size]
    valid = validity.valid_windows(proposals, ox + target_off,
                                   oy + target_off, target_size,
                                   cfg.min_disp, cfg.max_disp)
    tmask = in_image_windows(cfg, ox, oy, target_off, target_size)
    q = torch.where(valid, q, COST_FOR_INVALID)
    return q * tmask


def _warp_windows(data: EnergyData, cfg: EnergyConfig, mode: int,
                  proposals, fox, foy, fsize: int, clamp_slabs: bool):
    """Raw V2 costs of the naive kind over F x F windows at (fox, foy): the
    slab sampler when every plane's v is 0 (``max_vdisp`` 0), else the
    bilinear gather."""
    sign = 1.0 if mode == 0 else -1.0
    warp = dict(sign=sign, th_col=cfg.params.th_col,
                th_grad=cfg.params.th_grad, alpha=cfg.params.alpha)
    exi_self, exi_other = data.exi[mode], data.exi[1 - mode]
    if cfg.max_vdisp != 0.0:
        return unary_warp.sample_windows(exi_self, exi_other, proposals,
                                         fox, foy, fsize, **warp)
    x0, ws = unary_warp.slab_origin(fox, fsize, cfg.width, cfg.max_disp,
                                    sign, clamp_slabs)
    return unary_warp.sample_windows_slab(exi_self, exi_other, proposals,
                                          fox, foy, fsize, x0, ws, **warp)


def pixel_unary(data: EnergyData, cfg: EnergyConfig, mode: int,
                labeling: torch.Tensor,
                window_budget: int = 1 << 16) -> torch.Tensor:
    """Unary of every pixel under its own label over a 1 x 1 target window
    (filter window 2R + 1): the warm start of ``initCurrentFast``
    (``FastGCStereo.h:117-130``; the JAX engine's ``_warmstart_chunk``).

    Every pixel is a region of a stride-1 grid. The statistic windows are
    cut in bands of image rows, at most ``window_budget`` windows a band;
    each value depends on its own window only, so the banding does not
    change it. The plain sampler runs on every unary route, as in the JAX
    engine (for the naive kind, the init's clamped slabs).

    Args:
      labeling: [H, W, 4] labels, on the energy's device.
    Returns:
      [H, W] float32 costs.
    """
    h, w = cfg.height, cfg.width
    dev = labeling.device
    rows = max(1, window_budget // w)
    xs = torch.arange(w, device=dev)
    out = torch.empty((h, w), dtype=torch.float32, device=dev)
    for y0 in range(0, h, rows):
        nr = min(rows, h - y0)
        ox = xs.repeat(nr)
        oy = torch.arange(y0, y0 + nr, device=dev).repeat_interleave(w)
        stats = dense_filter_windows(data, cfg, mode, ox, oy, 0, y0, nr, w,
                                     1, 0, 1)
        q = unary_windows(data, cfg, mode,
                          labeling[y0:y0 + nr].reshape(-1, 4).contiguous(),
                          ox, oy, 0, 1, stats)
        out[y0:y0 + nr] = q.reshape(nr, w)
    return out
