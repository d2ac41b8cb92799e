"""Cost-volume data term: plane-indexed sampling of a [D, Hv, Wv] volume
(``CostVolumeEnergy::ComputeUnaryPotentialWithoutCheck``,
``CostVolumeEnergy.h:55-183``).

:func:`sample_windows_aligned` is the linear interpolation of the engine
(method 1). :func:`sample_windows` is the gather of
``localexpstereo_tpu.ops.unary_volume.sample_windows`` with its three
methods (``CostVolumeEnergy.h:45-48``): 0 nearest, 1 linear, 2 the
Lagrange quadratic through three taps; the engine routes methods 0 and 2
through it.

Both read a whole padded volume, or one rank's part of it:

- ``row_base``: the array row of image row 0, ``vol_pad`` by default; a
  height shard (:mod:`..parallel.volume`) holds a band of rows, and its
  row base is its own.
- ``dshard``: ``(d_base, d_owned, d_total)``, the volume a disparity
  shard (:mod:`..parallel.dvolume`): ``vol`` holds global planes
  ``[d_base - 1, d_base + d_owned + 1)`` (zero beyond the volume's ends).
  Every output pixel has one owner, the rank holding its primary tap
  (the tap plane the index arithmetic clamps into ``[0, d_total)``, so
  the out-of-range and non-finite planes go to the first and last rank);
  the owner computes the pixel's finished cost with the unsharded
  sampler's operations, in its order, from its local planes, and every
  other rank gives 0. The partials of all ranks merged
  (:func:`..parallel.collectives.merge_owned`) equal the unsharded
  sampler bit for bit.

Semantics of ``localexpstereo_tpu.ops.unary_volume.sample_slabs_aligned``:
the JAX package contracts each window's [D, F, F] slab with the tent
``max(0, 1 - |g - dv|)``, ``dv = clip(d - min_disp, 0, D-1)``. The tent has
at most two non-zero taps, ``floor(dv)`` and ``floor(dv) + 1``, so the port
gathers those two taps straight from the padded volume with the same tent
weights: the same sum (adding the zero taps is exact) without the slab.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..config import COST_FOR_INVALID

#: A disparity shard's (first owned plane, owned planes, planes of the
#: whole volume).
DShard = Tuple[int, int, int]


def sample_windows_aligned(vol: torch.Tensor, vol_pad: int,
                           proposals: torch.Tensor, fox: torch.Tensor,
                           foy: torch.Tensor, size: int, height: int,
                           width: int, *, min_disp: float, th_col: float,
                           scale: float = 1.0, zero: float = 0.0,
                           row_base: Optional[int] = None,
                           dshard: Optional[DShard] = None) -> torch.Tensor:
    """Raw matching cost of each proposal over its F x F window.

    Args:
      vol: [D, Hv, Wv] volume (float32, bfloat16 or uint8; widened to
        float32 exactly before the tent sum), spatially zero-padded by
        ``vol_pad``: image pixel (x, y) is ``vol[:, y + vol_pad, x + vol_pad]``.
      proposals: [N, 4]; fox, foy: [N] global window origins (may be < 0).
      scale, zero: uint8 decode ``q * scale + zero``, applied after the
        contraction (exact, the tent weights sum to 1).
      row_base, dshard: a shard's geometry (module docstring).
    Returns:
      [N, F, F] float32 costs truncated at ``th_col``, 0 outside the image
      (with ``dshard``, also 0 at the pixels another rank owns).
    """
    _, hv, wv = vol.shape
    d_ = vol.shape[0] if dshard is None else dshard[2]
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

    iy = torch.clamp(foy.to(torch.int64)[:, None, None]
                     + (vol_pad if row_base is None else row_base)
                     + torch.arange(size, device=dev)[None, :, None],
                     0, hv - 1)
    ix = torch.clamp(fox.to(torch.int64)[:, None, None] + vol_pad
                     + torch.arange(size, device=dev)[None, None, :],
                     0, wv - 1)
    pix = iy * wv + ix                                    # [N, F, F]
    tap = _tap_reader(vol, pix, dshard)
    v_lo = tap(ilo)
    v_hi = tap(ihi)
    cost = (v_lo * w_lo + v_hi * w_hi) * scale + zero
    cost = torch.where(finite, cost, COST_FOR_INVALID)
    cost = torch.clamp(cost, max=th_col)
    in_image = (xs >= 0) & (xs < width) & (ys >= 0) & (ys < height)
    return torch.where(_owned(in_image, ilo, dshard), cost, 0.0)


def _tap_reader(vol: torch.Tensor, pix: torch.Tensor,
                dshard: Optional[DShard]):
    """``tap(g)``: float32 values of global planes ``g`` ([N, F, F] int64)
    at ``pix``; on a disparity shard from its local planes, the index
    clamped into them (a pixel of another owner reads any local plane)."""
    flat = vol.reshape(-1)
    plane = vol.shape[1] * vol.shape[2]
    if dshard is None:
        return lambda g: flat[g * plane + pix].to(torch.float32)
    first = dshard[0] - 1
    top = vol.shape[0] - 1
    return lambda g: flat[torch.clamp(g - first, 0, top) * plane
                          + pix].to(torch.float32)


def _owned(mask: torch.Tensor, primary: torch.Tensor,
           dshard: Optional[DShard]) -> torch.Tensor:
    """``mask``, on a disparity shard also limited to the pixels whose
    primary tap plane it owns."""
    if dshard is None:
        return mask
    d_base, d_owned, _ = dshard
    return mask & (primary >= d_base) & (primary < d_base + d_owned)


def sample_windows(vol: torch.Tensor, vol_pad: int, proposals: torch.Tensor,
                   fox: torch.Tensor, foy: torch.Tensor, size: int,
                   height: int, width: int, *, min_disp: float,
                   max_disp: float, th_col: float, method: int,
                   scale: float = 1.0, zero: float = 0.0,
                   row_base: Optional[int] = None,
                   dshard: Optional[DShard] = None) -> torch.Tensor:
    """Raw matching cost of each proposal over its F x F window by
    d-interpolation ``method`` (``CostVolumeEnergy.h:69-118``; the JAX
    package's full-volume gather, each tap decoded before it is
    interpolated).

    The edge branches are the JAX package's: method 0 clamps the nearest
    index into the volume; method 1 takes the first plane below
    ``min_disp``, the last at or above ``max_disp`` and
    ``COST_FOR_INVALID`` where a tap leaves the volume; method 2 takes the
    first / last plane where the nearest index leaves the volume, and its
    degenerate abscissae at the volume's ends give inf or NaN, as in the
    reference. Every method gives ``COST_FOR_INVALID`` where d is not
    finite.

    Args: as :func:`sample_windows_aligned`, and ``max_disp`` (method 1's
      upper branch) and ``method`` (0, 1 or 2).
    Returns:
      [N, F, F] float32 costs truncated at ``th_col``, 0 outside the image
      (with ``dshard``, also 0 at the pixels another rank owns).
    """
    if method not in (0, 1, 2):
        raise ValueError(f"unknown interpolation method {method}")
    _, hv, wv = vol.shape
    d_ = vol.shape[0] if dshard is None else dshard[2]
    row0 = vol_pad if row_base is None else row_base
    dev = proposals.device
    it = torch.arange(size, device=dev)
    ys = foy.to(torch.int64)[:, None, None] + it[None, :, None]
    xs = fox.to(torch.int64)[:, None, None] + it[None, None, :]
    in_image = (xs >= 0) & (xs < width) & (ys >= 0) & (ys < height)
    pix = (torch.clamp(torch.clamp(ys, 0, height - 1) + row0, 0, hv - 1) * wv
           + torch.clamp(xs, 0, width - 1) + vol_pad)      # [N, F, F]
    a = proposals[:, 0][:, None, None]
    b = proposals[:, 1][:, None, None]
    c = proposals[:, 2][:, None, None]
    d = a * xs.to(torch.float32) + b * ys.to(torch.float32) + c
    finite = torch.isfinite(d)
    # Index arithmetic on a finite stand-in (0 where d is not finite, whose
    # cost the last branch replaces), clamped in float before the integer
    # conversion, which is what the JAX package's saturating one gives.
    d_safe = torch.where(finite, d, 0.0)
    d0_off = float(int(-min_disp))             # CostVolumeEnergy.h:68
    read = _tap_reader(vol, pix, dshard)
    decode = scale != 1.0 or zero != 0.0

    def tap(dslice: torch.Tensor) -> torch.Tensor:
        v = read(dslice.to(torch.int64))
        return v * scale + zero if decode else v

    def index(x: torch.Tensor) -> torch.Tensor:
        return torch.clamp(x, 0.0, float(d_ - 1))

    first = torch.zeros_like(pix)
    last = torch.full_like(pix, d_ - 1)
    if method == 0:
        primary = index(torch.floor(d_safe + 0.5) + d0_off)
        cost = tap(primary)
    elif method == 1:
        df = torch.floor(d_safe)
        dd0 = df + d0_off
        primary = torch.where(d_safe < min_disp, 0.0,
                              torch.where(d_safe >= max_disp, float(d_ - 1),
                                          index(dd0)))
        f1 = d - df
        lin = (1.0 - f1) * tap(index(dd0)) + f1 * tap(index(dd0 + 1.0))
        lin = torch.where((dd0 < 0) | (dd0 + 1.0 >= d_), COST_FOR_INVALID,
                          lin)
        cost = torch.where(d < min_disp, tap(first),
                           torch.where(d >= max_disp, tap(last), lin))
    else:
        nearest = torch.floor(d_safe + 0.5) + d0_off
        di = primary = index(nearest)
        d1i = torch.clamp(di - 1.0, min=0.0)
        d3i = torch.clamp(di + 1.0, max=float(d_ - 1))
        y1, y2, y3 = tap(d1i), tap(di), tap(d3i)
        rd1, rd2, rd3 = d1i, di, d3i
        qa = y1 / (rd1 - rd2) / (rd1 - rd3)
        qb = y2 / (rd2 - rd1) / (rd2 - rd3)
        qc = y3 / (rd3 - rd1) / (rd3 - rd2)
        r = qa + qb + qc
        p = -(qa * (rd2 + rd3) + qb * (rd1 + rd3) + qc * (rd1 + rd2))
        q = qa * rd2 * rd3 + qb * rd1 * rd3 + qc * rd1 * rd2
        dv = d + d0_off
        quad = r * dv * dv + p * dv + q
        cost = torch.where(nearest < 0, tap(first),
                           torch.where(nearest >= d_, tap(last), quad))
    cost = torch.where(finite, cost, COST_FOR_INVALID)
    cost = torch.minimum(cost, torch.tensor(th_col, dtype=torch.float32,
                                            device=dev))
    return torch.where(_owned(in_image, primary.to(torch.int64), dshard),
                       cost, 0.0)
