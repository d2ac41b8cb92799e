"""V2 (image-based) data term: the plane-induced warp matching cost
(``NaiveStereoEnergy``, ``StereoEnergy.h:629-764``; counterpart of
``localexpstereo_tpu.ops.unary_warp``).

The reference warps the other view's 4-channel feature image by the affine
map a plane induces (``warpAffine``, INTER_LINEAR, BORDER_REPLICATE). The
plane's disparity is affine in (x, y), so that warp is a bilinear sample of
the other view at ``(x - sign * d(x, y), y + v)`` for each pixel.

Raw cost (``StereoEnergy.h:730-741``):
    min(tau_col, ||dBGR||_1) + min(tau_grad, |d gx|)
with tau_col = th_col * (1 - alpha), tau_grad = th_grad * alpha, and the
feature image ExI = [BGR * (1 - alpha), sobel_x(gray) * 0.5 * alpha]
(``StereoEnergy.h:647-664``; Sobel ksize=1, scale 0.5, replicate border).

Two samplers, with the JAX package's semantics:

- :func:`sample_windows_slab`, for v = 0 (every plane's v when the
  solver's ``max_vdisp`` is 0). The JAX package reads the other view from
  a slab of columns per window, wide enough for every disparity in [0,
  max_disp], and contracts it with tent weights ``max(0, 1 - |col -
  src_x|)``, ``src_x`` clipped to the image. A source column outside the
  slab weighs nothing, so where a plane leaves the disparity range the
  cost differs from a plain bilinear warp. The tent has at most two
  non-zero taps, so the port gathers those two, each weighing nothing
  outside the slab: the same sum without the slab. Where the slab starts
  is the caller's (:func:`slab_origin`).
- :func:`sample_windows`, for any v: the bilinear gather with the border
  replicated in x and y.

Both return the raw cost, 0 outside the image, in float32.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def build_feature_image(image_bgr, alpha: float):
    """The 4-channel feature image ExI: a numpy array for a numpy image,
    a tensor on the image's device for a tensor (the same float32
    operations).

    Args:
      image_bgr: [H, W, 3] float32 BGR 0..255 (OpenCV's channel order, so
        the grayscale weights match the reference's cvtColor BGR2GRAY).
    Returns:
      [H, W, 4] float32: BGR * (1 - alpha), then gx * alpha.
    """
    if not isinstance(image_bgr, torch.Tensor):
        return build_feature_image(
            torch.from_numpy(np.asarray(image_bgr, np.float32)), alpha).numpy()
    img = image_bgr.to(torch.float32)
    gray = 0.114 * img[..., 0] + 0.587 * img[..., 1] + 0.299 * img[..., 2]
    padded = torch.cat([gray[:, :1], gray, gray[:, -1:]], dim=1)
    gx = 0.5 * (padded[:, 2:] - padded[:, :-2])
    return torch.cat([img * (1.0 - alpha), (gx * alpha)[..., None]], dim=-1)


def slab_origin(fox: torch.Tensor, size: int, width: int, max_disp: float,
                sign: float, clamped: bool):
    """First column [N] and width of each F x F window's other-view slab,
    as the JAX package cuts them: ``F + m`` columns, ``m = ceil(max_disp)
    + 1``, starting ``m`` columns left of the window for the left view
    (sign > 0), at the window for the right view.

    ``clamped`` selects the JAX package's init and warm-start form
    (``sample_windows_slab``): the window is first clamped into the image
    and the slab then into ``[0, width)``. Otherwise the slab starts at
    the window's own origin, reaching past the image (the sweeps' aligned
    slabs of the zero-padded feature images, ``dense_exi_slabs``)."""
    m = int(math.ceil(max_disp)) + 1
    ws = size + m
    back = m if sign > 0 else 0
    if not clamped:
        return fox - back, ws
    if ws > width:
        raise ValueError(f"image narrower than window + disparity range: "
                         f"{size} + {m} > {width}")
    ocx = torch.clamp(fox, 0, width - size)
    return torch.clamp(ocx - back, 0, width - ws), ws


def _grid(fox, foy, size):
    it = torch.arange(size, dtype=torch.float32, device=fox.device)
    xs = fox.to(torch.float32)[:, None, None] + it[None, None, :]
    ys = foy.to(torch.float32)[:, None, None] + it[None, :, None]
    return xs, ys


def _gather(exi: torch.Tensor, iy: torch.Tensor, ix: torch.Tensor):
    """exi [H, W, 4] at integer coordinates (in the image) -> [..., 4]."""
    w = exi.shape[1]
    return exi.reshape(-1, 4)[iy * w + ix]


def _cost(f_self, f_other, xs, ys, height, width, th_col, th_grad, alpha):
    diff = torch.abs(f_self - f_other)
    cost = (torch.clamp(diff[..., 0] + diff[..., 1] + diff[..., 2],
                        max=th_col * (1.0 - alpha))
            + torch.clamp(diff[..., 3], max=th_grad * alpha))
    in_image = (xs >= 0) & (xs < width) & (ys >= 0) & (ys < height)
    return torch.where(in_image, cost, 0.0)


def _self_windows(exi_self, xs, ys):
    h, w = exi_self.shape[:2]
    iy = torch.clamp(ys.to(torch.int64), 0, h - 1)
    ix = torch.clamp(xs.to(torch.int64), 0, w - 1)
    return _gather(exi_self, iy, ix), iy


def sample_windows_slab(exi_self: torch.Tensor, exi_other: torch.Tensor,
                        proposals: torch.Tensor, fox: torch.Tensor,
                        foy: torch.Tensor, size: int, slab_x0: torch.Tensor,
                        slab_width: int, *, sign: float, th_col: float,
                        th_grad: float, alpha: float) -> torch.Tensor:
    """Raw V2 costs with v = 0 over F x F windows, the other view read
    through each window's slab of columns ``[slab_x0, slab_x0 +
    slab_width)`` (from :func:`slab_origin`).

    Args:
      exi_self, exi_other: [H, W, 4] feature images of the view solved and
        of the other one.
      proposals: [N, 4] planes (their v is not read); fox, foy: [N] window
        origins (may lie outside the image).
      sign: +1 when solving the left view, -1 for the right
        (``StereoEnergy.h:705``).
    Returns:
      [N, F, F] float32 costs, 0 outside the image.
    """
    h, w = exi_self.shape[:2]
    xs, ys = _grid(fox, foy, size)
    a = proposals[:, 0][:, None, None]
    b = proposals[:, 1][:, None, None]
    c = proposals[:, 2][:, None, None]
    d = a * xs + b * ys + c
    src_x = torch.clamp(xs - sign * d, 0.0, float(w - 1))
    k = torch.floor(src_x)
    lo = slab_x0.to(torch.float32)[:, None, None]
    hi = torch.clamp(lo + float(slab_width), max=float(w))
    taps = []
    for col in (k, k + 1.0):
        wt = torch.clamp(1.0 - torch.abs(col - src_x), min=0.0)
        wt = torch.where((col >= lo) & (col < hi), wt, 0.0)
        ix = torch.clamp(col.to(torch.int64), 0, w - 1)
        taps.append((wt, ix))
    f_self, iy = _self_windows(exi_self, xs, ys)
    (w0, x0), (w1, x1) = taps
    f_other = (_gather(exi_other, iy, x0) * w0[..., None]
               + _gather(exi_other, iy, x1) * w1[..., None])
    return _cost(f_self, f_other, xs, ys, h, w, th_col, th_grad, alpha)


def sample_windows(exi_self: torch.Tensor, exi_other: torch.Tensor,
                   proposals: torch.Tensor, fox: torch.Tensor,
                   foy: torch.Tensor, size: int, *, sign: float,
                   th_col: float, th_grad: float,
                   alpha: float) -> torch.Tensor:
    """Raw V2 costs over F x F windows for planes with any v: the other
    view sampled bilinearly at ``(x - sign * d, y + v)``, its border
    replicated (``warpAffine`` BORDER_REPLICATE). Arguments as in
    :func:`sample_windows_slab`; the proposals' v is read."""
    h, w = exi_self.shape[:2]
    xs, ys = _grid(fox, foy, size)
    a = proposals[:, 0][:, None, None]
    b = proposals[:, 1][:, None, None]
    c = proposals[:, 2][:, None, None]
    v = proposals[:, 3][:, None, None]
    d = a * xs + b * ys + c
    src_x = xs - sign * d
    src_y = ys + v
    x0f = torch.floor(src_x)
    y0f = torch.floor(src_y)
    wx = (src_x - x0f)[..., None]
    wy = (src_y - y0f)[..., None]
    # float -> int64 of a finite value, then into the image: out-of-range
    # and non-finite sources read the border, as the JAX gather's clamp.
    x0, y0 = x0f.to(torch.int64), y0f.to(torch.int64)
    x1 = torch.clamp(x0 + 1, 0, w - 1)
    y1 = torch.clamp(y0 + 1, 0, h - 1)
    x0 = torch.clamp(x0, 0, w - 1)
    y0 = torch.clamp(y0, 0, h - 1)
    f_self, _ = _self_windows(exi_self, xs, ys)
    f_other = ((1 - wy) * ((1 - wx) * _gather(exi_other, y0, x0)
                           + wx * _gather(exi_other, y0, x1))
               + wy * ((1 - wx) * _gather(exi_other, y1, x0)
                       + wx * _gather(exi_other, y1, x1)))
    return _cost(f_self, f_other, xs, ys, h, w, th_col, th_grad, alpha)
