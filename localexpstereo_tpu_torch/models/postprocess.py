"""Dual-view post-processing (reference ``PMStereoBase.h:111-256``;
counterpart of ``localexpstereo_tpu.models.postprocess.post_process``):
left-right consistency check, horizontal nearest-neighbour hole filling, and
the joint-bilateral weighted median of plane disparities at failed pixels.

Plain PyTorch on whichever device the labelings are on. The check and the
fill are elementwise and prefix scans; the weighted median sorts the
(2 windR + 1)^2 patch of each failed pixel only, in chunks of pixels.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..config import Parameters
from ..ops import plane as plane_ops

#: Failed pixels whose patches are sorted at once by the weighted median.
MEDIAN_CHUNK = 8192


def consistency_check(disp_l: torch.Tensor, disp_r: torch.Tensor,
                      threshold: float = 1.5):
    """Round-trip check (``PMStereoBase.h:111-144``): each view looks up
    the other at ``floor(x - sign * d + 0.5)`` (sign +1 for the left view,
    -1 for the right), in float32. Returns the two [H, W] uint8 fail maps:
    255 where the disparities differ by more than ``threshold``, 128 where
    the lookup leaves the image, else 0."""
    h, w = disp_l.shape
    xs = torch.arange(w, dtype=torch.float32,
                      device=disp_l.device).expand(h, w)

    def one(disp_a, disp_b, sign):
        # The clamp to [-1, w] keeps the integer conversion defined and
        # changes no inside/outside decision.
        rx = torch.clamp(torch.floor(xs - disp_a * sign + 0.5), -1.0,
                         float(w)).to(torch.int64)
        inside = (rx >= 0) & (rx < w)
        d_b = torch.gather(disp_b, 1, rx.clamp(0, w - 1))
        fail = torch.where(torch.abs(d_b - disp_a) > threshold, 255, 0)
        return torch.where(inside, fail, 128).to(torch.uint8)

    return one(disp_l, disp_r, 1.0), one(disp_r, disp_l, -1.0)


def _dilate3(fail: torch.Tensor) -> torch.Tensor:
    """3x3 binary dilation with a zero border (``cv::dilate`` with the
    default kernel); [H, W] bool -> bool."""
    f = fail.to(torch.float32)[None, None]
    return F.max_pool2d(f, 3, stride=1, padding=1)[0, 0] > 0


def fill_holes(labeling: torch.Tensor, fail: torch.Tensor,
               fail2: torch.Tensor) -> torch.Tensor:
    """Horizontal nearest-valid fill (``PMStereoBase.h:169-202``): each
    failed pixel takes the label of the nearest pixel to its left or right
    whose dilated mask ``fail2`` is clear, the side whose plane gives the
    lower disparity at the pixel (a background bias); a side that has no
    such pixel loses."""
    h, w = labeling.shape[:2]
    dev = labeling.device
    ok = ~fail2
    idx = torch.arange(w, device=dev).expand(h, w)
    left_idx = torch.cummax(torch.where(ok, idx, -1), dim=1).values
    right_idx = torch.flip(torch.cummin(
        torch.flip(torch.where(ok, idx, w), [1]), dim=1).values, [1])

    def grab(indices):
        safe = indices.clamp(0, w - 1)[..., None].expand(h, w, 4)
        return torch.gather(labeling, 1, safe)

    lab_l, lab_r = grab(left_idx), grab(right_idx)
    xs = idx.to(torch.float32)
    ys = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    d_l = plane_ops.disparity_at(lab_l, xs, ys)
    d_r = plane_ops.disparity_at(lab_r, xs, ys)
    has_l, has_r = left_idx >= 0, right_idx < w
    use_l = has_l & (~has_r | (d_l < d_r))
    use_r = has_r & ~use_l
    filled = torch.where(use_l[..., None], lab_l,
                         torch.where(use_r[..., None], lab_r, labeling))
    return torch.where(fail[..., None], filled, labeling)


def weighted_median_at(labeling: torch.Tensor, image_bgr: torch.Tensor,
                       fail: torch.Tensor, wind_r: int, omega: float,
                       chunk: int = MEDIAN_CHUNK) -> torch.Tensor:
    """Joint-bilateral weighted median of plane disparities at the failed
    pixels (``PMStereoBase.h:210-252``); returns the repaired labeling.

    Each failed pixel p sorts the disparities ``d_q(p)`` of the labels of
    its (2 wind_r + 1)^2 window, weighted by ``exp(-||I(p) - I(q)||_1 /
    omega)`` (``computePatchWeight``, ``StereoEnergy.h:250-256``), and takes
    the label at the first position whose cumulative weight exceeds half
    the total. Images smaller than the window read a block clamped into the
    image and mask the cells outside the centred window, as the JAX
    version does. The weights and their sums are float64, so the card and
    the CPU pick the same label (float32 sums round by their order, which
    differs between the two); the JAX version sums in float32, so a pick
    can differ from its only where the half-weight falls within a float32
    rounding of a cumulative sum.
    """
    h, w = labeling.shape[:2]
    dev = labeling.device
    ys, xs = torch.nonzero(fail, as_tuple=True)
    if ys.numel() == 0:
        return labeling
    k = 2 * wind_r + 1
    kh, kw = min(k, h), min(k, w)
    lab_flat = labeling.reshape(-1, 4)
    img_flat = image_bgr.to(torch.float32).reshape(-1, 3)
    iy = torch.arange(kh, device=dev)
    ix = torch.arange(kw, device=dev)
    outs = []
    for i in range(0, ys.numel(), chunk):
        y, x = ys[i:i + chunk, None, None], xs[i:i + chunk, None, None]
        gy = (y - wind_r).clamp(0, h - kh) + iy[None, :, None]
        gx = (x - wind_r).clamp(0, w - kw) + ix[None, None, :]
        centred = ((gy - y).abs() <= wind_r) & ((gx - x).abs() <= wind_r)
        flat = (gy * w + gx).reshape(gy.shape[0], -1)       # [n, kh*kw]
        lab = lab_flat[flat]                                # [n, K, 4]
        img = img_flat[flat]                                # [n, K, 3]
        centre = img_flat[(y * w + x).reshape(-1)][:, None]  # [n, 1, 3]
        diff = (img - centre).abs()
        l1 = (diff[..., 0] + diff[..., 1]) + diff[..., 2]
        wgt = torch.exp(-l1.to(torch.float64) / omega) \
            * centred.reshape(flat.shape)
        d = (lab[..., 0] * x.reshape(-1, 1).to(torch.float32)
             + lab[..., 1] * y.reshape(-1, 1).to(torch.float32)) \
            + lab[..., 2]
        order = torch.sort(d, dim=1, stable=True).indices
        csum = torch.cumsum(torch.gather(wgt, 1, order), dim=1)
        half = wgt.sum(dim=1, keepdim=True) / 2.0
        first = (csum > half).to(torch.uint8).argmax(dim=1, keepdim=True)
        pick = torch.gather(order, 1, first)
        outs.append(torch.gather(lab, 1, pick[..., None].expand(-1, 1, 4))
                    [:, 0])
    repaired = labeling.clone()
    repaired[ys, xs] = torch.cat(outs)
    return repaired


def post_process(lab_l: torch.Tensor, lab_r: torch.Tensor, im0_bgr,
                 im1_bgr, params: Parameters, threshold: float = 1.0):
    """The dual-view post-process (``PMStereoBase.h:146-256``) of the two
    unpadded [H, W, 4] labelings, on their device: consistency check, then
    per view the dilated mask, the hole fill and the weighted median at the
    failed pixels. ``im0_bgr`` / ``im1_bgr``: [H, W, 3] images (numpy or
    tensors). Returns the two repaired labelings."""
    dev = lab_l.device
    disp_l = plane_ops.disparity_map(lab_l)
    disp_r = plane_ops.disparity_map(lab_r)
    fail_l, fail_r = consistency_check(disp_l, disp_r, threshold)
    out = []
    for lab, fail_u8, im in ((lab_l, fail_l, im0_bgr),
                             (lab_r, fail_r, im1_bgr)):
        fail = fail_u8 > 0
        filled = fill_holes(lab, fail, _dilate3(fail))
        image = (im if isinstance(im, torch.Tensor)
                 else torch.from_numpy(np.asarray(im, np.float32)))
        out.append(weighted_median_at(filled, image.to(dev), fail,
                                      params.windR,
                                      params.omega))
    return out[0], out[1]
