"""The ``video_h`` inputs: a frozen numpy copy of the port's
``utils/synthetic.v2_scene``, with the planted truth also given as plane
labels, and the pan that the stream's frames are cut from.

The left view's disparity is a background plane with four nearer slanted
planes in front of it (ellipses); the left image is blurred noise; the
right view is rendered from the planes with a depth test, so it has real
occlusions. The draws and their order are the port's, so the arrays equal
its generator's for one seed (a CPU test holds them to it).
"""
from __future__ import annotations

import numpy as np


def v2_scene(h: int, w: int, ndisp: int, seed: int = 0):
    """Returns (imL, imR [h, w, 3] uint8 BGR, disparity [h, w] float32 of
    the left view, nonocc [h, w] bool, labels [h, w, 4] float32).

    A label is the plane (a, b, c, 0) of the pixel's region, or where the
    disparity was clipped into [2, ndisp - 3] the fronto-parallel plane of
    the clipped value."""
    rng = np.random.default_rng(seed)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    lo, hi = 2.0, ndisp - 3.0
    planes = [(rng.uniform(-0.02, 0.02), rng.uniform(-0.02, 0.02), 0.0)]
    planes[0] = planes[0][:2] + (lo + 0.2 * (hi - lo)
                                 - planes[0][0] * w / 2
                                 - planes[0][1] * h / 2,)
    label = np.zeros((h, w), np.int64)
    for i in range(1, 5):
        cx, cy = rng.uniform(0.15, 0.85) * w, rng.uniform(0.15, 0.85) * h
        rx, ry = rng.uniform(0.1, 0.25) * w, rng.uniform(0.1, 0.25) * h
        a, b = rng.uniform(-0.08, 0.08), rng.uniform(-0.08, 0.08)
        dc = lo + (0.35 + 0.15 * i) * (hi - lo)
        planes.append((a, b, dc - a * cx - b * cy))
        label[((xs - cx) / rx) ** 2 + ((ys - cy) / ry) ** 2 < 1.0] = i
    planes = np.asarray(planes)
    disp_of = [pl[0] * xs + pl[1] * ys + pl[2] for pl in planes]
    raw = np.choose(label, disp_of)
    disp = np.clip(raw, lo, hi)

    def texture(shape):
        t = rng.random(shape)
        for _ in range(2):
            t = (t + np.roll(t, 1, 0) + np.roll(t, 1, 1)
                 + np.roll(t, (1, 1), (0, 1))) / 4.0
        return 30.0 + 195.0 * (t - t.min()) / (t.max() - t.min())

    left = texture((h, w, 3))
    best = np.full((h, w), -np.inf)
    src = np.zeros((h, w))
    for i, (a, b, c) in enumerate(planes):
        # x - (a x + b y + c) = xr, the left pixel of plane i seen at xr.
        x = (xs + b * ys + c) / (1.0 - a)
        d = np.clip(a * x + b * ys + c, lo, hi)
        xi = np.rint(x).astype(np.int64)
        inside = (x >= 0) & (x <= w - 1)
        own = inside & (label[ys.astype(np.int64), np.clip(xi, 0, w - 1)]
                        == i)
        near = own & (d > best)
        best = np.where(near, d, best)
        src = np.where(near, x, src)
    seen = np.isfinite(best)
    x0 = np.clip(np.floor(src).astype(np.int64), 0, w - 1)
    x1 = np.clip(x0 + 1, 0, w - 1)
    fx = (src - np.floor(src))[..., None]
    yi = ys.astype(np.int64)
    right = (1 - fx) * left[yi, x0] + fx * left[yi, x1]
    right = np.where(seen[..., None], right, texture((h, w, 3)))

    xr = np.rint(xs - disp).astype(np.int64)
    in_view = (xr >= 0) & (xr <= w - 1)
    front = best[yi, np.clip(xr, 0, w - 1)]
    nonocc = in_view & (disp >= front - 0.5)
    left, right = (np.clip(np.rint(im), 0, 255).astype(np.uint8)
                   for im in (left, right))
    labels = np.zeros((h, w, 4), np.float32)
    labels[..., :3] = planes[label]
    flat = disp != raw
    labels[flat, :2] = 0.0
    labels[flat, 2] = disp[flat]
    return left, right, disp.astype(np.float32), nonocc, labels


def make(config: dict, seed: int, index: int, pan_positions: int,
         pan_step: int):
    """Stream ``index``'s scene of a run with ``seed``, wide enough for
    ``pan_positions`` frame positions ``pan_step`` px apart. Returns a dict
    of host arrays: ``im0``, ``im1`` [h, w + pan, 3] uint8 and the truth's
    ``labels`` of the whole scene; :func:`frame_labels` cuts a frame's
    labels out of it."""
    h, w, nd = config["height"], config["width"], config["ndisp"]
    sub = int(np.random.SeedSequence([seed % 2 ** 63, index])
              .generate_state(1)[0])
    wide = w + pan_step * (pan_positions - 1)
    left, right, _, _, labels = v2_scene(h, wide, nd, sub)
    return {"im0": left, "im1": right, "labels": labels}


def frame_labels(labels: np.ndarray, x0: int, w: int) -> np.ndarray:
    """The labels of the frame whose column 0 is the scene's column
    ``x0``, in the frame's own coordinates (c moves by a x0)."""
    out = np.ascontiguousarray(labels[:, x0:x0 + w]).copy()
    out[..., 2] += out[..., 0] * np.float32(x0)
    return out
