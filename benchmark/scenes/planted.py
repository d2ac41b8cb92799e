"""The ``adirondack_h`` inputs: a frozen numpy copy of the port's
``utils/synthetic.planted_problem`` (the JAX package's bench problem), with
the planted truth also given as plane labels.

A piecewise-slanted-plane disparity field made of six random planes, one
image of uniform noise that serves both views, and a cost volume with a
linear basin around the truth plus noise. The draws and their order are the
port's, so the arrays equal its generator's for one seed (a CPU test holds
them to it); the benchmark keeps its own copy so that a change to the port
cannot change the yardstick.
"""
from __future__ import annotations

import numpy as np


def planted_problem(h: int, w: int, nd: int, seed: int = 0):
    """Returns (image [h, w, 3] float32 0..255, volume [nd, h, w] float32,
    truth disparity [h, w] float32, truth labels [h, w, 4] float32).

    A label is the plane (a, b, c, 0) whose ``a x + b y + c`` gives the
    truth at the pixel; where the planted disparity was clipped into
    [0, nd - 1] (and on the zero background) it is the fronto-parallel
    plane (0, 0, d, 0) of the clipped value."""
    rng = np.random.default_rng(seed)

    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    d_true = np.zeros((h, w), np.float32)
    labels = np.zeros((h, w, 4), np.float32)
    for _ in range(6):
        cx, cy = rng.uniform(0, w), rng.uniform(0, h)
        a = rng.uniform(-0.05, 0.05)
        b = rng.uniform(-0.05, 0.05)
        c = rng.uniform(0.2, 0.8) * nd
        mask = (((xs - cx) ** 2 + (ys - cy) ** 2)
                < rng.uniform(0.1, 0.4) ** 2 * (h * w))
        plane = a * xs + b * ys + c
        clipped = np.clip(plane, 0, nd - 1)
        d_true = np.where(mask, clipped, d_true)
        sloped = mask & (clipped == plane)
        flat = mask & ~sloped
        labels[sloped] = np.array([a, b, c, 0.0], np.float32)
        labels[flat] = 0.0
        labels[flat, 2] = clipped[flat]
    dd = np.arange(nd, dtype=np.float32)[:, None, None]
    vol = np.minimum(np.abs(dd - d_true[None]) * 0.15, 1.0).astype(np.float32)
    vol += rng.random(vol.shape, np.float32) * 0.05

    img = (rng.random((h, w, 3)) * 255).astype(np.float32)
    return img, vol, d_true.astype(np.float32), labels


def make(config: dict, seed: int, index: int):
    """Pair ``index`` of a run with ``seed``: its numpy seed is drawn from
    both, so every pair of every run differs and one seed always gives
    the same pairs. Returns a dict of host arrays: ``im0`` (both views'
    image), ``vol`` [nd, h, w] and the truth's ``labels`` [h, w, 4]."""
    h, w, nd = config["height"], config["width"], config["ndisp"]
    sub = int(np.random.SeedSequence([seed % 2 ** 63, index])
              .generate_state(1)[0])
    img, vol, _, labels = planted_problem(h, w, nd, sub)
    return {"im0": img, "vol": vol, "labels": labels}
