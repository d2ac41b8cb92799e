"""Synthetic V3 stereo problem with a planted disparity truth.

A numpy copy of the benchmark problem of the JAX package (``bench.py``'s
``build_problem``): a piecewise-slanted-plane disparity field made of a few
random planes, and a cost volume with a linear basin around the truth plus
noise. At scale 1.0 it is 1436 x 992 with 145 disparities, half the
Middlebury V3 full resolution.

:func:`fused_move_problem` makes random inputs of one fused expansion move,
for holding the kernel against its plain version.
"""
from __future__ import annotations

import numpy as np


def build_problem(scale: float, seed: int = 0):
    """Returns (image [h, w, 3] float32 0..255, volume [nd, h, w] float32,
    h, w, nd, truth [h, w] float32)."""
    h = max(int(992 * scale), 64)
    w = max(int(1436 * scale), 96)
    nd = max(int(145 * scale), 16)
    rng = np.random.default_rng(seed)

    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    d_true = np.zeros((h, w), np.float32)
    for _ in range(6):
        cx, cy = rng.uniform(0, w), rng.uniform(0, h)
        a = rng.uniform(-0.05, 0.05)
        b = rng.uniform(-0.05, 0.05)
        c = rng.uniform(0.2, 0.8) * nd
        mask = (((xs - cx) ** 2 + (ys - cy) ** 2)
                < rng.uniform(0.1, 0.4) ** 2 * (h * w))
        d_true = np.where(mask, np.clip(a * xs + b * ys + c, 0, nd - 1),
                          d_true)
    dd = np.arange(nd, dtype=np.float32)[:, None, None]
    vol = np.minimum(np.abs(dd - d_true[None]) * 0.15, 1.0).astype(np.float32)
    vol += rng.random(vol.shape, np.float32) * 0.05

    img = (rng.random((h, w, 3)) * 255).astype(np.float32)
    return img, vol, h, w, nd, d_true.astype(np.float32)


def fused_move_problem(rng: np.random.Generator, n: int, s: int,
                       lam: float = 0.7, tau: float = 1.0):
    """Random but realistic inputs of one fused expansion move over ``n``
    regions of ``s`` x ``s`` pixels (the recipe of the JAX package's
    fused-kernel tests). Returns ([halo, props, tox, toy, coeff8, ccost,
    pcost] as float32 numpy arrays, lam, tau)."""
    halo = rng.normal(size=(n, s + 2, s + 2, 4)).astype(np.float32)
    halo[..., 0:2] *= 0.1
    halo[..., 2] = rng.uniform(0, 8, (n, s + 2, s + 2))
    halo[..., 3] = 0.0
    props = np.stack([rng.uniform(-0.1, 0.1, n), rng.uniform(-0.1, 0.1, n),
                      rng.uniform(0, 8, n), np.zeros(n)],
                     -1).astype(np.float32)
    coeff8 = rng.uniform(0.01, 1.0, (n, 8, s, s)).astype(np.float32)
    ccost = rng.uniform(0, 2, (n, s, s)).astype(np.float32)
    pcost = rng.uniform(0, 2, (n, s, s)).astype(np.float32)
    tox = rng.integers(-3, 10, n).astype(np.float32)
    toy = rng.integers(-3, 10, n).astype(np.float32)
    return [halo, props, tox, toy, coeff8, ccost, pcost], lam, tau
