"""Synthetic stereo problems with a planted disparity truth.

A numpy copy of the benchmark problem of the JAX package (``bench.py``'s
``build_problem``): a piecewise-slanted-plane disparity field made of a few
random planes, and a cost volume with a linear basin around the truth plus
noise. At scale 1.0 it is 1436 x 992 with 145 disparities, half the
Middlebury V3 full resolution.

:func:`v2_scene` is a V2 (image-based) scene: a textured left view and a
right view rendered from planted slanted planes with a depth test, so it
has real occlusions; :func:`write_v2_scene` writes it as a Middlebury V2
directory (``imL/imR.png``, ``groundtruth.png``, ``nonocc.png``,
``info.txt``), at the cones size (450 x 375, 60 disparities) by default.

:func:`fused_move_problem` and :func:`fusion_move_problem` make random
inputs of one fused expansion move and of one fusion move, for holding the
kernels against their plain versions; :func:`bench_solver` and
:func:`unary_windows` the solver of that problem and the main path's unary
windows, for driving and timing the port on the card.
"""
from __future__ import annotations

import numpy as np


def problem_shape(scale: float):
    """(h, w, nd) of :func:`build_problem` at ``scale``, without building
    it."""
    return (max(int(992 * scale), 64), max(int(1436 * scale), 96),
            max(int(145 * scale), 16))


def build_problem(scale: float, seed: int = 0):
    """Returns (image [h, w, 3] float32 0..255, volume [nd, h, w] float32,
    h, w, nd, truth [h, w] float32)."""
    return planted_problem(*problem_shape(scale), seed)


def pan_frames(h: int, w: int, nd: int, frames: int, step: int = 2,
               seed: int = 0):
    """A camera pan over :func:`planted_problem`: frame k is the columns
    [step k, step k + w) of the problem ``step * (frames - 1)`` columns
    wider. Returns [(image, volume, truth), ...] as contiguous arrays."""
    img, vol, _, _, _, truth = planted_problem(h, w + step * (frames - 1),
                                               nd, seed)
    cols = [slice(step * k, step * k + w) for k in range(frames)]
    return [(np.ascontiguousarray(img[:, c]),
             np.ascontiguousarray(vol[:, :, c]),
             np.ascontiguousarray(truth[:, c])) for c in cols]


def planted_problem(h: int, w: int, nd: int, seed: int = 0):
    """:func:`build_problem` at a given size: (image, volume, h, w, nd,
    truth)."""
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


def fusion_move_problem(rng: np.random.Generator, n: int, s: int,
                        lam: float = 0.5, tau: float = 1.0):
    """Inputs of one fusion move over ``n`` regions of ``s`` x ``s``
    pixels: two labelings near a planted plane per region (each pixel's
    disparity offset by independent noise, more of it in one labeling than
    the other in random halves of the window), unaries that grow with the
    offset, and random pairwise weights. Returns ([halo0, halo1, tox, toy,
    coeff8, ccost, pcost] as float32 numpy arrays, lam, tau); the halos
    are [n, s+2, s+2, 4]."""
    hs = s + 2
    tox = rng.integers(0, 400, n).astype(np.float32)
    toy = rng.integers(0, 400, n).astype(np.float32)
    a = rng.uniform(-0.05, 0.05, n)[:, None, None]
    b = rng.uniform(-0.05, 0.05, n)[:, None, None]
    c = rng.uniform(10, 100, n)[:, None, None]
    ys, xs = np.mgrid[0:hs, 0:hs].astype(np.float64)
    gx = tox[:, None, None] - 1.0 + xs
    gy = toy[:, None, None] - 1.0 + ys
    truth = a * gx + b * gy + c
    left = xs[None] < rng.integers(1, hs, n)[:, None, None]
    halos, costs = [], []
    for scale in ((0.2, 1.5), (1.5, 0.2)):
        off = rng.normal(0.0, 1.0, (n, hs, hs)) * np.where(left, *scale)
        lab = np.zeros((n, hs, hs, 4), np.float32)
        lab[..., 0] = a + rng.normal(0.0, 0.005, (n, hs, hs))
        lab[..., 1] = b + rng.normal(0.0, 0.005, (n, hs, hs))
        lab[..., 2] = (truth + off - lab[..., 0] * gx - lab[..., 1] * gy)
        halos.append(lab)
        costs.append((np.minimum(np.abs(off[:, 1:-1, 1:-1]), 3.0) * 0.3
                      + rng.uniform(0.0, 0.1, (n, s, s))).astype(np.float32))
    coeff8 = rng.uniform(0.01, 1.0, (n, 8, s, s)).astype(np.float32)
    return [halos[0], halos[1], tox, toy, coeff8, costs[0], costs[1]], lam, tau


def unary_window_problem(rng: np.random.Generator, n: int, f: int, d: int,
                         h: int, w: int, pad: int, dtype: str = "float32"):
    """Random inputs of one call of the fused unary sampler
    (``ops/unary_cuda.sample_windows``) over ``n`` windows of ``f`` x ``f``
    pixels of an ``h`` x ``w`` image with ``d`` disparities (the recipe of
    the JAX package's tests of its fused kernel). Arrays are padded by
    ``pad`` on every side: the volume [d, h+2pad, w+2pad], uint8-quantized
    over [0, 2 th_col] or float32, and well-conditioned guide statistics
    (guide [.., 3], mean [.., 3], inverse covariance [.., 6]), zero outside
    the image. Proposal 0 leaves the disparity range and proposal 1 is not
    finite. Returns (vol, props [n, 4], fox [n], foy [n] int32 window
    origins, (guide, mean, inv), scale, th_col) as numpy arrays."""
    volf = rng.random((d, h + 2 * pad, w + 2 * pad), np.float32)
    if dtype == "uint8":
        th_col = 0.5
        scale = 2.0 * th_col / 255.0
        vol = np.clip(np.rint(volf / scale), 0, 255).astype(np.uint8)
    else:
        th_col, scale, vol = 0.8, 1.0, volf
    props = np.stack([rng.uniform(-0.3, 0.3, n), rng.uniform(-0.3, 0.3, n),
                      rng.uniform(0, d - 1, n), np.zeros(n)],
                     -1).astype(np.float32)
    props[0, 2] = d + 5.0
    props[1, 2] = np.inf
    fox = rng.integers(-4, w - 2, n).astype(np.int32)
    foy = rng.integers(-4, h - 2, n).astype(np.int32)
    stats = rng.random((h, w, 12)).astype(np.float32)
    stats[..., 6:] = stats[..., 6:] * 0.5 + 0.25
    stats = np.pad(stats, ((pad, pad), (pad, pad), (0, 0)))
    split = tuple(np.ascontiguousarray(stats[..., a:b])
                  for a, b in ((0, 3), (3, 6), (6, 12)))
    return vol, props, fox, foy, split, scale, th_col


def bench_solver(scale: float, device: str, sizes=None, windr: int = 20,
                 route: str = "auto", seed: int = 0, dual: bool = False):
    """The port's solver of :func:`build_problem` at ``scale`` on
    ``device``: PARAMS_GF with windR ``windr``, lambda 0.5, th_col 0.5, the
    unary route ``route``, and the reference's layer sizing
    (``main.cpp:395-397``) unless ``sizes`` are given. With ``dual`` the
    volumes are the command line's for a directory without ``im1.acrt``:
    the left one's out-of-view fill, and the right one recovered from it
    (``convert_volume_l2r``) with its own fill; else the one volume serves
    both views. Returns (solver, truth, sizes)."""
    from ..config import PARAMS_GF
    from ..models import engine
    from . import acrt
    img, vol, h, w, nd, truth = build_problem(scale)
    vol0 = vol1 = vol
    if dual:
        vol0 = acrt.fill_out_of_view(vol, 0)
        vol1 = acrt.fill_out_of_view(acrt.convert_volume_l2r(vol0), 1)
    params = PARAMS_GF.replace(windR=windr, lambda_=0.5, th_col=0.5)
    solver = engine.LocalExpansionSolver(img, img, params,
                                         max_disp=float(nd - 1), vol0=vol0,
                                         vol1=vol1, seed=seed, device=device,
                                         unary_backend=route)
    sizes = sizes or [int(w * f) for f in (0.01, 0.03, 0.09)]
    for i, sz in enumerate(sizes):
        solver.add_layer(sz, engine.LAYER0_PROPOSERS if i == 0
                         else engine.COARSE_PROPOSERS)
    return solver, truth, sizes


def unary_windows(solver, truth: np.ndarray, layer, rng: np.random.Generator):
    """The filter windows of color (0, 0) of ``layer`` (one call of the
    main path's unary) and one proposal per region near the planted truth
    at the region's centre, on the solver's device. Returns (proposals
    [N, 4], fox [N], foy [N], F)."""
    import torch
    cfg = solver.cfg
    s, r = layer.unit_size, cfg.params.guided_radius
    ox, oy, _ = layer.color_regions(0, 0)
    cx = np.clip(ox + s // 2, 0, cfg.width - 1)
    cy = np.clip(oy + s // 2, 0, cfg.height - 1)
    n = len(ox)
    a = rng.uniform(-0.02, 0.02, n)
    b = rng.uniform(-0.02, 0.02, n)
    c = truth[cy, cx] + rng.uniform(-0.5, 0.5, n) - a * cx - b * cy
    props = np.stack([a, b, c, np.zeros(n)], -1).astype(np.float32)
    dev = solver.data.coeff8.device
    return (torch.as_tensor(props, device=dev),
            torch.as_tensor((ox - s - r).astype(np.int64), device=dev),
            torch.as_tensor((oy - s - r).astype(np.int64), device=dev),
            3 * s + 2 * r)


def v2_scene(h: int = 375, w: int = 450, ndisp: int = 60, seed: int = 0):
    """A V2 stereo pair with planted slanted planes.

    The left view's disparity is a background plane with a few nearer
    slanted planes in front of it (ellipses), all within [2, ndisp - 3].
    The left image is a random texture (blurred noise, per channel). The
    right view is rendered from the planes: its pixel (xr, y) shows the
    nearest plane that maps a left pixel of that plane's own region onto
    it (x - d(x, y) = xr), sampled there bilinearly from the left image; a
    pixel no plane reaches (seen by the right camera only) gets texture of
    its own. Returns (imL, imR [h, w, 3] uint8 BGR, disparity [h, w]
    float32 of the left view, nonocc [h, w] bool: the left pixels the
    right view sees)."""
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
    disp = np.clip(np.choose(label, disp_of), lo, hi)

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
    return left, right, disp.astype(np.float32), nonocc


def write_v2_scene(target, h: int = 375, w: int = 450, ndisp: int = 60,
                   seed: int = 0):
    """Writes :func:`v2_scene` as a Middlebury V2 directory at ``target``
    (created): ``imL.png``, ``imR.png``, ``groundtruth.png`` (disparity x 4,
    rounded), ``nonocc.png`` (255 where the right view sees the pixel, 0
    elsewhere) and ``info.txt`` ("4 {ndisp}"). Returns the disparity
    [h, w] float32 that ``groundtruth.png`` holds (quarter-pixel steps)."""
    import os

    from . import png
    im_l, im_r, disp, nonocc = v2_scene(h, w, ndisp, seed)
    os.makedirs(target)
    png.write(os.path.join(target, "imL.png"), im_l)
    png.write(os.path.join(target, "imR.png"), im_r)
    gt = np.clip(np.rint(disp * 4.0), 1, 255).astype(np.uint8)
    png.write(os.path.join(target, "groundtruth.png"), gt)
    png.write(os.path.join(target, "nonocc.png"),
              np.where(nonocc, 255, 0).astype(np.uint8))
    with open(os.path.join(target, "info.txt"), "w") as f:
        f.write(f"4 {ndisp}\n")
    return gt.astype(np.float32) / 4.0


def v2_solver(h: int, w: int, ndisp: int, device: str, sizes=None,
              windr: int = 20, max_vdisp: float = 0.0, seed: int = 0):
    """The port's solver of :func:`v2_scene` (h, w, ndisp) on ``device``,
    on the V2 image-warp energy: PARAMS_GF with windR ``windr`` and the
    MiddV2 mode's smooth weight 1.0, the mode's layers {5, 15, 25} unless
    ``sizes`` are given, and ``max_vdisp``. Returns (solver, disparity
    truth [h, w], nonocc [h, w], sizes)."""
    from ..config import PARAMS_GF
    from ..models import engine
    im_l, im_r, truth, nonocc = v2_scene(h, w, ndisp)
    solver = engine.LocalExpansionSolver(
        im_l.astype(np.float32), im_r.astype(np.float32),
        PARAMS_GF.replace(windR=windr, lambda_=1.0),
        max_disp=float(ndisp - 1), max_vdisp=max_vdisp, seed=seed,
        device=device)
    sizes = list(sizes or (5, 15, 25))
    for i, sz in enumerate(sizes):
        solver.add_layer(sz, engine.LAYER0_PROPOSERS if i == 0
                         else engine.COARSE_PROPOSERS)
    return solver, truth, nonocc, sizes
