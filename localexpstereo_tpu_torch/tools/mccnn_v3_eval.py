"""The MC-CNN volume's accuracy at the V3 halfH geometry, images -> volume ->
solve on one device (the port of the JAX package's
``tools/mccnn_v3_eval.py``)::

    python -m localexpstereo_tpu_torch.tools.mccnn_v3_eval [--device cuda]
        [--scale 1.0]

:func:`build_pair` makes a seeded, warp-consistent pair at 1436 x 992 with
145 disparities (at ``--scale`` 1.0; numpy, the JAX tool's draws): the
right image a band-limited random texture, the truth piecewise slanted
planes with occluding jumps, the left image the right one sampled at
``x - d(x)``. The bundled MC-CNN-fast weights (``models/mccnn.py``, TF32
off on the card) give the volume, scored two ways against the truth on
the pixels whose source lies in the right image:

1. WTA (argmin over d): bad1.0 / bad2.0 in percent;
2. the tool's solve on that volume: ``PARAMS_GF`` with windR 20, lambda
   0.5, th_col 0.5; layers int(w * {0.01, 0.03, 0.09}) with
   ``LAYER0_PROPOSERS`` / ``COARSE_PROPOSERS``; 2 greedy + 5 graph-cut
   sweeps of view 0 with the volume as both views'; the "auto" unary route.

Prints the card's name and power limit (on a card), then one JSON line:
the geometry, the volume's seconds (cold and warm, synchronized), the
bad rates and the solve's seconds beside the JAX tool's artifact
(``tools/mccnn_v3_eval.json``, the JAX package on a TPU: its accuracy
only). Writes no file.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

from ..config import PARAMS_GF
from ..models import engine, mccnn

#: The JAX tool's artifact (tools/mccnn_v3_eval.json) at scale 1.0: bad
#: rates in percent.
JAX_ARTIFACT = {"wta_bad1": 1.967, "wta_bad2": 1.574, "solve_bad1": 0.569,
                "solve_bad2": 0.233}
#: The tool's solve: parameters, layer fractions of the width, schedule.
PARAMS = PARAMS_GF.replace(windR=20, lambda_=0.5, th_col=0.5)
LAYER_FRACTIONS = (0.01, 0.03, 0.09)
PM_ITERATIONS, ITERATIONS = 2, 5


def geometry(scale: float):
    """(height, width, disparities) at ``scale`` of 992 x 1436 x 145."""
    return (max(int(992 * scale), 64), max(int(1436 * scale), 96),
            max(int(145 * scale), 16))


def build_pair(h, w, nd, seed=0):
    """(left [h, w, 3], right [h, w, 3], truth [h, w], valid [h, w] bool):
    the warp-consistent pair, float32 images 0..255 (the JAX tool's
    construction, draw for draw)."""
    rng = np.random.default_rng(seed)

    # Multi-octave band-limited texture (values 0..255, 3 channels).
    def texture():
        img = np.zeros((h, w, 3), np.float32)
        for octave in (4, 8, 16, 32, 64):
            n = rng.random((h // octave + 2, w // octave + 2, 3)) - 0.5
            ys = np.linspace(0, n.shape[0] - 1.001, h)
            xs = np.linspace(0, n.shape[1] - 1.001, w)
            y0 = ys.astype(int)[:, None]
            x0 = xs.astype(int)[None, :]
            fy = (ys[:, None] - y0)[..., None]
            fx = (xs[None, :] - x0)[..., None]
            img += ((n[y0, x0] * (1 - fy) + n[y0 + 1, x0] * fy) * (1 - fx)
                    + (n[y0, x0 + 1] * (1 - fy)
                       + n[y0 + 1, x0 + 1] * fy) * fx) * octave
        img -= img.min()
        return (img / img.max() * 255.0).astype(np.float32)

    im_r = texture()

    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    d_gt = np.full((h, w), 0.25 * nd, np.float32)
    for _ in range(8):
        cx, cy = rng.uniform(0, w), rng.uniform(0, h)
        a = rng.uniform(-0.08, 0.08)
        b = rng.uniform(-0.08, 0.08)
        c = rng.uniform(0.25, 0.9) * nd
        rad = rng.uniform(0.15, 0.45) ** 2 * (h * w)
        mask = ((xs - cx) ** 2 + (ys - cy) ** 2) < rad
        plane = np.clip(a * (xs - cx) + b * (ys - cy) + c, 1.0, nd - 2.0)
        d_gt = np.where(mask & (plane > d_gt), plane, d_gt)

    # imL(x) = imR(x - d(x)), bilinear in x.
    src = xs - d_gt
    x0 = np.clip(np.floor(src).astype(int), 0, w - 2)
    f = np.clip(src - x0, 0.0, 1.0)[..., None]
    yi = ys.astype(int)
    im_l = im_r[yi, x0] * (1 - f) + im_r[yi, x0 + 1] * f
    valid = src >= 0
    return im_l.astype(np.float32), im_r, d_gt, valid


def bad_rates(disp, truth, valid):
    """(bad1.0, bad2.0) in percent of the valid pixels."""
    err = np.abs(np.asarray(disp, np.float32) - truth)
    n = valid.sum()
    return (float(100.0 * ((err > 1.0) & valid).sum() / n),
            float(100.0 * ((err > 2.0) & valid).sum() / n))


def wta(vol: torch.Tensor) -> np.ndarray:
    """[H, W] float32 argmin over d of a [D, H, W] volume, on the host."""
    return torch.argmin(vol, dim=0).to(torch.float32).cpu().numpy()


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def volume(net, im_l, im_r, nd):
    """(the [nd, H, W] volume, cold seconds, warm seconds): two calls, each
    synchronized."""
    dev = net.convs[0].weight.device
    times = []
    for _ in range(2):
        t0 = time.perf_counter()
        vol = mccnn.cost_volume(net, im_l, im_r, nd)
        _sync(dev)
        times.append(time.perf_counter() - t0)
    return vol, times[0], times[1]


def solve(im_l, im_r, vol, nd, device):
    """The tool's solve on ``vol`` (as both views'): (disparity [H, W] on
    the host, seconds)."""
    w = im_l.shape[1]
    solver = engine.LocalExpansionSolver(im_l, im_r, PARAMS, float(nd - 1),
                                         vol0=vol, vol1=vol, seed=0,
                                         device=device)
    for i, frac in enumerate(LAYER_FRACTIONS):
        solver.add_layer(max(1, int(w * frac)),
                         engine.LAYER0_PROPOSERS if i == 0
                         else engine.COARSE_PROPOSERS)
    t0 = time.perf_counter()
    solver.run(iterations=ITERATIONS, view_modes=(0,),
               pm_iterations=PM_ITERATIONS)
    disp = solver.disparity_map().float().cpu().numpy()
    return disp, time.perf_counter() - t0


def evaluate(device="cuda", scale: float = 1.0):
    """The whole check on ``device``: a dict of the geometry, the volume's
    seconds, the WTA bad rates, and the solve's bad rates and seconds."""
    device = torch.device(device)
    h, w, nd = geometry(scale)
    t0 = time.perf_counter()
    im_l, im_r, truth, valid = build_pair(h, w, nd)
    pair_s = time.perf_counter() - t0
    net = mccnn.params_from_jax(mccnn.load_default_params()).to(device)
    vol, cold_s, warm_s = volume(net, im_l, im_r, nd)
    wta_bad1, wta_bad2 = bad_rates(wta(vol), truth, valid)
    out = {"geometry": {"h": h, "w": w, "ndisp": nd, "scale": scale},
           "device": str(device), "pair_s": pair_s,
           "volume_cold_s": cold_s, "volume_warm_s": warm_s,
           "wta_bad1": wta_bad1, "wta_bad2": wta_bad2}
    disp, solve_s = solve(im_l, im_r, vol, nd, device)
    out["solve_bad1"], out["solve_bad2"] = bad_rates(disp, truth, valid)
    out["solve_s"] = solve_s
    out["finite"] = bool(np.isfinite(disp).all())
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--scale", type=float, default=1.0)
    ns = ap.parse_args(argv)
    if torch.device(ns.device).type == "cuda":
        if not torch.cuda.is_available():
            print("mccnn_v3_eval: no CUDA device (pass --device cpu)",
                  file=sys.stderr)
            return 2
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, check=True).stdout.strip(),
              flush=True)
    out = evaluate(ns.device, ns.scale)
    out["jax_tpu_artifact"] = JAX_ARTIFACT if ns.scale == 1.0 else None
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
