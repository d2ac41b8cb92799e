"""Trains the MC-CNN-fast matching network on Middlebury V2 ground truth (the
port of the JAX package's ``tools/train_mccnn.py``)::

    python -m localexpstereo_tpu_torch.tools.train_mccnn --data DIR
        [--steps 600] [--lr 3e-4] [--seed 0] [--out PATH] [--device cuda]

``DIR`` holds the Middlebury V2 scenes ``cones``, ``teddy``, ``venus``
(training) and ``tsukuba`` (held out), each a directory that
``utils/datasets.load_data`` reads (``imL.png``, ``imR.png``,
``groundtruth.png``, ``info.txt``; ``utils/synthetic.write_v2_scene``
writes such a directory).

The objective is MC-CNN-fast's: a siamese hinge loss on the cosine
similarity of the tower's features, the positive pair at the rounded
ground-truth disparity, the negative pair 4-10 px beside it, over a batch
of 4096 random pixels a step. Adam (lr 3e-4, betas (0.9, 0.999), eps 1e-8:
optax's ``adam``) updates the weights, which start from
``mccnn.init_params_from_key(PRNGKey(seed))``. Every random draw is the
JAX tool's (``ops/rng``), in its order, so a run follows the JAX run step
for step. Every 50 steps and at the last it prints the step's train hinge
and accuracy and the held-out scene's, then writes the weights as the JAX
package's ``.npz`` (``mccnn.params_to_jax``; both packages'
``load_params`` read it), by default over the port's bundled
``models/weights/mccnn_fast_v2.npz``.

The network runs in full float32 on the card (TF32 off, forward and
backward). ``--device cuda`` raises on a host without a card.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from ..models import mccnn
from ..ops import rng
from ..utils import datasets

TRAIN = ("cones", "teddy", "venus")
HOLDOUT = "tsukuba"
MARGIN = 0.2
NEG_MIN, NEG_MAX = 4, 10
#: The tool's defaults (the JAX tool's).
STEPS, LR, BATCH = 600, 3e-4, 4096
LOG_EVERY = 50


def load(data: str, name: str, device="cuda"):
    """(im0, im1 [H, W, 3] float32 BGR 0..255, gt [H, W] float32 with +inf
    where unknown, valid [H, W] bool) of ``data/name`` on ``device``."""
    pair = datasets.load_data(os.path.join(data, name), 0)
    gt = np.asarray(pair.disp_gt, np.float32)
    valid = np.isfinite(gt) & (gt > 0)
    return tuple(torch.as_tensor(a, device=device)
                 for a in (pair.im0, pair.im1, gt, valid))


def sample_batch(gt, valid, key, batch: int = BATCH):
    """The JAX tool's draws from ``key`` on a scene's ground truth: the
    pixel rows from ``kp``, the columns from ``fold_in(kp, 1)``, the
    negative's offset from ``kn`` and its side from ``ks``. Returns (ys, xs,
    xpos, xneg, ok): the pixels, their positive and negative columns in the
    right image (clipped), and whether a pixel counts (its disparity known,
    both columns in the image)."""
    h, w = gt.shape
    dev = gt.device
    kp, kn, ks = rng.split(key, 3)
    ys = rng.randint(kp, (batch,), 0, h, device=dev).long()
    xs = rng.randint(rng.fold_in(kp, 1), (batch,), 0, w, device=dev).long()
    # rint (half to even) of the known disparities; an unknown one is
    # masked out by ``valid`` below.
    d = torch.round(torch.where(valid, gt, 0.0)[ys, xs]).long()
    ok = valid[ys, xs] & (xs - d >= 0)

    off = rng.randint(kn, (batch,), NEG_MIN, NEG_MAX + 1, device=dev).long()
    sign = torch.where(rng.bernoulli(ks, 0.5, (batch,), device=dev), 1, -1)
    xneg = xs - d + off * sign
    ok &= (xneg >= 0) & (xneg < w)
    return (ys, xs, torch.clamp(xs - d, 0, w - 1),
            torch.clamp(xneg, 0, w - 1), ok)


def hinge_loss(net, im0, im1, gt, valid, key, batch: int = BATCH):
    """(mean hinge, matching accuracy) over the ``batch`` pixels that
    :func:`sample_batch` draws from ``key``, both means over the pixels
    that count. The loss is differentiable in ``net``'s weights through
    both images' features."""
    f0, f1 = net(im0), net(im1)
    ys, xs, xpos, xneg, ok = sample_batch(gt, valid, key, batch)
    fp = f0[ys, xs]
    s_pos = torch.sum(fp * f1[ys, xpos], -1)
    s_neg = torch.sum(fp * f1[ys, xneg], -1)
    # torch.maximum, as jnp.maximum, halves the gradient at a tie.
    hinge = torch.maximum(MARGIN + s_neg - s_pos,
                          torch.zeros_like(s_pos)) * ok
    n = torch.clamp(ok.sum(), min=1)
    return hinge.sum() / n, ((s_pos > s_neg) & ok).sum() / n


def adam(net, lr: float = LR) -> torch.optim.Adam:
    """optax's ``adam(lr)``: betas (0.9, 0.999), eps 1e-8, no eps_root."""
    return torch.optim.Adam(net.parameters(), lr=lr, betas=(0.9, 0.999),
                            eps=1e-8)


def train_step(net, opt, scene, key):
    """One Adam step on the hinge loss of ``scene`` (im0, im1, gt, valid)
    under ``key``: (loss, accuracy) before the update, as the JAX tool's
    ``step`` returns them."""
    opt.zero_grad(set_to_none=True)
    loss, acc = hinge_loss(net, *scene, key)
    loss.backward()
    opt.step()
    return loss.detach(), acc


def main(argv=None):
    """The JAX tool's loop; returns the printed rows as dicts (step, the
    train and held-out hinge and accuracy, seconds since the first step
    began)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--data", required=True,
                    help="directory of the V2 scenes cones, teddy, venus "
                         "and tsukuba")
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--lr", type=float, default=LR)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=mccnn.default_weights_path())
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available "
                           "(pass --device cpu)")

    train = [load(args.data, n, device) for n in TRAIN]
    val = load(args.data, HOLDOUT, device)

    key = rng.PRNGKey(args.seed)
    net = mccnn.params_from_jax(mccnn.init_params_from_key(key))
    net = net.to(device).requires_grad_(True)
    opt = adam(net, args.lr)

    rows = []
    t0 = time.perf_counter()
    for it in range(args.steps):
        key, k = rng.split(key)
        loss, acc = train_step(net, opt, train[it % len(train)], k)
        if it % LOG_EVERY == 0 or it == args.steps - 1:
            with torch.no_grad():
                vl, vacc = hinge_loss(net, *val, rng.fold_in(key, 999))
            row = {"step": it, "train_hinge": float(loss),
                   "train_acc": float(acc), "val_hinge": float(vl),
                   "val_acc": float(vacc),
                   "seconds": time.perf_counter() - t0}
            rows.append(row)
            print(f"step {it:4d}  train hinge {row['train_hinge']:.4f} "
                  f"acc {row['train_acc']:.3f}   {HOLDOUT} hinge "
                  f"{row['val_hinge']:.4f} acc {row['val_acc']:.3f}",
                  flush=True)

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    mccnn.save_params(args.out, mccnn.params_to_jax(net))
    print(f"wrote {args.out}")
    return rows


if __name__ == "__main__":
    main()
