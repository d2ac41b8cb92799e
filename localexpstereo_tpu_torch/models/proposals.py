"""Batched proposal generators (reference ``Proposer.h``; counterpart of
``localexpstereo_tpu.models.proposals``).

Each proposer produces one candidate plane per region for a whole color
set at once, from the regions' current cell labels. Every draw comes from a
stateless threefry key (:mod:`..ops.rng`), bit-exact with the JAX package.

- expansion (``Proposer.h:34-80``): the current label of a uniformly random
  pixel of the unit cell;
- random perturbation (``Proposer.h:84-153``): re-draw z within +-dz of a
  random in-cell label's disparity and jitter its normal by ``nr``;
- RANSAC (``Proposer.h:155-312``): a fixed batch of 3-point hypotheses
  scored in parallel, then a least-squares refit on the best one's inliers.
"""
from __future__ import annotations

import math

import torch

from ..ops import plane as plane_ops
from ..ops import rng

#: Hypotheses evaluated per RANSAC activation.
RANSAC_HYPOTHESES = 32
RANSAC_THRESHOLD = 1.0  # inlier threshold (Proposer.h:308)


def _cell_pixel(key: torch.Tensor, ox, oy, cw, ch):
    """Uniform random pixel inside the clipped unit cell
    (``selectRandomPixelInRect``, ``Proposer.h:37-44``): one draw over the
    cell's pixel count, split into local (x, y) [N] int64."""
    u = rng.uniform(key, tuple(ox.shape), device=ox.device)
    n = torch.floor(u * (cw * ch).to(torch.float32)).to(torch.int64)
    n = torch.minimum(n, cw * ch - 1)
    wd = torch.clamp(cw, min=1)
    return n % wd, n // wd


def _label_at(cell_labels: torch.Tensor, xx, yy) -> torch.Tensor:
    """[N, 4] labels at per-region local coords from [N, s, s, 4]."""
    n, s = cell_labels.shape[0], cell_labels.shape[1]
    flat = cell_labels.reshape(n, s * s, 4)
    idx = (yy * s + xx).to(torch.int64)
    return flat[torch.arange(n, device=flat.device), idx]


def expansion(key, cell_labels, ox, oy, cw, ch) -> torch.Tensor:
    """[N, 4] expansion proposals: a random in-cell current label."""
    xx, yy = _cell_pixel(key, ox, oy, cw, ch)
    return _label_at(cell_labels, xx, yy)


def random_perturbation(key, cell_labels, ox, oy, cw, ch, dz: float,
                        nr: float, min_disp: float, max_disp: float,
                        max_vdisp: float = 0.0) -> torch.Tensor:
    """[N, 4] perturbation proposals with disparity half-width ``dz`` and
    normal jitter radius ``nr`` (``Proposer.h:93-96,142``)."""
    kp, kz, kn, kv = rng.split(key, 4)
    dev = ox.device
    xx, yy = _cell_pixel(kp, ox, oy, cw, ch)
    base = _label_at(cell_labels, xx, yy)
    gx = (ox + xx).to(torch.float32)
    gy = (oy + yy).to(torch.float32)
    zs = plane_ops.disparity_at(base, gx, gy)
    dz = torch.tensor(dz, dtype=torch.float32, device=dev)
    nr = torch.tensor(nr, dtype=torch.float32, device=dev)

    minz = torch.clamp(zs - dz, min=min_disp)
    maxz = torch.clamp(zs + dz, max=max_disp)
    z_new = rng.uniform(kz, tuple(zs.shape), device=dev) * (maxz - minz) + minz

    n0 = plane_ops.get_normal(base)
    jitter = plane_ops.random_unit_vector(kn, math.pi, tuple(zs.shape),
                                          device=dev) * nr
    n1 = n0 + jitter
    n1 = n1 / torch.linalg.vector_norm(n1, dim=-1, keepdim=True)

    if max_vdisp != 0.0:
        dv = dz / max(max_disp - min_disp, 1e-9) * max_vdisp
        vs = base[:, 3]
        minv = torch.clamp(vs - dv, min=-max_vdisp)
        maxv = torch.clamp(vs + dv, max=max_vdisp)
        v_new = (rng.uniform(kv, tuple(vs.shape), device=dev) * (maxv - minv)
                 + minv)
    else:
        v_new = base[:, 3]
    return plane_ops.create_plane(n1, z_new, gx, gy, v_new)


def random_proposal_count(k_max: int, outer_iter: int, min_disp: float,
                          max_disp: float, do_early_stop: bool = True) -> int:
    """Perturbation proposals for this outer iteration: early stop once
    dz(outer_iter + k) < 0.1 (``Proposer.h:149-152``)."""
    if not do_early_stop:
        return k_max
    count = 0
    for k in range(k_max):
        if (max_disp - min_disp) * (0.5 ** (outer_iter + k + 1)) < 0.1:
            break
        count += 1
    return count


def _solve3x3(a: torch.Tensor, atb: torch.Tensor):
    """Batched 3x3 solve via the adjugate; returns (solution, ok_mask)."""
    det = (a[..., 0, 0] * (a[..., 1, 1] * a[..., 2, 2] - a[..., 1, 2] * a[..., 2, 1])
           - a[..., 0, 1] * (a[..., 1, 0] * a[..., 2, 2] - a[..., 1, 2] * a[..., 2, 0])
           + a[..., 0, 2] * (a[..., 1, 0] * a[..., 2, 1] - a[..., 1, 1] * a[..., 2, 0]))
    adj = torch.stack([
        a[..., 1, 1] * a[..., 2, 2] - a[..., 1, 2] * a[..., 2, 1],
        a[..., 0, 2] * a[..., 2, 1] - a[..., 0, 1] * a[..., 2, 2],
        a[..., 0, 1] * a[..., 1, 2] - a[..., 0, 2] * a[..., 1, 1],
        a[..., 1, 2] * a[..., 2, 0] - a[..., 1, 0] * a[..., 2, 2],
        a[..., 0, 0] * a[..., 2, 2] - a[..., 0, 2] * a[..., 2, 0],
        a[..., 0, 2] * a[..., 1, 0] - a[..., 0, 0] * a[..., 1, 2],
        a[..., 1, 0] * a[..., 2, 1] - a[..., 1, 1] * a[..., 2, 0],
        a[..., 0, 1] * a[..., 2, 0] - a[..., 0, 0] * a[..., 2, 1],
        a[..., 0, 0] * a[..., 1, 1] - a[..., 0, 1] * a[..., 1, 0],
    ], dim=-1).reshape(*a.shape[:-2], 3, 3)
    ok = torch.abs(det) > 1e-12
    safe_det = torch.where(ok, det, 1.0)
    sol = torch.einsum("...ij,...j->...i", adj, atb) / safe_det[..., None]
    return sol, ok


def ransac(key, cell_labels, ox, oy, cw, ch,
           num_hypotheses: int = RANSAC_HYPOTHESES,
           threshold: float = RANSAC_THRESHOLD) -> torch.Tensor:
    """[N, 4] MSAC plane fits to each cell's current disparities, fitted in
    cell-local coordinates (well-conditioned in float32) and shifted back.
    Out-of-image cell pixels are masked out."""
    n, s = cell_labels.shape[0], cell_labels.shape[1]
    dev = cell_labels.device
    iy = torch.arange(s, device=dev)[:, None].expand(s, s)
    ix = torch.arange(s, device=dev)[None, :].expand(s, s)
    gxg = (ox[:, None, None] + ix[None]).to(torch.float32)
    gyg = (oy[:, None, None] + iy[None]).to(torch.float32)
    in_cell = (ix[None] < cw[:, None, None]) & (iy[None] < ch[:, None, None])
    d = plane_ops.disparity_at(cell_labels, gxg, gyg).reshape(n, -1)
    gx = ix.to(torch.float32).reshape(1, -1).expand(n, s * s)
    gy = iy.to(torch.float32).reshape(1, -1).expand(n, s * s)
    w = in_cell.reshape(n, -1).to(torch.float32)              # [N, P]

    reg = torch.arange(n, device=dev)[None, :]
    rows = []
    for kk in rng.split(key, 3):
        xx, yy = _cell_pixel(kk, ox.repeat(num_hypotheses),
                             oy.repeat(num_hypotheses),
                             cw.repeat(num_hypotheses),
                             ch.repeat(num_hypotheses))
        idx = yy.reshape(num_hypotheses, n) * s + xx.reshape(num_hypotheses, n)
        rows.append((gx[reg, idx], gy[reg, idx], d[reg, idx]))
    one = torch.ones_like(rows[0][0])
    A = torch.stack([torch.stack([x_, y_, one], -1) for x_, y_, _ in rows],
                    -2)
    b = torch.stack([d_ for _, _, d_ in rows], -1)
    h_abc, h_ok = _solve3x3(A, b)                             # [NH, N, 3]

    res = torch.abs(h_abc[..., 0][..., None] * gx[None]
                    + h_abc[..., 1][..., None] * gy[None]
                    + h_abc[..., 2][..., None] - d[None])     # [NH, N, P]
    inlier = (res < threshold).to(torch.float32) * w[None]
    counts = torch.where(h_ok, inlier.sum(-1), -1.0)          # [NH, N]
    best = _first_argmax(counts)                              # [N]

    ar = torch.arange(n, device=dev)
    best_abc = h_abc[best, ar]                                # [N, 3]
    best_in = inlier[best, ar]                                # [N, P]

    feats = torch.stack([gx, gy, torch.ones_like(gx)], -1)    # [N, P, 3]
    wgt = best_in[..., None]
    ata = torch.einsum("npi,npj->nij", feats * wgt, feats)
    atb = torch.einsum("npi,np->ni", feats * wgt, d * best_in)
    refit, ok = _solve3x3(ata, atb)
    abc = torch.where(ok[:, None], refit, best_abc)
    any_ok = h_ok[best, ar]
    abc = torch.where(any_ok[:, None], abc, 0.0)
    a, b_, c_local = abc[:, 0], abc[:, 1], abc[:, 2]
    c = c_local - a * ox.to(torch.float32) - b_ * oy.to(torch.float32)
    return torch.stack([a, b_, c, torch.zeros_like(c)], dim=-1)


def _first_argmax(x: torch.Tensor) -> torch.Tensor:
    """Index of the first maximum along axis 0 (``jnp.argmax``'s tie rule,
    which ``torch.argmax`` does not promise on every device)."""
    m = x.max(dim=0, keepdim=True).values
    idx = torch.arange(x.shape[0], device=x.device)[:, None].expand_as(x)
    return torch.where(x == m, idx, x.shape[0]).min(dim=0).values
