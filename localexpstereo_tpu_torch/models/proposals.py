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

:func:`completion_labeling` makes a whole external labeling for the fusion
move, on the host.

Every float32 operation here rounds the same on the CPU and on the card
(:mod:`..ops.xla_math`), so a solve's proposals are the same on both. The
JAX engine runs the proposers under ``jit``, where XLA's CPU backend fuses
elementwise code and contracts each multiply that feeds an add into one
fused multiply-add: ``x*y + z*w`` becomes ``fma(x, y, z*w)``, and ``x*y -
z*w`` becomes ``fma(x, y, -(z*w))``. RANSAC is written in those forms and
equals the JAX engine's bit for bit (``tests/test_torch_proposals.py``);
the random perturbation keeps three sums in eager JAX's form (see there).
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from ..ops import cuda_build, rng, xla_math
from ..ops import plane as plane_ops

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


def _disparity(labels: torch.Tensor, x, y) -> torch.Tensor:
    """``plane.disparity_at`` as XLA contracts it: ``fma(a, x, b*y) + c``."""
    return xla_math.fma(labels[..., 0], x, labels[..., 1] * y) + labels[..., 2]


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
    # zs, z_new and v_new are rounded op by op, as eager JAX has them: the
    # JAX engine's jitted code fuses their multiply-adds, which moves the
    # port's solves off the JAX engine's in a parity test (ROADMAP C8).
    zs = plane_ops.disparity_at(base, gx, gy)
    # float32 values as Python numbers: no copy to the card.
    dz, nr = xla_math.as_f32(dz), xla_math.as_f32(nr)

    minz = torch.clamp(zs - dz, min=min_disp)
    maxz = torch.clamp(zs + dz, max=max_disp)
    z_new = rng.uniform(kz, tuple(zs.shape), device=dev) * (maxz - minz) + minz

    n0 = plane_ops.get_normal(base)
    jitter = plane_ops.random_unit_vector(kn, math.pi, tuple(zs.shape),
                                          device=dev) * nr
    n1 = n0 + jitter
    n1 = n1 / xla_math.norm3(n1)[..., None]

    if max_vdisp != 0.0:
        dv = float(torch.tensor(dz, dtype=torch.float32)
                   / max(max_disp - min_disp, 1e-9) * max_vdisp)
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


#: Each adjugate entry of a 3 x 3 matrix, row-major, as ``a[i] * a[j] -
#: a[k] * a[l]`` over its 9 flat entries (i, j, k, l), in the JAX package's
#: order of the factors.
_ADJUGATE = ((4, 8, 5, 7), (2, 7, 1, 8), (1, 5, 2, 4),
             (5, 6, 3, 8), (0, 8, 2, 6), (2, 3, 0, 5),
             (3, 7, 4, 6), (1, 6, 0, 7), (0, 4, 1, 3))


def _solve3x3(a: torch.Tensor, atb: torch.Tensor):
    """Batched 3x3 solve via the adjugate; returns (solution, ok_mask). The
    adjugate's and determinant's products and differences are contracted
    as XLA contracts the JAX package's, and ``adj @ atb`` is XLA's dot."""
    flat = a.flatten(-2)
    x, y, z, w = (torch.stack([flat[..., e[k]] for e in _ADJUGATE], -1)
                  for k in range(4))
    adj = xla_math.fma(x, y, -(z * w))                       # [..., 9]
    t2 = xla_math.fma(flat[..., 3], flat[..., 8],
                      -(flat[..., 5] * flat[..., 6]))
    det = xla_math.fma(flat[..., 2], adj[..., 6], xla_math.fma(
        flat[..., 0], adj[..., 0], -(flat[..., 1] * t2)))
    ok = torch.abs(det) > 1e-12
    safe_det = torch.where(ok, det, 1.0)
    sol = xla_math.matvec3(adj.unflatten(-1, (3, 3)), atb) / safe_det[..., None]
    return sol, ok


def refit_sums_reference(feats: torch.Tensor, weight: torch.Tensor,
                         d: torch.Tensor):
    """Plain PyTorch version of :func:`refit_sums` (same arguments and
    result): every output a fused multiply-add chain over p = 0 .. P-1,
    each step a float64 product (exact) and sum rounded to float32."""
    n, p = weight.shape
    fw = feats * weight[..., None]
    rhs = torch.cat([feats, (d * weight)[..., None]], -1)       # [N, P, 4]
    prod = fw.double()[..., :, None] * rhs.double()[..., None, :]
    acc = torch.zeros((n, 3, 4), dtype=torch.float32, device=feats.device)
    step = torch.empty((n, 3, 4), dtype=torch.float64, device=feats.device)
    for q in range(p):
        torch.add(prod[:, q], acc, out=step)
        acc.copy_(step)
    return acc[..., :3].contiguous(), acc[..., 3].contiguous()


def _declare_refit(lib: ctypes.CDLL) -> None:
    fn = lib.refit_sums_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    probe = lib.refit_chain_probe_launch
    probe.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_void_p]
    probe.restype = ctypes.c_int


REFIT_LIBRARY = cuda_build.Library("refit_sums", ("refit_sums.cu",),
                                   _declare_refit)


def refit_sums(feats: torch.Tensor, weight: torch.Tensor, d: torch.Tensor):
    """Normal equations (A^T W A [N, 3, 3], A^T W d [N, 3], float32) of the
    weighted least-squares plane fit to ``d`` [N, P] at ``feats`` [N, P, 3]
    (cell-local x, y, 1) with 0/1 ``weight`` [N, P].

    Each output is ``acc = fma(fw[p], f[p], acc)`` for p = 0 .. P-1 in
    order, from 0, where ``fw = feats * weight`` and ``f`` is ``feats`` or
    ``d * weight``: how XLA's CPU dot computes the JAX package's two einsums
    (``localexpstereo_tpu/models/proposals.py:218-219``). On a CUDA tensor
    this launches the kernel of ``csrc/refit_sums.cu``, the same arithmetic,
    or raises; on a CPU tensor it runs :func:`refit_sums_reference`."""
    n, p = weight.shape
    dev = feats.device
    cuda_build.check("feats", feats, dev, (torch.float32,), (n, p, 3))
    cuda_build.check("weight", weight, dev, (torch.float32,), (n, p))
    cuda_build.check("d", d, dev, (torch.float32,), (n, p))
    if dev.type == "cpu":
        return refit_sums_reference(feats, weight, d)
    if dev.type != "cuda":
        raise ValueError(f"refit_sums: unsupported device {dev}")
    ata = torch.empty((n, 3, 3), dtype=torch.float32, device=dev)
    atb = torch.empty((n, 3), dtype=torch.float32, device=dev)
    if n == 0:
        return ata, atb
    with torch.cuda.device(dev):
        lib = cuda_build.load(REFIT_LIBRARY)
        rc = lib.refit_sums_launch(
            feats.data_ptr(), weight.data_ptr(), d.data_ptr(),
            ata.data_ptr(), atb.data_ptr(), n, p,
            torch.cuda.current_stream().cuda_stream)
    cuda_build.launch_error("refit_sums", rc)
    refit_sums.launches += 1
    return ata, atb


#: Number of kernel launches, counted where the kernel launches.
refit_sums.launches = 0


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
    d = _disparity(cell_labels, gxg, gyg).reshape(n, -1)
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

    res = torch.abs(_disparity(h_abc[..., None, :], gx[None], gy[None])
                    - d[None])                                # [NH, N, P]
    inlier = (res < threshold).to(torch.float32) * w[None]
    counts = torch.where(h_ok, inlier.sum(-1), -1.0)          # [NH, N]
    best = _first_argmax(counts)                              # [N]

    ar = torch.arange(n, device=dev)
    best_abc = h_abc[best, ar]                                # [N, 3]
    best_in = inlier[best, ar]                                # [N, P]

    feats = torch.stack([gx, gy, torch.ones_like(gx)], -1)    # [N, P, 3]
    refit, ok = _solve3x3(*refit_sums(feats, best_in, d))
    abc = torch.where(ok[:, None], refit, best_abc)
    any_ok = h_ok[best, ar]
    abc = torch.where(any_ok[:, None], abc, 0.0)
    a, b_, c_local = abc[:, 0], abc[:, 1], abc[:, 2]
    c = xla_math.fma(-b_, oy.to(torch.float32),
                     xla_math.fma(-a, ox.to(torch.float32), c_local))
    return torch.stack([a, b_, c, torch.zeros_like(c)], dim=-1)


def _first_argmax(x: torch.Tensor) -> torch.Tensor:
    """Index of the first maximum along axis 0 (``jnp.argmax``'s tie rule,
    which ``torch.argmax`` does not promise on every device)."""
    m = x.max(dim=0, keepdim=True).values
    idx = torch.arange(x.shape[0], device=x.device)[:, None].expand_as(x)
    return torch.where(x == m, idx, x.shape[0]).min(dim=0).values


def completion_labeling(labeling, image, block: int = 48,
                        offset=(0, 0), irls_rounds: int = 3,
                        texture_radius: int = 2) -> np.ndarray:
    """Piecewise-planar completion of a labeling, on the host in numpy (a
    copy of the JAX package's): an external labeling for
    :meth:`..engine.LocalExpansionSolver.fuse`.

    For each ``block`` x ``block`` tile (grid shifted by ``offset`` =
    (dy, dx)), fits one plane to the tile's plane-induced disparities by
    weighted least squares with Cauchy reweighting (``irls_rounds``
    refits), each sample weighted by the local image texture (the standard
    deviation of the gray level over a (2 ``texture_radius`` + 1)^2 box),
    and paints the tile with it. A tile with no texture at all keeps
    uniform weights in every round.

    Args:
      labeling: [H, W, 4] labels; image: [H, W, 3] float image.
    Returns:
      [H, W, 4] float32 labeling (v = 0 everywhere).
    """
    lab = np.asarray(labeling, np.float32)
    h, w = lab.shape[:2]
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    d = lab[..., 0] * xs + lab[..., 1] * ys + lab[..., 2]

    gray = np.asarray(image, np.float32).mean(-1)
    r = texture_radius
    k = 2 * r + 1

    def box(a):
        p = np.pad(a, r, mode="edge")
        c = np.cumsum(np.cumsum(p, 0), 1)
        c = np.pad(c, ((1, 0), (1, 0)))
        return (c[k:, k:] - c[:-k, k:] - c[k:, :-k] + c[:-k, :-k]) / (k * k)

    conf = np.sqrt(np.maximum(box(gray * gray) - box(gray) ** 2, 0.0))

    out = np.empty_like(lab)
    oy0, ox0 = int(offset[0]) % block, int(offset[1]) % block
    y_edges = [0] + list(range(oy0 if oy0 else block, h, block)) + [h]
    x_edges = [0] + list(range(ox0 if ox0 else block, w, block)) + [w]
    for y0, y1 in zip(y_edges, y_edges[1:]):
        for x0, x1 in zip(x_edges, x_edges[1:]):
            if y0 >= y1 or x0 >= x1:
                continue
            tx = xs[y0:y1, x0:x1].ravel()
            ty = ys[y0:y1, x0:x1].ravel()
            td = d[y0:y1, x0:x1].ravel()
            base_w = conf[y0:y1, x0:x1].ravel().copy()
            if not np.any(base_w > 0):
                base_w = np.ones_like(base_w)
            tw = base_w.copy()
            cx_, cy_ = tx.mean(), ty.mean()
            a_mat = np.stack([tx - cx_, ty - cy_, np.ones_like(tx)], -1)
            for _ in range(irls_rounds + 1):
                aw = a_mat * tw[:, None]
                p = np.linalg.solve((aw.T @ a_mat) + 1e-6 * np.eye(3),
                                    aw.T @ td)
                tw = base_w / (1.0 + (a_mat @ p - td) ** 2)
            out[y0:y1, x0:x1, 0] = p[0]
            out[y0:y1, x0:x1, 1] = p[1]
            out[y0:y1, x0:x1, 2] = p[2] - p[0] * cx_ - p[1] * cy_
            out[y0:y1, x0:x1, 3] = 0.0
    return out
