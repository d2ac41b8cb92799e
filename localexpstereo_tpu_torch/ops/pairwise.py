"""Pairwise (smoothness) terms of the MRF energy.

    psi(f_p, f_q) = w_pq * min(|d_{f_p}(p) - d_{f_q}(p)|
                               + |d_{f_p}(q) - d_{f_q}(q)|, tau) * lambda
    w_pq = max(exp(-||I(p) - I(q)||_1 / omega), epsilon), 0 across the border

(reference ``StereoEnergy.h:131-163, 225-236``). The window functions take a
leading region axis (the JAX package vmaps per-window versions): the
expansion move's tables and boundary t-links against one proposal plane,
and the fusion move's against a second per-pixel labeling.
"""
from __future__ import annotations

import torch

#: Neighbor offsets (dx, dy) in the reference's order (``StereoEnergy.h:99-110``).
NEIGHBORS = (
    (-1, 0),   # 0 LE
    (+1, 0),   # 1 GE
    (0, -1),   # 2 EL
    (0, +1),   # 3 EG
    (-1, -1),  # 4 LL
    (+1, -1),  # 5 GL
    (-1, +1),  # 6 LG
    (+1, +1),  # 7 GG
)

#: Indices of the "forward" neighbors (raster order n.y*W + n.x > 0): GE, EG,
#: LG, GG — the interior edge set (``StereoEnergy.h:352,421``).
FORWARD = (1, 3, 6, 7)


def _shifted(img: torch.Tensor, dx: int, dy: int) -> torch.Tensor:
    """img [H, W, ...] sampled at p + (dx, dy), zero outside."""
    h, w = img.shape[0], img.shape[1]
    out = torch.zeros_like(img)
    ys, ye = max(0, -dy), min(h, h - dy)
    xs, xe = max(0, -dx), min(w, w - dx)
    out[ys:ye, xs:xe] = img[ys + dy:ye + dy, xs + dx:xe + dx]
    return out


def smoothness_coeffs(image: torch.Tensor, omega: float,
                      epsilon: float) -> torch.Tensor:
    """[8, H, W] weights ``max(eps, exp(-||I(p+n) - I(p)||_1 / omega))``
    for an [H, W, 3] float 0..255 image, zero where p + n leaves the image."""
    image = torch.as_tensor(image, dtype=torch.float32)
    h, w = image.shape[:2]
    dev = image.device
    ys = torch.arange(h, device=dev)[:, None]
    xs = torch.arange(w, device=dev)[None, :]
    outs = []
    for dx, dy in NEIGHBORS:
        l1 = torch.sum(torch.abs(_shifted(image, dx, dy) - image), dim=-1)
        coeff = torch.clamp(torch.exp(-l1 / omega), min=epsilon)
        inside = ((xs + dx >= 0) & (xs + dx < w) & (ys + dy >= 0)
                  & (ys + dy < h))
        outs.append(torch.where(inside, coeff, 0.0))
    return torch.stack(outs).to(torch.float32)


def _disp(labels: torch.Tensor, xs, ys) -> torch.Tensor:
    return labels[..., 0] * xs + labels[..., 1] * ys + labels[..., 2]


def smoothness_cost(labeling: torch.Tensor, coeffs: torch.Tensor,
                    lambda_: float, tau: float) -> torch.Tensor:
    """Full-image smoothness energy over the 4 forward neighbors
    (``StereoEnergy.h:165-201``); labeling [H, W, 4], coeffs [8, H, W]."""
    h, w = labeling.shape[:2]
    dev = labeling.device
    ys = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    d_ee_ee = _disp(labeling, xs, ys)
    total = torch.zeros((), dtype=torch.float32, device=dev)
    for k in FORWARD:
        dx, dy = NEIGHBORS[k]
        lab_nb = _shifted(labeling, dx, dy)
        xq, yq = xs + dx, ys + dy
        curv = (torch.abs(d_ee_ee - _disp(lab_nb, xs, ys))
                + torch.abs(_disp(labeling, xq, yq) - _disp(lab_nb, xq, yq)))
        total = total + torch.sum(torch.clamp(curv, max=tau) * coeffs[k]) \
            * lambda_
    return total


def halo_disparities(labels_halo: torch.Tensor, proposal: torch.Tensor,
                     ox: torch.Tensor, oy: torch.Tensor):
    """Disparity of the current label at each haloed pixel (d0h), of the
    proposal (d1h), and the current labels' slopes (ah, bh): [N, S+2, S+2]
    each; ox, oy [N] (float32) are the global coords of each window's
    (0, 0) pixel."""
    s2 = labels_halo.shape[1]
    it = torch.arange(s2, dtype=torch.float32, device=labels_halo.device)
    hx = (ox[:, None, None] - 1.0) + it[None, None, :]
    hy = (oy[:, None, None] - 1.0) + it[None, :, None]
    d0h = labels_halo[..., 0] * hx + labels_halo[..., 1] * hy \
        + labels_halo[..., 2]
    d1h = (proposal[:, 0, None, None] * hx + proposal[:, 1, None, None] * hy
           + proposal[:, 2, None, None])
    return d0h, d1h, labels_halo[..., 0], labels_halo[..., 1]


def _at(x: torch.Tensor, s: int, dx: int, dy: int) -> torch.Tensor:
    """The [N, S, S] window of a haloed [N, S+2, S+2] map at offset
    (dx, dy)."""
    return x[:, 1 + dy:1 + dy + s, 1 + dx:1 + dx + s]


def expansion_tables(labels_halo: torch.Tensor, proposal: torch.Tensor,
                     coeff_fwd: torch.Tensor, ox: torch.Tensor,
                     oy: torch.Tensor, lambda_: float, tau: float):
    """Pairwise tables of the binary expansion move (``StereoEnergy.h:398-453``).

    The expressions and their order are those of the fused expansion kernel
    (``csrc/expansion_accept.cu``), which matches them bit for bit: the
    neighbor's disparity at p is its disparity at q less its slope step.

    Args:
      labels_halo: [N, S+2, S+2, 4] current labels of each window + 1-px halo.
      proposal: [N, 4] candidate planes.
      coeff_fwd: [N, 4, S, S] forward-neighbor weights at p.
      ox, oy: [N] float32 global coords of each window's (0, 0) pixel.
    Returns:
      (cost00, cost01, cost10), each [N, 4, S, S]; cost11 is identically 0.
    """
    s = labels_halo.shape[1] - 2
    d0h, d1h, ah, bh = halo_disparities(labels_halo, proposal, ox, oy)
    d0, d1 = _at(d0h, s, 0, 0), _at(d1h, s, 0, 0)
    a0, b0 = _at(ah, s, 0, 0), _at(bh, s, 0, 0)
    c00, c01, c10 = [], [], []
    for i, k in enumerate(FORWARD):
        dx, dy = NEIGHBORS[k]
        d0q = _at(d0h, s, dx, dy)
        d_le_ee = d0q - (_at(ah, s, dx, dy) * dx + _at(bh, s, dx, dy) * dy)
        d_ee_le = d0 + a0 * dx + b0 * dy
        d1q = _at(d1h, s, dx, dy)
        w = coeff_fwd[:, i] * lambda_
        c00.append(torch.clamp(torch.abs(d0 - d_le_ee)
                               + torch.abs(d_ee_le - d0q), max=tau) * w)
        c01.append(torch.clamp(torch.abs(d0 - d1)
                               + torch.abs(d_ee_le - d1q), max=tau) * w)
        c10.append(torch.clamp(torch.abs(d1 - d_le_ee)
                               + torch.abs(d1q - d0q), max=tau) * w)
    return (torch.stack(c00, 1), torch.stack(c01, 1), torch.stack(c10, 1))


def boundary_tlinks(labels_halo: torch.Tensor, proposal: torch.Tensor,
                    coeff_all: torch.Tensor, ox: torch.Tensor,
                    oy: torch.Tensor, lambda_: float, tau: float):
    """Unary absorption of pairwise terms against the fixed labels just
    outside each window (``FastGCStereo.h:440-477``), all 8 directions, in
    the fused kernel's expressions and order.

    Args:
      labels_halo: [N, S+2, S+2, 4]; proposal: [N, 4];
      coeff_all: [N, 8, S, S]; ox, oy: [N] float32.
    Returns:
      (t0, t1): [N, S, S] extra costs for keep / switch.
    """
    s = labels_halo.shape[1] - 2
    dev = labels_halo.device
    d0h, d1h, ah, bh = halo_disparities(labels_halo, proposal, ox, oy)
    d0, d1 = _at(d0h, s, 0, 0), _at(d1h, s, 0, 0)
    a0, b0 = _at(ah, s, 0, 0), _at(bh, s, 0, 0)
    iy = torch.arange(s, device=dev)[:, None]
    ix = torch.arange(s, device=dev)[None, :]
    t0 = torch.zeros_like(d0)
    t1 = torch.zeros_like(d0)
    for k, (dx, dy) in enumerate(NEIGHBORS):
        outside = ((ix + dx < 0) | (ix + dx >= s) | (iy + dy < 0)
                   | (iy + dy >= s))
        d0q = _at(d0h, s, dx, dy)
        dq_p = d0q - (_at(ah, s, dx, dy) * dx + _at(bh, s, dx, dy) * dy)
        d0_q = d0 + a0 * dx + b0 * dy
        d1_q = _at(d1h, s, dx, dy)
        w = torch.where(outside, coeff_all[:, k], 0.0) * lambda_
        t0 = t0 + torch.clamp(torch.abs(d0 - dq_p)
                              + torch.abs(d0_q - d0q), max=tau) * w
        t1 = t1 + torch.clamp(torch.abs(d1 - dq_p)
                              + torch.abs(d1_q - d0q), max=tau) * w
    return t0, t1


def _window_coords(ox: torch.Tensor, oy: torch.Tensor, s: int):
    """Global (xs, ys) [N, S, S] float32 of each window's pixels."""
    it = torch.arange(s, dtype=torch.float32, device=ox.device)
    return (ox[:, None, None] + it[None, None, :],
            oy[:, None, None] + it[None, :, None])


def fusion_tables(labels0_halo: torch.Tensor, labels1_halo: torch.Tensor,
                  coeff_fwd: torch.Tensor, ox: torch.Tensor, oy: torch.Tensor,
                  lambda_: float, tau: float):
    """Pairwise tables for fusing two labelings, per window
    (``computeSmoothnessTermsFusion``, ``StereoEnergy.h:331-394``): both
    states are per-pixel labels, so cost11 is not identically zero.

    Args:
      labels0_halo, labels1_halo: [N, S+2, S+2, 4] current / external
        labels of each window + 1-px halo.
      coeff_fwd: [N, 4, S, S] forward-neighbor weights at p.
      ox, oy: [N] float32 global coords of each window's (0, 0) pixel.
    Returns:
      (cost00, cost01, cost10, cost11), each [N, 4, S, S].
    """
    s = labels0_halo.shape[1] - 2
    lab0 = _at(labels0_halo, s, 0, 0)
    lab1 = _at(labels1_halo, s, 0, 0)
    xs, ys = _window_coords(ox, oy, s)
    d0_ee = _disp(lab0, xs, ys)
    d1_ee = _disp(lab1, xs, ys)
    outs = [[], [], [], []]
    for i, k in enumerate(FORWARD):
        dx, dy = NEIGHBORS[k]
        xq, yq = xs + dx, ys + dy
        lab0_nb = _at(labels0_halo, s, dx, dy)
        lab1_nb = _at(labels1_halo, s, dx, dy)
        w = coeff_fwd[:, i] * lambda_

        def psi(lab_p, d_p_at_p, lab_q):
            d_q_at_p = _disp(lab_q, xs, ys)
            d_p_at_q = _disp(lab_p, xq, yq)
            d_q_at_q = _disp(lab_q, xq, yq)
            return torch.clamp(torch.abs(d_p_at_p - d_q_at_p)
                               + torch.abs(d_p_at_q - d_q_at_q),
                               max=tau) * w

        outs[0].append(psi(lab0, d0_ee, lab0_nb))
        outs[1].append(psi(lab0, d0_ee, lab1_nb))
        outs[2].append(psi(lab1, d1_ee, lab0_nb))
        outs[3].append(psi(lab1, d1_ee, lab1_nb))
    return tuple(torch.stack(o, 1) for o in outs)


def fusion_boundary_tlinks(labels0_halo: torch.Tensor,
                           labels1_halo: torch.Tensor,
                           coeff_all: torch.Tensor, ox: torch.Tensor,
                           oy: torch.Tensor, lambda_: float, tau: float):
    """Boundary absorption of the fusion move (``FastGCStereo.h:440-477``
    with per-pixel proposals): the neighbours outside each window keep
    their current (labeling-0) label; a switching pixel takes its own
    labeling-1 label.

    Args: as :func:`fusion_tables`, with coeff_all [N, 8, S, S].
    Returns:
      (t0, t1): [N, S, S] extra costs for keep / switch.
    """
    s = labels0_halo.shape[1] - 2
    dev = labels0_halo.device
    lab0 = _at(labels0_halo, s, 0, 0)
    lab1 = _at(labels1_halo, s, 0, 0)
    xs, ys = _window_coords(ox, oy, s)
    iy = torch.arange(s, device=dev)[:, None]
    ix = torch.arange(s, device=dev)[None, :]
    d0_p = _disp(lab0, xs, ys)
    d1_p = _disp(lab1, xs, ys)
    t0 = torch.zeros_like(d0_p)
    t1 = torch.zeros_like(d0_p)
    for k, (dx, dy) in enumerate(NEIGHBORS):
        outside = ((ix + dx < 0) | (ix + dx >= s) | (iy + dy < 0)
                   | (iy + dy >= s))
        lab_q = _at(labels0_halo, s, dx, dy)
        xq, yq = xs + dx, ys + dy
        dq_p = _disp(lab_q, xs, ys)
        dq_q = _disp(lab_q, xq, yq)
        d0_q = _disp(lab0, xq, yq)
        d1_q = _disp(lab1, xq, yq)
        w = torch.where(outside, coeff_all[:, k], 0.0) * lambda_
        t0 = t0 + torch.clamp(torch.abs(d0_p - dq_p)
                              + torch.abs(d0_q - dq_q), max=tau) * w
        t1 = t1 + torch.clamp(torch.abs(d1_p - dq_p)
                              + torch.abs(d1_q - dq_q), max=tau) * w
    return t0, t1
