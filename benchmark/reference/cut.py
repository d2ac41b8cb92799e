"""The plain reference of one expansion move: the move's energy over a
region's window, worked out from the labels around it, the proposal, the
image's pairwise weights and the window's unaries, and its least value by
a plain max-flow (``scipy.sparse.csgraph.maximum_flow``). It imports
nothing of the program.

A move on a window of S x S pixels gives each pixel the choice ``x = 0``
(keep its label) or ``x = 1`` (take the proposal ``alpha``). Its energy is

    E(x) = sum_p (x_p ? u1_p : u0_p)
         + lambda sum_{pq} w_pq psi(l_p(x), l_q(x))

over the forward 8-neighbour edges with a pixel in the window; a pixel
outside it (the 1-px halo) keeps its label. ``psi`` and ``w`` are those of
:mod:`.energy`. ``psi(alpha, alpha) = 0`` and ``psi`` obeys the triangle
inequality, so every edge's table is submodular and the least energy is a
minimum s-t cut.

The max-flow runs on integer capacities: the terms are scaled to fit 31
bits and rounded, so the cut it returns is least for the rounded terms.
Its energy is then worked out again in float64 from the terms as they are:
it lies at or above the exact least energy, never below it, by at most the
rounding's sum.
"""
from __future__ import annotations

import numpy as np
import torch

from .energy import FORWARD, NEIGHBORS

#: The largest capacity sum the integer max-flow is given.
CAP_SUM = float(2 ** 30)


class Move(dict):
    """The terms of one move, in float64: ``u0``, ``u1`` [S*S] unaries of
    keeping and of taking the proposal (the edges to the halo folded in),
    and the edges inside the window: flat pixel indices ``p``, ``q`` [E]
    and each edge's table ``tab`` [E, 4] (00, 01, 10, 11); ``n`` = S*S."""


def _psi(fp, fq, xs, ys, dx, dy, tau):
    """The truncated curvature between labels ``fp`` at (xs, ys) and ``fq``
    at (xs + dx, ys + dy), both [..., 4], in their floating type."""
    def d(f, x, y):
        return f[..., 0] * x + f[..., 1] * y + f[..., 2]
    curv = ((d(fp, xs, ys) - d(fq, xs, ys)).abs()
            + (d(fp, xs + dx, ys + dy) - d(fq, xs + dx, ys + dy)).abs())
    return curv.clamp(max=tau)


def move_terms(halo: np.ndarray, alpha: np.ndarray, tox: float, toy: float,
               u0: np.ndarray, u1: np.ndarray, weights: np.ndarray,
               lam: float, tau: float, dtype=torch.float64) -> Move:
    """The terms of the move on the window whose pixel (0, 0) lies at image
    coordinates (``tox``, ``toy``), computed in ``dtype`` (float64; the
    control computes them one precision lower) and returned in float64.

    ``halo`` [S+2, S+2, 4]: the labels of the window and its 1-px halo;
    ``alpha`` [4]; ``u0``, ``u1`` [S, S]: the unaries of keeping and of
    taking ``alpha``; ``weights`` [8, S+2, S+2]: the image's pairwise
    weights at the window and its halo (0 outside the image)."""
    t = lambda a: torch.as_tensor(np.asarray(a, np.float64)).to(dtype)
    s = halo.shape[0] - 2
    g = s + 2
    cur = t(halo)
    new = cur.clone()
    new[1:-1, 1:-1] = t(alpha)
    inside = torch.zeros((g, g), dtype=torch.bool)
    inside[1:-1, 1:-1] = True
    ys = t(toy - 1 + np.arange(g))[:, None].expand(g, g)
    xs = t(tox - 1 + np.arange(g))[None, :].expand(g, g)
    idx = torch.full((g, g), -1, dtype=torch.int64)
    idx[1:-1, 1:-1] = torch.arange(s * s).reshape(s, s)
    wts = t(weights)
    t0 = t(u0).reshape(-1).clone()
    t1 = t(u1).reshape(-1).clone()
    edges = []
    for k in FORWARD:
        dx, dy = NEIGHBORS[k]
        py = slice(max(0, -dy), g - max(0, dy))
        px = slice(max(0, -dx), g - max(0, dx))
        qy = slice(py.start + dy, py.stop + dy)
        qx = slice(px.start + dx, px.stop + dx)
        w = lam * wts[k][py, px]
        x, y = xs[py, px], ys[py, px]
        cp, cq = cur[py, px], cur[qy, qx]
        np_, nq = new[py, px], new[qy, qx]
        tab = torch.stack([w * _psi(cp, cq, x, y, dx, dy, tau),
                           w * _psi(cp, nq, x, y, dx, dy, tau),
                           w * _psi(np_, cq, x, y, dx, dy, tau),
                           w * _psi(np_, nq, x, y, dx, dy, tau)], -1)
        ip, iq = inside[py, px], inside[qy, qx]
        both = ip & iq
        edges.append((idx[py, px][both], idx[qy, qx][both], tab[both]))
        only_p = ip & ~iq            # q in the halo keeps its label
        t0.index_add_(0, idx[py, px][only_p], tab[only_p][:, 0])
        t1.index_add_(0, idx[py, px][only_p], tab[only_p][:, 2])
        only_q = iq & ~ip            # p in the halo keeps its label
        t0.index_add_(0, idx[qy, qx][only_q], tab[only_q][:, 0])
        t1.index_add_(0, idx[qy, qx][only_q], tab[only_q][:, 1])
    f64 = lambda a: a.to(torch.float64).numpy()
    return Move(u0=f64(t0), u1=f64(t1),
                p=torch.cat([e[0] for e in edges]).numpy(),
                q=torch.cat([e[1] for e in edges]).numpy(),
                tab=f64(torch.cat([e[2] for e in edges])), n=s * s)


def energy(move: Move, x: np.ndarray) -> float:
    """E(x) in float64 of a mask ``x`` [S, S] (bool)."""
    x = np.asarray(x, bool).ravel()
    un = np.where(x, move["u1"], move["u0"]).sum()
    col = 2 * x[move["p"]].astype(np.int64) + x[move["q"]].astype(np.int64)
    pair = np.take_along_axis(move["tab"], col[:, None], 1).sum()
    return float(un + pair)


def min_cut(move: Move) -> np.ndarray:
    """The least-energy mask [S*S] (bool) of the move, by a max-flow on
    its terms rounded to integers (module docstring)."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import breadth_first_order, maximum_flow

    n = move["n"]
    tab = move["tab"]
    a, b, c, d = tab[:, 0], tab[:, 1], tab[:, 2], tab[:, 3]
    u0 = move["u0"].copy()
    u1 = move["u1"].copy()
    # E(xp, xq) = A + (C - A) xp + (D - C) xq + (B + C - A - D) (1 - xp) xq
    np.add.at(u1, move["p"], c - a)
    np.add.at(u1, move["q"], d - c)
    pair = np.maximum(b + c - a - d, 0.0)
    # A pixel whose unary outweighs all its edges is decided by its unary:
    # cap its t-link there, so that a 1e6 cost does not set the scale.
    incident = np.zeros(n)
    np.add.at(incident, move["p"], pair)
    np.add.at(incident, move["q"], pair)
    diff = np.clip(u1 - u0, -(incident + 1.0), incident + 1.0)
    src = np.maximum(diff, 0.0)              # cut where the pixel takes alpha
    snk = np.maximum(-diff, 0.0)             # cut where it keeps its label
    total = src.sum() + snk.sum() + pair.sum()
    scale = CAP_SUM / max(total, 1e-30)
    s_node, t_node = n, n + 1
    rows = np.concatenate([np.full(n, s_node), np.arange(n), move["p"]])
    cols = np.concatenate([np.arange(n), np.full(n, t_node), move["q"]])
    caps = np.rint(np.concatenate([src, snk, pair]) * scale).astype(np.int64)
    keep = caps > 0
    graph = csr_matrix((caps[keep].astype(np.int32),
                        (rows[keep], cols[keep])), shape=(n + 2, n + 2))
    graph.sum_duplicates()
    flow = maximum_flow(graph, s_node, t_node).flow
    residual = (graph - flow).tocsr()
    residual.data = (residual.data > 0).astype(np.int32)
    residual.eliminate_zeros()
    reach = breadth_first_order(residual, s_node, directed=True,
                                return_predecessors=False)
    x = np.ones(n + 2, bool)
    x[reach] = False                          # the source's side keeps
    return x[:n]


def gap(move: Move, x: np.ndarray) -> float:
    """How far mask ``x``'s energy lies above the reference's cut's, in
    the move's energy units (float64)."""
    return energy(move, x) - energy(move, min_cut(move))
