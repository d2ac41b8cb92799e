"""Batched binary submodular min-cut on grid regions (parallel push-relabel),
plain PyTorch (counterpart of ``localexpstereo_tpu.ops.mincut``).

The graph is implicit: 4 forward-neighbor capacity planes per region, the
terminal capacities folded into per-node excess (``e = max(sigma - tau, 0)``,
``cap_t = max(tau - sigma, 0)``). Pushes and relabels alternate in Jacobi
phases (each node pushes along at most one admissible direction per
sweep), and a periodic global relabel recomputes exact residual distances
to the sink by min-plus BFS to a fixpoint. The accepted set is the source
side: the nodes that cannot reach the sink in the final residual graph
(BK's ``what_segment == SOURCE``, ``FastGCStereo.h:553-559``).

The core keeps the fused kernel's state: backward residuals are rebuilt as
``fw0 - cap_fw`` (reverse capacities start at 0), as in
``mincut_pallas._solver_core``; the CUDA kernel
(``csrc/expansion_accept.cu``) runs the same phases per region.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import pairwise

#: (dx, dy) of the 4 forward edge directions, in table order (GE, EG, LG, GG).
EDGE_DIRS = tuple(pairwise.NEIGHBORS[k] for k in pairwise.FORWARD)

INF = 3e38
EPS = 1e-7
#: The 8 push directions from p: 4 forward edges, then the 4 reversed.
_DIRS8 = EDGE_DIRS + tuple((-dx, -dy) for dx, dy in EDGE_DIRS)


def shift(x: torch.Tensor, dx: int, dy: int, fill: float) -> torch.Tensor:
    """[N, S, S] -> value at p + (dx, dy), ``fill`` outside the window."""
    return _neighbors(x, fill)(dx, dy)


def edge_masks(s: int, device=None) -> torch.Tensor:
    """[4, S, S] float32: edge (p, p + dir) lies inside the window."""
    iy = torch.arange(s, device=device)[:, None]
    ix = torch.arange(s, device=device)[None, :]
    return torch.stack([((ix + dx >= 0) & (ix + dx < s) & (iy + dy >= 0)
                         & (iy + dy < s)).to(torch.float32)
                        for dx, dy in EDGE_DIRS])


def build_graph(t0: torch.Tensor, t1: torch.Tensor, c00: torch.Tensor,
                c01: torch.Tensor, c10: torch.Tensor):
    """Folds unary + pairwise tables into (excess, sink cap, edge caps)
    (``FastGCStereo.h:479-551``): per forward edge with table (D, C, B, 0),
    capacity ``max(0, B + C - D)``, source-cap shifts C at p and D - C at q.

    Args:
      t0, t1: [N, S, S] cost of keeping / switching each pixel.
      c00, c01, c10: [N, 4, S, S] pairwise tables.
    Returns:
      e, cap_t: [N, S, S]; cap_fw: [N, 4, S, S].
    """
    em = edge_masks(t0.shape[-1], t0.device)
    sigma = t0
    cap_fw = []
    for k, (dx, dy) in enumerate(EDGE_DIRS):
        c = c01[:, k] * em[k]
        d_minus_c = (c00[:, k] - c01[:, k]) * em[k]
        sigma = sigma + c + shift(d_minus_c, -dx, -dy, 0.0)
        cap = torch.clamp((c10[:, k] + c01[:, k]) - c00[:, k], min=0.0)
        cap_fw.append(cap * em[k])
    nu = sigma - t1
    return (torch.clamp(nu, min=0.0), torch.clamp(-nu, min=0.0),
            torch.stack(cap_fw, dim=1))


def _out_caps(fw0, capfw):
    """Residual capacity from p outward along the 8 directions: 4 forward
    (cap_fw at p), then 4 backward (fw0 - cap_fw at p - dir)."""
    outs = [(capfw[k], dx, dy) for k, (dx, dy) in enumerate(EDGE_DIRS)]
    for k, (dx, dy) in enumerate(EDGE_DIRS):
        outs.append((shift(fw0[k] - capfw[k], -dx, -dy, 0.0), -dx, -dy))
    return outs


def _neighbors(x: torch.Tensor, fill: float):
    """View of x at p + (dx, dy) (``fill`` outside), from one padded copy:
    ``at(dx, dy)`` equals ``shift(x, dx, dy, fill)``."""
    s0, s1 = x.shape[-2], x.shape[-1]
    xp = F.pad(x, (1, 1, 1, 1), value=fill)

    def at(dx, dy):
        return xp[..., 1 + dy:1 + dy + s0, 1 + dx:1 + dx + s1]
    return at


def _bfs(capt, fw0, capfw, hmax: float) -> torch.Tensor:
    """Exact residual distance to the sink (min-plus relaxation to its
    unique fixpoint); unreachable nodes get ``hmax``."""
    # nb + 1 where the residual edge exists, else >= INF (never the min).
    step = torch.where(torch.stack([c for c, _, _ in
                                    _out_caps(fw0, capfw)]) > EPS, 1.0, INF)
    d = torch.where(capt > EPS, 1.0, INF)
    while True:
        at = _neighbors(d, INF)
        nb = torch.stack([at(dx, dy) for dx, dy in _DIRS8])
        best = torch.minimum(d, (nb + step).amin(0))
        if not bool((best < d).any()):
            break
        d = best
    return torch.where(d >= INF, hmax, d)


def _sweep(fw0, e, h, capt, capfw, hmax: float):
    """One Jacobi push phase, flow application and relabel phase. The 8
    directions are stacked on a leading axis; every reduction over it is
    exact (a min, or a sum with at most one non-zero term), and the inflow
    keeps the reference's addition order."""
    h_at = _neighbors(h, hmax)
    nb_h = torch.stack([h_at(dx, dy) for dx, dy in _DIRS8])
    caps = torch.stack([c for c, _, _ in _out_caps(fw0, capfw)])
    active = (e > EPS) & (h < hmax)
    # Admissible pushes in priority order (sink, 4 forward, 4 backward);
    # each node takes the first one.
    adm = torch.cat([(active & (capt > EPS) & (h == 1.0))[None],
                     active & (caps > EPS) & (h == nb_h + 1.0)])
    first = adm & (torch.cumsum(adm, 0) == 1)
    flows = torch.where(first, torch.minimum(e, torch.cat([capt[None], caps])),
                        0.0)
    capt = capt - flows[0]
    outflow = flows.sum(0)
    inflow = torch.zeros_like(e)
    new_fw = []
    for k, (dx, dy) in enumerate(EDGE_DIRS):
        new_fw.append(capfw[k] - flows[1 + k])
        inflow = inflow + shift(flows[1 + k], -dx, -dy, 0.0)
    for k, (dx, dy) in enumerate(EDGE_DIRS):
        fr = shift(flows[5 + k], dx, dy, 0.0)
        new_fw[k] = new_fw[k] + fr
        inflow = inflow + fr
    e = e - outflow + inflow
    capfw = new_fw

    active = (e > EPS) & (h < hmax)
    caps = torch.stack([c for c, _, _ in _out_caps(fw0, capfw)])
    best = torch.minimum(torch.where(capt > EPS, 0.0, INF),
                         torch.where(caps > EPS, nb_h, INF).amin(0))
    could_push = best <= h - 1.0
    new_h = torch.where(best >= INF, hmax, torch.clamp(best + 1.0, max=hmax))
    h = torch.where(active & (~could_push), torch.maximum(h, new_h), h)
    return e, h, capt, capfw


def solve_preflow(e: torch.Tensor, capt: torch.Tensor, cap_fw: torch.Tensor,
                  max_global_rounds: int, sweeps_per_round: int):
    """Runs the preflow until no active node can reach the sink or the
    round cap is hit; returns the [N, S, S] bool accept mask.

    A round is a global relabel, then up to ``sweeps_per_round`` sweeps
    while any node is active. The loops test the whole batch; a region
    that has converged does nothing in later rounds, so this equals the
    CUDA kernel's per-region loops.
    """
    s = e.shape[-1]
    hmax = float(s * s + 2)
    fw0 = [cap_fw[:, k] for k in range(4)]
    capfw = list(fw0)
    h = torch.zeros_like(e)
    rounds = 0
    live = True
    while live and rounds < max_global_rounds:
        h = _bfs(capt, fw0, capfw, hmax)
        live = bool(((e > EPS) & (h < hmax)).any())
        k = 0
        while k < sweeps_per_round and bool(((e > EPS) & (h < hmax)).any()):
            e, h, capt, capfw = _sweep(fw0, e, h, capt, capfw, hmax)
            k += 1
        rounds += 1
    return _bfs(capt, fw0, capfw, hmax) >= hmax


def mincut_accept(t0, t1, c00, c01, c10, max_global_rounds: int = 64,
                  sweeps_per_round: int = 16) -> torch.Tensor:
    """Solves the batched expansion move; accept[p] == True means pixel p
    takes the proposal (source side)."""
    e, cap_t, cap_fw = build_graph(t0, t1, c00, c01, c10)
    return solve_preflow(e, cap_t, cap_fw, max_global_rounds,
                         sweeps_per_round)


def move_energy_delta(accept: torch.Tensor, t0, t1, c00, c01, c10):
    """Exact region energy change [N] of applying ``accept``: the
    monotonicity guard (cf. ``FastGCStereo.h:561-594``)."""
    em = edge_masks(t0.shape[-1], t0.device)
    x = accept.to(torch.float32)
    delta = torch.sum((t1 - t0) * x, dim=(-2, -1))
    for k, (dx, dy) in enumerate(EDGE_DIRS):
        xq = shift(x, dx, dy, 0.0)
        pair = (c00[:, k] * (1 - x) * (1 - xq) + c01[:, k] * (1 - x) * xq
                + c10[:, k] * x * (1 - xq))
        delta = delta + torch.sum((pair - c00[:, k]) * em[k], dim=(-2, -1))
    return delta


def greedy_accept(current_cost: torch.Tensor,
                  proposal_cost: torch.Tensor) -> torch.Tensor:
    """PatchMatch-style per-pixel acceptance of the greedy sweeps
    (``updateMask = current > proposal``, ``FastGCStereo.h:57``)."""
    return proposal_cost < current_cost
