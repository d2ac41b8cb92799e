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

:func:`build_graph` folds an expansion move's tables, whose cost11 is 0;
:func:`build_fusion_graph` a fusion move's, truncating its non-submodular
edges. The core keeps the fused kernel's state: backward residuals are
rebuilt as ``fw0 - cap_fw`` (reverse capacities start at 0), as in
``mincut_pallas._solver_core``; the CUDA kernels
(``csrc/expansion_accept.cu``, ``csrc/mincut_accept.cu``) run the same
phases per region, from one core (``csrc/push_relabel.cuh``).
"""
from __future__ import annotations

from typing import Optional

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


def build_fusion_graph(t0: torch.Tensor, t1: torch.Tensor, c00: torch.Tensor,
                       c01: torch.Tensor, c10: torch.Tensor,
                       c11: torch.Tensor):
    """Graph of the fusion move (``fusionMoveBK``, ``FastGCStereo.h:241-410``):
    per forward edge with table (D, C, B, E), source-cap shifts C - E at p
    and D - C + E at q, sink-cap shift E at q, capacity
    ``max(0, B + C - D - E)`` (the reference's clamp of non-submodular
    edges). Returns (e, cap_t, cap_fw) as :func:`build_graph` does."""
    em = edge_masks(t0.shape[-1], t0.device)
    sigma, tau = t0, t1
    cap_fw = []
    for k, (dx, dy) in enumerate(EDGE_DIRS):
        cme = (c01[:, k] - c11[:, k]) * em[k]
        dce = (c00[:, k] - c01[:, k] + c11[:, k]) * em[k]
        sigma = sigma + cme + shift(dce, -dx, -dy, 0.0)
        tau = tau + shift(c11[:, k] * em[k], -dx, -dy, 0.0)
        cap = torch.clamp((c10[:, k] + c01[:, k]) - c00[:, k] - c11[:, k],
                          min=0.0)
        cap_fw.append(cap * em[k])
    nu = sigma - tau
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


def _bfs(capt, fw0, capfw, hmax: float, passes=None) -> torch.Tensor:
    """Exact residual distance to the sink (min-plus relaxation to its
    unique fixpoint); unreachable nodes get ``hmax``. ``passes`` ([N]
    int64), if given, counts each region's relaxation passes up to and
    including its first that changes nothing."""
    # nb + 1 where the residual edge exists, else >= INF (never the min).
    step = torch.where(torch.stack([c for c, _, _ in
                                    _out_caps(fw0, capfw)]) > EPS, 1.0, INF)
    d = torch.where(capt > EPS, 1.0, INF)
    if passes is not None:
        passes += 1
    while True:
        at = _neighbors(d, INF)
        nb = torch.stack([at(dx, dy) for dx, dy in _DIRS8])
        best = torch.minimum(d, (nb + step).amin(0))
        changed = best < d
        if passes is not None:
            passes += changed.flatten(1).any(1)
        if not bool(changed.any()):
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
                  max_global_rounds: int, sweeps_per_round: int,
                  stats: Optional[dict] = None):
    """Runs the preflow until no active node can reach the sink or the
    round cap is hit; returns the [N, S, S] bool accept mask.

    A round is a global relabel, then up to ``sweeps_per_round`` sweeps
    while any node is active. The loops test the whole batch; a region
    that has converged does nothing in later rounds, so this equals the
    CUDA kernels' per-region loops. ``stats``, if given, receives each
    region's work in those per-region loops as [N] int64 tensors:
    "rounds", "bfs_passes" (relaxation passes of every global relabel,
    the final one included) and "sweeps"; and "active_left", the nodes
    left with excess that can still reach the sink after the final global
    relabel. ``active_left == 0`` is the exactness certificate: the
    preflow is maximal, so the cut is a minimum cut; a region the round
    cap truncated has ``active_left > 0``.
    """
    n, s = e.shape[0], e.shape[-1]
    hmax = float(s * s + 2)
    fw0 = [cap_fw[:, k] for k in range(4)]
    capfw = list(fw0)
    h = torch.zeros_like(e)
    count = stats is not None
    if count:
        for k in ("rounds", "bfs_passes", "sweeps"):
            stats[k] = torch.zeros(n, dtype=torch.int64, device=e.device)
        in_loop = torch.ones(n, dtype=torch.bool, device=e.device)
    rounds = 0
    live = True
    while live and rounds < max_global_rounds:
        passes = torch.zeros_like(stats["bfs_passes"]) if count else None
        h = _bfs(capt, fw0, capfw, hmax, passes)
        active = ((e > EPS) & (h < hmax)).flatten(1).any(1)
        if count:
            stats["rounds"] += in_loop
            stats["bfs_passes"] += passes * in_loop
            in_loop &= active
        live = bool(active.any())
        k = 0
        while k < sweeps_per_round and live:
            if count:
                stats["sweeps"] += active
            e, h, capt, capfw = _sweep(fw0, e, h, capt, capfw, hmax)
            active = ((e > EPS) & (h < hmax)).flatten(1).any(1)
            if not bool(active.any()):
                break
            k += 1
        rounds += 1
    dist = _bfs(capt, fw0, capfw, hmax,
                stats["bfs_passes"] if count else None)
    if count:
        stats["active_left"] = ((e > EPS) & (dist < hmax)).flatten(1).sum(1)
    return dist >= hmax


def mincut_accept(t0, t1, c00, c01, c10, max_global_rounds: int = 64,
                  sweeps_per_round: int = 16, with_stats: bool = False):
    """Solves the batched expansion move; accept[p] == True means pixel p
    takes the proposal (source side). With ``with_stats``, returns
    (accept, rounds, active_left) as the JAX package's ``mincut_accept``
    does: the batch's global-relabel rounds and its nodes left active
    (0 certifies every region's cut exact), as int64 scalar tensors."""
    e, cap_t, cap_fw = build_graph(t0, t1, c00, c01, c10)
    stats = {} if with_stats else None
    accept = solve_preflow(e, cap_t, cap_fw, max_global_rounds,
                           sweeps_per_round, stats)
    if with_stats:
        return accept, stats["rounds"].max(), stats["active_left"].sum()
    return accept


def move_energy_delta(accept: torch.Tensor, t0, t1, c00, c01, c10):
    """Exact region energy change [N] of applying ``accept``: the
    monotonicity guard (cf. ``FastGCStereo.h:561-594``)."""
    return _energy_delta(accept, t0, t1, (c00, c01, c10))


def fusion_move_energy_delta(accept: torch.Tensor, t0, t1, c00, c01, c10,
                             c11):
    """:func:`move_energy_delta` of a fusion move, whose cost11 is not
    identically zero (``StereoEnergy.h:331-394``): the guard of the fusion
    sweep, where truncated non-submodular edges make the cut approximate."""
    return _energy_delta(accept, t0, t1, (c00, c01, c10, c11))


def _energy_delta(accept, t0, t1, tables):
    """Energy change of ``accept`` against all-keep, with the pairwise
    tables (c00, c01, c10[, c11]) summed in that order. The unary change
    counts on accepted pixels only, selected rather than multiplied by the
    mask (as the JAX engine's compiled guard does): the same sum for finite
    unaries, and a non-finite one outside the accepted pixels (the
    quadratic interpolation's degenerate taps) leaves the delta finite."""
    em = edge_masks(t0.shape[-1], t0.device)
    x = accept.to(torch.float32)
    delta = torch.sum(torch.where(accept, t1 - t0, 0.0), dim=(-2, -1))
    for k, (dx, dy) in enumerate(EDGE_DIRS):
        xq = shift(x, dx, dy, 0.0)
        states = ((1 - x) * (1 - xq), (1 - x) * xq, x * (1 - xq), x * xq)
        pair = tables[0][:, k] * states[0]
        for tbl, st in zip(tables[1:], states[1:]):
            pair = pair + tbl[:, k] * st
        delta = delta + torch.sum((pair - tables[0][:, k]) * em[k],
                                  dim=(-2, -1))
    return delta


def greedy_accept(current_cost: torch.Tensor,
                  proposal_cost: torch.Tensor) -> torch.Tensor:
    """PatchMatch-style per-pixel acceptance of the greedy sweeps
    (``updateMask = current > proposal``, ``FastGCStereo.h:57``)."""
    return proposal_cost < current_cost
