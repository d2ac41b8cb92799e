"""Audits the graph-cut round caps of the port's CUDA kernels against the
exact min cut, on one CUDA card (the port of the JAX package's
``tools/gc_cap_audit.py``)::

    python -m localexpstereo_tpu_torch.tools.gc_cap_audit [--instances 100]

The engine caps the push-relabel at 16 global-relabel rounds of 16 push
sweeps, 64 from S = 256 (``models/engine.mincut_knobs``), where the
reference runs BK's max flow to its end (``FastGCStereo.h:553-559``). A
truncated preflow gives a cut that is not minimal (the energy guard still
keeps the move monotone). The solve's own certificate tells: a preflow
that ends with no node left with excess that can still reach the sink
(``active_left == 0``, ``ops/mincut.solve_preflow``'s stats) is maximal,
so its cut is a minimum cut. Dinic's max flow (``native.grid_mincut_oracle``)
checks it independently.

For each (S, sweeps) of the main path's move windows, (42, 16), (129, 16)
and (387, 64):

- ``tables``: ``--instances`` random submodular expansion problems in each
  of the five :data:`REGIMES` through ``mincut_cuda.mincut_accept`` (the
  kernel ``mincut_accept``) under the engine's caps and with 64 rounds,
  and through the plain twin on the card (rounds used, ``active_left``);
  each cut's region energy against Dinic's;
- ``expansion``: ``--instances`` fused moves
  (``utils/synthetic.fused_move_problem``) through ``expansion_accept``
  (the kernel ``expansion_accept``, its energy guard included) under the
  same caps and with 64 rounds, the plain twin on the graph that
  ``mincut_cuda.fused_terms`` -> ``mincut.build_graph`` gives, and Dinic
  on that graph;
- ``fusion``: ``--instances`` fusion graphs (``fusion_terms`` ->
  ``build_fusion_graph``) through ``solve_graph`` at the fusion move's
  caps (``FUSION_ROUNDS`` of ``FUSION_SWEEPS``): the cut's capacity on the
  graph against Dinic's max flow.

Prints the card's name and power limit, then one JSON line per (part, S,
regime): instances, the most rounds used, the truncated instances
(``active_left > 0``), the masks that differ from the 64-round solve's and
from the plain twin's, the largest relative energy or cut-capacity gap to
Dinic and the instances outside ``RTOL`` / ``ATOL`` of it; then a summary
line. Exits 1 if any check fails, 2 without a card. Writes no file.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from .. import native
from ..models import engine
from ..ops import mincut, mincut_cuda
from ..utils import synthetic

#: (tau, lam, pairwise scale, unary scale), the JAX audit's regimes: the
#: engine-typical one, the V3 preset's lambda, a pairwise-dominated one
#: (long augmenting paths, the hard case for max flow), a unary-dominated
#: one and extreme smoothness.
REGIMES = [
    (1.0, 1.0, 1.0, 5.0),
    (1.0, 0.5, 1.0, 5.0),
    (3.0, 1.0, 2.0, 1.0),
    (1.0, 1.0, 0.2, 20.0),
    (5.0, 2.0, 4.0, 2.0),
]
#: The regimes the JAX package's tests/test_gc_caps.py certifies exact at
#: the capped budget.
CERTIFIED = (0, 2)
#: The audit's window sizes (the main path's S) with the engine's sweeps.
LEGS = tuple((s, engine.mincut_knobs(s)[1]) for s in (42, 129, 387))
#: The engine's round cap, and the conservative solve held against it.
ROUNDS, EXACT_ROUNDS = engine.mincut_knobs(42)[0], 64
#: A cut against Dinic's: |got - want| <= max(RTOL |want|, ATOL), on the
#: region energy or on the cut capacity (tests/test_gc_caps.py).
RTOL, ATOL = 1e-5, 1e-2
#: Instances a batch, by S.
BATCH = {42: 100, 129: 50, 387: 10}


def random_problem(rng, n, s, tau, lam, scale, unary_scale):
    """Engine-shaped expansion tables (t0, t1 [n, s, s]; c00, c01, c10
    [n, 4, s, s], float32 numpy): submodular curvature structure from random
    disparity fields (the JAX audit's construction, draw for draw)."""
    w = rng.random((n, 4, s, s)).astype(np.float32) * scale
    d = [rng.random((n, 4, s, s)).astype(np.float32) * 3 for _ in range(6)]
    d_cur_p, d_cur_q, d_nb_p, d_nb_q, d_pr_p, d_pr_q = d

    def psi(a_p, a_q, b_p, b_q):
        return w * np.minimum(np.abs(a_p - b_p) + np.abs(a_q - b_q),
                              tau) * lam

    c00 = psi(d_cur_p, d_cur_q, d_nb_p, d_nb_q)
    c01 = psi(d_cur_p, d_cur_q, d_pr_p, d_pr_q)
    c10 = psi(d_pr_p, d_pr_q, d_nb_p, d_nb_q)
    t0 = (rng.random((n, s, s)) * unary_scale).astype(np.float32)
    t1 = (rng.random((n, s, s)) * unary_scale).astype(np.float32)
    return t0, t1, c00, c01, c10


def region_energy(x, t0, t1, c00, c01, c10):
    """[N] energies of binary labelings x [N, S, S] (True: take the
    proposal) under the expansion tables (cost11 = 0), in numpy."""
    e = np.where(x, t1, t0).sum(axis=(-2, -1))
    s = x.shape[-1]
    for k, (dx, dy) in enumerate(mincut.EDGE_DIRS):
        # p ranges over pixels with an in-window neighbor q = p + (dx, dy).
        py = slice(max(0, -dy), s - max(0, dy))
        px = slice(max(0, -dx), s - max(0, dx))
        qy = slice(max(0, dy), s + min(0, dy))
        qx = slice(max(0, dx), s + min(0, dx))
        xp = x[:, py, px]
        xq = x[:, qy, qx]
        c = np.stack([c00[:, k, py, px], c01[:, k, py, px],
                      c10[:, k, py, px]], 0)
        idx = np.where(~xp & ~xq, 0, np.where(~xp & xq, 1, np.where(
            xp & ~xq, 2, -1)))
        pick = np.take_along_axis(c, np.maximum(idx, 0)[None], 0)[0]
        e = e + np.where(idx >= 0, pick, 0.0).sum(axis=(-2, -1))
    return e


def cut_capacity(accept, e, cap_t, cap_fw):
    """[N] float64 capacity of the cut that puts ``accept`` [N, S, S] on
    the source side of the graph (e, cap_t [N, S, S]; cap_fw [N, 4, S, S]):
    the source edges of the sink side, the sink edges of the source side
    and the grid edges from the source side to the sink side."""
    a = np.asarray(accept, bool)
    e, cap_t, cap_fw = (np.asarray(v, np.float64) for v in (e, cap_t, cap_fw))
    total = np.where(a, cap_t, e).sum(axis=(-2, -1))
    s = a.shape[-1]
    for k, (dx, dy) in enumerate(mincut.EDGE_DIRS):
        py = slice(max(0, -dy), s - max(0, dy))
        px = slice(max(0, -dx), s - max(0, dx))
        qy = slice(max(0, dy), s + min(0, dy))
        qx = slice(max(0, dx), s + min(0, dx))
        cut = a[:, py, px] & ~a[:, qy, qx]
        total = total + np.where(cut, cap_fw[:, k, py, px], 0.0).sum(
            axis=(-2, -1))
    return total


def oracle(graph, threads: int = 0):
    """Dinic on every region of ``graph`` (e, cap_t, cap_fw as
    ``mincut.build_graph`` returns them, on any device): (accept [N, S, S]
    bool, max flow [N] float64) in numpy, the regions solved in parallel on
    ``threads`` host threads (default: the CPU count)."""
    e, cap_t, cap_fw = (x.detach().cpu().numpy() if torch.is_tensor(x)
                        else np.asarray(x) for x in graph)
    with concurrent.futures.ThreadPoolExecutor(
            threads or os.cpu_count() or 1) as pool:
        cuts = list(pool.map(native.grid_mincut_oracle, e, cap_t, cap_fw))
    return (np.stack([a for a, _ in cuts]),
            np.array([f for _, f in cuts], np.float64))


def gaps(got, want):
    """(largest |got - want| / max(|want|, 1), instances outside
    max(RTOL |want|, ATOL)) of two [N] arrays."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    diff = np.abs(got - want)
    rel = diff / np.maximum(np.abs(want), 1.0)
    outside = diff > np.maximum(RTOL * np.abs(want), ATOL)
    return float(rel.max(initial=0.0)), int(outside.sum())


def _host(xs):
    return [x.cpu().numpy() for x in xs]


def _stats(graph, rounds, sweeps):
    """The plain twin's solve of ``graph`` with its per-region stats."""
    stats = {}
    accept = mincut.solve_preflow(*graph, rounds, sweeps, stats)
    return accept, stats


def _row(part, s, sweeps, rounds, counts):
    return {"part": part, "S": s, "rounds": rounds, "sweeps": sweeps,
            **counts}


def _differ(a, b) -> int:
    """Regions whose [N, S, S] masks differ."""
    return int((a != b).flatten(1).any(1).sum())


def _tally(counts, n, stats, capped, exact, plain, gap):
    """Adds a batch to ``counts``; ``exact`` is the 64-round solve's masks
    (None where the caps are 64 rounds already)."""
    counts["instances"] += n
    counts["max_rounds"] = max(counts["max_rounds"],
                               int(stats["rounds"].max()))
    counts["truncated"] += int((stats["active_left"] > 0).sum())
    if exact is not None:
        counts["mismatch_64"] += _differ(capped, exact)
    counts["mismatch_plain"] += _differ(capped, plain)
    counts["max_gap_vs_dinic"] = max(counts["max_gap_vs_dinic"], gap[0])
    counts["outside_dinic"] += gap[1]


def _counts():
    return {"instances": 0, "max_rounds": 0, "truncated": 0,
            "mismatch_64": 0, "mismatch_plain": 0, "max_gap_vs_dinic": 0.0,
            "outside_dinic": 0}


def audit_tables(s, sweeps, regime, instances, device="cuda", seed=0):
    """The ``tables`` part at one (S, regime): a row of counts."""
    rng = np.random.default_rng(seed + 1000 * regime + s)
    counts = _counts()
    t0 = time.perf_counter()
    while counts["instances"] < instances:
        n = min(BATCH[s], instances - counts["instances"])
        arrays = random_problem(rng, n, s, *REGIMES[regime])
        tables = [torch.as_tensor(a, device=device) for a in arrays]
        capped = mincut_cuda.mincut_accept(*tables, max_global_rounds=ROUNDS,
                                           sweeps_per_round=sweeps)
        exact = mincut_cuda.mincut_accept(
            *tables, max_global_rounds=EXACT_ROUNDS, sweeps_per_round=sweeps)
        graph = mincut.build_graph(*tables)
        plain, stats = _stats(graph, ROUNDS, sweeps)
        dinic, _ = oracle(graph)
        got = region_energy(capped.cpu().numpy(), *arrays)
        want = region_energy(dinic, *arrays)
        _tally(counts, n, stats, capped, exact, plain, gaps(got, want))
    return _row("tables", s, sweeps, ROUNDS,
                {"regime": regime, "tau_lam_scale_uscale": REGIMES[regime],
                 **counts, "seconds": time.perf_counter() - t0})


def audit_expansion(s, sweeps, instances, device="cuda", seed=0):
    """The ``expansion`` part at one S: a row of counts."""
    rng = np.random.default_rng(seed + 7 * s)
    counts = _counts()
    t0 = time.perf_counter()
    while counts["instances"] < instances:
        n = min(BATCH[s], instances - counts["instances"])
        arrays, lam, tau = synthetic.fused_move_problem(rng, n, s)
        args = [torch.as_tensor(a, device=device) for a in arrays]
        kw = dict(lam=lam, tau=tau, sweeps_per_round=sweeps)
        capped = mincut_cuda.expansion_accept(*args, max_global_rounds=ROUNDS,
                                              **kw)
        exact = mincut_cuda.expansion_accept(
            *args, max_global_rounds=EXACT_ROUNDS, **kw)
        c00, c01, c10, t0_, t1_ = mincut_cuda.fused_terms(*args, lam, tau)
        tables = _host((t0_, t1_, c00, c01, c10))
        graph = mincut.build_graph(t0_, t1_, c00, c01, c10)
        plain, stats = _stats(graph, ROUNDS, sweeps)
        # The kernel's mask is after its energy guard; so is the twin's.
        delta = mincut.move_energy_delta(plain, t0_, t1_, c00, c01, c10)
        plain = plain & (delta <= 0.0)[:, None, None]
        dinic, _ = oracle(graph)
        got = region_energy(capped.cpu().numpy(), *tables)
        want = region_energy(dinic, *tables)
        _tally(counts, n, stats, capped, exact, plain, gaps(got, want))
    return _row("expansion", s, sweeps, ROUNDS,
                {**counts, "seconds": time.perf_counter() - t0})


def audit_fusion(s, instances, device="cuda", seed=0):
    """The ``fusion`` part at one S: a row of counts (the gap is the cut
    capacity's to Dinic's max flow)."""
    rng = np.random.default_rng(seed + 11 * s)
    rounds, sweeps = mincut_cuda.FUSION_ROUNDS, mincut_cuda.FUSION_SWEEPS
    counts = _counts()
    t0 = time.perf_counter()
    while counts["instances"] < instances:
        n = min(BATCH[s], instances - counts["instances"])
        arrays, lam, tau = synthetic.fusion_move_problem(rng, n, s)
        terms = mincut_cuda.fusion_terms(
            *[torch.as_tensor(a, device=device) for a in arrays], lam, tau)
        graph = [x.contiguous() for x in mincut.build_fusion_graph(*terms)]
        got = mincut_cuda.solve_graph(*graph, max_global_rounds=rounds,
                                      sweeps_per_round=sweeps)
        plain, stats = _stats(graph, rounds, sweeps)
        _, flow = oracle(graph)
        cut = cut_capacity(got.cpu().numpy(), *_host(graph))
        _tally(counts, n, stats, got, None, plain, gaps(cut, flow))
    return _row("fusion", s, sweeps, rounds,
                {**counts, "seconds": time.perf_counter() - t0})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--instances", type=int, default=100,
                    help="instances a (part, S, regime) (default 100)")
    ns = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("gc_cap_audit: needs a CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    rows = []
    for s, sweeps in LEGS:
        for regime in range(len(REGIMES)):
            rows.append(audit_tables(s, sweeps, regime, ns.instances))
            print(json.dumps(rows[-1]), flush=True)
        rows.append(audit_expansion(s, sweeps, ns.instances))
        print(json.dumps(rows[-1]), flush=True)
        rows.append(audit_fusion(s, ns.instances))
        print(json.dumps(rows[-1]), flush=True)
    summary = {key: sum(r[key] for r in rows) for key in (
        "instances", "truncated", "mismatch_64", "mismatch_plain",
        "outside_dinic")}
    summary["max_rounds"] = max(r["max_rounds"] for r in rows)
    summary["max_gap_vs_dinic"] = max(r["max_gap_vs_dinic"] for r in rows)
    summary["ok"] = (summary["truncated"] == summary["mismatch_64"]
                     == summary["outside_dinic"] == 0)
    print(json.dumps({"summary": summary}), flush=True)
    return 0 if summary["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
