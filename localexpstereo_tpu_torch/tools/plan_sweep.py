"""Times the port's kernels under the card's launch plan and under other
plans, at the main path's shapes, on one CUDA card::

    python -m localexpstereo_tpu_torch.tools.plan_sweep

Inputs are those of ``chip_smoke.py``'s kernel phases: random fused-move
problems (16 rounds, 16 / 16 / 64 sweeps) for ``expansion_accept`` and
fusion graphs (64 rounds of 16 sweeps) for ``mincut_accept``, at (S, N) =
(42, 468), (129, 54), (387, 6); the windows of the 1436 x 992 x 145
problem for ``sample_windows``, at (F, N) = (62, 468), (149, 54), (407, 6),
raw and guided-filtered. Each plan's masks must equal the card plan's;
each plan's unary costs must agree with the card plan's within the
kernel's tolerance (2e-4 on supported positions filtered, 1e-6 raw), and
the share of bitwise-equal values is printed. Prints the card's name and
power limit, then one JSON line per (shape, plan): the plan, median
milliseconds of 5 calls of each kernel (CUDA events, after one warm-up
call).
"""
from __future__ import annotations

import dataclasses
import json
import subprocess

import numpy as np
import torch

from ..ops import boxfilter, mincut, mincut_cuda, unary_cuda
from ..utils import synthetic
from .unary_times import events_ms

SHAPES = ((42, 468, 16), (129, 54, 16), (387, 6, 64))  # (S, N, sweeps)
ROUNDS = 16
#: Plans timed beside the card's own: (K, threads, state) by window size.
VARIANTS = {
    42: ((1, 256, "shared"), (1, 1024, "shared"), (1, 1024, "global")),
    129: ((4, 1024, "banded"), (2, 512, "banded"), (1, 1024, "global")),
    387: ((16, 512, "banded"), (16, 1024, "global"), (8, 1024, "global"),
          (1, 1024, "global")),
}


#: Unary plans timed beside the card's own, filtered: (W, Hc) by window
#: size; raw: rows a block.
UNARY_VARIANTS = {
    62: ((32, 62), (62, 31), (62, 16)),
    149: ((149, 149), (64, 75), (32, 75), (64, 38)),
    407: ((128, 82), (64, 136), (32, 68), (64, 34)),
}
RAW_ROWS = (1, 4, 16)


def variant(s: int, k: int, threads: int, state: str) -> mincut_cuda.Plan:
    if k == 1:
        smem = s * s * mincut_cuda.SHARED_PX_BYTES if state == "shared" else 0
        return mincut_cuda.Plan(1, threads, smem, state, s)
    return dataclasses.replace(mincut_cuda.cluster_plan(s, k, state),
                               threads=threads)


def unary_sweep() -> None:
    """sample_windows under the card's plan and the variants, at the main
    path's windows (one color of each layer), raw and filtered."""
    solver, truth, _ = synthetic.bench_solver(1.0, "cuda")
    solver.finalize()
    data, cfg = solver.data, solver.cfg
    rng = np.random.default_rng(0)
    for layer in solver.layers:
        props, fox, foy, f = synthetic.unary_windows(solver, truth, layer,
                                                     rng)
        n = props.shape[0]
        it = torch.arange(f, device="cuda")
        ys = foy[:, None, None] + it[None, :, None]
        xs = fox[:, None, None] + it[None, None, :]
        inside = ((xs >= 0) & (xs < cfg.width) & (ys >= 0)
                  & (ys < cfg.height)).float()
        for r in (0, cfg.params.guided_radius):
            args = (data.vol[0], cfg.vol_pad, props, fox, foy, f,
                    cfg.height, cfg.width)
            kw = dict(min_disp=cfg.min_disp, th_col=cfg.params.th_col,
                      scale=cfg.vol_scale, zero=cfg.vol_zero,
                      stats=(data.guide[0], data.gf_mean[0], data.gf_inv[0]),
                      pad=cfg.pad, r_gf=r)
            card = unary_cuda.card_plan(f, n, r)
            want = unary_cuda.launch_windows(*args, **kw, plan=card)
            support = boxfilter.boxsum2d(inside, r) > 0.5
            others = ([unary_cuda.tile_plan(f, r, f, rows)
                       for rows in RAW_ROWS] if r == 0 else
                      [unary_cuda.tile_plan(f, r, w, rows)
                       for w, rows in UNARY_VARIANTS[f]])
            for plan in [card] + others:
                got = unary_cuda.launch_windows(*args, **kw, plan=plan)
                err = float((got - want).abs()[support].max())
                if not err <= (2e-4 if r else 1e-6):
                    raise AssertionError(f"plan {plan} changed the costs at "
                                         f"F={f}, r={r}: {err}")
                print(json.dumps({
                    "F": f, "N": n, "r_gf": r, "card": plan == card,
                    "plan": dataclasses.asdict(plan),
                    "blocks": plan.blocks(f, n), "max_abs_err": err,
                    "bitwise_equal": float((got == want)[support].double()
                                           .mean()),
                    "sample_windows_ms": events_ms(
                        lambda: unary_cuda.launch_windows(*args, **kw,
                                                          plan=plan))}),
                      flush=True)


def main() -> None:
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    unary_sweep()
    for s, n, sweeps in SHAPES:
        rng = np.random.default_rng(s)
        arrays, lam, tau = synthetic.fused_move_problem(rng, n, s)
        args = [torch.as_tensor(a, device="cuda") for a in arrays]
        kw = dict(lam=lam, tau=tau, max_global_rounds=ROUNDS,
                  sweeps_per_round=sweeps)
        arrays, lam, tau = synthetic.fusion_move_problem(
            np.random.default_rng(s), n, s)
        terms = mincut_cuda.fusion_terms(
            *[torch.as_tensor(a, device="cuda") for a in arrays], lam, tau)
        graph = [x.contiguous() for x in mincut.build_fusion_graph(*terms)]
        mkw = dict(max_global_rounds=mincut_cuda.FUSION_ROUNDS,
                   sweeps_per_round=mincut_cuda.FUSION_SWEEPS)
        card = mincut_cuda.card_plan("expansion_accept", s, n)
        want = mincut_cuda.launch_expansion(*args, plan=card, **kw)
        mwant = mincut_cuda.launch_mincut(*graph, plan=card, **mkw)
        for plan in [card] + [variant(s, *v) for v in VARIANTS[s]]:
            got = mincut_cuda.launch_expansion(*args, plan=plan, **kw)
            mgot = mincut_cuda.launch_mincut(*graph, plan=plan, **mkw)
            if not (torch.equal(got, want) and torch.equal(mgot, mwant)):
                raise AssertionError(f"plan {plan} changed the masks at "
                                     f"S={s}")
            print(json.dumps({
                "S": s, "N": n, "card": plan == card,
                "plan": dataclasses.asdict(plan),
                "expansion_ms": events_ms(lambda: mincut_cuda.launch_expansion(
                    *args, plan=plan, **kw)),
                "mincut_ms": events_ms(lambda: mincut_cuda.launch_mincut(
                    *graph, plan=plan, **mkw))}), flush=True)


if __name__ == "__main__":
    main()
