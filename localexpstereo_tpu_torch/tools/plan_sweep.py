"""Times both graph-cut kernels under the card's launch plan and under
other plans, at the main path's shapes, on one CUDA card::

    python -m localexpstereo_tpu_torch.tools.plan_sweep

Inputs are those of ``chip_smoke.py``'s kernel phases: random fused-move
problems (16 rounds, 16 / 16 / 64 sweeps) for ``expansion_accept`` and
fusion graphs (64 rounds of 16 sweeps) for ``mincut_accept``, at (S, N) =
(42, 468), (129, 54), (387, 6). Each plan's masks must equal the card
plan's. Prints the card's name and power limit, then one JSON line per
(shape, plan): the plan, median milliseconds of 5 calls of each kernel
(CUDA events, after one warm-up call).
"""
from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess

import numpy as np
import torch

from ..ops import mincut, mincut_cuda
from ..utils import synthetic

SHAPES = ((42, 468, 16), (129, 54, 16), (387, 6, 64))  # (S, N, sweeps)
ROUNDS = 16
#: Plans timed beside the card's own: (K, threads, state) by window size.
VARIANTS = {
    42: ((1, 256, "shared"), (1, 1024, "shared"), (1, 1024, "global")),
    129: ((4, 1024, "banded"), (2, 512, "banded"), (1, 1024, "global")),
    387: ((16, 512, "banded"), (16, 1024, "global"), (8, 1024, "global"),
          (1, 1024, "global")),
}


def variant(s: int, k: int, threads: int, state: str) -> mincut_cuda.Plan:
    if k == 1:
        smem = s * s * mincut_cuda.SHARED_PX_BYTES if state == "shared" else 0
        return mincut_cuda.Plan(1, threads, smem, state, s)
    return dataclasses.replace(mincut_cuda.cluster_plan(s, k, state),
                               threads=threads)


def time_ms(fn, reps: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def main() -> None:
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
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
                "expansion_ms": time_ms(lambda: mincut_cuda.launch_expansion(
                    *args, plan=plan, **kw)),
                "mincut_ms": time_ms(lambda: mincut_cuda.launch_mincut(
                    *graph, plan=plan, **mkw))}), flush=True)


if __name__ == "__main__":
    main()
