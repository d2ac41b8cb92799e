#!/usr/bin/env python3
"""Drives the PyTorch port (``localexpstereo_tpu_torch``) once on one CUDA card.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

Phases, each printing JSON lines:

1. env:     torch / CUDA / nvcc versions and the card's name and power limit;
2. build:   compiles the four hand-written kernel libraries from the
            checkout's sources (one ``nvcc`` each, started together, into
            ``build/torch_kernels/``), timed;
3. kernel:  ``expansion_accept`` (CUDA) against its plain PyTorch version on
            the card at the shapes of the main path, (S, N) = (42, 468),
            (129, 54), (387, 6), and of the V2 path at the cones size,
            (15, 437), (45, 56), (75, 20): equal accept masks (required at
            every shape), cut energies, the guard, median milliseconds of
            both, the card's bound, and the launch plan (K, threads, shared
            memory, state, the clusters that fit at once, registers);
4. mincut_kernel: ``mincut_accept`` (CUDA; ``mincut_cuda.solve_graph``)
            against its plain version on fusion graphs at the fusion path's
            shapes, the same (S, N), 64 rounds of 16 sweeps: equal masks or
            equal cut energies, the guard, median milliseconds, the bound,
            the launch plan;
5. unary_kernel: ``sample_windows`` (CUDA) against its plain version on the
            windows of the 1436 x 992 x 145 problem, (F, N) = (62, 468),
            (149, 54), (407, 6), raw and guided-filtered (r 10), on the
            uint8 volume and on the bfloat16 one: max abs error and the
            share of bitwise-equal values on supported positions, median
            milliseconds of both, the bound, and the launch plan (W, Hc,
            threads, shared memory, blocks, blocks an SM, registers);
6. small:   a small V3 solve (1 greedy + 1 graph-cut sweep) on the card
            against the same solve on the CPU (plain versions), at windR 6
            and 20, on the "auto" and the "dma" unary routes (both launch
            ``sample_windows`` on the card), once with
            ``run(fuse_with=...)``, and on both views
            (``run(view_modes=(0, 1))``, both routes): energies within the
            trajectory tolerance; the card's post-process of the CPU
            solve's raw labelings equal to the CPU's (one CPU solve serves
            both routes: on the CPU they are the same arithmetic); then a
            small V2 (image-warp) solve the same way, 96 x 144: both views,
            and one view with ``max_vdisp`` > 0, and at 48 x 72 (one view)
            and 64 x 96 (both views), every sweep within the trajectory
            tolerance (the largest gap printed); and a 3-frame
            ``StereoStream`` (96 x 144 x 24, a pan of 2 px a frame, 1 + 1
            cold, 1 warm), each frame's energy within the trajectory
            tolerance of the CPU stream's, and a pipelined card stream's
            maps bitwise the sync card stream's, one frame later;
7. slice:   ``LocalExpansionSolver(device="cuda")`` on the 1436 x 992 x 145
            synthetic problem, 3 layers, 1 greedy + 1 graph-cut sweep (the
            full 2 + 5 runs in cli, fuse and dual): seconds per sweep
            and per layer,
            energies, bad rates against the planted truth, and the kernel
            launch counts of each run (``expansion_accept``, ``refit_sums``
            and, on the "auto" route, ``sample_windows``: all > 0);
8. cli:     the port's command line, ``-mode MiddV3 -unaryBackend dma
            -device cuda``, on the same problem written out as a MiddV3
            directory (PNGs, calib.txt, im0.acrt, disp0GT.pfm) under
            ``build/``: time.txt, the log's energies and bad rates, seconds
            per sweep, both kernels' launch counts, the disparity's shape;
9. fuse:    the same command line with ``-fuseSeeds 2`` on the same
            directory (written once for both): 9 log rows, the fused energy
            against the last graph-cut one, all three kernels' launch
            counts, time.txt, the auxiliary solve's, the warm-start unary's
            and each layer's fusion seconds;
10. dual:   the same command line with ``-doDual 1`` on the same directory
            (2 + 5 on both views, then the post-process): time.txt, wall
            and set-up seconds, the post-process's seconds by step (check,
            fill, median) and each view's failed pixels, the 9 log rows,
            bad rates of disp0.pfm and disp0raw.pfm against the truth, both
            kernels' launches (twice the cli run's), the peak device
            memory; disp0.pfm differs from disp0raw.pfm only where the
            check failed, and every consistency image is there;
11. v2:     the command line ``-mode MiddV2 -smooth_weight 1 -doDual 1
            -device cuda`` (the reference demo's cones run) at the default
            2 + 5 on a cones-sized synthetic V2 directory (450 x 375, 60
            disparities; ``synthetic.write_v2_scene``) under ``build/``:
            time.txt, wall and set-up seconds, the 9 log rows, bad rates at
            0.5 of disp0.pfm and disp0raw.pfm (all pixels and the
            non-occluded ones), the kernels' launches (``expansion_accept``
            > 0), the post-process's failed pixels, the peak device memory;
            disp0.pfm differs from disp0raw.pfm only where the check
            failed;
12. mccnn:  the MC-CNN network (``models/mccnn.py``, plain torch, bundled
            weights) on the card against the CPU on a 192 x 256 crop of
            the stream scene at 64 disparities (features and volume, max
            abs error, held to MCCNN_ATOL), then the full 1436 x 992 x 145
            volume of one pair on the card: median of 3 after a warm-up
            (CUDA events), the peak device memory, and its bound;
13. stream:  ``serving.StereoStream`` at the main path's width: a pan of 2 px
            a frame over ``synthetic.v2_scene`` rendered at 992 x (1436 +
            14) with 145 disparities, each frame's volume from the MC-CNN
            on the card (as both views' volume), PARAMS_GF windR 20,
            lambda 0.5, th_col 0.5, layers [14, 43, 129]: frame 0 cold (2
            + 5), frames 1-4 warm (1 graph-cut sweep, "cell" warm start)
            with the build / solve / output split, then 3 warm frames
            pipelined and the flush. Per frame the MC-CNN seconds, the
            frame's seconds, the energy and bad1.0 against the truth; the
            expansion kernel's launches (exactly those of the schedule), the
            unary kernel's (> 0: the stream runs "auto") and the peak
            device memory. Fails if a warm frame's bad1.0 is more
            than 2 points above the cold frame's or a map is not finite;
14. cli_mccnn: the command line ``-mode MiddV3 -volume mccnn
            -unaryBackend dma -warmup 0 -device cuda`` at 2 + 5 on the
            stream scene's first frame written as a MiddV3 directory
            without any .acrt: time.txt, wall seconds, the volumes'
            seconds (the MC-CNN on the card, the right view's recovery on
            the host), the energy build's seconds on the card, the 8 log
            rows, bad rates, both kernels' launches (> 0), the peak device
            memory;
15. batch:   the batch command line (``cli/batch.py``, -mode MiddV3, 2 + 5,
            -warmup 1, in process on the one card) over three MiddV3
            directories: the cli phase's scene, a second one at its size
            (another seed) and a third at 718 x 496 x 72 (two shape
            groups), after the single-pair command line with the same
            flags on the first scene. Prints the groups, the summary's
            walls and each pair's load, prefetch-wait, warm-up and solve
            seconds and expansion launches; pair 0's disparity must equal
            the command line's bitwise, its bad1.0 within 0.5 pt and its
            launches equal, and the batch must launch ``sample_windows``. Then the two full-size pairs through two
            worker processes on cuda:0 (ReplicaSolver): their disparities
            must equal the serial run's; both walls are printed;
16. bf_interp: three solves at 360 x 248 x 37 (2 + 1, the reference's
            layer sizing) on the card against their CPU twins: PARAMS_BF
            (windR 6) on the dma route, and interp 0 and 2 on auto; each
            energy (NaN unaries, which interp 2's degenerate taps leave,
            counted as 0) after the init within 1e-4 relative and after
            every sweep within the trajectory tolerance, the same NaN
            pixels; every sweep's relative difference printed.
            Then one bilateral call at (N, F, R) = (468, 62, 20) and the
            method sampler at the main path's layer-0 windows, timed,
            beside the card's name and power limit;
17. profile: the init + one greedy sweep on each unary route, unprofiled
            in turns (2 each), then the ``dma`` route's under
            torch.profiler, and one graph-cut sweep under torch.profiler:
            wall seconds, and for the profiled windows device-busy seconds,
            the idle share and the largest device ops, the expansion
            kernel's seconds per move-window size (CUDA events), and the
            graph-cut sweep's peak device memory;
18. sharded: the sharded engines (``localexpstereo_tpu_torch.parallel``),
            one process a rank, SHARD_RANKS ranks sharing cuda:0 over
            gloo: ``expansion_accept`` on a row slice under ``plan_n`` at
            S = 129 and 387 (equal to the whole call's rows and to the
            plain version); the 1436 x 992 x 145 problem disparity- then
            height-sharded at 2 + 5 on "auto" against the single-device
            solve in this process (each sweep's energy, the largest label
            difference, bitwise equality (required of the height-sharded
            solve; the disparity-sharded one within the JAX tolerance),
            every rank's state equal, each rank's volume bytes against the
            whole, its peak memory, solve and collective seconds); a batch
            of two 718 x 496 x 72 pairs on the two ranks, each pair equal
            to its single solve; the whole-image aggregation at 992 x 1436
            over four ranks against ``filter_image``; and the at-scale
            slice (2880 x 1988 x 400 uint8 over four ranks: banded init,
            one greedy color step; each rank's volume bytes and peak);
19. oracle: both graph-cut kernels against the exact min cut (Dinic,
            ``native.grid_mincut_oracle``, built with g++ on the host) at
            S = 42, 129 and 387, a few regions each, through
            ``tools/gc_cap_audit.py``'s three parts: ``mincut_accept`` on
            random expansion tables of the two regimes that the JAX
            package's tests/test_gc_caps.py certifies and
            ``expansion_accept`` on fused moves, under the engine's caps
            (``engine.mincut_knobs``), and ``mincut_accept`` on fusion
            graphs under the fusion caps: each region's cut energy or cut
            capacity within rel 1e-5 / abs 1e-2 of Dinic's (the tool's
            RTOL / ATOL), no region truncated (the plain twin's
            ``active_left`` 0) and every mask the 64-round solve's and the
            plain twin's;
20. mccnn_v3: ``tools/mccnn_v3_eval.py`` at scale 1.0 on the card: the
            warp-consistent 1436 x 992 x 145 pair, its MC-CNN volume (WTA
            bad rates) and the tool's 2 + 5 solve (bad rates), beside the
            JAX tool's artifact; WTA bad1.0 and the solve's bad1.0 held to
            MCCNN_V3_LIMITS, both kernels of the solve launched;
21. train:  ``tools/train_mccnn.py`` on the card at full width (channels
            32, 32, 64, 64, 4096 pixel pairs a step, 600 steps, Adam 3e-4)
            on four synthetic V2 scenes at the MiddV2 size (375 x 450 x
            60, ``synthetic.write_v2_scene`` seeds 0-3 as cones, teddy,
            venus and tsukuba, in a temporary directory under ``build/``):
            first one hinge-loss step on the card against the CPU (loss,
            accuracy and each gradient tensor, held to TRAIN_LOSS_RTOL /
            TRAIN_ACC_ATOL / TRAIN_GRAD_RTOL); then the run's printed rows
            (train and held-out hinge and accuracy), its seconds and peak
            memory, the step's median ms (CUDA events) beside two bounds
            (the towers over both whole images, as the tool computes
            them, and only at the pixels the loss needs); then the written
            weights' tsukuba volume: WTA bad1.0 on the non-occluded pixels
            under the trained and the initial weights, and the 2 + 5
            ``auto`` solve on it (``mccnn_v3_eval.solve``): bad1.0, the
            kernels' launches, and ``expansion_accept`` against its plain
            version on the solve's first call of each shape. Fails unless
            every loss is finite, the held-out hinge fell, the trained WTA
            beats the initial one, the solve's bad1.0 is within
            TRAIN_SOLVE_BAD1, it launched ``expansion_accept`` and
            ``sample_windows`` and the expansion kernel agreed at every
            shape;
22. proposals: the proposals on the card against the CPU, bit for bit:
            ``ops/xla_math`` (sin / cos, sqrt, rsqrt, norm3, the fused
            multiply-add and the 3 x 3 dot) on 1,000,000 draws each, the
            init's random labels on the 1436 x 992 problem's grid of
            14-pixel cells, and ``refit_sums`` (CUDA) against its plain
            version at RANSAC's cells of the main path, (s, N) = (14, 468),
            (43, 54), (129, 6): bitwise, one launch a call, median
            milliseconds of the kernel, the plain version and one
            ``torch.einsum`` of the same sums, the bound, and the floor of
            the sums' dependent chain (its probe kernel: ms and cycles a
            step); the draws of ``csrc/threefry.cu`` (``rng.uniform`` and
            ``plane.random_unit_vector`` on the card) at DRAW_SHAPES:
            bitwise with the host's draw, one launch a call, median
            milliseconds of the kernel's call against the host draw and
            its copy to the card, and the bound; then
            ``tools/v2_drift.py``'s shared
            greedy sweep (48 x 72 V2, one state on both devices): no
            differing step among its proposals, unaries and masks, and the
            same random labels and perturbations from the same inputs.

A full run takes the phases in this order but runs ``oracle`` after
``mincut_kernel``, ``proposals`` after ``unary_kernel``, ``mccnn_v3`` and
``train`` after ``mccnn``, ``sharded`` after
``batch``, then ``small``, and ``bf_interp`` last: their CPU solves run meanwhile in two
worker processes that do not see the card. Then a ``{"kernels": [...]}`` line (launches from the
``fuse`` run, with the ``cli``, ``dual``, ``v2``, ``stream``,
``cli_mccnn``, ``batch``, ``bf_interp``, ``sharded``, ``oracle``,
``mccnn_v3`` and ``train`` runs' beside them; ``refit_sums`` with the
``slice`` run's too; ``threefry_uniform`` and ``threefry_unit_vector``
with every solving phase's, each of which must be above 0, and the
``proposals`` phase's ms against the host draw and its copy), the
``nvidia-smi`` name/power-limit line, and last ``{"ok": true, "device":
{...}}``. Any failed check raises,
so the script exits non-zero and prints no result; it also refuses to run
without a CUDA device. ``python3 chip_smoke.py PHASE ...`` runs only the
named phases (after env and build) and prints no result line.
"""
from __future__ import annotations

import contextlib
import functools
import json
import multiprocessing
import pathlib
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np

SHAPES = ((42, 468, 16), (129, 54, 16), (387, 6, 64))  # (S, N, sweeps)
#: The V2 path's at 450 x 375: layers {5, 15, 25}, the region counts of
#: grid.build_layers(450, 375, [5, 15, 25]).
V2_SHAPES = ((15, 437, 16), (45, 56, 16), (75, 20, 16))
ROUNDS = 16
RTOL, ATOL = 1e-5, 1e-4
#: The fusion move's solve: the JAX package's fusion_accept defaults.
FUSION_ROUNDS, FUSION_SWEEPS = 64, 16
#: H100 SXM peaks (NVIDIA's data sheet): device memory bytes/s, float32
#: operations/s outside the tensor cores.
HBM_BYTES_S, F32_OPS_S = 3.35e12, 67e12
#: float32 operations per pixel, counted from the kernels' code: one BFS
#: relaxation pass (8 residual tests, adds and mins), one push / apply /
#: relabel sweep, the expansion kernel's tables, t-links, graph build and
#: guard (once), and the unary kernel's 2-tap sample and guided filter
#: (float64 box passes counted at the float32 rate, which keeps the bound a
#: lower bound).
OPS_BFS_PASS, OPS_SWEEP, OPS_EXPANSION_SETUP = 28, 80, 320
OPS_SAMPLE, OPS_GUIDED = 15, 80
SMALL_WINDR = (6, 20)
#: The small V3 problem's layers (also the small V2 problem's).
SMALL_LAYERS = [4, 8, 16]
#: Threads of each of the two worker processes that run the small and
#: bf_interp phases' CPU solves while the card runs the phases before them.
TWIN_THREADS = 3
#: sample_windows against its plain version, by filter radius: raw costs
#: (the same float32 operations) and guided-filtered costs on supported
#: positions (float64 box sums in another order; the filter's inverse
#: covariance amplifies their last-bit differences).
UNARY_ATOL = {0: 1e-6, 10: 2e-4}
CLI_DIR = pathlib.Path(__file__).resolve().parent / "build" / "smoke_cli"
#: The v2 phase's scene: the cones size and disparity count.
V2_H, V2_W, V2_NDISP = 375, 450, 60
#: The stream phase: a frame's size and disparities (the main path's), the
#: pan's step, the frames (1 cold, 4 warm with the split, 3 pipelined) and
#: the layers.
STREAM_H, STREAM_W, STREAM_NDISP = 992, 1436, 145
STREAM_STEP, STREAM_FRAMES, STREAM_PROFILED = 2, 8, 4
STREAM_LAYERS = [14, 43, 129]
#: A warm frame's bad1.0 may exceed the cold frame's by this many points
#: (tests/test_serving.py's margin).
STREAM_BAD_MARGIN = 2.0
#: The mccnn phase: the crop (height, width, disparities) held against the
#: CPU, and the tolerance of the card's features and volume there (full
#: float32 convolutions on both; TF32 is off on the card).
MCCNN_CROP = (192, 256, 64)
MCCNN_ATOL = 1e-5
#: The small stream: height, width, disparities, frames.
SMALL_STREAM = (96, 144, 24, 3)
#: The batch phase: the second full-size scene's seed, and the third
#: scene's scale and seed (718 x 496 x 72, a second shape group).
BATCH_SEED_B = 1
BATCH_SMALL = (0.5, 2)
#: The bf_interp phase: the problem (height, width, disparities), its
#: schedule (greedy, graph-cut sweeps: the bilateral CPU twin of 2 + 1
#: takes 260 s on 8 threads, its graph-cut sweep most of it), each solve's
#: (name, unary route, interp), the bilateral solve's windR (a windR 20
#: bilateral twin would take most of an hour), the relative tolerance of
#: the card's init energy against its CPU twin's (the same labels through
#: the whole unary), and the one timed bilateral call (N, F, R: layer 0 of
#: the main path). Every sweep's energy is held to the trajectory
#: tolerance (_close).
BF_SHAPE = (248, 360, 37)
BF_SCHEDULE = (2, 1)
BF_CASES = (("bf", "dma", 1), ("interp0", "auto", 0), ("interp2", "auto", 2))
BF_WINDR = 6
BF_RTOL = 1e-4
BF_TIMED = (468, 62, 20)
#: float32 operations of one bilateral tap (3 differences, 3 absolute
#: values, 2 adds, the division and exp, 2 products, 2 sums).
OPS_BILATERAL_TAP = 14
#: The sharded phase: ranks sharing cuda:0 (gloo) for the disparity- and
#: height-sharded solves of the cli problem and the batch; the solves'
#: schedule (greedy, graph-cut sweeps); the batch's scale,
#: seeds (one pair a seed, pair b's seed b in the solver) and schedule;
#: the at-scale slice's (height, width, disparities), ranks and init band
#: (cell rows).
SHARD_RANKS = 2
SHARD_SCHEDULE = (2, 5)
SHARD_BATCH = (0.5, (2, 3), (1, 1))
SCALE_SHAPE = (1988, 2880, 400)
SCALE_RANKS = 4
SCALE_CHUNK = 16
#: The proposals phase: draws of each ops/xla_math function held card
#: against CPU, and RANSAC's refit at the main path's cells: (cell size s,
#: regions N of a color) for layers 14, 43 and 129 of the 1436 x 992
#: problem. H100 SXM float64 operations/s outside the tensor cores
#: (NVIDIA's data sheet).
XLA_MATH_DRAWS = 1_000_000
REFIT_SHAPES = ((14, 468), (43, 54), (129, 6))
#: The proposals' draws on the main path: a layer's cells (468, 54, 6) and
#: RANSAC's 32 hypotheses of each layer-0 cell.
DRAW_SHAPES = ((468,), (54,), (6,), (32 * 468,))
#: The kernels a command-line solve on ``-unaryBackend dma`` launches.
SOLVE_KERNELS = ("expansion_accept", "sample_windows", "refit_sums",
                 "threefry_uniform", "threefry_unit_vector")
#: The kernels that make the proposals' and the init's random draws.
DRAW_KERNELS = ("threefry_uniform", "threefry_unit_vector")
F64_OPS_S = 34e12
#: The oracle phase: regions a window size of each kind of problem.
ORACLE_REGIONS = {42: 6, 129: 3, 387: 2}
#: The mccnn_v3 phase's limits, in percent: WTA bad1.0 and the solve's
#: bad1.0 (the JAX tool's artifact: 1.967 and 0.569).
MCCNN_V3_LIMITS = (2.5, 1.0)
#: The train phase: the four V2 scenes' size (MiddV2's, cones' disparity
#: count); the card's one hinge-loss step against the CPU's: the loss
#: within TRAIN_LOSS_RTOL, each gradient tensor within TRAIN_GRAD_RTOL of
#: its largest entry (tests/test_torch_train_mccnn.py's tolerances against
#: JAX), the accuracy within TRAIN_ACC_ATOL (a near-tied pixel or two of
#: the 4096); the steps timed after the run.
TRAIN_SCENE = (375, 450, 60)
TRAIN_LOSS_RTOL, TRAIN_GRAD_RTOL, TRAIN_ACC_ATOL = 1e-6, 1e-5, 1e-3
TRAIN_TIMED_STEPS = 20
#: The train phase's 2 + 5 solve on the trained volume: its bad1.0 on the
#: non-occluded pixels, in percent (0.736 measured on the card), held under
#: the initial weights' WTA (1.075) as the mccnn_v3 phase holds its solve
#: to 1.0 against 0.569; a solve whose moves are not accepted stays at its
#: random labels.
TRAIN_SOLVE_BAD1 = 1.0


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def phase_env(torch):
    from localexpstereo_tpu_torch.ops import cuda_build
    nvcc = subprocess.run([cuda_build.nvcc(), "--version"],
                          capture_output=True, text=True, check=True)
    emit({"phase": "env", "python": sys.version.split()[0],
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "nvcc": nvcc.stdout.strip().splitlines()[-1],
          "device": torch.cuda.get_device_name(0),
          "nvidia_smi": smi_line()})


def phase_build():
    from localexpstereo_tpu_torch.models import proposals
    from localexpstereo_tpu_torch.ops import (cuda_build, mincut_cuda,
                                              threefry_cuda, unary_cuda)
    t0 = time.perf_counter()
    built = cuda_build.build([mincut_cuda.LIBRARY, mincut_cuda.MINCUT_LIBRARY,
                              unary_cuda.LIBRARY, proposals.REFIT_LIBRARY,
                              threefry_cuda.LIBRARY], verbose=True)
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": {name: {"file": path.name, "ready_s": s,
                               "compiled": compiled}
                        for name, (path, s, compiled) in built.items()}})


def time_ms(torch, fn, reps: int) -> float:
    """Median milliseconds of ``fn`` over ``reps`` timed calls (CUDA events,
    one warm-up call first)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound(nbytes: float, nops: float):
    """(ms, "bytes" | "operations"): the least time the card could take to
    move ``nbytes`` and do ``nops`` float32 operations."""
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = nops / F32_OPS_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def solve_ops(stats, s: int) -> float:
    """Operations of the push-relabel solves that the plain version ran on
    these inputs, region by region (``mincut.solve_preflow``'s counts)."""
    return float((stats["bfs_passes"] * OPS_BFS_PASS
                  + stats["sweeps"] * OPS_SWEEP).sum()) * s * s


def kernel_entry(rows):
    """Sums of a kernel's per-shape rows for the ``kernels`` line; it is
    bound by what bounds its largest share."""
    top = max(rows, key=lambda r: r["bound_ms"])
    return {"max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": sum(r["ms"] for r in rows),
            "plain_ms": sum(r["plain_ms"] for r in rows),
            "bound_ms": sum(r["bound_ms"] for r in rows),
            "bound_by": top["bound_by"], "library_ms": None}


def draw_entry(rows):
    """Sums of a draw kernel's per-shape rows for the ``kernels`` line."""
    return {"bitwise": all(r["bitwise"] for r in rows),
            "ms": sum(r["ms"] for r in rows),
            "host_copy_ms": sum(r["host_copy_ms"] for r in rows),
            "bound_ms": sum(r["bound_ms"] for r in rows),
            "bound_by": "bytes", "library_ms": None}


def accept_row(torch, args, kw):
    """expansion_accept on ``args`` (on the card) against its plain version:
    the move energies within RTOL/ATOL, the guard, the regions equal; both
    timed, and the bound of the push-relabel work that these inputs need.
    The kernel runs under ``kw`` (``plan_n`` included), the plain version
    without ``plan_n``."""
    from localexpstereo_tpu_torch.ops import mincut, mincut_cuda
    n, s = args[0].shape[0], args[0].shape[1] - 2
    plain_kw = {k: v for k, v in kw.items() if k != "plan_n"}
    rounds, sweeps = kw["max_global_rounds"], kw["sweeps_per_round"] or 16
    got = mincut_cuda.expansion_accept(*args, **kw)
    want = mincut_cuda.expansion_accept_reference(*args, **plain_kw)
    torch.cuda.synchronize()
    c00, c01, c10, t0, t1 = mincut_cuda.fused_terms(*args, kw["lam"],
                                                    kw["tau"])
    stats = {}
    mincut.solve_preflow(*mincut.build_graph(t0, t1, c00, c01, c10),
                         rounds, sweeps, stats=stats)
    nbytes = sum(a.numel() * a.element_size() for a in args) + n * s * s
    bound_ms, bound_by = bound(
        nbytes, solve_ops(stats, s) + OPS_EXPANSION_SETUP * n * s * s)
    e_got = mincut.move_energy_delta(got, t0, t1, c00, c01, c10)
    e_want = mincut.move_energy_delta(want, t0, t1, c00, c01, c10)
    err = (e_got - e_want).abs()
    energy_ok = bool((err <= ATOL + RTOL * e_want.abs()).all())
    guard_ok = bool((e_got <= 1e-5).all())
    ms = time_ms(torch, lambda: mincut_cuda.expansion_accept(*args, **kw), 5)
    plain_ms = time_ms(
        torch, lambda: mincut_cuda.expansion_accept_reference(*args,
                                                              **plain_kw), 3)
    row = {"S": s, "N": n, "rounds": rounds, "sweeps": sweeps,
           "plan": mincut_cuda.describe("expansion_accept", s,
                                        kw.get("plan_n") or n),
           # Exact: a float32 mean of N ones need not be 1.0 on the card.
           "regions_equal": int((got == want).all(-1).all(-1).sum()) / n,
           "max_abs_err": float(err.max()),
           "rtol": RTOL, "atol": ATOL, "energy_ok": energy_ok,
           "guard_ok": guard_ok, "max_delta": float(e_got.max()),
           "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
           "bound_by": bound_by, "bytes": nbytes,
           "plain_rounds": int(stats["rounds"].sum()),
           "plain_bfs_passes": int(stats["bfs_passes"].sum()),
           "plain_sweeps": int(stats["sweeps"].sum())}
    row["ok"] = energy_ok and guard_ok and row["regions_equal"] == 1.0
    return row


def phase_kernel(torch):
    """expansion_accept against its plain version at the V3 main path's
    shapes and the V2 path's; each row names its path."""
    from localexpstereo_tpu_torch.utils import synthetic
    rows = []
    shapes = [("v3", *shape) for shape in SHAPES] + [
        ("v2", *shape) for shape in V2_SHAPES]
    for path, s, n, sweeps in shapes:
        arrays, lam, tau = synthetic.fused_move_problem(
            np.random.default_rng(s), n, s)
        args = [torch.as_tensor(a, device="cuda") for a in arrays]
        row = {"path": path, **accept_row(torch, args, dict(
            lam=lam, tau=tau, max_global_rounds=ROUNDS,
            sweeps_per_round=sweeps))}
        emit({"phase": "kernel", **row})
        if not row["ok"]:
            raise AssertionError(f"kernel disagrees at S={s}: {row}")
        rows.append(row)
    return rows


def phase_mincut_kernel(torch):
    """mincut_accept (solve_graph) against its plain version on fusion
    graphs of two labelings near a planted plane, at the fusion path's
    shapes."""
    from localexpstereo_tpu_torch.ops import mincut, mincut_cuda
    from localexpstereo_tpu_torch.utils import synthetic
    rows = []
    for s, n, _ in SHAPES:
        arrays, lam, tau = synthetic.fusion_move_problem(
            np.random.default_rng(s), n, s)
        terms = mincut_cuda.fusion_terms(
            *[torch.as_tensor(a, device="cuda") for a in arrays], lam, tau)
        graph = [x.contiguous() for x in mincut.build_fusion_graph(*terms)]
        kw = dict(max_global_rounds=FUSION_ROUNDS,
                  sweeps_per_round=FUSION_SWEEPS)
        got = mincut_cuda.solve_graph(*graph, **kw)
        torch.cuda.synchronize()
        stats = {}
        want = mincut.solve_preflow(*graph, FUSION_ROUNDS, FUSION_SWEEPS,
                                    stats=stats)
        e_got = mincut.fusion_move_energy_delta(got, *terms)
        e_want = mincut.fusion_move_energy_delta(want, *terms)
        same = (got == want).all(-1).all(-1)
        err = (e_got - e_want).abs()
        ok = bool((same | (err == 0)).all())
        nbytes = sum(x.numel() * x.element_size() for x in graph) + n * s * s
        bound_ms, bound_by = bound(nbytes, solve_ops(stats, s))
        row = {"S": s, "N": n, "rounds": FUSION_ROUNDS,
               "sweeps": FUSION_SWEEPS,
               "plan": mincut_cuda.describe("mincut_accept", s, n),
               "regions_equal": int(same.sum()) / n,
               "max_abs_err": float(err.max()), "ok": ok,
               "accepted": float(got.float().mean()),
               "guard_rejects": int((e_got > 0).sum()),
               "guard_rejects_plain": int((e_want > 0).sum()),
               "ms": time_ms(torch, lambda: mincut_cuda.solve_graph(
                   *graph, **kw), 5),
               "plain_ms": time_ms(torch, lambda: mincut.solve_preflow(
                   *graph, FUSION_ROUNDS, FUSION_SWEEPS), 2),
               "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
               "plain_rounds": int(stats["rounds"].sum()),
               "plain_bfs_passes": int(stats["bfs_passes"].sum()),
               "plain_sweeps": int(stats["sweeps"].sum())}
        emit({"phase": "mincut_kernel", **row})
        if not ok or row["guard_rejects"] != row["guard_rejects_plain"]:
            raise AssertionError(f"mincut_accept disagrees at S={s}: {row}")
        rows.append(row)
    return rows


class Recorder:
    """Evaluator hook: energy and wall time of view 0 after the init and
    each sweep (synchronizes the card, so sweep times are complete), and
    every view's energies."""

    def __init__(self, torch):
        self.torch = torch
        self.rows = []
        self.energies = {}

    def start(self):
        pass

    def stop(self):
        pass

    def evaluate(self, solver, labeling_m, cost_m, mode, index):
        from localexpstereo_tpu_torch.models import engine
        e = engine.energy_audit(solver.data, solver.cfg, labeling_m, cost_m,
                                mode)
        total = float(e[0])
        if labeling_m.is_cuda:
            self.torch.cuda.synchronize()
        self.energies.setdefault(mode, []).append(total)
        if mode == 0:
            self.rows.append((index, total, time.perf_counter()))


def bad_rates(solver, truth):
    disp = solver.disparity_map().float().cpu().numpy()
    if disp.shape != truth.shape or not np.all(np.isfinite(disp)):
        raise AssertionError(f"bad disparity map {disp.shape}")
    err = np.abs(disp - truth)
    return float((err > 0.5).mean() * 100), float((err > 1.0).mean() * 100)


def _close(got, want) -> bool:
    """Energy rows within the trajectory tolerance, 0.002·|E| + 1e-3."""
    return len(got) == len(want) and all(
        abs(a - b) <= 0.002 * abs(b) + 1e-3 for a, b in zip(got, want))


def small_v3(torch, device, windr, route="auto", fuse_with=None, seed=0):
    """The small V3 solve (64 x 96, 1 + 1) on ``device``: (view 0's
    energies, bad rates, sample_windows launches, final labeling)."""
    from localexpstereo_tpu_torch.ops import mincut_cuda, unary_cuda
    from localexpstereo_tpu_torch.utils import synthetic
    solver, truth, _ = synthetic.bench_solver(
        0.06, device, sizes=SMALL_LAYERS, windr=windr, route=route,
        seed=seed)
    rec = Recorder(torch)
    solver.set_evaluator(rec)
    unary_cuda.sample_windows.launches = 0
    mincut_cuda.solve_graph.launches = 0
    lab, _ = solver.run(iterations=1, pm_iterations=1, fuse_with=fuse_with)
    launches = (unary_cuda.sample_windows.launches,
                mincut_cuda.solve_graph.launches)
    return ([e for _, e, _ in rec.rows], bad_rates(solver, truth),
            launches, lab.cpu().numpy())


def small_dual(torch, device, route="auto"):
    """The small V3 solve on both views (the command line's volumes for a
    directory without im1.acrt) on ``device``: (each view's energies, the
    post-process call of PostProcessTimer with numpy arrays, (im0, im1,
    params), sample_windows launches)."""
    from localexpstereo_tpu_torch.models import postprocess
    from localexpstereo_tpu_torch.ops import unary_cuda
    from localexpstereo_tpu_torch.utils import synthetic
    solver, _, _ = synthetic.bench_solver(0.06, device, sizes=SMALL_LAYERS,
                                          route=route, dual=True)
    rec = Recorder(torch)
    solver.set_evaluator(rec)
    unary_cuda.sample_windows.launches = 0
    with PostProcessTimer(torch, postprocess) as post:
        solver.run(iterations=1, view_modes=(0, 1), pm_iterations=1)
    call = post.calls[0]
    call = dict(call, **{k: tuple(x.numpy() for x in call[k])
                         for k in ("inputs", "outputs", "fail_maps")})
    return (rec.energies, call, (solver.im0, solver.im1, solver.params),
            unary_cuda.sample_windows.launches)


def small_v2(torch, device, shape, modes, max_vdisp):
    """The small V2 solve (``shape``, 1 + 1) on ``device``: (each view's
    energies, bad rates, expansion_accept and sample_windows launches)."""
    from localexpstereo_tpu_torch.ops import mincut_cuda, unary_cuda
    from localexpstereo_tpu_torch.utils import synthetic
    solver, truth, _, _ = synthetic.v2_solver(
        *shape, device, sizes=SMALL_LAYERS, max_vdisp=max_vdisp)
    rec = Recorder(torch)
    solver.set_evaluator(rec)
    mincut_cuda.expansion_accept.launches = 0
    unary_cuda.sample_windows.launches = 0
    solver.run(iterations=1, view_modes=modes, pm_iterations=1)
    return (rec.energies, bad_rates(solver, truth),
            mincut_cuda.expansion_accept.launches,
            unary_cuda.sample_windows.launches)


def small_stream(torch, device, pipelined=False):
    """The small stream (SMALL_STREAM: ``synthetic.pan_frames``, the frame's
    volume as both views', layers SMALL_LAYERS, windR 20, 1 + 1 cold, 1
    warm) on ``device``: (each frame's energy, the maps that process()
    returned and, pipelined, flush()'s, expansion_accept launches)."""
    from localexpstereo_tpu_torch.config import PARAMS_GF
    from localexpstereo_tpu_torch.models import engine
    from localexpstereo_tpu_torch.ops import mincut_cuda
    from localexpstereo_tpu_torch.serving import StereoStream
    from localexpstereo_tpu_torch.utils import synthetic
    h, w, nd, n = SMALL_STREAM
    stream = StereoStream(PARAMS_GF.replace(windR=20, lambda_=0.5,
                                            th_col=0.5),
                          max_disp=float(nd - 1), unit_sizes=SMALL_LAYERS,
                          cold_iterations=1, cold_pm_iterations=1,
                          pipelined=pipelined, device=device)
    mincut_cuda.expansion_accept.launches = 0
    energies, maps = [], []
    for img, vol, _ in synthetic.pan_frames(h, w, nd, n):
        maps.append(stream.process(img, img, vol, vol))
        s = stream.solver
        energies.append(float(engine.energy_audit(s.data, s.cfg,
                                                  *s._state[0], 0)[0]))
    if pipelined:
        maps.append(stream.flush())
    return energies, maps, mincut_cuda.expansion_accept.launches


def cpu_twins(torch):
    """Every CPU solve that the small phase holds the card against, keyed
    by case: the V3 solve at each windR (on the CPU the "dma" route runs
    the kernel's plain version, the same arithmetic as "auto": their logs
    are equal, tests/test_torch_cli.py::test_dma_and_auto_routes_agree_on_cpu,
    so one CPU solve serves both routes), the auxiliary seed-1 labeling
    and the fused solve, the dual solve and the V2 cases."""
    twins = {("v3", w): small_v3(torch, "cpu", w) for w in SMALL_WINDR}
    ext = small_v3(torch, "cpu", 20, seed=1)[3]
    twins["fuse_ext"] = ext
    twins["fuse"] = small_v3(torch, "cpu", 20, fuse_with=[ext])
    twins["dual"] = small_dual(torch, "cpu")
    for case in V2_SMALL_CASES:
        twins[("v2", *case)] = small_v2(torch, "cpu", *case)
    twins["stream"] = small_stream(torch, "cpu")
    return twins


def twins_worker():
    """:func:`cpu_twins` in a worker process that does not see the card:
    main() runs it while the card runs the phases before small."""
    import os
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    import torch
    torch.set_num_threads(TWIN_THREADS)
    return cpu_twins(torch)


def phase_small(torch, twins=None):
    """The same small problems solved on the card and on the CPU (the CPU
    solves of :func:`cpu_twins`, computed here unless given): V3 at a
    narrow filter window and at the main path's, on both unary routes,
    once fused, on both views; then V2."""
    twins = twins or cpu_twins(torch)
    for route in ("auto", "dma"):
        for windr in SMALL_WINDR:
            e_gpu, b_gpu, (n_gpu, _), _ = small_v3(torch, "cuda", windr, route)
            e_cpu, b_cpu, _, _ = twins[("v3", windr)]
            ok = _close(e_gpu, e_cpu)
            ok &= abs(b_gpu[1] - b_cpu[1]) <= 0.5
            ok &= n_gpu > 0
            emit({"phase": "small", "route": route, "windR": windr,
                  "layers": SMALL_LAYERS, "energies_cuda": e_gpu,
                  "energies_cpu": e_cpu, "bad_cuda": b_gpu, "bad_cpu": b_cpu,
                  "sample_windows_launches_cuda": n_gpu, "agree": ok})
            if not ok:
                raise AssertionError(f"CUDA and CPU solves disagree at windR "
                                     f"{windr} on the {route} route")
    phase_small_fuse(torch, twins)
    phase_small_dual(torch, twins)
    phase_small_v2(torch, twins)
    phase_small_stream(torch, twins)


def phase_small_stream(torch, twins):
    """The small stream on the card, sync and pipelined, against the CPU's:
    each frame's energy within the trajectory tolerance; the pipelined
    maps None first, then bitwise the sync ones, one frame later, the last
    from flush(); the expansion kernel launched on the card."""
    e_gpu, sync, n_gpu = small_stream(torch, "cuda")
    e_cpu, cpu_maps, _ = twins["stream"]
    e_pipe, pipe, _ = small_stream(torch, "cuda", pipelined=True)
    ok = _close(e_gpu, e_cpu) and n_gpu > 0 and e_pipe == e_gpu
    ok &= pipe[0] is None and len(pipe) == len(sync) + 1
    ok &= all(np.array_equal(a, b) for a, b in zip(pipe[1:], sync))
    ok &= all(np.isfinite(m).all() for m in sync)
    near = [float((np.abs(a - b) < 0.5).mean())
            for a, b in zip(sync, cpu_maps)]
    emit({"phase": "small", "stream": list(SMALL_STREAM),
          "layers": SMALL_LAYERS, "energies_cuda": e_gpu,
          "energies_cpu": e_cpu, "energies_pipelined": e_pipe,
          "within_half_px_of_cpu": near,
          "expansion_accept_launches_cuda": n_gpu,
          "pipelined_equal_sync": ok, "agree": ok})
    if not ok:
        raise AssertionError("the card's stream disagrees with the CPU's, "
                             "or its pipelined maps with its sync ones")


def phase_small_fuse(torch, twins):
    """The small solve with run(fuse_with=[the CPU solve of seed 1]) on
    the card against the CPU's: energies within the trajectory tolerance,
    the fused row no higher than the last graph-cut row, and the min-cut
    kernel launched on the card."""
    e_gpu, b_gpu, (_, n_gpu), _ = small_v3(torch, "cuda", 20,
                                           fuse_with=[twins["fuse_ext"]])
    e_cpu, b_cpu, _, _ = twins["fuse"]
    ok = len(e_gpu) == 4 and _close(e_gpu, e_cpu)
    ok &= e_gpu[-1] <= e_gpu[-2] and n_gpu > 0
    emit({"phase": "small", "route": "auto", "windR": 20, "fuse_with": 1,
          "layers": SMALL_LAYERS, "energies_cuda": e_gpu,
          "energies_cpu": e_cpu, "bad_cuda": b_gpu, "bad_cpu": b_cpu,
          "mincut_accept_launches_cuda": n_gpu, "agree": ok})
    if not ok:
        raise AssertionError("CUDA and CPU fused solves disagree")


class PostProcessTimer:
    """Stands in for the post-process's functions while it is active:
    times every ``post_process`` call and, synchronized, its steps (check:
    ``consistency_check``; fill: ``_dilate3`` and ``fill_holes``; median:
    ``weighted_median_at``), counts each view's failed pixels, and keeps the
    call's inputs, outputs and fail maps (on the CPU). Calls from outside
    ``post_process`` (the evaluator's consistency images) pass through."""

    STEPS = {"consistency_check": "check_s", "_dilate3": "fill_s",
             "fill_holes": "fill_s", "weighted_median_at": "median_s"}

    def __init__(self, torch, postprocess):
        self.torch, self.pp = torch, postprocess
        self.saved = {name: getattr(postprocess, name)
                      for name in ("post_process", *self.STEPS)}
        self.calls = []
        self.active = False

    def _sync(self):
        if self.torch.cuda.is_available():
            self.torch.cuda.synchronize()

    def _step(self, name):
        fn, key = self.saved[name], self.STEPS[name]

        def wrapper(*args, **kwargs):
            if not self.active:
                return fn(*args, **kwargs)
            self._sync()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            self._sync()
            call = self.calls[-1]
            call[key] += time.perf_counter() - t0
            if name == "consistency_check":
                call["fail_maps"] = [f.cpu() for f in out]
            elif name == "weighted_median_at":
                call["failed"].append(int(args[2].sum()))
            return out
        return wrapper

    def _post_process(self, lab_l, lab_r, *args, **kwargs):
        # Copies: the engine writes the outputs into the state that the
        # inputs may view.
        call = {"check_s": 0.0, "fill_s": 0.0, "median_s": 0.0,
                "failed": [], "inputs": tuple(x.to("cpu", copy=True)
                                              for x in (lab_l, lab_r))}
        self.calls.append(call)
        self._sync()
        t0 = time.perf_counter()
        self.active = True
        try:
            out = self.saved["post_process"](lab_l, lab_r, *args, **kwargs)
        finally:
            self.active = False
        self._sync()
        call["total_s"] = time.perf_counter() - t0
        call["outputs"] = tuple(x.to("cpu", copy=True) for x in out)
        return out

    def __enter__(self):
        for name in self.STEPS:
            setattr(self.pp, name, self._step(name))
        self.pp.post_process = self._post_process
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.pp, name, fn)


def phase_small_dual(torch, twins):
    """run(view_modes=(0, 1)), 1 + 1 sweeps, windR 20, on the card on both
    unary routes against the CPU's: each view's energies within the
    trajectory tolerance; then post_process on the card of the CPU run's
    raw labelings against the CPU's own post-process of them: equal
    labelings (the differing share of pixels is printed)."""
    from localexpstereo_tpu_torch.models import postprocess
    e_cpu, call, (im0, im1, params), _ = twins["dual"]
    for route in ("auto", "dma"):
        e_gpu, _, _, n_gpu = small_dual(torch, "cuda", route)
        ok = all(len(e_gpu[m]) == 4 and _close(e_gpu[m], e_cpu[m])
                 for m in (0, 1))
        ok &= n_gpu > 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = postprocess.post_process(
            *(torch.as_tensor(x, device="cuda") for x in call["inputs"]),
            im0, im1, params, threshold=1.5)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        differ = [float((g.cpu().numpy() != w).any(-1).mean())
                  for g, w in zip(got, call["outputs"])]
        ok &= max(differ) == 0.0
        emit({"phase": "small", "route": route, "windR": 20,
              "view_modes": [0, 1], "layers": SMALL_LAYERS,
              "energies_cuda": e_gpu, "energies_cpu": e_cpu,
              "sample_windows_launches_cuda": n_gpu,
              "failed_pixels": call["failed"],
              "post_process_s": {"cuda": card_s, "cpu": call["total_s"]},
              "post_process_differing_share": differ, "agree": ok})
        if not ok:
            raise AssertionError(f"CUDA and CPU dual solves or post-processes "
                                 f"disagree on the {route} route")


#: The small V2 cases (layers SMALL_LAYERS): (height, width, disparities),
#: views, max_vdisp. 48 x 72 and 64 x 96 are where the card's and the CPU's
#: solves parted by up to 1 % while the card rounded RANSAC's refit sums
#: and the random draws' sin, cos and roots otherwise (ROADMAP C8).
V2_SMALL_CASES = (((96, 144, 24), (0, 1), 0.0), ((96, 144, 24), (0,), 1.0),
                  ((48, 72, 16), (0,), 0.0), ((64, 96, 24), (0, 1), 0.0))


def _largest_gap(got, want) -> float:
    """The largest relative gap between two energy rows."""
    return max(abs(a - b) / max(abs(b), 1e-12) for a, b in zip(got, want))


def phase_small_v2(torch, twins):
    """The small V2 (image-warp) solve, 1 greedy + 1 graph-cut sweep, windR
    20, on the card against the CPU's, at each of V2_SMALL_CASES: both
    views (then the post-process), one view with max_vdisp 1, and one or
    both views at the sizes that C8 parted. Each view's energies within
    the trajectory tolerance at every sweep (the largest relative gap
    printed); the expansion kernel launched on the card; no launch of the
    volume kernel."""
    for shape, modes, max_vdisp in V2_SMALL_CASES:
        e_gpu, b_gpu, n_gpu, u_gpu = small_v2(torch, "cuda", shape, modes,
                                              max_vdisp)
        e_cpu, b_cpu, _, _ = twins[("v2", shape, modes, max_vdisp)]
        ok = all(len(e_gpu[m]) == 2 + len(modes)
                 and _close(e_gpu[m], e_cpu[m]) for m in modes)
        ok &= n_gpu > 0 and u_gpu == 0
        emit({"phase": "small", "energy": "naive", "windR": 20,
              "view_modes": list(modes), "max_vdisp": max_vdisp,
              "shape": list(shape), "layers": SMALL_LAYERS,
              "energies_cuda": e_gpu, "energies_cpu": e_cpu,
              "largest_gap": max(_largest_gap(e_gpu[m], e_cpu[m])
                                 for m in modes),
              "bad_cuda": b_gpu, "bad_cpu": b_cpu,
              "expansion_accept_launches_cuda": n_gpu,
              "sample_windows_launches_cuda": u_gpu, "agree": ok})
        if not ok:
            raise AssertionError(f"CUDA and CPU V2 solves disagree: {shape}, "
                                 f"views {modes}, max_vdisp {max_vdisp}")


def refit_inputs(torch, s: int, n: int):
    """RANSAC's refit inputs for ``n`` cells of ``s`` x ``s`` pixels on the
    card: (x, y, 1) cell-local features, 0/1 inlier weights (60 % set)
    and disparities, from a seed."""
    r = np.random.default_rng(s)
    iy, ix = np.mgrid[0:s, 0:s].astype(np.float32)
    feats = np.stack([ix.ravel(), iy.ravel(), np.ones(s * s, np.float32)],
                     -1)[None].repeat(n, 0)
    w = (r.random((n, s * s)) < 0.6).astype(np.float32)
    d = r.uniform(0, 144, (n, s * s)).astype(np.float32)
    return [torch.as_tensor(a, device="cuda") for a in (feats, w, d)]


def phase_proposals(torch):
    """The proposals on the card against the CPU, bit for bit: ops/xla_math
    on XLA_MATH_DRAWS draws a function; the init's random labels on the
    main path's layer-0 cell grid; the refit kernel against its plain
    version at REFIT_SHAPES (timed beside the plain version, one
    torch.einsum of the same sums, the bound and the chain's floor); then
    tools/v2_drift.py's shared sweep, which must find no differing step
    and the same random labels and perturbations from the same inputs."""
    from localexpstereo_tpu_torch.models import proposals
    from localexpstereo_tpu_torch.ops import plane, rng, xla_math
    from localexpstereo_tpu_torch.tools import v2_drift
    r = np.random.default_rng(0)
    n = XLA_MATH_DRAWS

    def f32(*a):
        return torch.as_tensor(r.uniform(*a).astype(np.float32))

    equal = {}
    for name, fn, args in (
            ("sincosf", xla_math.sincosf, (f32(0, 2 * np.pi, n),)),
            ("sqrt", xla_math.sqrt, (f32(0, 1, n),)),
            ("rsqrt", xla_math.rsqrt, (f32(1, 20, n),)),
            ("norm3", xla_math.norm3, (f32(-2, 2, (n, 3)),)),
            ("fma", xla_math.fma, (f32(-3, 3, n), f32(-3, 3, n),
                                   f32(-3, 3, n))),
            ("matvec3", xla_math.matvec3, (f32(-100, 100, (n, 3, 3)),
                                           f32(-9, 9, (n, 3))))):
        outs = [fn(*(a.to(dev) for a in args)) for dev in ("cpu", "cuda")]
        outs = [o if isinstance(o, tuple) else (o,) for o in outs]
        equal[name] = min(float((c == g.cpu()).double().mean())
                          for c, g in zip(*outs))
    # The init's labels (engine.init_step's draw) on the 1436 x 992 grid of
    # 14-pixel cells.
    s0, (h, w) = 14, (992, 1436)
    wb, hb = -(-w // s0), -(-h // s0)
    ox = torch.arange(wb).repeat(hb) * s0
    oy = torch.arange(hb).repeat_interleave(wb) * s0
    cw, ch = torch.clamp(w - ox, 1, s0), torch.clamp(h - oy, 1, s0)
    kp, kl = rng.split(rng.fold_in(rng.PRNGKey(0), 1000))
    labels = {}
    for dev in ("cpu", "cuda"):
        xx, yy = proposals._cell_pixel(kp, *(t.to(dev) for t in (ox, oy, cw,
                                                                 ch)))
        labels[dev] = plane.random_label(
            kl, (ox.to(dev) + xx).float(), (oy.to(dev) + yy).float(), 0.0,
            144.0).cpu()
    init_equal = bool(torch.equal(labels["cpu"], labels["cuda"]))
    draw_rows = draw_times(torch)
    refit_rows = []
    for s, cells in REFIT_SHAPES:
        args = refit_inputs(torch, s, cells)
        before = proposals.refit_sums.launches
        got = proposals.refit_sums(*args)
        torch.cuda.synchronize()
        launched = proposals.refit_sums.launches - before
        want = proposals.refit_sums_reference(*args)
        bitwise = all(bool(torch.equal(a, b)) for a, b in zip(got, want))
        fw = args[0] * args[1][..., None]
        rhs = torch.cat([args[0], (args[2] * args[1])[..., None]], -1)
        p = s * s
        nbytes = sum(a.numel() * a.element_size() for a in args) + cells * 48
        bound_ms, bound_by = bound(nbytes, 0.0)
        ops_ms = cells * 12 * p * 2 / F64_OPS_S * 1e3
        if ops_ms > bound_ms:
            bound_ms, bound_by = ops_ms, "operations"
        row = {"phase": "proposals", "part": "refit_sums", "S": s, "N": cells,
               "P": p, "bitwise": bitwise, "launches": launched,
               "max_abs_err": max(float((a - b).abs().max())
                                  for a, b in zip(got, want)),
               "ms": time_ms(torch, lambda: proposals.refit_sums(*args), 20),
               "plain_ms": time_ms(
                   torch, lambda: proposals.refit_sums_reference(*args), 2),
               "library_ms": time_ms(torch, lambda: torch.einsum(
                   "npi,npj->nij", fw, rhs), 20),
               "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes}
        # The floor that the chain of P dependent steps sets: the chain
        # alone, its operands in registers, one launch.
        row["chain_floor_ms"], row["chain_cycles_per_step"] = (
            refit_chain_floor(torch, proposals, p))
        emit(row)
        refit_rows.append(row)
    drift = v2_drift.shared()
    same = drift["same_inputs"]
    row = {"phase": "proposals", "xla_math_draws": n,
           "xla_math_equal_share": equal, "init_labels_cells": wb * hb,
           "init_labels_equal": init_equal,
           "refit_bitwise": [r["bitwise"] for r in refit_rows],
           "draws_bitwise": [r["bitwise"] for r in draw_rows],
           "v2_drift_shared": drift, "nvidia_smi": smi_line()}
    row["ok"] = (min(equal.values()) == 1.0 and init_equal
                 and all(r["bitwise"] and r["launches"] == 1
                         for r in refit_rows + draw_rows)
                 and not drift["first_differing"]
                 and drift["labeling_max_gap"] == 0.0
                 and same["init_labeling_max_gap"] == 0.0
                 and same["random_perturbation_differing"] == 0)
    emit(row)
    if not row["ok"]:
        raise AssertionError(f"the card's proposals differ from the CPU's: "
                             f"{row}")
    return refit_rows, draw_rows


def draw_times(torch):
    """The proposals' draws made on the card (``csrc/threefry.cu``) against
    the host's draw of the same bits plus its copy to the card, as the port
    drew them before: ``rng.uniform`` in (0, 144) and
    ``plane.random_unit_vector`` at angle pi, at DRAW_SHAPES. Each call
    timed between CUDA events (median of 50 kernel, 20 host calls), so the
    host's work to launch is in it; bound: the draws' bytes written once."""
    import math

    from localexpstereo_tpu_torch.ops import plane, rng, threefry_cuda
    key = rng.fold_in(rng.PRNGKey(0), 2003)
    rows = []
    for shape in DRAW_SHAPES:
        for kind, width, fn in (
                ("uniform", 1, lambda dev: rng.uniform(
                    key, shape, 0.0, 144.0, device=dev)),
                ("unit_vector", 3, lambda dev: plane.random_unit_vector(
                    key, math.pi, shape, device=dev))):
            wrapper = getattr(threefry_cuda, kind)
            before = wrapper.launches
            got = fn("cuda")
            torch.cuda.synchronize()
            launched = wrapper.launches - before
            nbytes = 4 * width * math.prod(shape)
            row = {"phase": "proposals", "part": "draw", "kind": kind,
                   "shape": list(shape), "launches": launched,
                   "bitwise": bool(torch.equal(got.cpu(), fn(None))),
                   "ms": time_ms(torch, lambda: fn("cuda"), 50),
                   "host_copy_ms": time_ms(
                       torch, lambda: fn(None).to("cuda"), 20),
                   "bound_ms": bound(nbytes, 0.0)[0], "bytes": nbytes}
            emit(row)
            rows.append(row)
    return rows


def refit_chain_floor(torch, proposals, p: int):
    """(ms, clock cycles a step) of ``csrc/refit_sums.cu``'s chain probe:
    P dependent refit steps with their operands in registers, 12 threads,
    timed as one launch (CUDA events, median of 20) and by the SM's clock
    in the kernel. Not a launch of the refit kernel."""
    from localexpstereo_tpu_torch.ops import cuda_build
    lib = cuda_build.load(proposals.REFIT_LIBRARY)
    out = torch.empty(12, dtype=torch.float32, device="cuda")
    cycles = torch.empty(1, dtype=torch.float64, device="cuda")

    def run():
        rc = lib.refit_chain_probe_launch(
            out.data_ptr(), cycles.data_ptr(), p,
            torch.cuda.current_stream().cuda_stream)
        cuda_build.launch_error("refit_chain_probe", rc)

    ms = time_ms(torch, run, 20)
    return ms, float(cycles.item())


def phase_unary_kernel(torch):
    """sample_windows against its plain version on the main path's windows
    (r 10) of every layer, raw and guided-filtered, on the uint8 volume of
    the main path and on the bfloat16 volume (the float volume rounded to
    nearest even, as build_energy(vol_dtype="bfloat16") stores it)."""
    from localexpstereo_tpu_torch.utils import synthetic
    solver, truth, sizes = synthetic.bench_solver(1.0, "cuda")
    solver.finalize()
    data, cfg = solver.data, solver.cfg
    r = cfg.params.guided_radius
    vp = cfg.vol_pad
    bf16 = torch.from_numpy(np.pad(solver.vol0, ((0, 0), (vp, vp), (vp, vp)))
                            ).to(torch.bfloat16).cuda()
    volumes = (("uint8", data.vol[0], cfg.vol_scale, cfg.vol_zero),
               ("bfloat16", bf16, 1.0, 0.0))
    rng = np.random.default_rng(0)
    rows = []
    for layer in solver.layers:
        props, fox, foy, f = synthetic.unary_windows(solver, truth, layer,
                                                     rng)
        n = props.shape[0]
        it = torch.arange(f, device="cuda")
        ys = foy[:, None, None] + it[None, :, None]
        xs = fox[:, None, None] + it[None, None, :]
        inside = ((xs >= 0) & (xs < cfg.width) & (ys >= 0)
                  & (ys < cfg.height)).float()
        windows = (layer, props, fox, foy, f, inside)
        for volume in volumes:
            for r_gf in (0, r):
                rows.append(unary_row(torch, data, cfg, volume, windows,
                                      r_gf))
    del solver, data, bf16, volumes
    torch.cuda.empty_cache()
    return rows


def unary_row(torch, data, cfg, volume, windows, r_gf):
    """One ``unary_kernel`` row: the kernel against its plain version on
    one layer's windows and one volume (dtype, tensor, decode scale and
    zero), its plan, times and bound."""
    from localexpstereo_tpu_torch.ops import boxfilter, unary_cuda
    dtype, vol, scale, zero = volume
    layer, props, fox, foy, f, inside = windows
    n = props.shape[0]
    support = boxfilter.boxsum2d(inside, r_gf) > 0.5
    args = (vol, cfg.vol_pad, props, fox, foy, f, cfg.height, cfg.width)
    kw = dict(min_disp=cfg.min_disp, th_col=cfg.params.th_col, scale=scale,
              zero=zero,
              stats=(data.guide[0], data.gf_mean[0], data.gf_inv[0]),
              pad=cfg.pad, r_gf=r_gf)
    got = unary_cuda.sample_windows(*args, **kw)
    want = unary_cuda.sample_windows_reference(*args, **kw)
    torch.cuda.synchronize()
    err = float((got - want).abs().masked_fill(~support, 0).max())
    ok = bool(torch.isfinite(got.masked_fill(~support, 0)).all()
              and err <= UNARY_ATOL[r_gf])
    bitwise = float((got == want)[support].double().mean())
    # Bytes: each window pixel's output and two volume taps, the windows'
    # union of the statistics (12 float32 a pixel), the proposals and
    # origins; operations: per window pixel.
    span = [(nb - 1) * min(f, 4 * layer.unit_size) + f
            for nb in (layer.nbx, layer.nby)]
    px = n * f * f
    nbytes = (px * (4 + 2 * vol.element_size())
              + (span[0] * span[1] * 48 if r_gf else 0)
              + n * (16 + 2 * fox.element_size()))
    bound_ms, bound_by = bound(
        nbytes, px * (OPS_SAMPLE + (OPS_GUIDED if r_gf else 0)))
    row = {"F": f, "N": n, "r_gf": r_gf, "dtype": dtype,
           "plan": unary_cuda.describe(f, n, r_gf,
                                       unary_cuda.VOL_TYPES[vol.dtype]),
           "max_abs_err": err, "bitwise_equal": bitwise,
           "atol": UNARY_ATOL[r_gf], "ok": ok,
           "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
           "ms": time_ms(torch, lambda: unary_cuda.sample_windows(
               *args, **kw), 5),
           "plain_ms": time_ms(
               torch, lambda: unary_cuda.sample_windows_reference(
                   *args, **kw), 3)}
    emit({"phase": "unary_kernel", **row})
    if not ok:
        raise AssertionError(f"sample_windows disagrees: {row}")
    return row


def timed_layers(torch, engine, layer_times):
    """Wraps engine.layer_sweep to record per-layer seconds (synchronized)."""
    inner = engine.layer_sweep

    def layer_sweep(data, cfg, labeling_m, cost_m, layer, li, *a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        inner(data, cfg, labeling_m, cost_m, layer, li, *a, **kw)
        torch.cuda.synchronize()
        layer_times.append((li, kw["do_gc"], time.perf_counter() - t0))
    return inner, layer_sweep


def run_slice(torch, pm_iterations: int, iterations: int):
    from localexpstereo_tpu_torch.models import engine
    from localexpstereo_tpu_torch.utils import synthetic
    solver, truth, sizes = synthetic.bench_solver(1.0, "cuda")
    t0 = time.perf_counter()
    solver.finalize()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    rec = Recorder(torch)
    solver.set_evaluator(rec)
    layer_times = []
    inner, wrapped = timed_layers(torch, engine, layer_times)
    engine.layer_sweep = wrapped
    fns = reset_launches()
    t_run = time.perf_counter()
    try:
        solver.run(iterations=iterations, pm_iterations=pm_iterations)
        torch.cuda.synchronize()
    finally:
        engine.layer_sweep = inner
    run_s = time.perf_counter() - t_run
    launches = fns["expansion_accept"].launches
    energies = [e for _, e, _ in rec.rows]
    sweep_s = [b[2] - a[2] for a, b in zip(rec.rows, rec.rows[1:])]
    b05, b10 = bad_rates(solver, truth)
    row = {"phase": "slice", "shape": [solver.cfg.height, solver.cfg.width],
           "ndisp": int(solver.vol0.shape[0]), "layers": sizes,
           "pm_iterations": pm_iterations, "iterations": iterations,
           "setup_s": setup_s, "init_s": rec.rows[0][2] - t_run,
           "run_s": run_s, "sweep_s": sweep_s,
           "layer_s": [[li, "gc" if gc else "greedy", s]
                       for li, gc, s in layer_times],
           "energies": energies, "bad05": b05, "bad10": b10,
           "expansion_accept_launches": launches,
           "sample_windows_launches": fns["sample_windows"].launches,
           "refit_sums_launches": fns["refit_sums"].launches,
           "draw_launches": {k: fns[k].launches for k in DRAW_KERNELS}}
    emit(row)
    if 0 in (launches, row["sample_windows_launches"],
             row["refit_sums_launches"]):
        raise AssertionError("the sweeps never launched a kernel: "
                             f"{launches}, {row['sample_windows_launches']}, "
                             f"{row['refit_sums_launches']}")
    gc = energies[pm_iterations + 1:]
    if gc[0] > energies[pm_iterations] or any(
            b > a for a, b in zip(gc, gc[1:])):
        raise AssertionError(f"graph-cut energy rose: {energies}")
    return row


class TimedKernels:
    """Stands in for the engine's ``mincut_cuda`` module: times every
    ``expansion_accept`` call with CUDA events, keyed by its (S, N)."""

    def __init__(self, torch, real):
        self.torch = torch
        self.real = real
        self.calls = []

    def expansion_accept(self, halo, *args, **kwargs):
        ev = [self.torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out = self.real.expansion_accept(halo, *args, **kwargs)
        ev[1].record()
        self.calls.append((halo.shape[1] - 2, halo.shape[0], *ev))
        return out

    def by_shape(self):
        self.torch.cuda.synchronize()
        rows = {}
        for s, n, a, b in self.calls:
            row = rows.setdefault((s, n), {"S": s, "N": n, "calls": 0,
                                           "kernel_s": 0.0})
            row["calls"] += 1
            row["kernel_s"] += a.elapsed_time(b) / 1e3
        return sorted(rows.values(), key=lambda r: -r["S"])


class CapturedKernels:
    """Stands in for the engine's ``mincut_cuda`` module: passes every call
    through to it (the launch counts go on as they would) and keeps a copy
    of the first ``expansion_accept`` call's inputs of each (S, N)."""

    def __init__(self, real):
        self.real = real
        self.first = {}

    def __getattr__(self, name):
        return getattr(self.real, name)

    def expansion_accept(self, halo, *args, **kwargs):
        shape = (halo.shape[1] - 2, halo.shape[0])
        if shape not in self.first:
            self.first[shape] = ([a.clone() for a in (halo, *args)],
                                 dict(kwargs))
        return self.real.expansion_accept(halo, *args, **kwargs)


def profiled(torch, fn):
    """Runs ``fn`` under torch.profiler. Returns the synchronized wall
    seconds, the device's busy seconds (the sum of the durations of its
    kernels and copies; one stream, so they do not overlap), the idle share
    of that one window, the number of device ops and the largest ones, and
    the host's seconds inside torch ops (self time, summed; the rest of
    the wall time is Python outside them) with the largest ops."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            t, c = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (t + e.device_time_total / 1e6, c + 1)
    dev = sorted(((t, c, k) for k, (t, c) in by_name.items()), reverse=True)
    busy = sum(t for t, _, _ in dev)
    if busy <= 0:
        raise AssertionError("the profiler saw no device time")
    host = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    return {"wall_s": wall, "device_busy_s": busy,
            "idle_share": 1.0 - busy / wall,
            "device_ops": sum(c for _, c, _ in dev),
            "top": [[k[:80], t, c] for t, c, k in dev[:8]],
            "host_op_s": sum(e.self_cpu_time_total for e in host) / 1e6,
            "host_top": [[e.key[:60], e.self_cpu_time_total / 1e6, e.count]
                         for e in host[:8]]}


def greedy_walls(torch, solvers, order):
    """Unprofiled wall seconds (synchronized) of the init + one greedy
    sweep, per unary route, the routes taken in ``order``."""
    walls = {route: [] for route in solvers}
    for route in order:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solvers[route].run(iterations=0, pm_iterations=1)
        torch.cuda.synchronize()
        walls[route].append(time.perf_counter() - t0)
    return walls


def phase_profile(torch):
    """The init + one greedy sweep of the slice on each unary route,
    unprofiled in turns (auto, dma, dma, auto), then the "dma" route's under
    torch.profiler; then one graph-cut sweep on the "auto" route (the 1 + 1
    run's trajectory, in a warm process) under torch.profiler, the
    graph-cut kernel timed per call with CUDA events. Parsing a profiled
    window's trace takes minutes, so there are two."""
    from localexpstereo_tpu_torch.models import engine
    from localexpstereo_tpu_torch.ops import mincut_cuda, rng
    from localexpstereo_tpu_torch.utils import synthetic
    solvers = {}
    for route in ("auto", "dma"):
        solvers[route], _, sizes = synthetic.bench_solver(1.0, "cuda",
                                                          route=route)
        solvers[route].finalize()
    parts = {}
    t0 = time.perf_counter()
    walls = greedy_walls(torch, solvers,
                         ("auto", "dma", "dma", "auto"))
    parts["walls_s"] = time.perf_counter() - t0
    greedy_dma = profiled(torch, lambda: solvers["dma"].run(
        iterations=0, pm_iterations=1))
    parts["greedy_profiled_s"] = time.perf_counter() - t0 - parts["walls_s"]
    solver = solvers.pop("auto")
    del solvers
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    timed = TimedKernels(torch, mincut_cuda)
    engine.mincut_cuda = timed
    try:
        key = rng.fold_in(rng.PRNGKey(solver.seed), 3000 + 1)
        t0 = time.perf_counter()
        gc = profiled(torch, lambda: solver._sweep(solver._state[0], 0, 0,
                                                   True, key))
        parts["gc_profiled_s"] = time.perf_counter() - t0
    finally:
        engine.mincut_cuda = mincut_cuda
    gc["kernel_by_shape"] = timed.by_shape()
    gc["kernel_s"] = sum(r["kernel_s"] for r in gc["kernel_by_shape"])
    emit({"phase": "profile", "layers": sizes, "greedy_wall_s": walls,
          "seconds": parts,
          "greedy_dma": greedy_dma, "gc": gc,
          "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30})


def write_midv3_scene(target: pathlib.Path, scale: float = 1.0,
                      seed: int = 0):
    """The synthetic problem (1436 x 992 x 145 at scale 1.0) of ``seed`` as
    a MiddV3 directory: im0/im1.png (the image as uint8), calib.txt,
    im0.acrt, disp0GT.pfm."""
    from localexpstereo_tpu_torch.utils import acrt, pfm, png, synthetic
    img, vol, h, w, nd, truth = synthetic.build_problem(scale, seed)
    target.mkdir(parents=True)
    for name in ("im0.png", "im1.png"):
        png.write(str(target / name), img.astype(np.uint8))
    (target / "calib.txt").write_text(
        f"cam0=[1000 0 {w / 2}; 0 1000 {h / 2}; 0 0 1]\n"
        f"cam1=[1000 0 {w / 2}; 0 1000 {h / 2}; 0 0 1]\n"
        f"doffs=0\nbaseline=100\nwidth={w}\nheight={h}\nndisp={nd}\n")
    acrt.write_acrt(str(target / "im0.acrt"), vol)
    pfm.write_pfm(str(target / "disp0GT.pfm"), truth)
    return h, w


def read_log(path: pathlib.Path):
    rows = path.read_text().strip().split("\n")
    if rows[0].split("\t") != ["Time", "Eng", "Data", "Smooth", "all",
                               "nonocc"]:
        raise AssertionError(f"bad log header {rows[0]!r}")
    return [[float(v) for v in row.split("\t")] for row in rows[1:]]


def cli_scene():
    """The MiddV3 directory of the cli and fuse phases, written at first
    use (main removes it at the end). Returns (path, (h, w), seconds
    spent writing it now)."""
    from localexpstereo_tpu_torch.utils import pfm
    scene = CLI_DIR / "scene"
    t0 = time.perf_counter()
    if not scene.exists():
        shutil.rmtree(CLI_DIR, ignore_errors=True)
        write_midv3_scene(scene)
    h, w = pfm.read_pfm(str(scene / "disp0GT.pfm")).shape
    return scene, (h, w), time.perf_counter() - t0


def run_cli(argv, out, mode="MiddV3", scene=None):
    """The port's command line in ``mode`` on ``scene`` (default: the
    shared MiddV3 scene); returns (wall seconds, log rows, time.txt,
    disparity map)."""
    from localexpstereo_tpu_torch.cli import main as cli
    from localexpstereo_tpu_torch.utils import pfm
    if scene is None:
        scene, _, _ = cli_scene()
    t0 = time.perf_counter()
    rc = cli.main(["-mode", mode, "-targetDir", str(scene),
                   "-outputDir", str(out), *argv])
    wall_s = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"the CLI returned {rc}")
    return (wall_s, read_log(out / "debug" / "log_output.txt"),
            float((out / "time.txt").read_text()),
            pfm.read_pfm(str(out / "disp0.pfm")))


def kernel_launches():
    """The port's kernel wrappers by name, from its one registry."""
    from localexpstereo_tpu_torch.ops import kernels
    return kernels.wrappers()


def check_disparity(disp, shape):
    if list(disp.shape) != list(shape) or not np.isfinite(disp).all():
        raise AssertionError(f"bad disparity map: {disp.shape}")


def phase_cli(torch):
    """The port's command line on the problem written as a MiddV3
    directory, -unaryBackend dma on the card, the default 2 + 5 schedule."""
    _, shape, write_s = cli_scene()
    fns = kernel_launches()
    for fn in fns.values():
        fn.launches = 0
    wall_s, log, time_txt, disp = run_cli(
        ["-unaryBackend", "dma", "-device", "cuda"], CLI_DIR / "out")
    launches = {k: fns[k].launches for k in SOLVE_KERNELS}
    row = {"phase": "cli", "argv": "-mode MiddV3 -unaryBackend dma "
                                   "-device cuda (2 + 5)",
           "scene_write_s": write_s, "wall_s": wall_s, "time_txt": time_txt,
           "time": [r[0] for r in log],
           "sweep_s": [b[0] - a[0] for a, b in zip(log, log[1:])],
           "energies": [r[1] for r in log], "bad_all": [r[4] for r in log],
           "launches": launches, "disp_shape": list(disp.shape),
           "disp_finite": bool(np.isfinite(disp).all())}
    emit(row)
    energies = row["energies"]
    if len(energies) != 1 + 2 + 5:
        raise AssertionError(f"expected 8 log rows, got {len(energies)}")
    check_disparity(disp, shape)
    if min(launches.values()) == 0:
        raise AssertionError(f"a kernel was never launched: {launches}")
    gc = energies[2:]
    if any(b > a for a, b in zip(gc, gc[1:])):
        raise AssertionError(f"graph-cut energy rose: {energies}")
    return row


class FuseTimer:
    """Times, synchronized, every ``LocalExpansionSolver.run`` (by seed and
    whether it fuses), the warm-start unary inside ``run`` and every fusion
    color step, by unit size and by whether it ran inside the fused run."""

    def __init__(self, torch, engine):
        self.torch, self.engine = torch, engine
        self.runs, self.warm_start, self.steps = [], [], []
        self.fusing = False
        self.saved = (engine.LocalExpansionSolver.run,
                      engine.init_from_labeling, engine.fusion_color_step)

    def timed(self, fn, record):
        def wrapper(*args, **kwargs):
            self.torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            self.torch.cuda.synchronize()
            record(args, kwargs, time.perf_counter() - t0)
            return out
        return wrapper

    def __enter__(self):
        eng = self.engine
        run, warm, step = self.saved

        def fused_run(solver, *args, **kwargs):
            self.fusing = bool(kwargs.get("fuse_with"))
            try:
                return self.timed(run, lambda a, kw, t: self.runs.append(
                    (a[0].seed, self.fusing, t)))(solver, *args, **kwargs)
            finally:
                self.fusing = False

        eng.LocalExpansionSolver.run = fused_run
        eng.init_from_labeling = self.timed(
            warm, lambda a, kw, t: self.warm_start.append(t))
        eng.fusion_color_step = self.timed(
            step, lambda a, kw, t: self.steps.append(
                (kw["unit_size"], self.fusing, t)))
        return self

    def __exit__(self, *exc):
        eng = self.engine
        (eng.LocalExpansionSolver.run, eng.init_from_labeling,
         eng.fusion_color_step) = self.saved

    def fused_layers(self):
        """[[unit size, color steps, seconds], ...] of the fused run."""
        by = {}
        for unit, fusing, t in self.steps:
            if fusing:
                n, total = by.get(unit, (0, 0.0))
                by[unit] = (n + 1, total + t)
        return [[u, n, t] for u, (n, t) in sorted(by.items(), reverse=True)]


def phase_fuse(torch):
    """The command line with -fuseSeeds 2 on the same directory: the
    default 2 + 5 schedule of seed 1 (untimed), a throwaway fusion on the
    warm-up state, then the timed 2 + 5 solve of seed 0 fused with seed 1's
    labeling at every layer."""
    from localexpstereo_tpu_torch.models import engine
    _, shape, write_s = cli_scene()
    fns = kernel_launches()
    torch.cuda.reset_peak_memory_stats()
    for fn in fns.values():
        fn.launches = 0
    with FuseTimer(torch, engine) as timer:
        wall_s, log, time_txt, disp = run_cli(
            ["-unaryBackend", "dma", "-fuseSeeds", "2", "-device", "cuda"],
            CLI_DIR / "fuse")
    launches = {k: fn.launches for k, fn in fns.items()}
    energies = [r[1] for r in log]
    row = {"phase": "fuse", "argv": "-mode MiddV3 -unaryBackend dma "
                                    "-fuseSeeds 2 -device cuda (2 + 5)",
           "scene_write_s": write_s, "wall_s": wall_s, "time_txt": time_txt,
           "time": [r[0] for r in log], "energies": energies,
           "bad_all": [r[4] for r in log],
           "runs_s": [[seed, fusing, t] for seed, fusing, t in timer.runs],
           "aux_solve_s": [t for seed, fusing, t in timer.runs if seed == 1],
           "warm_start_unary_s": timer.warm_start,
           "fusion_layer_s": timer.fused_layers(),
           "fusion_s": log[-1][0] - log[-2][0] if len(log) > 1 else None,
           "launches": launches, "disp_shape": list(disp.shape),
           "disp_finite": bool(np.isfinite(disp).all()),
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    emit(row)
    if len(energies) != 1 + 2 + 5 + 1:
        raise AssertionError(f"expected 9 log rows, got {len(energies)}")
    check_disparity(disp, shape)
    if min(launches.values()) == 0:
        raise AssertionError(f"a kernel was never launched: {launches}")
    gc = energies[2:8]
    if any(b > a for a, b in zip(gc, gc[1:])) or energies[8] > energies[7]:
        raise AssertionError(f"graph-cut or fused energy rose: {energies}")
    return row


def disparity_bad(disp, truth, threshold):
    return float((np.abs(disp - truth) > threshold).mean() * 100)


class SetupTimer:
    """Times every ``energy.build_energy`` call (the host set-up of a
    solve, synchronized) while it is active."""

    def __init__(self, torch, energy):
        self.torch, self.energy = torch, energy
        self.build = energy.build_energy
        self.seconds = []

    def __enter__(self):
        def timed_build(*args, **kwargs):
            t0 = time.perf_counter()
            out = self.build(*args, **kwargs)
            self.torch.cuda.synchronize()
            self.seconds.append(time.perf_counter() - t0)
            return out
        self.energy.build_energy = timed_build
        return self

    def __exit__(self, *exc):
        self.energy.build_energy = self.build


def post_process_row(post, disp, raw, out, sweeps):
    """The dual and v2 phases' post-process fields: the timed run's call
    (the first is the warm-up's), the pixels it changed outside those the
    check failed (must be 0), and the consistency images missing."""
    call = post.calls[-1]
    fail_u8 = call["fail_maps"][0].numpy()
    changed = disp != raw
    debug = out / "debug"
    missing = [f"result{m}C{i:02d}.png" for i in range(1, 1 + sweeps)
               for m in (0, 1)
               if not (debug / f"result{m}C{i:02d}.png").exists()]
    return fail_u8, {
        "post_process_s": {k: call[k] for k in
                           ("check_s", "fill_s", "median_s", "total_s")},
        "post_process_calls": len(post.calls),
        "failed_pixels": call["failed"],
        "failed_share": [c / disp.size for c in call["failed"]],
        "changed_pixels": int(changed.sum()),
        "changed_outside_failed": int((changed & ~(fail_u8 > 0)).sum()),
        "consistency_images_missing": missing}


def phase_dual(torch, cli_row=None):
    """The command line with -doDual 1 on the same directory (no im1.acrt:
    the right volume is recovered from the left), -unaryBackend dma, the
    default 2 + 5 schedule on both views, then the post-process. With the
    cli phase's row, the kernels' launches are held at twice its own."""
    from localexpstereo_tpu_torch.models import energy, postprocess
    from localexpstereo_tpu_torch.utils import pfm
    scene, shape, write_s = cli_scene()
    truth = pfm.read_pfm(str(scene / "disp0GT.pfm"))
    fns = kernel_launches()
    torch.cuda.reset_peak_memory_stats()
    for fn in fns.values():
        fn.launches = 0
    out = CLI_DIR / "dual"
    with SetupTimer(torch, energy) as setup, \
            PostProcessTimer(torch, postprocess) as post:
        wall_s, log, time_txt, disp = run_cli(
            ["-unaryBackend", "dma", "-doDual", "1", "-device", "cuda"], out)
    raw = pfm.read_pfm(str(out / "disp0raw.pfm"))
    launches = {k: fns[k].launches for k in SOLVE_KERNELS}
    energies = [r[1] for r in log]
    fail_u8, post_row = post_process_row(post, disp, raw, out, 2 + 5)
    row = {"phase": "dual", "argv": "-mode MiddV3 -unaryBackend dma "
                                    "-doDual 1 -device cuda (2 + 5)",
           "scene_write_s": write_s, "wall_s": wall_s, "time_txt": time_txt,
           "setup_s": setup.seconds,
           "time": [r[0] for r in log], "energies": energies,
           "sweep_s": [b[0] - a[0] for a, b in zip(log, log[1:])],
           "bad_all": [r[4] for r in log],
           "bad_disp0": [disparity_bad(disp, truth, t) for t in (0.5, 1.0)],
           "bad_disp0raw": [disparity_bad(raw, truth, t)
                            for t in (0.5, 1.0)],
           # By the check's verdict on view 0 (128: the lookup left the
           # image; 255: the views disagree; 0: passed), the pixels off
           # the truth by more than 1.0 before and after the post-process,
           # and the pixels.
           "bad10_by_fail": {
               str(v): [int((np.abs(img - truth) > 1.0)[fail_u8 == v].sum())
                        for img in (raw, disp)] + [int((fail_u8 == v).sum())]
               for v in (0, 128, 255)},
           **post_row,
           "launches": launches,
           "launches_over_cli": ({k: v / max(cli_row["launches"][k], 1)
                                  for k, v in launches.items()}
                                 if cli_row else None),
           "disp_shape": list(disp.shape), "raw_shape": list(raw.shape),
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    emit(row)
    if len(energies) != 1 + 2 + 5 + 1:
        raise AssertionError(f"expected 9 log rows, got {len(energies)}")
    check_disparity(disp, shape)
    check_disparity(raw, shape)
    check_post_process(row)
    if min(launches.values()) == 0:
        raise AssertionError(f"a kernel was never launched: {launches}")
    if cli_row and any(abs(v - 2.0) > 0.1
                       for v in row["launches_over_cli"].values()):
        raise AssertionError(f"launches are not twice the cli run's: {row}")
    gc = energies[2:8]
    if any(b > a for a, b in zip(gc, gc[1:])):
        raise AssertionError(f"graph-cut energy rose: {energies}")
    return row


def check_post_process(row):
    if row["changed_outside_failed"] or row["consistency_images_missing"]:
        raise AssertionError(
            f"post-process changed pixels that passed the check, or "
            f"consistency images are missing: "
            f"{row['changed_outside_failed']}, "
            f"{row['consistency_images_missing']}")


def phase_v2(torch):
    """The command line in the MiddV2 mode as the reference demo runs cones
    (``-smooth_weight 1 -doDual 1``), on the card, at the default 2 + 5, on
    a cones-sized synthetic V2 directory written under ``build/``."""
    from localexpstereo_tpu_torch.models import energy, postprocess
    from localexpstereo_tpu_torch.utils import pfm, png, synthetic
    scene = CLI_DIR / "v2_scene"
    t0 = time.perf_counter()
    shutil.rmtree(scene, ignore_errors=True)
    truth = synthetic.write_v2_scene(str(scene), V2_H, V2_W, V2_NDISP)
    nonocc = png.read_gray(str(scene / "nonocc.png")) == 255
    write_s = time.perf_counter() - t0
    fns = kernel_launches()
    torch.cuda.reset_peak_memory_stats()
    for fn in fns.values():
        fn.launches = 0
    out = CLI_DIR / "v2"
    argv = ["-smooth_weight", "1", "-doDual", "1", "-device", "cuda"]
    with SetupTimer(torch, energy) as setup, \
            PostProcessTimer(torch, postprocess) as post:
        wall_s, log, time_txt, disp = run_cli(argv, out, mode="MiddV2",
                                              scene=scene)
    raw = pfm.read_pfm(str(out / "disp0raw.pfm"))
    launches = {k: fn.launches for k, fn in fns.items()}
    energies = [r[1] for r in log]
    _, post_row = post_process_row(post, disp, raw, out, 2 + 5)

    def bad05(img):
        err = np.abs(img - truth) > 0.5
        return [float(err.mean() * 100), float(err[nonocc].mean() * 100)]

    row = {"phase": "v2", "argv": "-mode MiddV2 " + " ".join(argv)
                                  + " (2 + 5)",
           "shape": [V2_H, V2_W], "ndisp": V2_NDISP,
           "scene_write_s": write_s, "wall_s": wall_s, "time_txt": time_txt,
           "setup_s": setup.seconds,
           "time": [r[0] for r in log], "energies": energies,
           "sweep_s": [b[0] - a[0] for a, b in zip(log, log[1:])],
           "bad_all": [r[4] for r in log], "bad_nonocc": [r[5] for r in log],
           # [all pixels, non-occluded] off the quarter-pixel truth by > 0.5.
           "bad05_disp0": bad05(disp), "bad05_disp0raw": bad05(raw),
           **post_row, "launches": launches,
           "disp_shape": list(disp.shape), "raw_shape": list(raw.shape),
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    emit(row)
    if len(energies) != 1 + 2 + 5 + 1:
        raise AssertionError(f"expected 9 log rows, got {len(energies)}")
    check_disparity(disp, truth.shape)
    check_disparity(raw, truth.shape)
    check_post_process(row)
    if launches["expansion_accept"] == 0 or launches["sample_windows"]:
        raise AssertionError(f"the V2 solve launched the expansion kernel "
                             f"no time, or the volume kernel: {launches}")
    gc = energies[2:8]
    if any(b > a for a, b in zip(gc, gc[1:])):
        raise AssertionError(f"graph-cut energy rose: {energies}")
    return row


@functools.lru_cache(maxsize=1)
def stream_scene():
    """The stream phase's scene, wide enough for its pan: (left, right
    [H, W', 3] uint8, left disparity truth [H, W'], nonocc [H, W'])."""
    from localexpstereo_tpu_torch.utils import synthetic
    return synthetic.v2_scene(
        STREAM_H, STREAM_W + STREAM_STEP * (STREAM_FRAMES - 1), STREAM_NDISP)


def mccnn_net(device):
    from localexpstereo_tpu_torch.models import mccnn
    return mccnn.params_from_jax(mccnn.load_default_params()).to(device)


def mccnn_bound(h: int, w: int, nd: int, channels):
    """(ms, by) of one pair's volume: the towers' multiply-adds on both
    images and the correlation's, in float32; the images read and the
    volume written once."""
    c_in, ops = 3, 0
    for c_out in channels:
        ops += 2 * 9 * c_in * c_out
        c_in = c_out
    nops = h * w * (2 * ops + 2 * nd * c_in)
    return bound(2 * h * w * 3 * 4 + nd * h * w * 4, nops)


def phase_mccnn(torch):
    """The MC-CNN on the card against the CPU on a crop of the stream
    scene, then the full volume of one pair timed on the card."""
    from localexpstereo_tpu_torch.models import mccnn
    left, right, _, _ = stream_scene()
    h, w, nd = MCCNN_CROP
    y0, x0 = (STREAM_H - h) // 2, (STREAM_W - w) // 2
    crop = [np.ascontiguousarray(im[y0:y0 + h, x0:x0 + w])
            for im in (left, right)]
    gpu, cpu = mccnn_net("cuda"), mccnn_net("cpu")
    tf32 = torch.backends.cudnn.allow_tf32
    f_err = float((mccnn.features(gpu, crop[0]).cpu()
                   - mccnn.features(cpu, crop[0])).abs().max())
    v_err = float((mccnn.cost_volume(gpu, *crop, nd).cpu()
                   - mccnn.cost_volume(cpu, *crop, nd)).abs().max())
    restored = torch.backends.cudnn.allow_tf32 == tf32
    ims = [torch.as_tensor(im[:, :STREAM_W], dtype=torch.float32,
                           device="cuda") for im in (left, right)]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    times = []
    for i in range(4):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        vol = mccnn.cost_volume(gpu, *ims, STREAM_NDISP)
        b.record()
        torch.cuda.synchronize()
        if i:
            times.append(a.elapsed_time(b))
        del vol
    bound_ms, bound_by = mccnn_bound(STREAM_H, STREAM_W, STREAM_NDISP,
                                     [c.out_channels for c in gpu.convs])
    ok = max(f_err, v_err) <= MCCNN_ATOL and restored
    row = {"phase": "mccnn", "crop": list(MCCNN_CROP),
           "features_max_abs_err": f_err, "volume_max_abs_err": v_err,
           "atol": MCCNN_ATOL, "cudnn_tf32_setting_restored": restored,
           "shape": [STREAM_H, STREAM_W, STREAM_NDISP],
           "volume_ms": statistics.median(times), "volume_ms_runs": times,
           "bound_ms": bound_ms, "bound_by": bound_by,
           "peak_gib": (torch.cuda.max_memory_allocated() - base) / 2 ** 30,
           "ok": ok}
    emit(row)
    if not ok:
        raise AssertionError(f"the card's MC-CNN disagrees with the CPU's: "
                             f"{row}")
    return row


def stream_gc_launches(iterations: int) -> int:
    """expansion_accept launches of ``iterations`` graph-cut sweeps of the
    stream's solve: one a plan step, a color and a layer (make_plan and
    the layers of a 1436 x 992 frame)."""
    from localexpstereo_tpu_torch.models import engine, grid
    layers = grid.build_layers(STREAM_W, STREAM_H, STREAM_LAYERS)
    return sum(
        len(engine.make_plan(engine.LAYER0_PROPOSERS if li == 0
                             else engine.COARSE_PROPOSERS, it, 0.0,
                             float(STREAM_NDISP - 1))) * len(layer.colors)
        for it in range(iterations) for li, layer in enumerate(layers))


def phase_stream(torch):
    """StereoStream over the panned scene with the MC-CNN volume of each
    frame computed on the card."""
    from localexpstereo_tpu_torch.config import PARAMS_GF
    from localexpstereo_tpu_torch.models import engine, mccnn
    from localexpstereo_tpu_torch.serving import StereoStream
    left, right, truth, nonocc = stream_scene()
    net = mccnn_net("cuda")
    ims = [torch.as_tensor(im, dtype=torch.float32, device="cuda")
           for im in (left, right)]
    stream = StereoStream(PARAMS_GF.replace(windR=20, lambda_=0.5,
                                            th_col=0.5),
                          max_disp=float(STREAM_NDISP - 1),
                          unit_sizes=STREAM_LAYERS, profile=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fns = kernel_launches()
    for fn in fns.values():
        fn.launches = 0
    frames, maps = [], {}
    for k in range(STREAM_FRAMES):
        if k == 1 + STREAM_PROFILED:
            stream.profile, stream.pipelined = False, True
        cols = slice(STREAM_STEP * k, STREAM_STEP * k + STREAM_W)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        vol = mccnn.cost_volume(net, ims[0][:, cols], ims[1][:, cols],
                                STREAM_NDISP)
        torch.cuda.synchronize()
        mccnn_s = time.perf_counter() - t0
        disp = stream.process(ims[0][:, cols], ims[1][:, cols], vol, vol)
        del vol
        s = stream.solver
        frames.append({
            "frame": k, "kind": "cold" if k == 0 else "warm",
            "pipelined": stream.pipelined, "mccnn_s": mccnn_s,
            "frame_s": stream.last_frame_seconds,
            "split": stream.last_timings if stream.profile else None,
            "energy": float(engine.energy_audit(s.data, s.cfg, *s._state[0],
                                                0)[0])})
        if disp is not None:
            maps[k - 1 if stream.pipelined else k] = disp
    maps[STREAM_FRAMES - 1] = stream.flush()
    launches = {k: fn.launches for k, fn in fns.items()}
    for k, row in enumerate(frames):
        cols = slice(STREAM_STEP * k, STREAM_STEP * k + STREAM_W)
        err = np.abs(maps[k] - truth[:, cols]) > 1.0
        row["finite"] = bool(np.isfinite(maps[k]).all())
        row["bad10"] = float(err.mean() * 100)
        row["bad10_nonocc"] = float(err[nonocc[:, cols]].mean() * 100)
    warm_sync = [r["frame_s"] for r in frames[1:1 + STREAM_PROFILED]]
    piped = [r["frame_s"] for r in frames[1 + STREAM_PROFILED:]]
    expected = stream_gc_launches(5) + (STREAM_FRAMES - 1) * \
        stream_gc_launches(1)
    row = {"phase": "stream", "shape": [STREAM_H, STREAM_W, STREAM_NDISP],
           "layers": STREAM_LAYERS, "step_px": STREAM_STEP,
           "frames": frames, "cold_s": frames[0]["frame_s"],
           "warm_sync_mean_s": statistics.mean(warm_sync),
           "warm_pipelined_mean_s": statistics.mean(piped),
           "warm_split_mean_s": {
               key: statistics.mean(r["split"][key]
                                    for r in frames[1:1 + STREAM_PROFILED])
               for key in ("build_s", "solve_s", "output_s")},
           "mccnn_mean_s": statistics.mean(r["mccnn_s"] for r in frames),
           "launches": launches, "expansion_accept_expected": expected,
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    emit(row)
    cold = frames[0]["bad10"]
    if not all(r["finite"] for r in frames):
        raise AssertionError("a stream frame's map is not finite")
    if any(r["bad10"] > cold + STREAM_BAD_MARGIN for r in frames[1:]):
        raise AssertionError(f"a warm frame's bad1.0 is more than "
                             f"{STREAM_BAD_MARGIN} points above the cold "
                             f"frame's: {[r['bad10'] for r in frames]}")
    if launches["expansion_accept"] != expected:
        raise AssertionError(f"expansion_accept launched "
                             f"{launches['expansion_accept']} times, the "
                             f"schedule has {expected}")
    if launches["sample_windows"] == 0:
        raise AssertionError("the stream's sweeps never launched "
                             "sample_windows")
    return row


def write_stream_frame_scene(target: pathlib.Path):
    """The stream scene's first frame as a MiddV3 directory without any
    .acrt: im0/im1.png, calib.txt, disp0GT.pfm."""
    from localexpstereo_tpu_torch.utils import pfm, png
    left, right, truth, _ = stream_scene()
    h, w, nd = STREAM_H, STREAM_W, STREAM_NDISP
    target.mkdir(parents=True)
    png.write(str(target / "im0.png"), np.ascontiguousarray(left[:, :w]))
    png.write(str(target / "im1.png"), np.ascontiguousarray(right[:, :w]))
    (target / "calib.txt").write_text(
        f"cam0=[1000 0 {w / 2}; 0 1000 {h / 2}; 0 0 1]\n"
        f"cam1=[1000 0 {w / 2}; 0 1000 {h / 2}; 0 0 1]\n"
        f"doffs=0\nbaseline=100\nwidth={w}\nheight={h}\nndisp={nd}\n")
    pfm.write_pfm(str(target / "disp0GT.pfm"),
                  np.ascontiguousarray(truth[:, :w]))


def phase_cli_mccnn(torch):
    """The command line with -volume mccnn -unaryBackend dma (2 + 5,
    no warm-up solve) on the stream scene's first frame: the left volume
    from the MC-CNN on the card, the right one recovered from it on the
    host, the energy built on the card with the data-dependent uint8
    range."""
    from localexpstereo_tpu_torch.cli import main as cli
    from localexpstereo_tpu_torch.models import energy
    scene = CLI_DIR / "mccnn_scene"
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    if not scene.exists():
        write_stream_frame_scene(scene)
    write_s = time.perf_counter() - t0
    load = cli.load_v3_volumes
    load_s = []

    def timed_load(*args, **kwargs):
        t = time.perf_counter()
        out = load(*args, **kwargs)
        torch.cuda.synchronize()
        load_s.append(time.perf_counter() - t)
        return out
    fns = kernel_launches()
    for fn in fns.values():
        fn.launches = 0
    cli.load_v3_volumes = timed_load
    try:
        with SetupTimer(torch, energy) as setup:
            wall_s, log, time_txt, disp = run_cli(
                ["-volume", "mccnn", "-unaryBackend", "dma", "-warmup", "0",
                 "-device", "cuda"], CLI_DIR / "mccnn_out", scene=scene)
    finally:
        cli.load_v3_volumes = load
    launches = {k: fns[k].launches for k in SOLVE_KERNELS}
    row = {"phase": "cli_mccnn",
           "argv": "-mode MiddV3 -volume mccnn -unaryBackend dma -warmup 0 "
                   "-device cuda (2 + 5)",
           "shape": [STREAM_H, STREAM_W, STREAM_NDISP],
           "scene_write_s": write_s, "wall_s": wall_s,
           "time_txt": time_txt, "volumes_s": load_s,
           "setup_s": setup.seconds,
           "sweep_s": [b[0] - a[0] for a, b in zip(log, log[1:])],
           "energies": [r[1] for r in log], "bad_all": [r[4] for r in log],
           "launches": launches, "disp_shape": list(disp.shape),
           "disp_finite": bool(np.isfinite(disp).all()),
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    emit(row)
    energies = row["energies"]
    if len(energies) != 1 + 2 + 5:
        raise AssertionError(f"expected 8 log rows, got {len(energies)}")
    check_disparity(disp, (STREAM_H, STREAM_W))
    if min(launches.values()) == 0:
        raise AssertionError(f"a kernel was never launched: {launches}")
    gc = energies[2:]
    if any(b > a for a, b in zip(gc, gc[1:])):
        raise AssertionError(f"graph-cut energy rose: {energies}")
    return row


def batch_scenes():
    """The batch phase's three MiddV3 directories, written at first use:
    the cli phase's scene, a second one at its shape (another seed) and a
    third at half its size. Returns (paths, seconds spent writing now)."""
    scene, _, write_s = cli_scene()
    t0 = time.perf_counter()
    scenes = [scene, CLI_DIR / "scene_b", CLI_DIR / "scene_q"]
    for target, (scale, seed) in zip(scenes[1:], ((1.0, BATCH_SEED_B),
                                                  BATCH_SMALL)):
        if not target.exists():
            write_midv3_scene(target, scale, seed)
    return scenes, write_s + time.perf_counter() - t0


def phase_batch(torch):
    """The batch command line (-mode MiddV3, 2 + 5, -warmup 1, one card: in
    process) on three directories in two shape groups, held against the
    single-pair command line with the same flags on pair 0's scene (equal
    disparity, bad1.0 within 0.5 pt, equal expansion launches); then the
    two full-size pairs again through two worker processes on cuda:0
    (ReplicaSolver, the batch command's parameters), their disparities equal to
    the serial run's."""
    from localexpstereo_tpu_torch.cli import batch
    from localexpstereo_tpu_torch.cli import main as cli_main
    from localexpstereo_tpu_torch.config import PARAMS_GF
    from localexpstereo_tpu_torch.parallel.replica import ReplicaSolver
    from localexpstereo_tpu_torch.utils import datasets, pfm
    from localexpstereo_tpu_torch.utils.prefetch import PairPrefetcher
    scenes, write_s = batch_scenes()
    truth = pfm.read_pfm(str(scenes[0] / "disp0GT.pfm"))
    fns = kernel_launches()
    for fn in fns.values():
        fn.launches = 0
    cli_wall, _, cli_time, cli_disp = run_cli(["-device", "cuda"],
                                              CLI_DIR / "batch_cli")
    cli_launches = fns["expansion_accept"].launches
    for fn in fns.values():
        fn.launches = 0
    out = CLI_DIR / "batch"
    t0 = time.perf_counter()
    if batch.main(["-mode", "MiddV3", "-targetDirs", *map(str, scenes),
                   "-outputDir", str(out), "-device", "cuda"]) != 0:
        raise AssertionError("the batch command line failed")
    batch_wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in fns.items()}
    summary = json.loads((out / "batch_summary.json").read_text())
    disps = [pfm.read_pfm(str(out / p.name / "disp0.pfm")) for p in scenes]
    pair_launches = [ln["expansion_accept"] for g in summary["groups"]
                     for ln in g["launches"]]

    # The two full-size pairs on two worker processes of one card.
    dirs = [str(p) for p in scenes[:2]]
    pairs = [datasets.load_data(d) for d in dirs]
    prefetcher = PairPrefetcher(dirs, load_volumes=True)
    rs = ReplicaSolver(
        [p.im0 for p in pairs], [p.im1 for p in pairs],
        PARAMS_GF.replace(windR=20, lambda_=0.5, th_col=0.5),
        pairs[0].max_disparity, cli_main.v3_layers(pairs[0].im0.shape[1]),
        devices=["cuda:0", "cuda:0"], volumes=prefetcher.volumes(), seed=0)
    rs.precompile((0,), 2, 5)
    t0 = time.perf_counter()
    rs.run(5, (0,), 2)
    stats = [rs.pair_stats(b) for b in range(2)]
    workers_wall = (time.perf_counter() - t0
                    - max(st["warmup_s"] for st in stats))
    worker_disps = rs.disparities()
    full = summary["groups"][0]
    # From the first timed solve's start to the last one's end: the two
    # solves' overlap, without the workers' start-up and warm-ups.
    span = (max(st["solve_at"][1] for st in stats)
            - min(st["solve_at"][0] for st in stats))
    row = {"phase": "batch",
           "argv": "-mode MiddV3 -device cuda (2 + 5, -warmup 1)",
           "scenes": [p.name for p in scenes], "scene_write_s": write_s,
           "groups": [[g["shape"], g["datasets"]] for g in summary["groups"]],
           "wall_s": [g["wall_s"] for g in summary["groups"]],
           "amortized_s_per_frame": [g["amortized_s_per_frame"]
                                     for g in summary["groups"]],
           "warmup_s": [g["warmup_s"] for g in summary["groups"]],
           "solve_s": [g["solve_s"] for g in summary["groups"]],
           "load_s": [g["load_s"] for g in summary["groups"]],
           "prefetch_wait_s": [g["prefetch_wait_s"]
                               for g in summary["groups"]],
           "command_wall_s": batch_wall,
           "time_txt": [float((out / p.name / "time.txt").read_text())
                        for p in scenes],
           "expansion_accept_per_pair": pair_launches,
           "cli_expansion_accept": cli_launches, "launches": launches,
           "cli_wall_s": cli_wall, "cli_time_txt": cli_time,
           "pair0_max_abs_diff_vs_cli": float(np.abs(disps[0]
                                                     - cli_disp).max()),
           "bad1_pair0": disparity_bad(disps[0], truth, 1.0),
           "bad1_cli": disparity_bad(cli_disp, truth, 1.0),
           "workers": {"devices": ["cuda:0", "cuda:0"],
                       "wall_s": workers_wall, "solve_span_s": span,
                       "serial_wall_s": full["wall_s"],
                       "solve_s": [st["solve_s"] for st in stats],
                       "serial_solve_s": full["solve_s"],
                       "warmup_s": [st["warmup_s"] for st in stats],
                       "equal_to_serial": [bool(np.array_equal(a, b)) for
                                           a, b in zip(worker_disps, disps)]},
           "nvidia_smi": smi_line()}
    emit(row)
    if [len(g["datasets"]) for g in summary["groups"]] != [2, 1]:
        raise AssertionError(f"expected two shape groups: {row['groups']}")
    for disp, scene in zip(disps, scenes):
        check_disparity(disp, pfm.read_pfm(str(scene / "disp0GT.pfm")).shape)
    if row["pair0_max_abs_diff_vs_cli"] != 0.0:
        raise AssertionError("pair 0 differs from the command line's solve")
    if abs(row["bad1_pair0"] - row["bad1_cli"]) > 0.5:
        raise AssertionError("pair 0's bad1.0 is off the command line's")
    if pair_launches[0] != cli_launches or min(pair_launches) == 0:
        raise AssertionError(f"expansion_accept launches a pair "
                             f"{pair_launches} against the command line's "
                             f"{cli_launches}")
    if launches["sample_windows"] == 0:
        raise AssertionError("the batch never launched sample_windows")
    if not all(row["workers"]["equal_to_serial"]):
        raise AssertionError("the worker processes' disparities differ "
                             "from the serial run's")
    return row


class FiniteRecorder:
    """Evaluator hook: view 0's energy after the init and each sweep, with
    NaN unaries counted as 0 (interp 2's degenerate taps leave some), and
    the NaN pixels."""

    def __init__(self, torch):
        self.torch = torch
        self.energies, self.nan_pixels = [], []

    def start(self):
        pass

    def stop(self):
        pass

    def evaluate(self, solver, labeling_m, cost_m, mode, index):
        from localexpstereo_tpu_torch.models import engine
        nan = self.torch.isnan(cost_m)
        e = engine.energy_audit(solver.data, solver.cfg, labeling_m,
                                cost_m.masked_fill(nan, 0.0), mode)
        self.energies.append(float(e[0]))
        self.nan_pixels.append(int(nan.sum()))


def bf_interp_solve(torch, device, case):
    """One bf_interp solve (BF_SHAPE, BF_SCHEDULE, the reference's layer
    sizing) of ``case`` on ``device``: its energies, NaN pixels, wall
    seconds and kernel launches."""
    from localexpstereo_tpu_torch.cli import main as cli_main
    from localexpstereo_tpu_torch.config import PARAMS_BF, PARAMS_GF
    from localexpstereo_tpu_torch.models import engine
    from localexpstereo_tpu_torch.utils import synthetic
    name, route, interp = case
    h, w, nd = BF_SHAPE
    img, vol, _, _, _, _ = synthetic.planted_problem(h, w, nd)
    params = (PARAMS_BF.replace(windR=BF_WINDR, th_col=0.5) if name == "bf"
              else PARAMS_GF.replace(windR=20, lambda_=0.5, th_col=0.5))
    solver = engine.LocalExpansionSolver(
        img, img, params, float(nd - 1), vol0=vol, vol1=vol, device=device,
        unary_backend=route, interp=interp)
    for i, s in enumerate(cli_main.v3_layers(w)):
        solver.add_layer(s, engine.LAYER0_PROPOSERS if i == 0
                         else engine.COARSE_PROPOSERS)
    rec = FiniteRecorder(torch)
    solver.set_evaluator(rec)
    fns = kernel_launches()
    before = {k: fn.launches for k, fn in fns.items()}
    t0 = time.perf_counter()
    solver.run(iterations=BF_SCHEDULE[1], pm_iterations=BF_SCHEDULE[0])
    wall_s = time.perf_counter() - t0
    return {"energies": rec.energies, "nan_pixels": rec.nan_pixels,
            "wall_s": wall_s,
            "launches": {k: fn.launches - before[k] for k, fn in fns.items()}}


def bf_twins_worker():
    """The bf_interp solves on the CPU, in a worker process that does not
    see the card (main() runs it beside twins_worker)."""
    import os
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    import torch
    torch.set_num_threads(TWIN_THREADS)
    return {case[0]: bf_interp_solve(torch, "cpu", case) for case in BF_CASES}


def phase_bf_interp(torch, twins=None):
    """The bilateral filter and d-interpolation methods 0 and 2: three
    solves on the card against their CPU twins (computed here unless
    given): the init's energy within BF_RTOL relative, every sweep's
    within the trajectory tolerance, the same NaN pixels; then one
    bilateral call at layer 0's shape of the main path and the method
    sampler at that layer's windows, timed."""
    twins = twins or {case[0]: bf_interp_solve(torch, "cpu", case)
                      for case in BF_CASES}
    rows = []
    for case in BF_CASES:
        got = bf_interp_solve(torch, "cuda", case)
        want = twins[case[0]]
        rel = [abs(a - b) / max(abs(b), 1e-12)
               for a, b in zip(got["energies"], want["energies"])]
        ok = (len(got["energies"]) == len(want["energies"])
              == 1 + sum(BF_SCHEDULE)
              and rel[0] <= BF_RTOL
              and _close(got["energies"][1:], want["energies"][1:])
              and got["nan_pixels"] == want["nan_pixels"]
              and (got["nan_pixels"][-1] > 0) == (case[2] == 2)
              and got["launches"]["expansion_accept"] > 0
              and (got["launches"]["sample_windows"] > 0)
              == (case[1] == "dma"))
        row = {"phase": "bf_interp", "case": case[0], "route": case[1],
               "interp": case[2], "shape": list(BF_SHAPE),
               "energies_cuda": got["energies"],
               "energies_cpu": want["energies"],
               "nan_pixels_cuda": got["nan_pixels"],
               "nan_pixels_cpu": want["nan_pixels"], "rel_diff": rel,
               "init_rtol": BF_RTOL, "wall_s_cuda": got["wall_s"],
               "wall_s_cpu": want["wall_s"], "launches": got["launches"],
               "agree": ok}
        emit(row)
        rows.append(row)
        if not ok:
            raise AssertionError(f"bf_interp {case[0]}: the card's solve "
                                 f"disagrees with the CPU's")
    rows.append(bf_interp_times(torch))
    return rows


def bf_interp_times(torch):
    """One bilateral call at (N, F, R) = BF_TIMED on the card, and the
    method sampler (methods 0, 1, 2) and the engine's tent at the main
    path's layer-0 windows of the 1436 x 992 x 145 problem, timed (CUDA
    events) with their bounds."""
    from localexpstereo_tpu_torch.ops import bilateral, unary_volume
    from localexpstereo_tpu_torch.utils import synthetic
    n, f, r = BF_TIMED
    rng = np.random.default_rng(0)
    p = torch.rand((n, f, f), device="cuda")
    guide = torch.rand((n, f, f, 3), device="cuda") * 255.0
    mask = (torch.rand((n, f, f), device="cuda") > 0.1).float()
    torch.cuda.reset_peak_memory_stats()
    bil_ms = time_ms(torch, lambda: bilateral.filter_windows(
        p, guide, mask, r, 10.0), 3)
    bil_bound = bound(n * f * f * 4 * (1 + 3 + 1 + 1),
                      n * f * f * (2 * r + 1) ** 2 * OPS_BILATERAL_TAP)
    bil_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    # The card against the CPU on a slice (float64 sums and exp).
    part = [x[:6].contiguous() for x in (p, guide, mask)]
    on_card = bilateral.filter_windows(*part, r, 10.0).cpu()
    on_cpu = bilateral.filter_windows(*[x.cpu() for x in part], r, 10.0)
    bil_err = float((on_card - on_cpu).abs().max())
    bil_bitwise = float((on_card == on_cpu).double().mean())
    del p, guide, mask, part
    solver, truth, _ = synthetic.bench_solver(1.0, "cuda")
    solver.finalize()
    data, cfg = solver.data, solver.cfg
    layer = solver.layers[0]
    props, fox, foy, fw = synthetic.unary_windows(solver, truth, layer, rng)
    args = (data.vol[0], cfg.vol_pad, props, fox, foy, fw, cfg.height,
            cfg.width)
    kw = dict(min_disp=cfg.min_disp, th_col=cfg.params.th_col,
              scale=cfg.vol_scale, zero=cfg.vol_zero)
    px = props.shape[0] * fw * fw
    methods = {}
    for method, taps in ((0, 1), (1, 4), (2, 5)):
        ms = time_ms(torch, lambda: unary_volume.sample_windows(
            *args, max_disp=cfg.max_disp, method=method, **kw), 5)
        methods[str(method)] = {"ms": ms, "bound_ms": bound(
            px * (4 + taps), px * (OPS_SAMPLE + 4 * taps))[0]}
    methods["tent"] = {"ms": time_ms(torch, lambda: (
        unary_volume.sample_windows_aligned(*args, **kw)), 5)}
    del solver, data
    torch.cuda.empty_cache()
    row = {"phase": "bf_interp", "bilateral": {
        "N": n, "F": f, "R": r, "ms": bil_ms, "bound_ms": bil_bound[0],
        "bound_by": bil_bound[1], "peak_gib": bil_peak,
        "cuda_vs_cpu_max_abs_err": bil_err,
        "cuda_vs_cpu_bitwise": bil_bitwise},
        "sample_windows": {"F": fw, "N": int(props.shape[0]),
                           "methods": methods},
        "nvidia_smi": smi_line()}
    emit(row)
    return row


def sharded_jobs_rank(rank, device, jobs):
    """One rank of the sharded phase's group: each job in turn, on the
    synthetic problem of its (scale, seed), layers sized as the main
    path's. A job is ("volume" | "dvolume", scale, seed, schedule), a solve
    of view 0 (``multichip.solve``), or ("batch", scale, seeds, schedule):
    a BatchedSolver over one pair a seed, built lazily (a rank builds its
    own pairs only)."""
    import torch
    from localexpstereo_tpu_torch.ops import kernels
    from localexpstereo_tpu_torch.parallel.batch import BatchedSolver
    from localexpstereo_tpu_torch.tools import multichip
    from localexpstereo_tpu_torch.utils import synthetic
    params = sharded_params()
    out = []
    for kind, scale, seed, schedule in jobs:
        torch.cuda.empty_cache()
        if kind != "batch":
            img, vol, _, w, nd, _ = synthetic.build_problem(scale, seed)
            sizes = [int(w * f) for f in (0.01, 0.03, 0.09)]
            row = multichip.solve(rank, device, kind, img, vol,
                                  float(nd - 1), sizes, 0, schedule, params)
            del img, vol
        else:
            pairs = BatchPairs(scale, seed)
            torch.cuda.reset_peak_memory_stats(device)
            bs = BatchedSolver(pairs.images(), pairs.images(), params,
                               pairs.max_disp, pairs.sizes, device=device,
                               vols0=pairs.volumes(), vols1=pairs.volumes())
            kernels.zero_launch_counts()
            t0 = time.perf_counter()
            final, _ = bs.run(schedule[1], pm_iterations=schedule[0])
            torch.cuda.synchronize(device)
            row = {"final": final, "pairs": list(bs.pairs),
                   "solve_s": time.perf_counter() - t0,
                   "launches": kernels.launch_counts(),
                   "peak_gib": torch.cuda.max_memory_allocated(device)
                   / 2 ** 30}
        row["job"] = kind
        out.append(row)
    return out


def sharded_params():
    """The main path's parameters (``synthetic.bench_solver``'s)."""
    from localexpstereo_tpu_torch.config import PARAMS_GF
    return PARAMS_GF.replace(windR=20, lambda_=0.5, th_col=0.5)


class BatchPairs:
    """The sharded batch's pairs: ``synthetic.build_problem(scale, seed)``
    for each seed, built at first use, as the sequences BatchedSolver
    indexes."""

    def __init__(self, scale, seeds):
        from localexpstereo_tpu_torch.utils import synthetic
        self.seeds = list(seeds)
        self._build = functools.lru_cache(maxsize=None)(
            lambda b: synthetic.build_problem(scale, self.seeds[b]))
        _, w, nd = synthetic.problem_shape(scale)
        self.max_disp = float(nd - 1)
        self.sizes = [int(w * f) for f in (0.01, 0.03, 0.09)]

    def images(self):
        return _Lazy(len(self.seeds), lambda b: self._build(b)[0])

    def volumes(self):
        return _Lazy(len(self.seeds), lambda b: self._build(b)[1])


class _Lazy:
    def __init__(self, n, get):
        self.n, self.get = n, get

    def __len__(self):
        return self.n

    def __getitem__(self, b):
        return self.get(b)


def shard_row(o):
    """A sharded solve's printed fields (no arrays)."""
    return {k: v for k, v in o.items()
            if k not in ("labels", "cost", "final")}


@contextlib.contextmanager
def plain_unary():
    """While the block runs, every sweep's unary takes the route it takes
    on the CPU ("auto": the plain sampler and guided filter), on the card
    too: the sharded ranks' arithmetic, since the fused kernel does not
    read a part of the volume."""
    from localexpstereo_tpu_torch.models import energy
    real = energy.fused_unary
    energy.fused_unary = lambda cfg, device, size: real(cfg, "cpu", size)
    try:
        yield
    finally:
        energy.fused_unary = real


def phase_sharded(torch):
    """The sharded engines on the card (``localexpstereo_tpu_torch.parallel``,
    one process a rank, gloo: SHARD_RANKS ranks share cuda:0): the
    disparity- and the height-sharded solves of the cli problem (2 + 5,
    one view, auto, so the plain sampler) against the single-device solve
    in this process on the plain sampler (:func:`plain_unary`), and that
    one against the single-device solve on the route "auto" takes on the
    card (the fused unary kernel; energies within the trajectory
    tolerance), the batch over two ranks against each pair's single
    solve, the spatial aggregation over 4 ranks against filter_image, the
    at-scale slice over 4 ranks, and expansion_accept on a row slice under
    plan_n."""
    from localexpstereo_tpu_torch.models import engine
    from localexpstereo_tpu_torch.ops import mincut_cuda
    from localexpstereo_tpu_torch.parallel import collectives
    from localexpstereo_tpu_torch.tools import multichip
    from localexpstereo_tpu_torch.utils import synthetic
    devices = ["cuda:0"] * SHARD_RANKS
    # expansion_accept on a row slice, the whole call's plan (plan_n).
    plan_rows = []
    for s, n, sweeps in SHAPES[1:]:
        arrays, lam, tau = synthetic.fused_move_problem(
            np.random.default_rng(s), n, s)
        args = [torch.as_tensor(a, device="cuda") for a in arrays]
        kw = dict(lam=lam, tau=tau, max_global_rounds=ROUNDS,
                  sweeps_per_round=sweeps)
        lo, hi = n // 3, n // 3 + max(n // 3, 1)
        full = mincut_cuda.expansion_accept(*args, **kw)
        part = [a[lo:hi] for a in args]
        got = mincut_cuda.expansion_accept(*part, plan_n=n, **kw)
        plain = mincut_cuda.expansion_accept_reference(*part, **kw)
        row = {"S": s, "N": n, "rows": [lo, hi],
               "plan": mincut_cuda.describe("expansion_accept", s, n),
               "plan_alone": mincut_cuda.describe("expansion_accept", s,
                                                  hi - lo),
               "equal_full_rows": bool(torch.equal(got, full[lo:hi])),
               "equal_plain": bool(torch.equal(got, plain))}
        plan_rows.append(row)
        if not (row["equal_full_rows"] and row["equal_plain"]):
            raise AssertionError(f"expansion_accept under plan_n: {row}")

    # The D- and H-sharded solves and the batch, one group of two ranks.
    jobs = [("dvolume", 1.0, 0, SHARD_SCHEDULE),
            ("volume", 1.0, 0, SHARD_SCHEDULE),
            ("batch", SHARD_BATCH[0], SHARD_BATCH[1], SHARD_BATCH[2])]
    t0 = time.perf_counter()
    ranks = collectives.launch(sharded_jobs_rank, devices, jobs,
                               timeout_s=900)
    group_s = time.perf_counter() - t0
    img, vol, h, w, nd, truth = synthetic.build_problem(1.0)
    sizes = [int(w * f) for f in (0.01, 0.03, 0.09)]
    with plain_unary():
        ref = multichip.solve_single(img, vol, float(nd - 1), sizes, 0,
                                     "cuda", schedule=SHARD_SCHEDULE,
                                     params=sharded_params())
    fused = multichip.solve_single(img, vol, float(nd - 1), sizes, 0, "cuda",
                                   schedule=SHARD_SCHEDULE,
                                   params=sharded_params())
    whole = ref["vol_bytes"]
    del img, vol
    rows = {}
    for j, kind in enumerate(("dvolume", "volume")):
        outs = [r[j] for r in ranks]
        same = all(np.array_equal(o["labels"], outs[0]["labels"])
                   and np.array_equal(o["cost"], outs[0]["cost"])
                   for o in outs)
        lab = outs[0]["labels"]
        bitwise = bool(np.array_equal(lab, ref["labels"])
                       and np.array_equal(outs[0]["cost"], ref["cost"]))
        disp = lab[..., 0] * np.arange(w)[None] + lab[..., 1] \
            * np.arange(h)[:, None] + lab[..., 2]
        rows[kind] = {
            "energies": outs[0]["energies"], "energies_single":
            ref["energies"], "max_label_diff": float(np.abs(
                lab - ref["labels"]).max()), "bitwise": bitwise,
            "ranks_equal": same,
            "bad10": float((np.abs(disp - truth) > 1.0).mean() * 100),
            "vol_bytes": [o["vol_bytes"] for o in outs],
            "whole_vol_bytes": whole,
            "vol_fraction": [o["vol_bytes"] / whole for o in outs],
            "ranks": [shard_row(o) for o in outs]}
        if not same:
            raise AssertionError(f"{kind}: the ranks' states differ")
        if kind == "volume" and not bitwise:
            raise AssertionError("the height-sharded solve differs from the "
                                 "single-device one")
        if kind == "dvolume" and not np.allclose(
                lab, ref["labels"], atol=multichip.DSHARD_ATOL,
                rtol=multichip.DSHARD_RTOL):
            raise AssertionError("the disparity-sharded solve is outside "
                                 "the tolerance of the single-device one")
    rows["dvolume"]["expected_fraction"] = 1 / SHARD_RANKS + 2 / nd
    rows["volume"]["shard_rows"] = ranks[0][1]["vol_shape"][2]
    rows["volume"]["image_rows"] = h
    rows["volume"]["padded_rows"] = ref["vol_shape"][2]
    rows["single"] = {k: ref[k] for k in ("solve_s", "build_s", "peak_gib",
                                          "launches", "energies")}
    rows["single_fused"] = {
        **{k: fused[k] for k in ("solve_s", "launches", "energies")},
        "labels_equal_plain": bool(np.array_equal(fused["labels"],
                                                  ref["labels"])),
        "cost_equal_plain": bool(np.array_equal(fused["cost"],
                                                ref["cost"])),
        "max_label_diff": float(np.abs(fused["labels"]
                                       - ref["labels"]).max())}
    if not (_close(fused["energies"], ref["energies"])
            and fused["launches"]["sample_windows"] > 0
            and ref["launches"]["sample_windows"] == 0):
        raise AssertionError(f"the single-device solve on the fused unary "
                             f"kernel is off the plain one's: "
                             f"{rows['single_fused']}")
    # The batch: each pair against LocalExpansionSolver(seed=b).
    pairs = BatchPairs(SHARD_BATCH[0], SHARD_BATCH[1])
    final = ranks[0][2]["final"]
    equal = []
    for b in range(len(SHARD_BATCH[1])):
        single = engine.LocalExpansionSolver(
            pairs.images()[b], pairs.images()[b], sharded_params(),
            pairs.max_disp, vol0=pairs.volumes()[b],
            vol1=pairs.volumes()[b], seed=b, device="cuda")
        for i, size in enumerate(pairs.sizes):
            single.add_layer(size, engine.LAYER0_PROPOSERS if i == 0
                             else engine.COARSE_PROPOSERS)
        lab, _ = single.run(SHARD_BATCH[2][1],
                            pm_iterations=SHARD_BATCH[2][0])
        equal.append(bool(np.array_equal(final[b], lab.cpu().numpy())))
        del single
    rows["batch"] = {"pairs_equal_single": equal,
                     "ranks_equal": all(np.array_equal(r[2]["final"], final)
                                        for r in ranks),
                     "ranks": [shard_row(r[2]) for r in ranks]}
    if not all(equal) or not rows["batch"]["ranks_equal"]:
        raise AssertionError(f"the batch differs from the single solves: "
                             f"{equal}")
    torch.cuda.empty_cache()
    # The spatial aggregation, then the at-scale slice, over 4 ranks.
    t1 = time.perf_counter()
    spatial = multichip.spatial_case(["cuda:0"] * 4, h, w,
                                     sharded_params().guided_radius)
    rows["spatial"] = {"shape": [h, w], "ranks": 4, **spatial,
                       "atol": multichip.SPATIAL_ATOL,
                       "seconds": time.perf_counter() - t1}
    if not spatial["max_abs_err"] <= multichip.SPATIAL_ATOL:
        raise AssertionError(f"sharded aggregation: {spatial}")
    t1 = time.perf_counter()
    scale = multichip.scale_slice(["cuda:0"] * SCALE_RANKS, *SCALE_SHAPE,
                                  init_chunk=SCALE_CHUNK)
    rows["scale"] = {"shape": SCALE_SHAPE, "ranks": scale,
                     "seconds": time.perf_counter() - t1}
    launches = {kind: sum(r[j]["launches"]["expansion_accept"]
                          for r in ranks)
                for j, kind in enumerate(("dvolume", "volume", "batch"))}
    row = {"phase": "sharded", "devices": devices,
           "backend": collectives.choose_backend(devices),
           "group_s": group_s, "plan_n": plan_rows, **rows,
           "launches": launches,
           "sample_windows_launches": sum(
               r[j]["launches"]["sample_windows"] for r in ranks
               for j in range(3)),
           "refit_sums_launches": sum(
               r[j]["launches"]["refit_sums"] for r in ranks
               for j in range(3)),
           "draw_launches": {k: sum(r[j]["launches"][k] for r in ranks
                                    for j in range(3))
                             for k in DRAW_KERNELS},
           "nvidia_smi": smi_line()}
    emit(row)
    if min(launches.values()) == 0:
        raise AssertionError(f"a sharded run never launched the expansion "
                             f"kernel: {launches}")
    return row


def reset_launches():
    """Sets every kernel wrapper's launch count to 0; returns the wrappers
    by kernel name."""
    fns = kernel_launches()
    for fn in fns.values():
        fn.launches = 0
    return fns


def phase_oracle(torch):
    """Both graph-cut kernels against Dinic's exact min cut at the main
    path's window sizes, through ``tools/gc_cap_audit.py``'s three parts
    with a few instances each: mincut_accept on random expansion tables of
    the certified regimes, expansion_accept on fused moves (the engine's
    caps) and mincut_accept on fusion graphs (the fusion caps). Every row
    must have no truncated region (the plain twin's certificate), no mask
    off the 64-round solve's or the plain twin's, and no cut outside
    ``RTOL`` / ``ATOL`` of Dinic's."""
    from localexpstereo_tpu_torch.tools import gc_cap_audit as audit
    fns = reset_launches()
    t_start = time.perf_counter()
    for s, sweeps in audit.LEGS:
        n = ORACLE_REGIONS[s]
        rows = [audit.audit_tables(s, sweeps, ri, n) for ri in audit.CERTIFIED]
        rows += [audit.audit_expansion(s, sweeps, n), audit.audit_fusion(s, n)]
        for row in rows:
            row["ok"] = all(row[k] == 0 for k in (
                "truncated", "mismatch_64", "mismatch_plain", "outside_dinic"))
            emit({"phase": "oracle", **row, "rtol": audit.RTOL,
                  "atol": audit.ATOL})
            if not row["ok"]:
                raise AssertionError(f"a graph-cut kernel's cut is not "
                                     f"Dinic's: {row}")
    launches = {k: fn.launches for k, fn in fns.items()}
    out = {"phase": "oracle", "launches": launches,
           "seconds": time.perf_counter() - t_start,
           "nvidia_smi": smi_line()}
    emit(out)
    if not (launches["expansion_accept"] and launches["mincut_accept"]):
        raise AssertionError(f"the oracle phase did not launch both "
                             f"graph-cut kernels: {launches}")
    return out


def phase_mccnn_v3(torch):
    """tools/mccnn_v3_eval.py at scale 1.0 on the card: WTA and solve bad
    rates held to MCCNN_V3_LIMITS, beside the JAX tool's artifact."""
    from localexpstereo_tpu_torch.tools import mccnn_v3_eval
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fns = reset_launches()
    out = mccnn_v3_eval.evaluate("cuda", 1.0)
    launches = {k: fn.launches for k, fn in fns.items()}
    row = {"phase": "mccnn_v3", **out,
           "jax_tpu_artifact": mccnn_v3_eval.JAX_ARTIFACT,
           "limits": {"wta_bad1": MCCNN_V3_LIMITS[0],
                      "solve_bad1": MCCNN_V3_LIMITS[1]},
           "launches": launches,
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "nvidia_smi": smi_line()}
    row["ok"] = (out["finite"] and out["wta_bad1"] <= MCCNN_V3_LIMITS[0]
                 and out["solve_bad1"] <= MCCNN_V3_LIMITS[1]
                 and launches["expansion_accept"] > 0
                 and launches["sample_windows"] > 0)
    emit(row)
    if not row["ok"]:
        raise AssertionError(f"the MC-CNN V3 check failed: {row}")
    return row


def train_bound(pixels, image_pixels: float, channels, n_params: int):
    """(ms, by) of one training step whose towers compute ``pixels[i]``
    outputs of layer i (both images together): the convolutions forward,
    the weights' gradients and the inputs' gradients (the first layer's
    image needs none), in float32; ``image_pixels`` of the images read
    once and the weights, their gradients and Adam's two moments read and
    written once."""
    c_in, layers = 3, []
    for c_out, p in zip(channels, pixels):
        layers.append(2 * 9 * c_in * c_out * p)
        c_in = c_out
    fwd = sum(layers)
    nops = fwd + fwd + (fwd - layers[0])
    return bound(image_pixels * 3 * 4 + 4 * 4 * 2 * n_params, nops)


def tower_pixels(torch, h: int, w: int, ys, xs, depth: int):
    """(image pixels, [pixels of each layer's output]) that the features
    at pixels (ys, xs) of an [h, w] image depend on, through ``depth``
    3 x 3 convolutions: the union of the (2 r + 1)^2 windows around them,
    r = depth - layer."""
    mask = torch.zeros(1, 1, h, w)
    mask[0, 0, ys.cpu(), xs.cpu()] = 1.0
    counts = [float(torch.nn.functional.max_pool2d(mask, 2 * r + 1, 1,
                                                   r).sum())
              for r in range(depth, -1, -1)]
    return counts[0], counts[1:]


def phase_train(torch):
    """tools/train_mccnn.py on the card at full width: four MiddV2-sized
    synthetic V2 scenes (cones, teddy, venus; tsukuba held out) in a
    temporary directory under build/; one hinge-loss step and its
    gradients on the card against the CPU; the tool's 600 steps; the step
    timed; then the written weights' tsukuba volume (WTA bad1.0 on the
    non-occluded pixels, against the initial weights') and the 2 + 5 solve
    on it (mccnn_v3_eval.solve, auto), which launches expansion_accept;
    that kernel is then held against its plain version on the solve's
    first call's inputs of each shape."""
    import tempfile
    from localexpstereo_tpu_torch.models import engine, mccnn
    from localexpstereo_tpu_torch.ops import rng
    from localexpstereo_tpu_torch.tools import mccnn_v3_eval
    from localexpstereo_tpu_torch.tools import train_mccnn as tool
    from localexpstereo_tpu_torch.utils import datasets, synthetic
    h, w, nd = TRAIN_SCENE
    CLI_DIR.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=CLI_DIR.parent) as tmp:
        t0 = time.perf_counter()
        for seed, name in enumerate(tool.TRAIN + (tool.HOLDOUT,)):
            synthetic.write_v2_scene(str(pathlib.Path(tmp) / name), h, w, nd,
                                     seed=seed)
        scenes_s = time.perf_counter() - t0

        init = mccnn.init_params_from_key(rng.PRNGKey(0))
        key = rng.split(rng.PRNGKey(0))[1]       # the run's first batch key
        one = {}
        for dev in ("cuda", "cpu"):
            net = mccnn.params_from_jax(init).to(dev).requires_grad_(True)
            loss, acc = tool.hinge_loss(
                net, *tool.load(tmp, tool.TRAIN[0], dev), key)
            loss.backward()
            one[dev] = {"loss": float(loss.detach()), "acc": float(acc),
                        "grads": {f"{kind}{i}": getattr(conv, attr).grad.cpu()
                                  for i, conv in enumerate(net.convs)
                                  for kind, attr in (("w", "weight"),
                                                     ("b", "bias"))}}
        gpu, cpu = one["cuda"], one["cpu"]
        grad_gaps = {k: float((g - cpu["grads"][k]).abs().max()
                              / cpu["grads"][k].abs().max())
                     for k, g in gpu["grads"].items()}
        loss_gap = abs(gpu["loss"] - cpu["loss"]) / abs(cpu["loss"])
        acc_gap = abs(gpu["acc"] - cpu["acc"])
        step_ok = (loss_gap <= TRAIN_LOSS_RTOL
                   and max(grad_gaps.values()) <= TRAIN_GRAD_RTOL
                   and acc_gap <= TRAIN_ACC_ATOL)
        emit({"phase": "train", "part": "card_vs_cpu",
              "loss": gpu["loss"], "loss_cpu": cpu["loss"],
              "loss_rel_gap": loss_gap, "acc_gap": acc_gap,
              "grad_rel_gap": grad_gaps, "loss_rtol": TRAIN_LOSS_RTOL,
              "grad_rtol": TRAIN_GRAD_RTOL, "acc_atol": TRAIN_ACC_ATOL,
              "ok": step_ok})
        if not step_ok:
            raise AssertionError("the card's hinge-loss step disagrees with "
                                 "the CPU's")

        out = str(pathlib.Path(tmp) / "w.npz")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        rows = tool.main(["--data", tmp, "--out", out, "--device", "cuda"])
        train_s = time.perf_counter() - t0
        peak_gib = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        trained = mccnn.load_params(out)

        # The step alone, timed on a copy of the trained weights.
        net = mccnn.params_from_jax(trained).to("cuda").requires_grad_(True)
        opt = tool.adam(net)
        scene = tool.load(tmp, tool.TRAIN[0], "cuda")
        keys = iter(rng.split(rng.PRNGKey(1), TRAIN_TIMED_STEPS + 1))
        step_ms = time_ms(torch, lambda: tool.train_step(
            net, opt, scene, next(keys)), TRAIN_TIMED_STEPS)
        # The step's bound as the tool computes it (both towers over both
        # whole images), and the least the loss needs: the towers only at
        # the pixels that the counted pairs' features depend on, averaged
        # over the timed steps' batches.
        channels = [c.out_channels for c in net.convs]
        n_params = sum(p.numel() for p in net.parameters())
        bound_ms, bound_by = train_bound([2 * h * w] * len(channels),
                                         2 * h * w, channels, n_params)
        image_px, layer_px = 0.0, np.zeros(len(channels))
        for k in rng.split(rng.PRNGKey(1), TRAIN_TIMED_STEPS + 1):
            ys, xs, xpos, xneg, ok = tool.sample_batch(*scene[2:], k)
            for y, x in ((ys[ok], xs[ok]), (torch.cat([ys[ok], ys[ok]]),
                                            torch.cat([xpos[ok], xneg[ok]]))):
                im_px, px = tower_pixels(torch, h, w, y, x, len(channels))
                image_px += im_px / (TRAIN_TIMED_STEPS + 1)
                layer_px += np.asarray(px) / (TRAIN_TIMED_STEPS + 1)
        patch_bound_ms, patch_bound_by = train_bound(layer_px, image_px,
                                                     channels, n_params)

        pair = datasets.load_data(str(pathlib.Path(tmp) / tool.HOLDOUT), 0)
        truth = pair.disp_gt
        mask = pair.nonocc & np.isfinite(truth)

        def bad1(disp):
            return float(100.0 * (np.abs(disp - truth)[mask] > 1.0).mean())

        vols, wta_bad1 = {}, {}
        for name, params in (("trained", trained), ("initial", init)):
            vols[name] = mccnn.cost_volume(
                mccnn.params_from_jax(params).to("cuda"), pair.im0, pair.im1,
                pair.ndisp)
            wta_bad1[name] = bad1(
                torch.argmin(vols[name], 0).float().cpu().numpy())
        del vols["initial"]
        fns = reset_launches()
        captured = CapturedKernels(engine.mincut_cuda)
        engine.mincut_cuda = captured
        try:
            disp, solve_s = mccnn_v3_eval.solve(pair.im0, pair.im1,
                                                vols["trained"], pair.ndisp,
                                                "cuda")
        finally:
            engine.mincut_cuda = captured.real
        launches = {k: fn.launches for k, fn in fns.items()}
        # expansion_accept at this solve's shapes, on its first call's
        # inputs of each, against its plain version (these launches are
        # not the solve's).
        accept_rows = []
        for (s, n), (args, kw) in sorted(captured.first.items()):
            row = accept_row(torch, args, kw)
            emit({"phase": "train", "part": "kernel", **row})
            accept_rows.append(row)
        del captured
    finite = all(np.isfinite([r[k] for r in rows for k in (
        "train_hinge", "train_acc", "val_hinge", "val_acc")]))
    row = {"phase": "train", "scene": list(TRAIN_SCENE),
           "steps": rows[-1]["step"] + 1, "batch": tool.BATCH,
           "scenes_s": scenes_s, "train_s": train_s,
           "loop_ms_per_step": 1e3 * rows[-1]["seconds"] / (
               rows[-1]["step"] + 1),
           "step_ms": step_ms, "bound_ms": bound_ms, "bound_by": bound_by,
           "patch_bound_ms": patch_bound_ms,
           "patch_bound_by": patch_bound_by,
           "patch_pixels": {"image": image_px, "layers": layer_px.tolist()},
           "peak_gib": peak_gib, "rows": rows,
           "wta_bad1_nonocc": wta_bad1,
           "solve_bad1_nonocc": bad1(disp),
           "solve_bad1_limit": TRAIN_SOLVE_BAD1, "solve_s": solve_s,
           "solve_finite": bool(np.isfinite(disp).all()),
           "launches": launches,
           "accept_check": [{k: r[k] for k in (
               "S", "N", "plan", "regions_equal", "max_abs_err", "ms",
               "plain_ms", "bound_ms", "ok")} for r in accept_rows],
           "nvidia_smi": smi_line()}
    row["ok"] = (finite and rows[-1]["val_hinge"] < rows[0]["val_hinge"]
                 and wta_bad1["trained"] < wta_bad1["initial"]
                 and row["solve_finite"]
                 and row["solve_bad1_nonocc"] <= TRAIN_SOLVE_BAD1
                 and launches["expansion_accept"] > 0
                 and launches["sample_windows"] > 0
                 and bool(accept_rows)
                 and all(r["ok"] for r in accept_rows))
    emit(row)
    if not row["ok"]:
        raise AssertionError(f"the train phase failed: {row}")
    return row


PHASES = ("kernel", "mincut_kernel", "oracle", "unary_kernel", "proposals",
          "small",
          "slice", "cli", "fuse", "dual", "v2", "mccnn", "mccnn_v3", "train",
          "stream", "cli_mccnn", "batch", "bf_interp", "profile", "sharded")


def main(argv) -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke needs one card",
              file=sys.stderr)
        return 2
    only = set(argv)
    if not only <= set(PHASES):
        print(f"chip_smoke: phases are {PHASES}", file=sys.stderr)
        return 2
    phase_env(torch)
    phase_build()
    pool = None
    try:
        if only:
            for name in PHASES:
                if name == "slice" and name in only:
                    run_slice(torch, pm_iterations=1, iterations=1)
                elif name in only:
                    globals()[f"phase_{name}"](torch)
            return 0
        seconds = {}

        def timed(name, fn, *args, **kwargs):
            t0 = time.perf_counter()
            out = fn(torch, *args, **kwargs)
            seconds[name] = time.perf_counter() - t0
            return out
        # The small and bf_interp phases' CPU solves run in two workers
        # while the card runs the phases before them.
        pool = multiprocessing.get_context("spawn").Pool(2)
        twins = pool.apply_async(twins_worker)
        bf_twins = pool.apply_async(bf_twins_worker)
        pool.close()
        rows = timed("kernel", phase_kernel)
        mrows = timed("mincut_kernel", phase_mincut_kernel)
        oracle_row = timed("oracle", phase_oracle)
        urows = timed("unary_kernel", phase_unary_kernel)
        refit_rows, draw_rows = timed("proposals", phase_proposals)
        first = timed("slice_1_1", run_slice, pm_iterations=1, iterations=1)
        cli_row = timed("cli", phase_cli)
        fuse_row = timed("fuse", phase_fuse)
        dual_row = timed("dual", phase_dual, cli_row)
        v2_row = timed("v2", phase_v2)
        timed("mccnn", phase_mccnn)
        v3_row = timed("mccnn_v3", phase_mccnn_v3)
        train_row = timed("train", phase_train)
        stream_row = timed("stream", phase_stream)
        mccnn_cli_row = timed("cli_mccnn", phase_cli_mccnn)
        batch_row = timed("batch", phase_batch)
        sharded_row = timed("sharded", phase_sharded)
        t0 = time.perf_counter()
        twins = twins.get()
        seconds["small_twins_wait"] = time.perf_counter() - t0
        timed("small", phase_small, twins)
        timed("profile", phase_profile)
        t0 = time.perf_counter()
        bf_twins = bf_twins.get()
        seconds["bf_interp_twins_wait"] = time.perf_counter() - t0
        bf_rows = timed("bf_interp", phase_bf_interp, bf_twins)
        emit({"phase_seconds": seconds})
    finally:
        if pool is not None:
            pool.terminate()
            pool.join()
        shutil.rmtree(CLI_DIR, ignore_errors=True)
    # ms / plain_ms / bound_ms: one call at each of the three shapes, summed
    # (for sample_windows, the guided-filtered calls of the main path, on
    # its uint8 volume).
    # For expansion_accept, of the V3 main path's shapes; "v2" holds the
    # same at the V2 path's.
    # launches: the fuse run's; launches_<phase>: that phase's run's.
    gf = [r for r in urows if r["r_gf"] > 0 and r["dtype"] == "uint8"]
    # The draw kernels' launches in every phase that solves on the card.
    draw_launches = {
        k: {"launches": fuse_row["launches"][k],
            **{f"launches_{name}": row["launches"][k]
               for name, row in (("cli", cli_row), ("dual", dual_row),
                                 ("v2", v2_row), ("stream", stream_row),
                                 ("cli_mccnn", mccnn_cli_row),
                                 ("batch", batch_row), ("mccnn_v3", v3_row),
                                 ("train", train_row))},
            "launches_slice": first["draw_launches"][k],
            "launches_bf_interp": sum(r["launches"][k] for r in bf_rows[:-1]),
            "launches_sharded": sharded_row["draw_launches"][k]}
        for k in DRAW_KERNELS}
    emit({"kernels": [
        {"name": "expansion_accept", "route": "cuda",
         "source": "localexpstereo_tpu_torch/csrc/expansion_accept.cu",
         "replaces": "localexpstereo_tpu/ops/mincut_pallas.py:636",
         "launches": fuse_row["launches"]["expansion_accept"],
         "launches_cli": cli_row["launches"]["expansion_accept"],
         "launches_dual": dual_row["launches"]["expansion_accept"],
         "launches_v2": v2_row["launches"]["expansion_accept"],
         "launches_stream": stream_row["launches"]["expansion_accept"],
         "launches_cli_mccnn": mccnn_cli_row["launches"]["expansion_accept"],
         "launches_slice": first["expansion_accept_launches"],
         "launches_batch": batch_row["launches"]["expansion_accept"],
         "launches_bf_interp": sum(r["launches"]["expansion_accept"]
                                   for r in bf_rows[:-1]),
         "launches_sharded": sum(sharded_row["launches"].values()),
         "launches_sharded_by_run": sharded_row["launches"],
         "launches_oracle": oracle_row["launches"]["expansion_accept"],
         "launches_mccnn_v3": v3_row["launches"]["expansion_accept"],
         "launches_train": train_row["launches"]["expansion_accept"],
         **kernel_entry([r for r in rows if r["path"] == "v3"]),
         "v2": kernel_entry([r for r in rows if r["path"] == "v2"])},
        {"name": "sample_windows", "route": "cuda",
         "source": "localexpstereo_tpu_torch/csrc/sample_windows.cu",
         "replaces": "localexpstereo_tpu/ops/unary_pallas.py:256",
         "launches": fuse_row["launches"]["sample_windows"],
         "launches_cli": cli_row["launches"]["sample_windows"],
         "launches_dual": dual_row["launches"]["sample_windows"],
         "launches_cli_mccnn": mccnn_cli_row["launches"]["sample_windows"],
         "launches_v2": v2_row["launches"]["sample_windows"],
         "launches_stream": stream_row["launches"]["sample_windows"],
         "launches_slice": first["sample_windows_launches"],
         "launches_batch": batch_row["launches"]["sample_windows"],
         "launches_bf_interp": bf_rows[0]["launches"]["sample_windows"],
         "launches_sharded": sharded_row["sample_windows_launches"],
         "launches_mccnn_v3": v3_row["launches"]["sample_windows"],
         "launches_train": train_row["launches"]["sample_windows"],
         **kernel_entry(gf),
         "max_abs_err": max(r["max_abs_err"] for r in urows)},
        {"name": "mincut_accept", "route": "cuda",
         "source": "localexpstereo_tpu_torch/csrc/mincut_accept.cu",
         "replaces": "localexpstereo_tpu/ops/mincut_pallas.py:589",
         "launches": fuse_row["launches"]["mincut_accept"],
         "launches_oracle": oracle_row["launches"]["mincut_accept"],
         "launches_mccnn_v3": v3_row["launches"]["mincut_accept"],
         "launches_train": train_row["launches"]["mincut_accept"],
         **kernel_entry(mrows)},
        {"name": "refit_sums", "route": "cuda",
         "source": "localexpstereo_tpu_torch/csrc/refit_sums.cu",
         "replaces": "localexpstereo_tpu/models/proposals.py:218",
         "launches": fuse_row["launches"]["refit_sums"],
         **{f"launches_{name}": row["launches"]["refit_sums"]
            for name, row in (("cli", cli_row), ("dual", dual_row),
                              ("v2", v2_row), ("stream", stream_row),
                              ("cli_mccnn", mccnn_cli_row),
                              ("batch", batch_row), ("mccnn_v3", v3_row),
                              ("train", train_row))},
         "launches_slice": first["refit_sums_launches"],
         "launches_bf_interp": sum(r["launches"]["refit_sums"]
                                   for r in bf_rows[:-1]),
         "launches_sharded": sharded_row["refit_sums_launches"],
         **kernel_entry(refit_rows),
         "library_ms": sum(r["library_ms"] for r in refit_rows)},
        *[{"name": k, "route": "cuda",
           "source": "localexpstereo_tpu_torch/csrc/threefry.cu",
           "replaces": "none: the JAX side is XLA's threefry",
           **draw_launches[k], **draw_entry(
               [r for r in draw_rows if f"threefry_{r['kind']}" == k])}
          for k in DRAW_KERNELS]]})
    never = {k: [n for n, v in e.items() if v == 0]
             for k, e in draw_launches.items()}
    if any(never.values()):
        raise AssertionError(f"a solve on the card made no draw there: "
                             f"{never}")
    print(smi_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
