#!/usr/bin/env python3
"""Drives the PyTorch port (``localexpstereo_tpu_torch``) once on one CUDA card.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

Phases, each printing JSON lines:

1. env:     torch / CUDA / nvcc versions and the card's name and power limit;
2. build:   compiles the three hand-written kernel libraries from the
            checkout's sources (one ``nvcc`` each, started together, into
            ``build/torch_kernels/``), timed;
3. kernel:  ``expansion_accept`` (CUDA) against its plain PyTorch version on
            the card at the shapes of the main path, (S, N) = (42, 468),
            (129, 54), (387, 6): equal accept masks (required at every
            shape), cut energies, the guard, median milliseconds of both,
            the card's bound, and the launch plan (K, threads, shared
            memory, state, the clusters that fit at once, registers);
4. mincut_kernel: ``mincut_accept`` (CUDA; ``mincut_cuda.solve_graph``)
            against its plain version on fusion graphs at the fusion path's
            shapes, the same (S, N), 64 rounds of 16 sweeps: equal masks or
            equal cut energies, the guard, median milliseconds, the bound,
            the launch plan;
5. unary_kernel: ``sample_windows`` (CUDA) against its plain version on the
            windows of the 1436 x 992 x 145 problem, (F, N) = (62, 468),
            (149, 54), (407, 6), raw and guided-filtered (r 10): max abs
            error on supported positions, median milliseconds of both;
6. small:   a small V3 solve (1 greedy + 1 graph-cut sweep) on the card
            against the same solve on the CPU (plain versions), at windR 6
            and 20, on the "auto" and the "dma" unary routes, and once with
            ``run(fuse_with=...)``: energies within the trajectory
            tolerance;
7. slice:   ``LocalExpansionSolver(device="cuda")`` on the 1436 x 992 x 145
            synthetic problem, 3 layers, 1 greedy + 1 graph-cut sweep, then
            2 + 2 (the full 2 + 5 runs in cli and fuse): seconds per sweep
            and per layer,
            energies, bad rates against the planted truth, and the kernel
            launch counts of each run;
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
10. profile: the init + one greedy sweep on each unary route, unprofiled
            in turns (2 each), then the ``dma`` route's under
            torch.profiler, and one graph-cut sweep under torch.profiler:
            wall seconds, and for the profiled windows device-busy seconds,
            the idle share and the largest device ops, the expansion
            kernel's seconds per move-window size (CUDA events), and the
            graph-cut sweep's peak device memory.

Then a ``{"kernels": [...]}`` line (launches from the ``fuse`` run), the
``nvidia-smi`` name/power-limit line, and last ``{"ok": true, "device":
{...}}``. Any failed check raises,
so the script exits non-zero and prints no result; it also refuses to run
without a CUDA device. ``python3 chip_smoke.py PHASE ...`` runs only the
named phases (after env and build) and prints no result line.
"""
from __future__ import annotations

import json
import pathlib
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np

SHAPES = ((42, 468, 16), (129, 54, 16), (387, 6, 64))  # (S, N, sweeps)
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
#: sample_windows against its plain version, by filter radius: raw costs
#: (the same float32 operations) and guided-filtered costs on supported
#: positions (float64 box sums in another order; the filter's inverse
#: covariance amplifies their last-bit differences).
UNARY_ATOL = {0: 1e-6, 10: 2e-4}
CLI_DIR = pathlib.Path(__file__).resolve().parent / "build" / "smoke_cli"


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
    from localexpstereo_tpu_torch.ops import cuda_build, mincut_cuda, unary_cuda
    t0 = time.perf_counter()
    built = cuda_build.build([mincut_cuda.LIBRARY, mincut_cuda.MINCUT_LIBRARY,
                              unary_cuda.LIBRARY], verbose=True)
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


def phase_kernel(torch):
    from localexpstereo_tpu_torch.ops import mincut, mincut_cuda
    from localexpstereo_tpu_torch.utils import synthetic
    rows = []
    for s, n, sweeps in SHAPES:
        arrays, lam, tau = synthetic.fused_move_problem(
            np.random.default_rng(s), n, s)
        args = [torch.as_tensor(a, device="cuda") for a in arrays]
        kw = dict(lam=lam, tau=tau, max_global_rounds=ROUNDS,
                  sweeps_per_round=sweeps)
        got = mincut_cuda.expansion_accept(*args, **kw)
        want = mincut_cuda.expansion_accept_reference(*args, **kw)
        torch.cuda.synchronize()
        c00, c01, c10, t0, t1 = mincut_cuda.fused_terms(*args, lam, tau)
        stats = {}
        mincut.solve_preflow(*mincut.build_graph(t0, t1, c00, c01, c10),
                             ROUNDS, sweeps, stats=stats)
        nbytes = sum(a.numel() * a.element_size() for a in args) + n * s * s
        bound_ms, bound_by = bound(
            nbytes, solve_ops(stats, s) + OPS_EXPANSION_SETUP * n * s * s)
        e_got = mincut.move_energy_delta(got, t0, t1, c00, c01, c10)
        e_want = mincut.move_energy_delta(want, t0, t1, c00, c01, c10)
        err = (e_got - e_want).abs()
        energy_ok = bool((err <= ATOL + RTOL * e_want.abs()).all())
        guard_ok = bool((e_got <= 1e-5).all())
        ms = time_ms(torch, lambda: mincut_cuda.expansion_accept(*args, **kw),
                     5)
        plain_ms = time_ms(
            torch, lambda: mincut_cuda.expansion_accept_reference(*args, **kw),
            3)
        row = {"S": s, "N": n, "rounds": ROUNDS, "sweeps": sweeps,
               "plan": mincut_cuda.describe("expansion_accept", s, n),
               "regions_equal": float((got == want).all(-1).all(-1)
                                      .float().mean()),
               "max_abs_err": float(err.max()),
               "rtol": RTOL, "atol": ATOL, "energy_ok": energy_ok, "guard_ok": guard_ok,
               "max_delta": float(e_got.max()),
               "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
               "bound_by": bound_by, "bytes": nbytes,
               "plain_rounds": int(stats["rounds"].sum()),
               "plain_bfs_passes": int(stats["bfs_passes"].sum()),
               "plain_sweeps": int(stats["sweeps"].sum())}
        emit({"phase": "kernel", **row})
        if not (energy_ok and guard_ok and row["regions_equal"] == 1.0):
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
               "regions_equal": float(same.float().mean()),
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
    """Evaluator hook: energy and wall time after the init and each sweep
    (synchronizes the card, so sweep times are complete)."""

    def __init__(self, torch):
        self.torch = torch
        self.rows = []

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
        self.rows.append((index, total, time.perf_counter()))


def make_solver(scale: float, device: str, sizes=None, windr: int = 20,
                route: str = "auto", seed: int = 0):
    from localexpstereo_tpu_torch.config import PARAMS_GF
    from localexpstereo_tpu_torch.models import engine
    from localexpstereo_tpu_torch.utils import synthetic
    img, vol, h, w, nd, truth = synthetic.build_problem(scale)
    params = PARAMS_GF.replace(windR=windr, lambda_=0.5, th_col=0.5)
    solver = engine.LocalExpansionSolver(img, img, params,
                                         max_disp=float(nd - 1), vol0=vol,
                                         vol1=vol, seed=seed, device=device,
                                         unary_backend=route)
    # The reference's layer sizing (main.cpp:395-397), taken as it is.
    sizes = sizes or [int(w * f) for f in (0.01, 0.03, 0.09)]
    for i, sz in enumerate(sizes):
        solver.add_layer(sz, engine.LAYER0_PROPOSERS if i == 0
                         else engine.COARSE_PROPOSERS)
    return solver, truth, sizes


def bad_rates(solver, truth):
    disp = solver.disparity_map().float().cpu().numpy()
    if disp.shape != truth.shape or not np.all(np.isfinite(disp)):
        raise AssertionError(f"bad disparity map {disp.shape}")
    err = np.abs(disp - truth)
    return float((err > 0.5).mean() * 100), float((err > 1.0).mean() * 100)


def phase_small(torch):
    """The same small problem solved on the card and on the CPU, at a
    narrow filter window and at the main path's, on both unary routes."""
    from localexpstereo_tpu_torch.ops import unary_cuda
    for route in ("auto", "dma"):
        for windr in SMALL_WINDR:
            out = {}
            for device in ("cuda", "cpu"):
                solver, truth, sizes = make_solver(
                    0.06, device, sizes=[4, 8, 16], windr=windr, route=route)
                rec = Recorder(torch)
                solver.set_evaluator(rec)
                unary_cuda.sample_windows.launches = 0
                solver.run(iterations=1, pm_iterations=1)
                out[device] = ([e for _, e, _ in rec.rows],
                               bad_rates(solver, truth),
                               unary_cuda.sample_windows.launches)
            (e_gpu, b_gpu, n_gpu), (e_cpu, b_cpu, _) = out["cuda"], out["cpu"]
            ok = all(abs(a - b) <= 0.002 * abs(b) + 1e-3
                     for a, b in zip(e_gpu, e_cpu))
            ok &= abs(b_gpu[1] - b_cpu[1]) <= 0.5
            ok &= (n_gpu > 0) == (route == "dma")
            emit({"phase": "small", "route": route, "windR": windr,
                  "layers": sizes, "energies_cuda": e_gpu,
                  "energies_cpu": e_cpu, "bad_cuda": b_gpu, "bad_cpu": b_cpu,
                  "sample_windows_launches_cuda": n_gpu, "agree": ok})
            if not ok:
                raise AssertionError(f"CUDA and CPU solves disagree at windR "
                                     f"{windr} on the {route} route")
    phase_small_fuse(torch)


def phase_small_fuse(torch):
    """The small solve with run(fuse_with=[the CPU solve of seed 1]) on
    the card and on the CPU: energies within the trajectory tolerance, the
    fused row no higher than the last graph-cut row, and the min-cut kernel
    launched on the card."""
    from localexpstereo_tpu_torch.ops import mincut_cuda
    aux, _, _ = make_solver(0.06, "cpu", sizes=[4, 8, 16], seed=1)
    ext = aux.run(iterations=1, pm_iterations=1).numpy()
    out = {}
    for device in ("cuda", "cpu"):
        solver, truth, sizes = make_solver(0.06, device, sizes=[4, 8, 16])
        rec = Recorder(torch)
        solver.set_evaluator(rec)
        mincut_cuda.solve_graph.launches = 0
        solver.run(iterations=1, pm_iterations=1, fuse_with=[ext])
        out[device] = ([e for _, e, _ in rec.rows], bad_rates(solver, truth),
                       mincut_cuda.solve_graph.launches)
    (e_gpu, b_gpu, n_gpu), (e_cpu, b_cpu, _) = out["cuda"], out["cpu"]
    ok = len(e_gpu) == len(e_cpu) == 4 and all(
        abs(a - b) <= 0.002 * abs(b) + 1e-3 for a, b in zip(e_gpu, e_cpu))
    ok &= e_gpu[-1] <= e_gpu[-2] and n_gpu > 0
    emit({"phase": "small", "route": "auto", "windR": 20, "fuse_with": 1,
          "layers": sizes, "energies_cuda": e_gpu, "energies_cpu": e_cpu,
          "bad_cuda": b_gpu, "bad_cpu": b_cpu,
          "mincut_accept_launches_cuda": n_gpu, "agree": ok})
    if not ok:
        raise AssertionError("CUDA and CPU fused solves disagree")


def unary_problem(torch, solver, truth, layer, rng):
    """Window origins of color (0, 0) of ``layer`` and one proposal per
    region near the planted truth at the region's centre."""
    cfg = solver.cfg
    s, r = layer.unit_size, cfg.params.guided_radius
    ox, oy, _ = layer.color_regions(0, 0)
    cx = np.clip(ox + s // 2, 0, cfg.width - 1)
    cy = np.clip(oy + s // 2, 0, cfg.height - 1)
    n = len(ox)
    a = rng.uniform(-0.02, 0.02, n)
    b = rng.uniform(-0.02, 0.02, n)
    c = truth[cy, cx] + rng.uniform(-0.5, 0.5, n) - a * cx - b * cy
    props = np.stack([a, b, c, np.zeros(n)], -1).astype(np.float32)

    def dev(x):
        return torch.as_tensor(x, device="cuda")
    return (dev(props), dev((ox - s - r).astype(np.int64)),
            dev((oy - s - r).astype(np.int64)), 3 * s + 2 * r)


def phase_unary_kernel(torch):
    """sample_windows against its plain version on the main path's windows
    (uint8 volume, r 10) of every layer, raw and guided-filtered."""
    from localexpstereo_tpu_torch.ops import boxfilter, unary_cuda
    solver, truth, sizes = make_solver(1.0, "cuda")
    solver.finalize()
    data, cfg = solver.data, solver.cfg
    r = cfg.params.guided_radius
    rng = np.random.default_rng(0)
    rows = []
    for layer in solver.layers:
        props, fox, foy, f = unary_problem(torch, solver, truth, layer, rng)
        n = props.shape[0]
        it = torch.arange(f, device="cuda")
        ys = foy[:, None, None] + it[None, :, None]
        xs = fox[:, None, None] + it[None, None, :]
        inside = ((xs >= 0) & (xs < cfg.width) & (ys >= 0)
                  & (ys < cfg.height)).float()
        for r_gf in (0, r):
            support = boxfilter.boxsum2d(inside, r_gf) > 0.5
            args = (data.vol[0], cfg.vol_pad, props, fox, foy, f,
                    cfg.height, cfg.width)
            kw = dict(min_disp=cfg.min_disp, th_col=cfg.params.th_col,
                      scale=cfg.vol_scale, zero=cfg.vol_zero,
                      stats=(data.guide[0], data.gf_mean[0], data.gf_inv[0]),
                      pad=cfg.pad, r_gf=r_gf)
            got = unary_cuda.sample_windows(*args, **kw)
            want = unary_cuda.sample_windows_reference(*args, **kw)
            torch.cuda.synchronize()
            err = float((got - want).abs().masked_fill(~support, 0).max())
            ok = bool(torch.isfinite(got.masked_fill(~support, 0)).all()
                      and err <= UNARY_ATOL[r_gf])
            # Bytes: each window pixel's output and two volume taps, the
            # windows' union of the statistics (12 float32 a pixel), the
            # proposals and origins; operations: per window pixel.
            span = [(nb - 1) * min(f, 4 * layer.unit_size) + f
                    for nb in (layer.nbx, layer.nby)]
            px = n * f * f
            nbytes = (px * (4 + 2 * data.vol.element_size())
                      + (span[0] * span[1] * 48 if r_gf else 0)
                      + n * (16 + 2 * fox.element_size()))
            bound_ms, bound_by = bound(
                nbytes, px * (OPS_SAMPLE + (OPS_GUIDED if r_gf else 0)))
            row = {"F": f, "N": n, "r_gf": r_gf, "max_abs_err": err,
                   "atol": UNARY_ATOL[r_gf], "ok": ok,
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "bytes": nbytes,
                   "ms": time_ms(torch, lambda: unary_cuda.sample_windows(
                       *args, **kw), 5),
                   "plain_ms": time_ms(
                       torch, lambda: unary_cuda.sample_windows_reference(
                           *args, **kw), 3)}
            emit({"phase": "unary_kernel", **row})
            if not ok:
                raise AssertionError(f"sample_windows disagrees: {row}")
            rows.append(row)
    del solver, data
    torch.cuda.empty_cache()
    return rows


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
    from localexpstereo_tpu_torch.ops import mincut_cuda
    solver, truth, sizes = make_solver(1.0, "cuda")
    t0 = time.perf_counter()
    solver.finalize()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    rec = Recorder(torch)
    solver.set_evaluator(rec)
    layer_times = []
    inner, wrapped = timed_layers(torch, engine, layer_times)
    engine.layer_sweep = wrapped
    mincut_cuda.expansion_accept.launches = 0
    t_run = time.perf_counter()
    try:
        solver.run(iterations=iterations, pm_iterations=pm_iterations)
        torch.cuda.synchronize()
    finally:
        engine.layer_sweep = inner
    run_s = time.perf_counter() - t_run
    launches = mincut_cuda.expansion_accept.launches
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
           "expansion_accept_launches": launches}
    emit(row)
    if launches == 0:
        raise AssertionError("the graph-cut sweeps never launched the kernel")
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
    solvers = {}
    for route in ("auto", "dma"):
        solvers[route], _, sizes = make_solver(1.0, "cuda", route=route)
        solvers[route].finalize()
    walls = greedy_walls(torch, solvers,
                         ("auto", "dma", "dma", "auto"))
    greedy_dma = profiled(torch, lambda: solvers["dma"].run(
        iterations=0, pm_iterations=1))
    solver = solvers.pop("auto")
    del solvers
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    timed = TimedKernels(torch, mincut_cuda)
    engine.mincut_cuda = timed
    try:
        key = rng.fold_in(rng.PRNGKey(solver.seed), 3000 + 1)
        gc = profiled(torch, lambda: solver._sweep(solver._state, 0, 0, True,
                                                   key))
    finally:
        engine.mincut_cuda = mincut_cuda
    gc["kernel_by_shape"] = timed.by_shape()
    gc["kernel_s"] = sum(r["kernel_s"] for r in gc["kernel_by_shape"])
    emit({"phase": "profile", "layers": sizes, "greedy_wall_s": walls,
          "greedy_dma": greedy_dma, "gc": gc,
          "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30})


def write_midv3_scene(target: pathlib.Path):
    """The 1436 x 992 x 145 synthetic problem as a MiddV3 directory:
    im0/im1.png (the image as uint8), calib.txt, im0.acrt, disp0GT.pfm."""
    from localexpstereo_tpu_torch.utils import acrt, pfm, png, synthetic
    img, vol, h, w, nd, truth = synthetic.build_problem(1.0)
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


def run_cli(argv, out):
    """The port's command line on the shared scene; returns (wall seconds,
    log rows, time.txt, disparity map)."""
    from localexpstereo_tpu_torch.cli import main as cli
    from localexpstereo_tpu_torch.utils import pfm
    scene, _, _ = cli_scene()
    t0 = time.perf_counter()
    rc = cli.main(["-mode", "MiddV3", "-targetDir", str(scene),
                   "-outputDir", str(out), *argv])
    wall_s = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"the CLI returned {rc}")
    return (wall_s, read_log(out / "debug" / "log_output.txt"),
            float((out / "time.txt").read_text()),
            pfm.read_pfm(str(out / "disp0.pfm")))


def kernel_launches():
    from localexpstereo_tpu_torch.ops import mincut_cuda, unary_cuda
    return {"expansion_accept": mincut_cuda.expansion_accept,
            "mincut_accept": mincut_cuda.solve_graph,
            "sample_windows": unary_cuda.sample_windows}


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
    launches = {k: fns[k].launches
                for k in ("expansion_accept", "sample_windows")}
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


PHASES = ("kernel", "mincut_kernel", "unary_kernel", "small", "slice", "cli",
          "fuse", "profile")


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
        rows = timed("kernel", phase_kernel)
        mrows = timed("mincut_kernel", phase_mincut_kernel)
        urows = timed("unary_kernel", phase_unary_kernel)
        timed("small", phase_small)
        first = timed("slice_1_1", run_slice, pm_iterations=1, iterations=1)
        timed("slice_2_2", run_slice, pm_iterations=2, iterations=2)
        cli_row = timed("cli", phase_cli)
        fuse_row = timed("fuse", phase_fuse)
        timed("profile", phase_profile)
        emit({"phase_seconds": seconds})
    finally:
        shutil.rmtree(CLI_DIR, ignore_errors=True)
    # ms / plain_ms / bound_ms: one call at each of the three shapes, summed
    # (for sample_windows, the guided-filtered calls of the main path).
    # launches: the fuse run's.
    gf = [r for r in urows if r["r_gf"] > 0]
    emit({"kernels": [
        {"name": "expansion_accept", "route": "cuda",
         "source": "localexpstereo_tpu_torch/csrc/expansion_accept.cu",
         "replaces": "localexpstereo_tpu/ops/mincut_pallas.py:636",
         "launches": fuse_row["launches"]["expansion_accept"],
         "launches_cli": cli_row["launches"]["expansion_accept"],
         "launches_slice": first["expansion_accept_launches"],
         **kernel_entry(rows)},
        {"name": "sample_windows", "route": "cuda",
         "source": "localexpstereo_tpu_torch/csrc/sample_windows.cu",
         "replaces": "localexpstereo_tpu/ops/unary_pallas.py:256",
         "launches": fuse_row["launches"]["sample_windows"],
         "launches_cli": cli_row["launches"]["sample_windows"],
         **kernel_entry(gf),
         "max_abs_err": max(r["max_abs_err"] for r in urows)},
        {"name": "mincut_accept", "route": "cuda",
         "source": "localexpstereo_tpu_torch/csrc/mincut_accept.cu",
         "replaces": "localexpstereo_tpu/ops/mincut_pallas.py:589",
         "launches": fuse_row["launches"]["mincut_accept"],
         **kernel_entry(mrows)}]})
    print(smi_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
