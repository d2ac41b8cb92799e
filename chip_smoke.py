#!/usr/bin/env python3
"""Drives the PyTorch port (``localexpstereo_tpu_torch``) once on one CUDA card.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

Phases, each printing JSON lines:

1. env:     torch / CUDA / nvcc versions and the card's name and power limit;
2. build:   compiles both hand-written kernel libraries from the checkout's
            sources (one ``nvcc`` each, started together, into
            ``build/torch_kernels/``), timed;
3. kernel:  ``expansion_accept`` (CUDA) against its plain PyTorch version on
            the card at the shapes of the main path, (S, N) = (42, 468),
            (129, 54), (387, 6): equal accept masks, cut energies, the
            guard, median milliseconds of both;
4. unary_kernel: ``sample_windows`` (CUDA) against its plain version on the
            windows of the 1436 x 992 x 145 problem, (F, N) = (62, 468),
            (149, 54), (407, 6), raw and guided-filtered (r 10): max abs
            error on supported positions, median milliseconds of both;
5. small:   a small V3 solve on the card against the same solve on the CPU
            (plain versions), at windR 6 and 20, on the "auto" and the
            "dma" unary routes: energies within the trajectory tolerance;
6. slice:   ``LocalExpansionSolver(device="cuda")`` on the 1436 x 992 x 145
            synthetic problem, 3 layers, 1 greedy + 1 graph-cut sweep, then
            the full 2 + 5 schedule: seconds per sweep and per layer,
            energies, bad rates against the planted truth, and the kernel
            launch counts of each run;
7. cli:     the port's command line, ``-mode MiddV3 -unaryBackend dma
            -device cuda``, on the same problem written out as a MiddV3
            directory (PNGs, calib.txt, im0.acrt, disp0GT.pfm) under
            ``build/``: time.txt, the log's energies and bad rates, seconds
            per sweep, both kernels' launch counts, the disparity's shape;
8. profile: the init + one greedy sweep on each unary route, unprofiled
            in turns (3 each) and under torch.profiler, and one graph-cut
            sweep under torch.profiler: wall seconds, and for the profiled
            windows device-busy seconds, the idle share and the largest
            device ops, the expansion kernel's seconds per move-window size
            (CUDA events), and peak device memory.

Then a ``{"kernels": [...]}`` line, the ``nvidia-smi`` name/power-limit
line, and last ``{"ok": true, "device": {...}}``. Any failed check raises,
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
    built = cuda_build.build([mincut_cuda.LIBRARY, unary_cuda.LIBRARY],
                             verbose=True)
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
               "regions_equal": float((got == want).all(-1).all(-1)
                                      .float().mean()),
               "max_abs_energy_err": float(err.max()),
               "rtol": RTOL, "atol": ATOL, "energy_ok": energy_ok, "guard_ok": guard_ok,
               "max_delta": float(e_got.max()),
               "ms": ms, "plain_ms": plain_ms}
        emit({"phase": "kernel", **row})
        if not (energy_ok and guard_ok):
            raise AssertionError(f"kernel disagrees at S={s}: {row}")
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
                route: str = "auto"):
    from localexpstereo_tpu_torch.config import PARAMS_GF
    from localexpstereo_tpu_torch.models import engine
    from localexpstereo_tpu_torch.utils import synthetic
    img, vol, h, w, nd, truth = synthetic.build_problem(scale)
    params = PARAMS_GF.replace(windR=windr, lambda_=0.5, th_col=0.5)
    solver = engine.LocalExpansionSolver(img, img, params,
                                         max_disp=float(nd - 1), vol0=vol,
                                         vol1=vol, seed=0, device=device,
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
                solver.run(iterations=2, pm_iterations=1)
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
            row = {"F": f, "N": n, "r_gf": r_gf, "max_abs_err": err,
                   "atol": UNARY_ATOL[r_gf], "ok": ok,
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
    unprofiled in turns (auto, dma, dma, auto, auto, dma) and then under
    torch.profiler; then one graph-cut sweep on the "auto" route (the 1 + 1
    run's trajectory, in a warm process) under torch.profiler, the
    graph-cut kernel timed per call with CUDA events."""
    from localexpstereo_tpu_torch.models import engine
    from localexpstereo_tpu_torch.ops import mincut_cuda, rng
    solvers = {}
    for route in ("auto", "dma"):
        solvers[route], _, sizes = make_solver(1.0, "cuda", route=route)
        solvers[route].finalize()
    walls = greedy_walls(torch, solvers,
                         ("auto", "dma", "dma", "auto", "auto", "dma"))
    greedy_dma = profiled(torch, lambda: solvers["dma"].run(
        iterations=0, pm_iterations=1))
    solver = solvers.pop("auto")
    del solvers
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    greedy = profiled(torch, lambda: solver.run(iterations=0,
                                                pm_iterations=1))
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
          "greedy_dma": greedy_dma, "greedy": greedy, "gc": gc,
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


def phase_cli(torch):
    """The port's command line on the problem written as a MiddV3
    directory, -unaryBackend dma on the card, the default 2 + 5 schedule."""
    from localexpstereo_tpu_torch.cli import main as cli
    from localexpstereo_tpu_torch.ops import mincut_cuda, unary_cuda
    from localexpstereo_tpu_torch.utils import pfm
    shutil.rmtree(CLI_DIR, ignore_errors=True)
    try:
        t0 = time.perf_counter()
        h, w = write_midv3_scene(CLI_DIR / "scene")
        write_s = time.perf_counter() - t0
        out = CLI_DIR / "out"
        mincut_cuda.expansion_accept.launches = 0
        unary_cuda.sample_windows.launches = 0
        t0 = time.perf_counter()
        rc = cli.main(["-mode", "MiddV3", "-targetDir", str(CLI_DIR / "scene"),
                       "-outputDir", str(out), "-unaryBackend", "dma",
                       "-device", "cuda"])
        wall_s = time.perf_counter() - t0
        launches = {"expansion_accept": mincut_cuda.expansion_accept.launches,
                    "sample_windows": unary_cuda.sample_windows.launches}
        if rc != 0:
            raise AssertionError(f"the CLI returned {rc}")
        log = read_log(out / "debug" / "log_output.txt")
        disp = pfm.read_pfm(str(out / "disp0.pfm"))
        row = {"phase": "cli", "argv": "-mode MiddV3 -unaryBackend dma "
                                       "-device cuda (2 + 5)",
               "scene_write_s": write_s, "wall_s": wall_s,
               "time_txt": float((out / "time.txt").read_text()),
               "time": [r[0] for r in log],
               "sweep_s": [b[0] - a[0] for a, b in zip(log, log[1:])],
               "energies": [r[1] for r in log],
               "bad_all": [r[4] for r in log],
               "launches": launches, "disp_shape": list(disp.shape),
               "disp_finite": bool(np.isfinite(disp).all())}
        emit(row)
    finally:
        shutil.rmtree(CLI_DIR, ignore_errors=True)
    energies = row["energies"]
    if len(energies) != 1 + 2 + 5:
        raise AssertionError(f"expected 8 log rows, got {len(energies)}")
    if row["disp_shape"] != [h, w] or not row["disp_finite"]:
        raise AssertionError(f"bad disparity map: {row['disp_shape']}")
    if min(launches.values()) == 0:
        raise AssertionError(f"a kernel was never launched: {launches}")
    gc = energies[2:]
    if any(b > a for a, b in zip(gc, gc[1:])):
        raise AssertionError(f"graph-cut energy rose: {energies}")
    return row


PHASES = ("kernel", "unary_kernel", "small", "slice", "cli", "profile")


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
    if only:
        for name in PHASES:
            if name == "slice" and name in only:
                run_slice(torch, pm_iterations=1, iterations=1)
            elif name in only:
                globals()[f"phase_{name}"](torch)
        return 0
    rows = phase_kernel(torch)
    urows = phase_unary_kernel(torch)
    phase_small(torch)
    first = run_slice(torch, pm_iterations=1, iterations=1)
    run_slice(torch, pm_iterations=2, iterations=5)
    cli_row = phase_cli(torch)
    phase_profile(torch)
    # ms / plain_ms: one call at each of the three shapes, summed (for
    # sample_windows, the guided-filtered calls of the main path).
    gf = [r for r in urows if r["r_gf"] > 0]
    emit({"kernels": [
        {"name": "expansion_accept", "route": "cuda",
         "source": "localexpstereo_tpu_torch/csrc/expansion_accept.cu",
         "replaces": "localexpstereo_tpu/ops/mincut_pallas.py:636",
         "launches": cli_row["launches"]["expansion_accept"],
         "launches_slice": first["expansion_accept_launches"],
         "max_abs_err": max(r["max_abs_energy_err"] for r in rows),
         "ms": sum(r["ms"] for r in rows),
         "plain_ms": sum(r["plain_ms"] for r in rows)},
        {"name": "sample_windows", "route": "cuda",
         "source": "localexpstereo_tpu_torch/csrc/sample_windows.cu",
         "replaces": "localexpstereo_tpu/ops/unary_pallas.py:256",
         "launches": cli_row["launches"]["sample_windows"],
         "max_abs_err": max(r["max_abs_err"] for r in urows),
         "ms": sum(r["ms"] for r in gf),
         "plain_ms": sum(r["plain_ms"] for r in gf)}]})
    print(smi_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
