#!/usr/bin/env python3
"""Drives the PyTorch port (``localexpstereo_tpu_torch``) once on one CUDA card.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. env:     torch / CUDA / nvcc versions and the card's name and power limit;
2. build:   compiles the hand-written kernels from the checkout's sources
            (``nvcc``, into ``build/torch_kernels/``), timed;
3. kernel:  ``expansion_accept`` (CUDA) against its plain PyTorch version on
            the card at the shapes of the main path, (S, N) = (42, 468),
            (129, 54), (387, 6): equal accept masks, cut energies, the
            guard, median milliseconds of both;
4. small:   a small V3 solve on the card against the same solve on the CPU
            (plain versions), at windR 6 and 20: energies within the
            trajectory tolerance;
5. slice:   ``LocalExpansionSolver(device="cuda")`` on the 1436 x 992 x 145
            synthetic problem, 3 layers, 1 greedy + 1 graph-cut sweep, then
            the full 2 + 5 schedule: seconds per sweep and per layer,
            energies, bad rates against the planted truth, and the kernel
            launch counts of each run;
6. profile: one greedy and one graph-cut sweep of the slice under
            torch.profiler: wall and device-busy seconds and the idle share
            of each window, the largest device ops, the kernel's seconds per
            move-window size (CUDA events), and peak device memory.

Then a ``{"kernels": [...]}`` line, the ``nvidia-smi`` name/power-limit
line, and last ``{"ok": true, "device": {...}}``. Any failed check raises,
so the script exits non-zero and prints no result; it also refuses to run
without a CUDA device.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np

SHAPES = ((42, 468, 16), (129, 54, 16), (387, 6, 64))  # (S, N, sweeps)
ROUNDS = 16
RTOL, ATOL = 1e-5, 1e-4
SMALL_WINDR = (6, 20)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def phase_env(torch):
    from localexpstereo_tpu_torch.ops import mincut_cuda
    nvcc = subprocess.run([mincut_cuda._nvcc(), "--version"],
                          capture_output=True, text=True, check=True)
    emit({"phase": "env", "python": sys.version.split()[0],
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "nvcc": nvcc.stdout.strip().splitlines()[-1],
          "device": torch.cuda.get_device_name(0),
          "nvidia_smi": smi_line()})


def phase_build():
    from localexpstereo_tpu_torch.ops import mincut_cuda
    path, seconds, compiled = mincut_cuda.build(verbose=True)
    emit({"phase": "build", "library": str(path.name), "seconds": seconds,
          "compiled": compiled})


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


def make_solver(scale: float, device: str, sizes=None, windr: int = 20):
    from localexpstereo_tpu_torch.config import PARAMS_GF
    from localexpstereo_tpu_torch.models import engine
    from localexpstereo_tpu_torch.utils import synthetic
    img, vol, h, w, nd, truth = synthetic.build_problem(scale)
    params = PARAMS_GF.replace(windR=windr, lambda_=0.5, th_col=0.5)
    solver = engine.LocalExpansionSolver(img, img, params,
                                         max_disp=float(nd - 1), vol0=vol,
                                         vol1=vol, seed=0, device=device)
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
    narrow filter window and at the main path's."""
    for windr in SMALL_WINDR:
        out = {}
        for device in ("cuda", "cpu"):
            solver, truth, sizes = make_solver(0.06, device, sizes=[4, 8, 16],
                                               windr=windr)
            rec = Recorder(torch)
            solver.set_evaluator(rec)
            solver.run(iterations=2, pm_iterations=1)
            out[device] = ([e for _, e, _ in rec.rows],
                           bad_rates(solver, truth))
        (e_gpu, b_gpu), (e_cpu, b_cpu) = out["cuda"], out["cpu"]
        ok = all(abs(a - b) <= 0.002 * abs(b) + 1e-3
                 for a, b in zip(e_gpu, e_cpu))
        ok &= abs(b_gpu[1] - b_cpu[1]) <= 0.5
        emit({"phase": "small", "windR": windr, "layers": sizes,
              "energies_cuda": e_gpu, "energies_cpu": e_cpu,
              "bad_cuda": b_gpu, "bad_cpu": b_cpu, "agree": ok})
        if not ok:
            raise AssertionError(f"CUDA and CPU solves disagree at windR "
                                 f"{windr}")


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
    of that one window, the number of device ops and the largest ones."""
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
    return {"wall_s": wall, "device_busy_s": busy,
            "idle_share": 1.0 - busy / wall,
            "device_ops": sum(c for _, c, _ in dev),
            "top": [[k[:80], t, c] for t, c, k in dev[:8]]}


def phase_profile(torch):
    """One greedy sweep and then one graph-cut sweep of the slice (the
    1 + 1 run's trajectory, in a warm process), each under torch.profiler,
    the graph-cut kernel timed per call with CUDA events."""
    from localexpstereo_tpu_torch.models import engine
    from localexpstereo_tpu_torch.ops import mincut_cuda, rng
    solver, _, sizes = make_solver(1.0, "cuda")
    solver.finalize()
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
    emit({"phase": "profile", "layers": sizes, "greedy": greedy, "gc": gc,
          "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30})


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke needs one card",
              file=sys.stderr)
        return 2
    phase_env(torch)
    phase_build()
    rows = phase_kernel(torch)
    phase_small(torch)
    first = run_slice(torch, pm_iterations=1, iterations=1)
    run_slice(torch, pm_iterations=2, iterations=5)
    phase_profile(torch)
    # ms / plain_ms: one call at each of the three shapes, summed.
    emit({"kernels": [{
        "name": "expansion_accept", "route": "cuda",
        "source": "localexpstereo_tpu_torch/csrc/expansion_accept.cu",
        "replaces": "localexpstereo_tpu/ops/mincut_pallas.py:636",
        "launches": first["expansion_accept_launches"],
        "max_abs_err": max(r["max_abs_energy_err"] for r in rows),
        "ms": sum(r["ms"] for r in rows),
        "plain_ms": sum(r["plain_ms"] for r in rows)}]})
    print(smi_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
