"""One pair per device, in waves (counterpart of
``localexpstereo_tpu.parallel.replica``).

The reference processes one pair per process (``demo.bat`` runs them one
after the other). The JAX package runs a batch of same-sized pairs over its
mesh, each chip executing the unchanged single-pair program; the port runs
the unchanged :class:`..models.engine.LocalExpansionSolver` for every pair,
pair ``b`` on ``devices[b % n]``, each device solving its pairs one after
the other. Pair ``b`` is ``LocalExpansionSolver(seed=seed + b)`` (the
reference's per-thread seeding, ``main.cpp:444-450``) on its device, so it
equals that solve bit for bit by construction. No wave is padded (the JAX
package pads for ``shard_map`` only).

With one device the pairs are solved in this process. With more, each
device gets one worker process (``spawn``), which initializes its device,
builds its pairs' energies there and sends its results back as numpy
arrays: the sweeps are bound by the host (PERF.md §5), so threads of one
process would serialize on the interpreter lock. A list that names one
device twice runs two workers on it.

Volumes are read one pair at a time, in pair order (``volumes`` may be a
generator, e.g. a :class:`..utils.prefetch.PairPrefetcher`'s), and a pair's
are dropped when it is solved.

Evaluators keep the JAX package's meaning: a process's evaluators start
together (when its first timed solve has its init) and stop together
(after its last pair), each pausing only itself while it evaluates, and
energy builds and volume reads are outside the clock. So with one device,
every pair of a group logs and writes the group's optimization time,
measured to device completion.
"""
from __future__ import annotations

import dataclasses
import multiprocessing
import queue
import time
import traceback
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import Parameters
from ..models import engine as engine_mod
from ..ops import kernels
from ..ops import plane as plane_ops
from .mesh import make_devices

#: Seconds between liveness checks of a worker while waiting on it.
_POLL_S = 1.0


@dataclasses.dataclass(frozen=True)
class _Problem:
    """What the pairs of a batch share (sent to every worker)."""

    params: Parameters
    max_disp: float
    unit_sizes: Tuple[int, ...]
    layer_proposers: Tuple[Tuple[str, ...], ...]
    min_disp: float
    seed: int
    vol_dtype: str
    unary_backend: str
    interp: int


@dataclasses.dataclass(frozen=True)
class _Schedule:
    iterations: int
    view_modes: Tuple[int, ...]
    pm_iterations: int
    #: (view_modes, pm_iterations, iterations) of a throwaway solve of the
    #: first pair each process solves, before its clock starts; or None.
    warmup: Optional[Tuple[Tuple[int, ...], int, int]]


class _GroupMember:
    """A pair's evaluator as one of its group: :meth:`start` starts every
    evaluator of the group, :meth:`stop` leaves them ticking (the group
    stops together), and the rest is the evaluator's own."""

    def __init__(self, evaluator, group):
        self._evaluator = evaluator
        self._group = group

    def start(self):
        for ev in self._group:
            ev.start()

    def stop(self):
        pass

    def __getattr__(self, name):
        return getattr(self._evaluator, name)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _solve_pair(problem: _Problem, schedule: _Schedule, b: int, im0, im1,
                vols, device: torch.device, evaluator, group,
                warmup: bool) -> dict:
    """Pair ``b``'s solve on ``device``, its results as numpy arrays."""
    before = kernels.launch_counts()
    t0 = time.perf_counter()
    solver = engine_mod.LocalExpansionSolver(
        im0, im1, problem.params, problem.max_disp, vol0=vols[0],
        vol1=vols[1], min_disp=problem.min_disp, seed=problem.seed + b,
        device=device, unary_backend=problem.unary_backend,
        vol_dtype=problem.vol_dtype, interp=problem.interp)
    for size, names in zip(problem.unit_sizes, problem.layer_proposers):
        solver.add_layer(size, names)
    solver.finalize()
    _sync(device)
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    if warmup and schedule.warmup is not None:
        modes, pm, it = schedule.warmup
        solver.run(it, view_modes=modes, pm_iterations=pm)
        _sync(device)
    warmup_s = time.perf_counter() - t0
    if evaluator is not None:
        solver.set_evaluator(_GroupMember(evaluator, group))
    t0, started = time.perf_counter(), time.time()
    _, raw = solver.run(schedule.iterations, view_modes=schedule.view_modes,
                        pm_iterations=schedule.pm_iterations)
    _sync(device)
    solve_s = time.perf_counter() - t0
    modes = schedule.view_modes
    after = kernels.launch_counts()
    return {
        "labelings": {m: solver._unpadded_labeling(m).cpu().numpy()
                      for m in modes},
        "raw": raw.cpu().numpy() if len(modes) == 2 else None,
        "disparity": solver.disparity_map(0).cpu().numpy(),
        "raw_disparity": (plane_ops.disparity_map(raw).cpu().numpy()
                          if len(modes) == 2 else None),
        "energies": {m: tuple(float(x) for x in engine_mod.energy_audit(
            solver.data, solver.cfg, *solver._state[m], m)) for m in modes},
        "launches": {k: after[k] - before[k] for k in after},
        "build_s": build_s, "warmup_s": warmup_s, "solve_s": solve_s,
        "solve_at": (started, started + solve_s)}


def _worker(device: str, threads: int, problem: _Problem,
            schedule: _Schedule, evaluators: Dict[int, object], tasks,
            results) -> None:
    """One device's worker: solves the pairs it is sent, in order, until
    None; then sends ("done", {b: evaluator timer}). A failure sends
    ("error", traceback)."""
    try:
        torch.set_num_threads(threads)
        dev = torch.device(device)
        group = [ev for ev in evaluators.values() if ev is not None]
        first = True
        while True:
            task = tasks.get()
            if task is None:
                break
            b, im0, im1, vols = task
            for ev in group:
                ev.stop()
            results.put((b, _solve_pair(problem, schedule, b, im0, im1, vols,
                                        dev, evaluators.get(b), group,
                                        first)))
            first = False
        for ev in group:
            ev.stop()
            ev.close()
        results.put(("done", {b: ev.timer for b, ev in evaluators.items()
                              if ev is not None}))
    except Exception:
        results.put(("error", f"worker on {device}:\n"
                              f"{traceback.format_exc()}"))


def _put(q, item, proc, results) -> None:
    """``q.put(item)``; raises the worker's error if the worker that reads
    ``q`` died."""
    while True:
        try:
            q.put(item, timeout=_POLL_S)
            return
        except queue.Full:
            if not proc.is_alive():
                raise RuntimeError(_worker_error(results) or (
                    f"replica worker {proc.name} exited "
                    f"({proc.exitcode})")) from None


def _worker_error(results) -> Optional[str]:
    """The first error a worker sent, if any, from what is queued."""
    while True:
        try:
            key, value = results.get(timeout=_POLL_S)
        except queue.Empty:
            return None
        if key == "error":
            return value


def _get(q, procs):
    """The next result, raising if every worker has died without one."""
    while True:
        try:
            return q.get(timeout=_POLL_S)
        except queue.Empty:
            if not any(p.is_alive() for p in procs):
                raise RuntimeError("replica workers exited without their "
                                   "results") from None


class ReplicaSolver:
    """Local-expansion stereo over a batch of same-sized pairs, one pair
    at a time on each device (the JAX package's ``ReplicaSolver`` API,
    with a device list in place of the mesh).

    Args:
      ims0, ims1: [B, H, W, 3] arrays, or sequences of B [H, W, 3] images.
      params, max_disp, min_disp: the energy's.
      unit_sizes: the layers' unit sizes; ``layer_proposers`` their
        proposer names (default: the reference's sets).
      devices: torch devices (or names); pair b runs on devices[b % n].
        Default: one entry per visible CUDA device
        (:func:`.mesh.make_devices`).
      vols0, vols1: [B, D, H, W] arrays or sequences of [D, H, W] volumes;
        or ``volumes``: an iterable of (vol0, vol1), one per pair in pair
        order, read once by :meth:`run`. Without either, the V2
        (image-warp) energy.
      seed: pair b takes ``seed + b``.
      vol_dtype, unary_backend, interp: as
        :class:`..models.engine.LocalExpansionSolver`'s.
    """

    def __init__(self, ims0, ims1, params: Parameters, max_disp: float,
                 unit_sizes: Sequence[int], devices=None,
                 layer_proposers: Optional[Sequence[Sequence[str]]] = None,
                 vols0=None, vols1=None,
                 volumes: Optional[Iterable] = None, min_disp: float = 0.0,
                 seed: int = 0, vol_dtype: str = "uint8",
                 unary_backend: str = "auto", interp: int = 1):
        if len(ims0) != len(ims1):
            raise ValueError(f"{len(ims0)} left and {len(ims1)} right images")
        if volumes is not None and vols0 is not None:
            raise ValueError("pass vols0/vols1 or volumes, not both")
        if unary_backend == "dma" and interp != 1:
            raise ValueError(f"unary_backend 'dma' samples linearly only: "
                             f"interp {interp} needs 'auto'")
        self.ims0, self.ims1 = ims0, ims1
        self.batch = len(ims0)
        if devices is None:
            devices = make_devices()
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("no devices")
        proposers = (layer_proposers or
                     [engine_mod.LAYER0_PROPOSERS]
                     + [engine_mod.COARSE_PROPOSERS] * (len(unit_sizes) - 1))
        self.problem = _Problem(
            params=params, max_disp=float(max_disp),
            unit_sizes=tuple(int(s) for s in unit_sizes),
            layer_proposers=tuple(tuple(p) for p in proposers),
            min_disp=float(min_disp), seed=int(seed), vol_dtype=vol_dtype,
            unary_backend=unary_backend, interp=int(interp))
        if vols0 is not None:
            volumes = list(zip(vols0, vols1 if vols1 is not None else vols0))
        self._volumes = volumes
        self._volumes_read = False
        self.evaluators: Optional[List] = None
        self._warmup = None
        self._results: Optional[List[dict]] = None

    @property
    def waves(self) -> int:
        """Pairs a device solves one after the other, at most."""
        return -(-self.batch // len(self.devices))

    def set_evaluators(self, evaluators: List):
        if len(evaluators) != self.batch:
            raise ValueError(f"{len(evaluators)} evaluators for "
                             f"{self.batch} pairs")
        self.evaluators = evaluators

    def precompile(self, view_modes: Sequence[int] = (0, 1),
                   pm_iterations: int = 1, iterations: int = 1):
        """Makes the next :meth:`run` give the first pair each process
        solves a throwaway solve with at most one sweep of each kind (and
        these views) before its clock starts: the kernels' builds and the
        device's first-use costs stay out of the evaluators' time (the JAX
        method compiles at once; here the volumes are only read in
        :meth:`run`)."""
        self._warmup = (tuple(view_modes), min(pm_iterations, 1),
                        min(iterations, 1))

    def _pair_volumes(self):
        """(vol0, vol1) of each pair in order; an iterable that is not a
        list is read once."""
        if self._volumes is None:
            return [(None, None)] * self.batch
        if self._volumes_read and not isinstance(self._volumes, list):
            raise RuntimeError("the volumes were read by an earlier run()")
        self._volumes_read = True
        return self._volumes

    def run(self, iterations: int, view_modes: Sequence[int] = (0,),
            pm_iterations: int = 0):
        """Solves every pair with ``LocalExpansionSolver.run``'s schedule
        (init, greedy sweeps, graph-cut sweeps, the views interleaved, and
        with two views the post-process). Returns (final, raw): [B, H, W,
        4] numpy labelings of view 0 after and before the post-process (the
        same array with one view)."""
        schedule = _Schedule(int(iterations), tuple(view_modes),
                             int(pm_iterations), self._warmup)
        if len(self.devices) == 1:
            results = self._run_here(schedule)
        else:
            results = self._run_workers(schedule)
        self._results = results
        final = np.stack([r["labelings"][0] for r in results])
        if len(schedule.view_modes) == 2:
            return final, np.stack([r["raw"] for r in results])
        return final, final

    def _run_here(self, schedule: _Schedule) -> List[dict]:
        group = [ev for ev in (self.evaluators or []) if ev is not None]
        results = []
        for b, vols in zip(range(self.batch), self._pair_volumes()):
            for ev in group:
                ev.stop()
            results.append(_solve_pair(
                self.problem, schedule, b, self.ims0[b], self.ims1[b], vols,
                self.devices[0], self.evaluators[b] if self.evaluators
                else None, group, b == 0))
        for ev in group:
            ev.stop()
        if len(results) != self.batch:
            raise ValueError(f"volumes of {len(results)} pairs for "
                             f"{self.batch}")
        return results

    def _run_workers(self, schedule: _Schedule) -> List[dict]:
        ctx = multiprocessing.get_context("spawn")
        n = len(self.devices)
        evs = self.evaluators or [None] * self.batch
        tasks = [ctx.Queue(maxsize=1) for _ in range(n)]
        out = ctx.Queue()
        procs = [ctx.Process(
            target=_worker, name=f"replica-{i}-{dev}", daemon=True,
            args=(str(dev), torch.get_num_threads(), self.problem, schedule,
                  {b: evs[b] for b in range(i, self.batch, n)}, tasks[i],
                  out)) for i, dev in enumerate(self.devices)]
        for p in procs:
            p.start()
        try:
            sent = 0
            for b, vols in zip(range(self.batch), self._pair_volumes()):
                _put(tasks[b % n], (b, self.ims0[b], self.ims1[b], vols),
                     procs[b % n], out)
                sent += 1
            for q, p in zip(tasks, procs):
                _put(q, None, p, out)
            if sent != self.batch:
                raise ValueError(f"volumes of {sent} pairs for {self.batch}")
            results: Dict[int, dict] = {}
            done = 0
            while done < n:
                key, value = _get(out, procs)
                if key == "error":
                    raise RuntimeError(value)
                if key == "done":
                    for b, timer in value.items():
                        evs[b].timer = timer
                    done += 1
                else:
                    results[key] = value
            for p in procs:
                p.join()
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
                    p.join()
        return [results[b] for b in range(self.batch)]

    # ------------------------------------------------------------ results --

    def _result(self, b: int) -> dict:
        if self._results is None:
            raise RuntimeError("needs a completed run()")
        return self._results[b]

    def labeling(self, b: int, mode: int = 0) -> np.ndarray:
        """Pair ``b``'s [H, W, 4] labeling of view ``mode`` after
        :meth:`run` (after the post-process, with two views)."""
        return self._result(b)["labelings"][mode]

    def disparities(self, raw: bool = False) -> np.ndarray:
        """[B, H, W] disparities of view 0 after :meth:`run`, computed on
        the pairs' devices; with ``raw`` (two views only) before the
        post-process."""
        key = "raw_disparity" if raw else "disparity"
        return np.stack([self._result(b)[key] for b in range(self.batch)])

    def energies(self, mode: int = 0):
        """Per-pair (total, data, smooth) energies of view ``mode`` at the
        end of :meth:`run`, and the batch mean total."""
        rows = np.asarray([self._result(b)["energies"][mode]
                           for b in range(self.batch)], np.float64)
        return (rows[:, 0], rows[:, 1], rows[:, 2]), float(rows[:, 0].mean())

    def pair_stats(self, b: int) -> dict:
        """Pair ``b``'s kernel launches (its warm-up included), the
        seconds of its energy build, its warm-up solve (0 without one) and
        its timed solve, and when the timed solve ran (``solve_at``: start
        and end on the host's wall clock, which the workers share)."""
        r = self._result(b)
        return {k: r[k] for k in ("launches", "build_s", "warmup_s",
                                  "solve_s", "solve_at")}
