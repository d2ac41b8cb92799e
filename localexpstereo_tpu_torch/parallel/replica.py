"""One pair per device, in waves (counterpart of
``localexpstereo_tpu.parallel.replica``), and the standing pool of
workers that serves them.

The reference processes one pair per process (``demo.bat`` runs them one
after the other). The JAX package runs a batch of same-sized pairs over its
mesh, each chip executing the unchanged single-pair program; the port runs
the unchanged :class:`..models.engine.LocalExpansionSolver` for every pair,
pair ``b`` on ``devices[b % n]``, each device solving its pairs one after
the other. Pair ``b`` is ``LocalExpansionSolver(seed=seed + b)`` (the
reference's per-thread seeding, ``main.cpp:444-450``) on its device, so it
equals that solve bit for bit by construction. No wave is padded (the JAX
package pads for ``shard_map`` only).

With one device the pairs are solved in this process. With more, they go
through a :class:`ReplicaPool`: one worker process a device (``spawn``),
which initializes its device and runs the warm-up once, then takes pairs
one at a time, builds each pair's energy there and sends each result back
as numpy arrays as soon as its solve ends: the sweeps are bound by the host
(PERF.md §5), so threads of one process would serialize on the interpreter
lock. A list that names one device twice runs two workers on it. Pairs and
results are pickled through ``multiprocessing`` queues, whose readers take
each message from the pipe into one buffer.

Volumes are read one pair at a time, in pair order (``volumes`` may be a
generator, e.g. a :class:`..utils.prefetch.PairPrefetcher`'s), and a pair's
are dropped when it is solved.

Evaluators keep the JAX package's meaning: a process's evaluators start
together (when its first timed solve has its init) and stop together
(after its last pair), each pausing only itself while it evaluates, and
energy builds and volume reads are outside the clock. So with one device,
every pair of a group logs and writes the group's optimization time,
measured to device completion.

Tracing (:mod:`..utils.profiling`): the pool's own spans are
``replica.submit`` and ``replica.collect`` in the caller (the put of a pair
and the get of a result) and ``replica.receive`` and ``replica.return`` in
a worker (the get and unpickling of a pair; its results to numpy and the
put), each with the pair's ``b``; they record while a profiler window
records in their process. ``ReplicaPool(trace=True)`` opens one in every
worker, over its device's activity, from its start to :meth:`ReplicaPool.
close`, which hands back each worker's spans, device ops and peak memory.
"""
from __future__ import annotations

import dataclasses
import functools
import itertools
import multiprocessing
import multiprocessing.queues
import os
import queue
import struct
import time
import traceback
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import Parameters
from ..models import engine as engine_mod
from ..ops import kernels
from ..ops import plane as plane_ops
from ..utils import profiling
from .mesh import make_devices

#: Seconds between liveness checks of a worker while waiting on it.
_POLL_S = 1.0
#: Seconds between looks at an empty queue.
_IDLE_S = 0.002


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
    #: (view_modes, pm_iterations, iterations) of a throwaway solve before
    #: the clock starts; or None.
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


class _Dropped(Exception):
    """A pair dropped at a sweep boundary: its pool is closing."""


class _Stamps:
    """The evaluator a worker gives every solve: stamps the init and each
    sweep on ``time.perf_counter`` (``marks``: [(index, time)]), drops the
    pair at the stamp once ``stop`` is set, and passes every call on to the
    pair's own evaluator, where it has one."""

    def __init__(self, evaluator, stop):
        self._evaluator = evaluator
        self._stop = stop
        self.marks: List[Tuple[int, float]] = []

    def start(self):
        if self._evaluator is not None:
            self._evaluator.start()

    def stop(self):
        if self._evaluator is not None:
            self._evaluator.stop()

    def evaluate(self, solver, labeling_m, cost_m, mode=0, index=0):
        if self._evaluator is not None:
            self._evaluator.evaluate(solver, labeling_m, cost_m, mode=mode,
                                     index=index)
        self.marks.append((index, time.perf_counter()))
        if self._stop.is_set():
            raise _Dropped()

    def __getattr__(self, name):
        return getattr(self._evaluator, name)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        profiling.count_sync()


def _build(problem: _Problem, seed: int, im0, im1, vols,
           device: torch.device):
    solver = engine_mod.LocalExpansionSolver(
        im0, im1, problem.params, problem.max_disp, vol0=vols[0],
        vol1=vols[1], min_disp=problem.min_disp, seed=seed, device=device,
        unary_backend=problem.unary_backend, vol_dtype=problem.vol_dtype,
        interp=problem.interp)
    for size, names in zip(problem.unit_sizes, problem.layer_proposers):
        solver.add_layer(size, names)
    solver.finalize()
    _sync(device)
    return solver


def _warm_up(solver, schedule: _Schedule, device: torch.device) -> float:
    """The schedule's throwaway solve on ``solver``; its seconds."""
    t0 = time.perf_counter()
    modes, pm, it = schedule.warmup
    solver.run(it, view_modes=modes, pm_iterations=pm)
    _sync(device)
    return time.perf_counter() - t0


def _solve(problem: _Problem, schedule: _Schedule, b: int, im0, im1, vols,
           device: torch.device, evaluator, warmup: bool):
    """Pair ``b``'s solve on ``device``: (solver, raw labeling, its
    timings), the timings on both clocks."""
    before = kernels.launch_counts()
    t0 = time.perf_counter()
    solver = _build(problem, problem.seed + b, im0, im1, vols, device)
    t1 = time.perf_counter()
    warmup_s = (_warm_up(solver, schedule, device)
                if warmup and schedule.warmup is not None else 0.0)
    if evaluator is not None:
        solver.set_evaluator(evaluator)
    t2, started = time.perf_counter(), time.time()
    _, raw = solver.run(schedule.iterations, view_modes=schedule.view_modes,
                        pm_iterations=schedule.pm_iterations)
    _sync(device)
    t3 = time.perf_counter()
    return solver, raw, {
        "before": before, "build_s": t1 - t0, "warmup_s": warmup_s,
        "solve_s": t3 - t2, "solve_at": (started, started + t3 - t2),
        "stamps": {"build": (t0, t1), "solve": (t2, t3)}}


def _result(solver, raw, schedule: _Schedule, timing: dict) -> dict:
    """A solved pair's results as numpy arrays."""
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
        "launches": {k: after[k] - timing["before"][k] for k in after},
        "build_s": timing["build_s"], "warmup_s": timing["warmup_s"],
        "solve_s": timing["solve_s"], "solve_at": timing["solve_at"]}


def _solve_pair(problem: _Problem, schedule: _Schedule, b: int, im0, im1,
                vols, device: torch.device, evaluator, group,
                warmup: bool) -> dict:
    """Pair ``b``'s solve on ``device`` in this process, its results as
    numpy arrays."""
    solver, raw, timing = _solve(
        problem, schedule, b, im0, im1, vols, device,
        None if evaluator is None else _GroupMember(evaluator, group),
        warmup)
    return _result(solver, raw, schedule, timing)


def _nbytes(obj, seen=None) -> int:
    """Bytes of the arrays and tensors in ``obj`` (nested tuples, lists and
    dict values), each counted once, as pickling sends it."""
    seen = set() if seen is None else seen
    if id(obj) in seen:
        return 0
    seen.add(id(obj))
    if isinstance(obj, np.ndarray):
        return obj.nbytes
    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    if isinstance(obj, dict):
        obj = list(obj.values())
    if isinstance(obj, (tuple, list)):
        return sum(_nbytes(v, seen) for v in obj)
    return 0


def _label(sp, b) -> None:
    """Gives an open span (None while the recorder is off) the pair's
    ``b``."""
    if sp is not None:
        sp.attrs["b"] = b


def _wait(q, stop) -> bool:
    """Waits until ``q`` holds an item (True) or ``stop`` is set
    (False)."""
    while q.empty():
        if stop.is_set():
            return False
        time.sleep(_IDLE_S)
    return not stop.is_set()


def _drain(q) -> None:
    """Reads and drops what is queued on ``q``, so that its writer's
    feeder thread is not left blocked on a full pipe."""
    while True:
        try:
            q.get(timeout=0.05)
        except queue.Empty:
            return


def _read_exactly(fd: int, n: int) -> bytearray:
    """``n`` bytes of the pipe ``fd``, read into one buffer."""
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        k = os.readv(fd, [view[got:]])
        if k == 0:
            raise EOFError("the pipe closed inside a message")
        got += k
    return buf


def _recv_whole(conn, maxsize=None):
    """``conn.recv_bytes(maxsize)`` of a pipe ``Connection``, the message
    read into one buffer. ``Connection`` asks ``os.read`` for every byte
    still to come on each read of the pipe's 64 KiB, so a message of a
    pair's 843 MB allocated and freed that much some 13,000 times: 14 s
    for one reader, about 25 s each for four at once (PERF.md §5)."""
    fd = conn.fileno()
    size, = struct.unpack("!i", _read_exactly(fd, 4))
    if size == -1:
        size, = struct.unpack("!Q", _read_exactly(fd, 8))
    if maxsize is not None and size > maxsize:
        return None
    return _read_exactly(fd, size)


class _Queue(multiprocessing.queues.Queue):
    """A ``multiprocessing`` queue whose reader takes each message from the
    pipe into one buffer (:func:`_recv_whole`); the rest is the queue's."""

    def _reset(self, after_fork=False):
        super()._reset(after_fork)
        self._recv_bytes = functools.partial(_recv_whole, self._reader)


def _warm_inputs(like):
    """Random inputs shaped like a pair's: ``like`` is (image shape,
    volume shape or None)."""
    im_shape, vol_shape = like
    rng = np.random.default_rng(0)
    im = (rng.random(im_shape) * 255).astype(np.float32)
    vol = None if vol_shape is None else rng.random(vol_shape, np.float32)
    return im, (vol, vol)


def _worker(index: int, device: str, threads: int, problem: _Problem,
            schedule: _Schedule, evaluators: Dict[int, object], like,
            trace: bool, tasks, results, stop) -> None:
    """One device's worker. Warms up, sends ("ready", index), then solves
    the pairs it is sent, one at a time, sending (b, result) for each,
    until ``stop``; then sends ("closed", what it hands back). A failure
    sends ("error", traceback)."""
    try:
        torch.set_num_threads(threads)
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        window = profiling.DeviceWindow(dev) if trace else None
        if window is not None:
            window.start()
        group = [ev for ev in evaluators.values() if ev is not None]
        # The warm-up's launches and seconds go to the first pair solved.
        warm = {"before": kernels.launch_counts(), "warmup_s": 0.0}
        if schedule.warmup is not None and like is not None:
            im, vols = _warm_inputs(like)
            t0 = time.perf_counter()
            _warm_up(_build(problem, problem.seed, im, im, vols, dev),
                     schedule, dev)
            warm["warmup_s"] = time.perf_counter() - t0
            del im, vols
        else:
            torch.zeros(1, device=dev)
            _sync(dev)
        results.put(("ready", index))
        while _wait(tasks, stop):
            with profiling.span("replica.receive") as sp:
                t0 = time.perf_counter()
                b, im0, im1, vols = tasks.get()
                t1 = time.perf_counter()
                _label(sp, b)
            for ev in group:
                ev.stop()
            own = evaluators.get(b)
            stamps = _Stamps(None if own is None
                             else _GroupMember(own, group), stop)
            try:
                solver, raw, timing = _solve(problem, schedule, b, im0, im1,
                                             vols, dev, stamps, False)
            except _Dropped:
                break
            del im0, im1, vols
            with profiling.span("replica.return", b=b):
                t2 = time.perf_counter()
                if warm is not None:
                    timing.update(before=warm["before"],
                                  warmup_s=warm["warmup_s"])
                    warm = None
                result = _result(solver, raw, schedule, timing)
                del solver, raw
                result["stamps"] = dict(timing["stamps"], receive=(t0, t1),
                                        marks=stamps.marks, ret=t2)
                results.put((b, result))
        for ev in group:
            ev.stop()
            ev.close()
        info = {"worker": index, "device": device,
                "timers": {b: ev.timer for b, ev in evaluators.items()
                           if ev is not None},
                "peak_bytes": (torch.cuda.max_memory_allocated(dev)
                               if dev.type == "cuda" else 0)}
        if window is not None:
            info.update(window.stop())
        _drain(tasks)
        results.put(("closed", info))
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


class ReplicaPool:
    """Standing workers, one a device, that take pairs one at a time and
    send each pair's results back as soon as its solve ends.

    :meth:`start` spawns the workers; each initializes its device and runs
    the schedule's warm-up (random inputs of the pairs' shapes) before
    :meth:`start` returns, so that the processes' start, the kernels' loads
    and the device's first-use costs stay out of every pair's time.
    :meth:`submit` gives pair ``b`` (``LocalExpansionSolver(seed=seed + b)``
    with the schedule) to a worker, :meth:`next_result` returns the results
    in the order the solves end, and :meth:`close` stops the workers. A
    worker's exception is raised in the caller with its traceback.

    Args:
      problem, schedule: the pairs' problem and schedule (as
        :meth:`ReplicaSolver.pool` makes them).
      devices: one worker a device (a device named twice gets two).
      evaluators: by worker, {b: evaluator} of the pairs it will solve (a
        group that starts and stops together); their clocks come back at
        :meth:`close` (``timers``).
      trace: each worker records a profiler window over its device from its
        start to :meth:`close`, which hands back its spans and device ops.

    Each worker takes this process's intra-op thread count.
    """

    def __init__(self, problem: _Problem, schedule: _Schedule, devices,
                 evaluators: Optional[List[Dict[int, object]]] = None,
                 trace: bool = False):
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("no devices")
        n = len(self.devices)
        self.problem = problem
        self.schedule = schedule
        self.trace = trace
        self._evaluators = evaluators or [{} for _ in range(n)]
        if len(self._evaluators) != n:
            raise ValueError(f"evaluators for {len(self._evaluators)} "
                             f"workers, {n} devices")
        self._procs: Optional[list] = None
        self._in_flight = [0] * n
        self._sent: Dict[int, Tuple[int, float, float]] = {}
        self._counts = {"submitted": 0, "completed": 0, "bytes_in": 0,
                        "bytes_out": 0, "max_in_flight": 0}
        #: What each worker handed back at :meth:`close`, by worker.
        self.workers: List[dict] = []

    def __enter__(self) -> "ReplicaPool":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False

    def start(self, like=None) -> "ReplicaPool":
        """Spawns the workers and waits until every one is warm. ``like``:
        (image, (vol0, vol1)) of a pair, whose shapes the warm-up's random
        inputs take; without it, or without a warm-up in the schedule, a
        worker only initializes its device."""
        if like is not None:
            im, vols = like
            like = (tuple(im.shape),
                    None if vols[0] is None else tuple(vols[0].shape))
        ctx = multiprocessing.get_context("spawn")
        n = len(self.devices)
        self._tasks = [_Queue(maxsize=1, ctx=ctx) for _ in range(n)]
        self._out = _Queue(ctx=ctx)
        self._stop = ctx.Event()
        self._procs = [ctx.Process(
            target=_worker, name=f"replica-{i}-{dev}", daemon=True,
            args=(i, str(dev), torch.get_num_threads(), self.problem,
                  self.schedule,
                  self._evaluators[i], like, self.trace, self._tasks[i],
                  self._out, self._stop))
            for i, dev in enumerate(self.devices)]
        for p in self._procs:
            p.start()
        try:
            ready = 0
            while ready < n:
                key, value = self._get(None)
                if key == "error":
                    raise RuntimeError(value)
                ready += key == "ready"
        except BaseException:
            self.close()
            raise
        return self

    def submit(self, b: int, im0, im1, vols,
               worker: Optional[int] = None) -> int:
        """Gives pair ``b`` (images, (vol0, vol1)) to ``worker``, by
        default to the one with the fewest pairs in flight; waits while that
        worker's queue is full. Returns the worker's index."""
        if self._procs is None:
            raise RuntimeError("the pool is not running")
        i = (worker if worker is not None else
             min(range(len(self.devices)), key=self._in_flight.__getitem__))
        with profiling.span("replica.submit", b=b):
            t0 = time.perf_counter()
            _put(self._tasks[i], (b, im0, im1, vols), self._procs[i],
                 self._out)
            t1 = time.perf_counter()
        self._sent[b] = (i, t0, t1)
        self._in_flight[i] += 1
        c = self._counts
        c["submitted"] += 1
        c["bytes_in"] += _nbytes((im0, im1, vols))
        c["max_in_flight"] = max(c["max_in_flight"], sum(self._in_flight))
        return i

    def next_result(self, timeout: Optional[float] = None) -> Optional[dict]:
        """The next pair whose solve ended: {"b", "worker", "result" (as
        :meth:`ReplicaSolver.run` keeps it), "stamps"}; None if ``timeout``
        seconds pass first. ``stamps``, on ``time.perf_counter``: "submit",
        "receive", "build", "solve" and "collect" as (start, end), "ret" (its
        return's start) and "marks" ([(evaluator index, time)])."""
        while True:
            got = self._get(timeout, span="replica.collect")
            if got is None:
                return None
            (key, value), (c0, c1) = got
            if key == "error":
                raise RuntimeError(value)
            if key not in ("ready", "closed"):
                break
        i, s0, s1 = self._sent.pop(key)
        self._in_flight[i] -= 1
        self._counts["completed"] += 1
        self._counts["bytes_out"] += _nbytes(value)
        stamps = dict(value.pop("stamps"), submit=(s0, s1), collect=(c0, c1))
        return {"b": key, "worker": i, "result": value, "stamps": stamps}

    def _get(self, timeout: Optional[float], span: Optional[str] = None):
        """The next message of the workers (with ``span``: the message and
        the get's (start, end), in a span of that name); None once
        ``timeout`` seconds have passed. Raises if every worker has died."""
        deadline = None if timeout is None else time.perf_counter() + timeout
        last = time.perf_counter()
        while self._out.empty():
            now = time.perf_counter()
            if deadline is not None and now >= deadline:
                return None
            if now - last >= _POLL_S:
                last = now
                if not any(p.is_alive() for p in self._procs) and \
                        self._out.empty():
                    raise RuntimeError("replica workers exited without "
                                       "their results")
            time.sleep(_IDLE_S)
        if span is None:
            return self._out.get()
        with profiling.span(span) as sp:
            t0 = time.perf_counter()
            msg = self._out.get()
            t1 = time.perf_counter()
            _label(sp, msg[0])
        return msg, (t0, t1)

    def counts(self) -> Dict[str, int]:
        """Pairs ``submitted`` and ``completed``; the bytes of the arrays
        handed to the workers (``bytes_in``) and back (``bytes_out``); the
        most pairs in flight at once (``max_in_flight``)."""
        return dict(self._counts)

    def close(self, timeout: float = 30.0) -> List[dict]:
        """Stops the workers: a pair in flight is dropped at its next sweep
        boundary, and a worker still running ``timeout`` seconds on is
        terminated. Returns what each worker handed back (:attr:`workers`):
        ``timers`` (its evaluators' clocks by pair), ``peak_bytes`` (its
        device's ``max_memory_allocated``) and, with ``trace``, ``spans``
        and ``ops`` (:meth:`..utils.profiling.DeviceWindow.stop`)."""
        if self._procs is None:
            return self.workers
        procs, n = self._procs, len(self.devices)
        self._stop.set()
        infos: Dict[int, dict] = {}
        deadline = time.perf_counter() + timeout
        while len(infos) < n and time.perf_counter() < deadline:
            alive = any(p.is_alive() for p in procs)
            try:
                key, value = self._out.get(timeout=_POLL_S)
            except queue.Empty:
                if not alive:
                    break
                continue
            if key == "closed":
                infos[value["worker"]] = value
        for p in procs:
            p.join(max(deadline - time.perf_counter(), 0.0))
            if p.is_alive():
                p.terminate()
                p.join()
        for q in self._tasks + [self._out]:
            q.cancel_join_thread()
            q.close()
        self._procs = None
        self.workers = [infos.get(i, {"worker": i}) for i in range(n)]
        return self.workers


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
        """Gives the next :meth:`run` (or :meth:`pool`) a throwaway solve
        with at most one sweep of each kind (and these views) before the
        clock starts: in this process on the first pair, in each worker at
        its start. The kernels' builds and the device's first-use costs stay
        out of the evaluators' time (the JAX method compiles at once; here
        the volumes are only read in :meth:`run`)."""
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

    def _schedule(self, iterations: int, view_modes: Sequence[int],
                  pm_iterations: int) -> _Schedule:
        return _Schedule(int(iterations), tuple(view_modes),
                         int(pm_iterations), self._warmup)

    def pool(self, iterations: int, view_modes: Sequence[int] = (0,),
             pm_iterations: int = 0, trace: bool = False) -> ReplicaPool:
        """A :class:`ReplicaPool` (not started) of this batch's problem
        and devices, with :meth:`run`'s schedule and the warm-up of
        :meth:`precompile`; the evaluators of pairs ``b`` go to worker ``b
        % n``."""
        n = len(self.devices)
        evs = self.evaluators or [None] * self.batch
        return ReplicaPool(
            self.problem, self._schedule(iterations, view_modes,
                                         pm_iterations), self.devices,
            evaluators=[{b: evs[b] for b in range(i, self.batch, n)
                         if evs[b] is not None} for i in range(n)],
            trace=trace)

    def run(self, iterations: int, view_modes: Sequence[int] = (0,),
            pm_iterations: int = 0):
        """Solves every pair with ``LocalExpansionSolver.run``'s schedule
        (init, greedy sweeps, graph-cut sweeps, the views interleaved, and
        with two views the post-process). Returns (final, raw): [B, H, W,
        4] numpy labelings of view 0 after and before the post-process (the
        same array with one view)."""
        schedule = self._schedule(iterations, view_modes, pm_iterations)
        if len(self.devices) == 1:
            results = self._run_here(schedule)
        else:
            results = self._run_pool(iterations, view_modes, pm_iterations)
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

    def _run_pool(self, iterations, view_modes, pm_iterations) -> List[dict]:
        """Pair ``b`` to worker ``b % n`` in pair order, the volumes read
        as each pair is handed over."""
        n = len(self.devices)
        volumes = iter(self._pair_volumes())
        first = next(volumes, None)
        results: Dict[int, dict] = {}
        with self.pool(iterations, view_modes, pm_iterations) as pool:
            pool.start(None if first is None else (self.ims0[0], first))
            pairs = itertools.chain([] if first is None else [first],
                                    volumes)
            sent = 0
            for b, vols in zip(range(self.batch), pairs):
                pool.submit(b, self.ims0[b], self.ims1[b], vols, worker=b % n)
                sent += 1
            if sent != self.batch:
                raise ValueError(f"volumes of {sent} pairs for {self.batch}")
            while len(results) < sent:
                got = pool.next_result()
                results[got["b"]] = got["result"]
        for info in pool.workers:
            for b, timer in info.get("timers", {}).items():
                self.evaluators[b].timer = timer
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
        """Pair ``b``'s kernel launches (the warm-up's included in those of
        the first pair each process solves), the seconds of its energy
        build, its process's warm-up (0 but on that first pair) and its
        timed solve, and when the timed solve ran (``solve_at``: start and
        end on the host's wall clock, which the workers share)."""
        r = self._result(b)
        return {k: r[k] for k in ("launches", "build_s", "warmup_s",
                                  "solve_s", "solve_at")}
