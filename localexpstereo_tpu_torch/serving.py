"""Video-rate serving: one persistent solver for a stream of frames, each
warm-started from the previous frame's labeling (counterpart of
``localexpstereo_tpu.serving``).

The reference is a batch binary, one pair per process
(``main.cpp:425-480``). A stream keeps one :class:`LocalExpansionSolver`
(its layers and configuration) for every frame of one geometry, builds each
frame's energy on the device (``stats_backend="device"``,
:meth:`LocalExpansionSolver.update_frame`), and starts each frame after the
first from the previous labeling by the "cell" warm start: each layer-0
cell takes the previous label at a random pixel of the cell, one init's
cost, instead of the reference's per-pixel warm evaluation
(``FastGCStereo.h:117-130``, which its own comment calls "very slow"). A
short schedule (one graph-cut sweep by default) then adapts the labeling to
the new frame.

Usage::

    stream = StereoStream(params, max_disp=144.0, unit_sizes=[14, 43, 129])
    for im0, im1, vol0, vol1 in frames:
        disp = stream.process(im0, im1, vol0, vol1)   # [H, W] float32

Frames and volumes may be numpy arrays or tensors, on the card already
(e.g. from :func:`models.mccnn.cost_volume`); the labeling stays on the
device between frames, and only the [H, W] disparity map leaves it.
"""
from __future__ import annotations

import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from .config import Parameters
from .models.energy import resolve_device
from .models.engine import (COARSE_PROPOSERS, LAYER0_PROPOSERS,
                            LocalExpansionSolver)
from .ops import plane as plane_ops


class StereoStream:
    """Persistent stereo engine for frames of one geometry (H, W, and for
    the volume energy ndisp).

    Args:
      params: energy parameters, shared by all frames.
      max_disp, min_disp: the disparity range.
      unit_sizes: the layers' unit sizes.
      layer_proposers: optional proposer names per layer; by default the
        reference sets (``LAYER0_PROPOSERS`` on layer 0, else
        ``COARSE_PROPOSERS``).
      cold_iterations / cold_pm_iterations: graph-cut / greedy sweeps of
        the first frame after construction or :meth:`reset` (random init).
      warm_iterations / warm_pm_iterations: those of every other frame
        ("cell" warm start).
      vol_dtype: volume storage, "uint8" (256 levels over [0, 2 th_col],
        the device build's static range), "bfloat16" or "float32".
      stats_backend: "device", the JAX package's name of the static uint8
        range that every frame's build shares (the only value a stream
        takes: :meth:`LocalExpansionSolver.update_frame` needs it).
      profile: with True, :attr:`last_timings` splits each frame into the
        energy build, the solve and the output, with a device sync between
        them (which serializes the host against the device: leave False
        when serving).
      pipelined: with True, ``process(frame i)`` returns frame ``i - 1``'s
        disparity (``None`` for the first frame) and only starts frame
        ``i``'s copy to the host, into a pinned buffer, so that the copy
        may overlap frame ``i + 1``'s build;
        :meth:`flush` returns the last frame's.
      device: "cuda" (the default; raises without a card) or "cpu".
    """

    def __init__(self, params: Parameters, max_disp: float,
                 unit_sizes: Sequence[int],
                 layer_proposers: Optional[List] = None,
                 min_disp: float = 0.0, seed: int = 0,
                 cold_iterations: int = 5, cold_pm_iterations: int = 2,
                 warm_iterations: int = 1, warm_pm_iterations: int = 0,
                 vol_dtype: str = "uint8",
                 stats_backend: str = "device", profile: bool = False,
                 pipelined: bool = False, device="cuda"):
        if stats_backend != "device":
            raise ValueError(f"stats_backend {stats_backend!r}: a stream's "
                             f"frames share one configuration, which needs "
                             f"'device' (the static uint8 range)")
        self.params = params
        self.max_disp = float(max_disp)
        self.min_disp = float(min_disp)
        self.unit_sizes = list(unit_sizes)
        self.layer_proposers = layer_proposers
        self.seed = seed
        self.cold = (cold_iterations, cold_pm_iterations)
        self.warm = (warm_iterations, warm_pm_iterations)
        self.vol_dtype = vol_dtype
        self.stats_backend = stats_backend
        self.profile = profile
        self.pipelined = pipelined
        self.device = resolve_device(device)
        self.frame_index = 0
        #: Wall seconds of the last :meth:`process` call.
        self.last_frame_seconds: Optional[float] = None
        #: With ``profile``: {"build_s", "solve_s", "output_s"} of the last
        #: frame.
        self.last_timings: Optional[dict] = None
        self._prev_labeling: Optional[torch.Tensor] = None
        #: Pipelined mode: (host tensor, event) of the frame in flight.
        self._pending = None
        self._buffer: Optional[torch.Tensor] = None
        self._solver: Optional[LocalExpansionSolver] = None

    @property
    def solver(self) -> Optional[LocalExpansionSolver]:
        """The stream's solver (None before the first frame)."""
        return self._solver

    def _proposers(self, li: int):
        if self.layer_proposers is not None:
            return self.layer_proposers[li]
        return LAYER0_PROPOSERS if li == 0 else COARSE_PROPOSERS

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def process(self, im0, im1, vol0=None, vol1=None) -> Optional[np.ndarray]:
        """Estimates the left view's disparity of one frame: [H, W] float32,
        or with ``pipelined`` the previous frame's (``None`` on the first
        call and after :meth:`reset`). :attr:`last_frame_seconds` holds the
        wall time of the call."""
        t0 = time.perf_counter()
        if self._solver is None:
            self._solver = LocalExpansionSolver(
                im0, im1, self.params, self.max_disp, vol0=vol0, vol1=vol1,
                min_disp=self.min_disp, seed=self.seed, device=self.device,
                vol_dtype=self.vol_dtype, stats_backend=self.stats_backend)
            for li, size in enumerate(self.unit_sizes):
                self._solver.add_layer(size, self._proposers(li))
            self._solver.finalize()
        else:
            self._solver.update_frame(im0, im1, vol0, vol1,
                                      seed=self.seed + self.frame_index)
        solver = self._solver
        if self.profile:
            self._sync()
            t_build = time.perf_counter()
        if self._prev_labeling is None:
            iters, pm = self.cold
            labeling, _ = solver.run(iters, view_modes=(0,),
                                     pm_iterations=pm)
        else:
            iters, pm = self.warm
            labeling, _ = solver.run(iters, view_modes=(0,), pm_iterations=pm,
                                     init_labeling=self._prev_labeling,
                                     init_mode="cell")
        self._prev_labeling = labeling
        self.frame_index += 1
        if self.profile:
            self._sync()
            t_solve = time.perf_counter()
        disp = plane_ops.disparity_map(labeling)
        if self.pipelined:
            out = self._take_pending()
            self._pending = self._start_copy(disp)
        else:
            out = disp.cpu().numpy()
        t_end = time.perf_counter()
        self.last_frame_seconds = t_end - t0
        if self.profile:
            self.last_timings = {"build_s": t_build - t0,
                                 "solve_s": t_solve - t_build,
                                 "output_s": t_end - t_solve}
        return out

    def _start_copy(self, disp: torch.Tensor):
        """Starts the copy of ``disp`` to the host: on the card into the
        pinned buffer, without waiting, and an event that marks its end. (A
        copy into pageable memory would wait for the device.) The buffer
        is free: the frame before was taken out of it first."""
        if self.device.type != "cuda":
            return disp.clone(), None
        if self._buffer is None or self._buffer.shape != disp.shape:
            self._buffer = torch.empty(disp.shape, dtype=disp.dtype,
                                       pin_memory=True)
        host = self._buffer
        host.copy_(disp, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return host, done

    def _take_pending(self) -> Optional[np.ndarray]:
        """The frame in flight's disparity (a copy the caller owns: the
        buffer is reused by the next frame), or None."""
        if self._pending is None:
            return None
        host, done = self._pending
        self._pending = None
        if done is not None:
            done.synchronize()
        return host.numpy().copy()

    def flush(self) -> Optional[np.ndarray]:
        """Pipelined mode: the last frame's disparity, still in flight
        (``None`` when nothing is pending or the stream is not
        pipelined)."""
        return self._take_pending()

    def reset(self) -> Optional[np.ndarray]:
        """Drops the warm start: the next frame runs the cold schedule.
        Returns the frame still in flight in pipelined mode, as
        :meth:`flush` would (``None`` when nothing is pending), so that no
        frame is lost."""
        self._prev_labeling = None
        return self._take_pending()
