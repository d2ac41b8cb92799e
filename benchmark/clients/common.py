"""What both clients share: the solver's evaluator that stamps the
schedule and closes the window, the samples of each frame that the
correctness check reads once the window has closed, and the capture of a
few of each frame's expansion moves.

Everything a frame keeps for the check is gathered on the card where it is
produced, without waiting for it (a few gathers a frame), so that the
window's frames are not slowed by the check.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch


class WindowClosed(Exception):
    """Raised inside a solve once the window has closed: the frame is
    dropped."""


class Samples:
    """Where a run samples its frames, drawn once from the seed: layer-0
    cells (``cell_y``, ``cell_x``) whose init the reference evaluates
    again, and ``points`` pixels (``py``, ``px``) of the built statistics
    and weights, with a disparity each (``pd``) for the stored volume."""

    def __init__(self, config: dict, seed: int, device, cells: int = 32,
                 points: int = 1 << 15):
        h, w, nd = config["height"], config["width"], config["ndisp"]
        s = config["unit_sizes"][0]
        rng = np.random.default_rng([seed % 2 ** 63, 7])
        hb, wb = -(-h // s), -(-w // s)
        pick = rng.choice(hb * wb, size=min(cells, hb * wb), replace=False)
        self.cell_y = torch.as_tensor((pick // wb) * s, device=device)
        self.cell_x = torch.as_tensor((pick % wb) * s, device=device)
        self.py = torch.as_tensor(rng.integers(0, h, points), device=device)
        self.px = torch.as_tensor(rng.integers(0, w, points), device=device)
        self.pd = torch.as_tensor(rng.integers(0, nd, points), device=device)
        self.s = s
        self.r = config["energy"]["windR"] // 2
        self.shape = (h, w)
        it = torch.arange(s, device=device)
        self._cy = self.cell_y[:, None, None] + it[None, :, None]
        self._cx = self.cell_x[:, None, None] + it[None, None, :]
        f = s + 2 * self.r
        jt = torch.arange(f, device=device) - self.r
        self._wy = self.cell_y[:, None, None] + jt[None, :, None]
        self._wx = self.cell_x[:, None, None] + jt[None, None, :]

    def cell_state(self, labeling_m, cost_m, pad: int):
        """The padded state at the cells: labels [M, 4] (each cell's one
        label, at its first pixel) and costs [M, s, s] (0 outside the
        image)."""
        h, w = self.shape
        ys = (self._cy.clamp(max=h - 1) + pad)
        xs = (self._cx.clamp(max=w - 1) + pad)
        inside = (self._cy < h) & (self._cx < w)
        labels = labeling_m[self.cell_y + pad, self.cell_x + pad]
        return labels.clone(), cost_m[ys, xs] * inside

    def volume_windows(self, vol: torch.Tensor) -> torch.Tensor:
        """[M, D, F, F] float32 windows of a [D, H, W] volume around the
        cells (F = s + 2R), zero outside the image."""
        h, w = self.shape
        inside = ((self._wy >= 0) & (self._wy < h) & (self._wx >= 0)
                  & (self._wx < w))
        win = vol[:, self._wy.clamp(0, h - 1), self._wx.clamp(0, w - 1)]
        return (win * inside).to(torch.float32).permute(1, 0, 2, 3) \
            .contiguous()

    def volume_points(self, vol: torch.Tensor) -> torch.Tensor:
        return vol[self.pd, self.py, self.px].to(torch.float32)

    def built(self, data, cfg) -> Dict[str, torch.Tensor]:
        """The energy build's output at the sampled pixels (view 0): guide
        means [K, 3], inverse covariances [K, 6], weights [8, K], and the
        stored volume's codes at the sampled positions [K]."""
        p, vp = cfg.pad, cfg.vol_pad
        y, x = self.py + p, self.px + p
        return {"mean": data.gf_mean[0, y, x].clone(),
                "inv": data.gf_inv[0, y, x].clone(),
                "weights": data.coeff8[0][:, y, x].clone(),
                "codes": data.vol[0, self.pd, self.py + vp,
                                  self.px + vp].clone(),
                "vol_scale": cfg.vol_scale, "vol_zero": cfg.vol_zero}


class Evaluator:
    """The solver's evaluator (``set_evaluator``): stamps the init and every
    sweep, keeps the init's samples, and raises :class:`WindowClosed` once ``deadline`` has
    passed. With ``sync`` it waits for the card at every stamp (traced
    runs only), so that the stamps time the device work."""

    def __init__(self, samples: Samples, deadline: float, sync: bool,
                 float_volume: Optional[torch.Tensor]):
        self.samples = samples
        self.deadline = deadline
        self.sync = sync
        self.float_volume = float_volume
        self.marks: List[tuple] = []
        self.kept: Dict[str, object] = {}

    def start(self):
        pass

    def stop(self):
        pass

    def evaluate(self, solver, labeling_m, cost_m, mode=0, index=0):
        if self.sync:
            torch.cuda.synchronize()
        now = time.perf_counter()
        self.marks.append((index, now))
        if index == 0:
            lab, cost = self.samples.cell_state(labeling_m, cost_m,
                                                solver.cfg.pad)
            self.kept.update(init_labels=lab, init_costs=cost,
                             built=self.samples.built(solver.data,
                                                      solver.cfg))
            if self.float_volume is not None:
                self.kept.update(
                    vol_windows=self.samples.volume_windows(
                        self.float_volume),
                    vol_points=self.samples.volume_points(
                        self.float_volume))
        if now > self.deadline:
            raise WindowClosed()


#: Colour steps of a layer's sweep (the reference C++'s j = 0..15).
COLORS = 16


class MoveCapture:
    """Stands in for the engine's module of graph-cut kernels
    (``engine.mincut_cuda``): passes every call on to that module as it is
    at the call, and, between :meth:`begin` and :meth:`end`, keeps one
    region of some of the expansion moves of window size ``3 s`` (layer 0):
    the kernel's inputs and its answer, copied on the card without waiting
    for it. The calls and regions are drawn from the seed and the frame,
    ``per_frame`` of them a frame on average."""

    def __init__(self, module, config: dict, kind: str, seed: int,
                 per_frame: int):
        from .. import roofline
        self.module = module
        self.size = 3 * config["unit_sizes"][0]
        self.seed = seed
        nd = float(config["ndisp"] - 1)
        calls = sum(COLORS * roofline.plan_length(config["proposers"][0], it,
                                                  0.0, nd)
                    for it, gc in roofline.sweeps(config, kind) if gc)
        self.rate = min(1.0, per_frame / max(calls, 1))
        self.moves: Optional[List[dict]] = None

    def __getattr__(self, attr):
        return getattr(self.module, attr)

    def begin(self, frame: int) -> None:
        rng = np.random.default_rng([self.seed % 2 ** 63, 13, frame])
        self.draw = rng.random((1 << 14, 2))
        self.calls = 0
        self.moves = []

    def end(self) -> Optional[List[dict]]:
        moves, self.moves = self.moves, None
        return moves

    def expansion_accept(self, halo, props, tox, toy, coeff8, ccost, pcost,
                         **kwargs):
        accept = self.module.expansion_accept(halo, props, tox, toy, coeff8,
                                              ccost, pcost, **kwargs)
        n = halo.shape[0]
        if self.moves is None or halo.shape[1] - 2 != self.size or n == 0:
            return accept
        j = self.calls % len(self.draw)
        self.calls += 1
        if self.draw[j, 0] < self.rate:
            i = min(int(self.draw[j, 1] * n), n - 1)
            self.moves.append({
                "halo": halo[i].clone(), "alpha": props[i].clone(),
                "origin": torch.stack([tox[i], toy[i]]),
                "u0": ccost[i].clone(), "u1": pcost[i].clone(),
                "accept": accept[i].clone()})
        return accept


def install_capture(config: dict, kind: str, seed: int,
                    per_frame: int) -> MoveCapture:
    """Puts a :class:`MoveCapture` in the engine's place of its graph-cut
    module; :func:`remove_capture` takes it out."""
    from localexpstereo_tpu_torch.models import engine
    capture = MoveCapture(engine.mincut_cuda, config, kind, seed, per_frame)
    engine.mincut_cuda = capture
    return capture


def remove_capture(capture: MoveCapture) -> None:
    from localexpstereo_tpu_torch.models import engine
    if engine.mincut_cuda is capture:
        engine.mincut_cuda = capture.module


class Reservoir:
    """Keeps ``k`` of the items offered, each offered item equally likely,
    drawn from ``seed`` (reservoir sampling)."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = np.random.default_rng([seed % 2 ** 63, 11])
        self.items: list = []
        self.seen = 0

    def offer(self, item) -> None:
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(item)
            return
        j = int(self.rng.integers(0, self.seen))
        if j < self.k:
            self.items[j] = item
