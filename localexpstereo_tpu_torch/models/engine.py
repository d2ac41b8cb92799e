"""The local-expansion move engine, single view, cost-volume energy
(reference ``FastGCStereo`` + ``PMStereoBase``; counterpart of
``localexpstereo_tpu.models.engine``).

Schedule (``FastGCStereo.h:133-226``):

  init (random label per layer-0 cell)                 -> initCurrentFast
  pm_iterations sweeps with greedy acceptance          -> doGC = false
  iterations sweeps with graph-cut acceptance          -> doGC = true
  per sweep: layers in order, 16 colors sequentially, proposers per region
  in plan order (each proposal sees the state the previous one left).

One color set is processed as a batch: all its regions form a regular grid
at stride 4s, every proposal of the plan is evaluated for all of them with
fixed-shape tensor ops, and the accepted labels are written into the padded
state through one dense canvas. The color grid keeps regions disjoint, so
no scatter ever collides. Python loops replace the JAX package's ``scan``
over colors and its unrolled plan, and the canvas update writes the state
tensors in place (slice assignment).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import Parameters
from ..ops import mincut, mincut_cuda, pairwise, rng, windows
from ..ops import plane as plane_ops
from . import energy as energy_mod
from . import grid, proposals

#: Layer proposer sets of the reference driver (``main.cpp:300-306``).
LAYER0_PROPOSERS = ("expansion", "ransac", "random7")
COARSE_PROPOSERS = ("expansion", "expansion", "ransac")


def make_plan(proposer_names: Sequence[str], outer_iter: int,
              min_disp: float, max_disp: float) -> Tuple[Tuple, ...]:
    """Expands proposer names into the per-step plan of one sweep."""
    plan = []
    for name in proposer_names:
        if name == "expansion":
            plan.append(("expansion",))
        elif name == "ransac":
            plan.append(("ransac",))
        elif name == "random7":
            k = proposals.random_proposal_count(7, outer_iter, min_disp,
                                                max_disp)
            plan.extend(("random", i) for i in range(k))
        else:
            raise ValueError(f"unknown proposer {name}")
    return tuple(plan)


def mincut_knobs(ss: int) -> Tuple[int, int]:
    """(global-relabel round cap, push sweeps per round) of the min-cut for
    ``ss``-px move windows: the JAX package's fused-path values, used on
    every device so that CPU and GPU runs compute the same thing."""
    return 16, (64 if ss >= 256 else 16)


def _to_canvas(x: torch.Tensor, nby: int, nbx: int, s: int) -> torch.Tensor:
    """[N, 3s, 3s, ...] region tiles -> dense [nby*4s, nbx*4s, ...] canvas
    (windows at stride 4s, the s gap zero-filled)."""
    ss = 3 * s
    trail = tuple(x.shape[3:])
    x = x.reshape((nby, nbx, ss, ss) + trail)
    canvas = x.new_zeros((nby, 4 * s, nbx, 4 * s) + trail)
    canvas[:, :ss, :, :ss] = x.permute(
        (0, 2, 1, 3) + tuple(range(4, 4 + len(trail))))
    return canvas.reshape((nby * 4 * s, nbx * 4 * s) + trail)


def _canvas_slices(arr: torch.Tensor, y0: int, x0: int, h: int, w: int):
    """The [h, w] block of ``arr`` at (y0, x0), the start clamped into the
    array like ``jax.lax.dynamic_update_slice``."""
    y0 = min(max(y0, 0), arr.shape[0] - h)
    x0 = min(max(x0, 0), arr.shape[1] - w)
    return slice(y0, y0 + h), slice(x0, x0 + w)


def _write_canvas(labeling_m, cost_m, y0, x0, acc_c, cost_c, lab_c):
    """In-place masked update of the padded state through one canvas."""
    sy, sx = _canvas_slices(cost_m, y0, x0, acc_c.shape[0], acc_c.shape[1])
    cost_m[sy, sx] = torch.where(acc_c, cost_c, cost_m[sy, sx])
    labeling_m[sy, sx] = torch.where(acc_c[..., None], lab_c,
                                     labeling_m[sy, sx])


def _color_body(data: energy_mod.EnergyData, cfg: energy_mod.EnergyConfig,
                labeling_m: torch.Tensor, cost_m: torch.Tensor,
                ox: torch.Tensor, oy: torch.Tensor, rmask: torch.Tensor,
                cox: int, coy: int, dzs: Sequence[float],
                nrs: Sequence[float], key: torch.Tensor, *, unit_size: int,
                nbx: int, nby: int, plan: tuple, do_gc: bool,
                mode: int) -> None:
    """Runs the proposal plan of one (layer, color) for one view, updating
    ``labeling_m`` [Hp, Wp, 4] and ``cost_m`` [Hp, Wp] in place.

    Equivalent to ``localExpansionMovesForLayer_CPU``
    (``FastGCStereo.h:22-72``) for one disjoint set, every region of the
    set processed as one batch. ox, oy, rmask: [N] region unit origins and
    validity; (cox, coy): canvas origin in unpadded coords; dzs, nrs: the
    perturbation schedule of the "random" plan entries.
    """
    s = unit_size
    ss = 3 * s
    t4 = 4 * s
    p = cfg.pad
    cw = torch.clamp(cfg.width - ox, 1, s)
    ch = torch.clamp(cfg.height - oy, 1, s)
    tmask = energy_mod.in_image_windows(cfg, ox, oy, -s, ss) > 0
    live = tmask & rmask[:, None, None]
    # Proposal-independent per color step (the Reusable cache,
    # StereoEnergy.h:616-626): statistic windows and pairwise weights.
    stat_windows = energy_mod.dense_filter_windows(
        data, cfg, mode, ox, oy, cox + s, coy + s, nby, nbx, t4, -s, ss)
    if do_gc:
        coeff_win = windows.dense_windows_leading(
            data.coeff8[mode], coy + p, cox + p, nby, nbx, t4,
            ss).contiguous()                              # [N, 8, S, S]
        tox = (ox - s).to(torch.float32)
        toy = (oy - s).to(torch.float32)
        rounds, sweeps = mincut_knobs(ss)

    for idx, step in enumerate(plan):
        k = rng.fold_in(key, idx)
        cell_labels = windows.dense_windows(labeling_m, coy + p + s,
                                            cox + p + s, nby, nbx, t4, s)
        if step[0] == "expansion":
            props = proposals.expansion(k, cell_labels, ox, oy, cw, ch)
        elif step[0] == "ransac":
            props = proposals.ransac(k, cell_labels, ox, oy, cw, ch)
        else:
            di = step[1]
            props = proposals.random_perturbation(
                k, cell_labels, ox, oy, cw, ch, dzs[di], nrs[di],
                cfg.min_disp, cfg.max_disp, cfg.max_vdisp)
        props = props.contiguous()

        pcost = energy_mod.unary_windows(data, cfg, mode, props, ox, oy, -s,
                                         ss, stat_windows)
        ccost = windows.dense_windows(cost_m, coy + p, cox + p, nby, nbx,
                                      t4, ss).contiguous()
        if do_gc:
            halo = windows.dense_windows(labeling_m, coy + p - 1,
                                         cox + p - 1, nby, nbx, t4,
                                         ss + 2).contiguous()
            accept = mincut_cuda.expansion_accept(
                halo, props, tox, toy, coeff_win, ccost, pcost,
                lam=cfg.params.lambda_, tau=cfg.params.th_smooth,
                max_global_rounds=rounds, sweeps_per_round=sweeps)
        else:
            accept = mincut.greedy_accept(ccost, pcost)
        accept = accept & live

        lab_tiles = props[:, None, None, :].expand(props.shape[0], ss, ss, 4)
        _write_canvas(labeling_m, cost_m, coy + p, cox + p,
                      _to_canvas(accept, nby, nbx, s),
                      _to_canvas(pcost, nby, nbx, s),
                      _to_canvas(lab_tiles, nby, nbx, s))


def layer_sweep(data, cfg, labeling_m, cost_m, layer: grid.Layer, li: int,
                plan: tuple, dzs, nrs, key: torch.Tensor, *, do_gc: bool,
                mode: int) -> None:
    """All color steps of one layer, in the reference's order j = 0..15
    (``FastGCStereo.h:26``); updates the state in place."""
    dev = labeling_m.device
    for ci, (i0, j0) in enumerate(layer.colors):
        ox, oy, rmask = layer.color_regions(i0, j0)
        cox, coy = layer.canvas_origin(i0, j0)
        _color_body(data, cfg, labeling_m, cost_m,
                    torch.as_tensor(ox, dtype=torch.int64, device=dev),
                    torch.as_tensor(oy, dtype=torch.int64, device=dev),
                    torch.as_tensor(rmask, device=dev), cox, coy, dzs, nrs,
                    rng.fold_in(key, li * 100 + ci),
                    unit_size=layer.unit_size, nbx=layer.nbx, nby=layer.nby,
                    plan=plan, do_gc=do_gc, mode=mode)


def _init_canvas(x: torch.Tensor, hb: int, wb: int, s: int) -> torch.Tensor:
    trail = tuple(x.shape[3:])
    x = x.reshape((hb, wb, s, s) + trail)
    x = x.permute((0, 2, 1, 3) + tuple(range(4, 4 + len(trail))))
    return x.reshape((hb * s, wb * s) + trail)


def init_step(data: energy_mod.EnergyData, cfg: energy_mod.EnergyConfig,
              key: torch.Tensor, *, unit_size: int, mode: int):
    """Random per-cell initialization (``initCurrentFast``,
    ``FastGCStereo.h:94-115``): one random label at a random pixel of each
    layer-0 cell, assigned cell-wide, its unary evaluated on the cell.
    Returns the padded (labeling_m [Hp, Wp, 4], cost_m [Hp, Wp])."""
    s = unit_size
    p = cfg.pad
    dev = data.coeff8.device
    wb = -(-cfg.width // s)
    hb = -(-cfg.height // s)
    jj = torch.arange(wb, device=dev).repeat(hb)
    ii = torch.arange(hb, device=dev).repeat_interleave(wb)
    ox = jj * s
    oy = ii * s
    cw = torch.clamp(cfg.width - ox, 1, s)
    ch = torch.clamp(cfg.height - oy, 1, s)

    kp, kl = rng.split(key)
    xx, yy = proposals._cell_pixel(kp, ox, oy, cw, ch)
    labels = plane_ops.random_label(kl, (ox + xx).to(torch.float32),
                                    (oy + yy).to(torch.float32),
                                    cfg.min_disp, cfg.max_disp,
                                    cfg.max_vdisp)
    stat_windows = energy_mod.dense_filter_windows(
        data, cfg, mode, ox, oy, 0, 0, hb, wb, s, 0, s)
    cost = energy_mod.unary_windows(data, cfg, mode, labels, ox, oy, 0, s,
                                    stat_windows)
    mask = energy_mod.in_image_windows(cfg, ox, oy, 0, s) > 0

    n = hb * wb
    labeling_m = torch.zeros((cfg.height + 2 * p, cfg.width + 2 * p, 4),
                             dtype=torch.float32, device=dev)
    cost_m = torch.zeros(labeling_m.shape[:2], dtype=torch.float32,
                         device=dev)
    lab_tiles = labels[:, None, None, :].expand(n, s, s, 4)
    _write_canvas(labeling_m, cost_m, p, p, _init_canvas(mask, hb, wb, s),
                  _init_canvas(cost, hb, wb, s),
                  _init_canvas(lab_tiles, hb, wb, s))
    return labeling_m, cost_m


def energy_audit(data: energy_mod.EnergyData, cfg: energy_mod.EnergyConfig,
                 labeling_m: torch.Tensor, cost_m: torch.Tensor, mode: int):
    """(total, data, smooth) energy of a view (``Evaluator.h:119-121``)."""
    p = cfg.pad
    lab = labeling_m[p:p + cfg.height, p:p + cfg.width]
    cost = cost_m[p:p + cfg.height, p:p + cfg.width]
    coeffs = data.coeff8[mode, :, p:p + cfg.height, p:p + cfg.width]
    sc = pairwise.smoothness_cost(lab, coeffs, cfg.params.lambda_,
                                  cfg.params.th_smooth)
    dc = torch.sum(cost)
    return dc + sc, dc, sc


class LocalExpansionSolver:
    """Host-side orchestration (the reference's ``FastGCStereo`` object)
    for one view of a cost-volume (V3) problem.

    ``device`` holds every tensor of :class:`energy.EnergyData` and the
    padded state; on a CUDA device the graph-cut sweeps run the
    hand-written expansion kernel, on the CPU its plain version.
    """

    def __init__(self, im0_bgr: np.ndarray, im1_bgr: np.ndarray,
                 params: Parameters, max_disp: float, vol0: np.ndarray,
                 vol1: np.ndarray, min_disp: float = 0.0,
                 max_vdisp: float = 0.0, seed: int = 0, device="cpu"):
        self.im0 = np.asarray(im0_bgr, np.float32)
        self.im1 = np.asarray(im1_bgr, np.float32)
        self.params = params
        self.max_disp = float(max_disp)
        self.min_disp = float(min_disp)
        self.max_vdisp = float(max_vdisp)
        self.vol0 = vol0
        self.vol1 = vol1
        self.seed = seed
        self.device = torch.device(device)
        self.unit_sizes: List[int] = []
        self.layer_proposers: List[Tuple[str, ...]] = []
        self.evaluator = None
        self.data: Optional[energy_mod.EnergyData] = None
        self.cfg: Optional[energy_mod.EnergyConfig] = None
        self.layers: List[grid.Layer] = []
        #: Padded (labeling_m [Hp, Wp, 4], cost_m [Hp, Wp]) of view 0.
        self._state: Optional[Tuple[torch.Tensor, torch.Tensor]] = None

    def add_layer(self, unit_size: int, proposer_names: Sequence[str]):
        """cf. ``FastGCStereo::addLayer`` (``FastGCStereo.h:88-92``)."""
        self.unit_sizes.append(int(unit_size))
        self.layer_proposers.append(tuple(proposer_names))

    def set_evaluator(self, evaluator):
        """``evaluator`` gets ``start()``, ``stop()`` and
        ``evaluate(solver, labeling_m, cost_m, mode=, index=)`` after the
        init and after every sweep."""
        self.evaluator = evaluator

    def finalize(self):
        """Builds the layers and, unless one was set, the energy."""
        h, w = self.im0.shape[:2]
        self.layers = grid.build_layers(w, h, self.unit_sizes)
        if self.data is not None:
            return
        pad = grid.required_padding(self.unit_sizes, self.params.windR)
        vol_pad = grid.required_volume_padding(
            w, h, self.unit_sizes, self.params.guided_radius)
        self.data, self.cfg = energy_mod.build_energy(
            self.im0, self.im1, self.params, self.max_disp, pad, self.vol0,
            self.vol1, self.min_disp, self.max_vdisp, vol_pad=vol_pad,
            device=self.device)

    def _sweep(self, state_m, mode: int, outer_iter: int, do_gc: bool,
               key: torch.Tensor) -> None:
        """One full sweep over all layers and colors, updating the padded
        state (labeling_m, cost_m) in place."""
        labeling_m, cost_m = state_m
        for li, layer in enumerate(self.layers):
            plan = make_plan(self.layer_proposers[li], outer_iter,
                             self.min_disp, self.max_disp)
            n_random = max(sum(1 for st in plan if st[0] == "random"), 1)
            # float32 like the reference's schedule arrays.
            dzs = np.asarray([(self.max_disp - self.min_disp)
                              * 0.5 ** (outer_iter + i + 1)
                              for i in range(n_random)], np.float32)
            nrs = np.asarray([0.5 ** (outer_iter + i)
                              for i in range(n_random)], np.float32)
            layer_sweep(self.data, self.cfg, labeling_m, cost_m, layer, li,
                        plan, dzs.tolist(), nrs.tolist(), key, do_gc=do_gc,
                        mode=mode)

    def run(self, iterations: int, view_modes: Sequence[int] = (0,),
            pm_iterations: int = 0):
        """Full optimization of view 0 (cf. ``FastGCStereo::run``). Returns
        the unpadded [H, W, 4] labeling as a tensor on the solver's device.
        """
        if tuple(view_modes) != (0,):
            raise NotImplementedError("the port solves view 0 only")
        self.finalize()
        root = rng.PRNGKey(self.seed)
        mode = 0
        self._state = init_step(self.data, self.cfg,
                                rng.fold_in(root, 1000 + mode),
                                unit_size=self.layers[0].unit_size, mode=mode)
        self._evaluate(mode, 0)
        if self.evaluator is not None:
            self.evaluator.start()
        step = 0
        for it in range(pm_iterations):
            self._sweep(self._state, mode, it, False,
                        rng.fold_in(root, 2000 + step))
            step += 1
            self._evaluate(mode, it + 1)
        for it in range(iterations):
            self._sweep(self._state, mode, it, True,
                        rng.fold_in(root, 3000 + step))
            step += 1
            self._evaluate(mode, it + 1 + pm_iterations)
        if self.evaluator is not None:
            self.evaluator.stop()
        return self._unpadded_labeling()

    def _unpadded_labeling(self):
        p = self.cfg.pad
        return self._state[0][p:p + self.cfg.height, p:p + self.cfg.width]

    def _evaluate(self, mode, index):
        if self.evaluator is not None:
            self.evaluator.evaluate(self, *self._state, mode=mode,
                                    index=index)

    def disparity_map(self) -> torch.Tensor:
        """[H, W] disparity of view 0 after :meth:`run`."""
        return plane_ops.disparity_map(self._unpadded_labeling())

