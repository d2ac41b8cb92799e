"""The local-expansion move engine, one or both views, on the cost-volume
(V3) or the image-warp (V2) energy (reference ``FastGCStereo`` +
``PMStereoBase``; counterpart of ``localexpstereo_tpu.models.engine``).

Schedule (``FastGCStereo.h:133-226``):

  init (random label per layer-0 cell)                 -> initCurrentFast
  pm_iterations sweeps with greedy acceptance          -> doGC = false
  iterations sweeps with graph-cut acceptance          -> doGC = true
  per sweep: layers in order, 16 colors sequentially, proposers per region
  in plan order (each proposal sees the state the previous one left).
  fusion (optional, ``run(fuse_with=...)``): each external labeling's
  per-pixel unary, then one 16-color fusion sweep per layer, coarsest
  first (the reference's unused ``fusionMoveBK`` hook).
  both views (``run(view_modes=(0, 1))``): each sweep on view 0, then on
  view 1; then the left-right post-process (``PMStereoBase.h:146-256``,
  :mod:`.postprocess`).

One color set is processed as a batch: all its regions form a regular grid
at stride 4s, every proposal of the plan is evaluated for all of them with
fixed-shape tensor ops, and the accepted labels are written into the padded
state through one dense canvas. The color grid keeps regions disjoint, so
no scatter ever collides. Python loops replace the JAX package's ``scan``
over colors and its unrolled plan, and the canvas update writes the state
tensors in place (slice assignment).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import Parameters
from ..ops import mincut, mincut_cuda, pairwise, rng, windows
from ..ops import plane as plane_ops
from ..utils import checkpoint
from ..utils.profiling import span
from . import energy as energy_mod
from . import grid, postprocess, proposals

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


def _slice_rows(x: torch.Tensor, m_start: int, nby: int, nbx: int,
                nby_loc: int) -> torch.Tensor:
    """Rows [m_start, m_start + nby_loc) of a row-major [nby * nbx, ...]
    region batch."""
    trail = tuple(x.shape[1:])
    x = x.reshape((nby, nbx) + trail)[m_start:m_start + nby_loc]
    return x.reshape((nby_loc * nbx,) + trail)


def _color_body(data: energy_mod.EnergyData, cfg: energy_mod.EnergyConfig,
                labeling_m: torch.Tensor, cost_m: torch.Tensor,
                ox: torch.Tensor, oy: torch.Tensor, rmask: torch.Tensor,
                cox: int, coy: int, dzs: Sequence[float],
                nrs: Sequence[float], key: torch.Tensor, *, unit_size: int,
                nbx: int, nby: int, plan: tuple, do_gc: bool,
                mode: int, nby_loc: int = 0, m_start: Optional[int] = None,
                own_rmask: Optional[torch.Tensor] = None,
                vol_row_base: Optional[int] = None,
                dshard: Optional[Tuple[int, int, int]] = None) -> None:
    """Runs the proposal plan of one (layer, color) for one view, updating
    ``labeling_m`` [Hp, Wp, 4] and ``cost_m`` [Hp, Wp] in place.

    Equivalent to ``localExpansionMovesForLayer_CPU``
    (``FastGCStereo.h:22-72``) for one disjoint set, every region of the
    set processed as one batch. ox, oy, rmask: [N] region unit origins and
    validity; (cox, coy): canvas origin in unpadded coords; dzs, nrs: the
    perturbation schedule of the "random" plan entries.

    Sharding (the JAX engine's arguments of the same names):

    - ``nby_loc`` / ``m_start`` / ``own_rmask`` / ``vol_row_base``: a
      height shard (:mod:`..parallel.volume`). Proposals are drawn for all
      ``nby`` region rows, as without sharding (the same random streams),
      but the unary, the accept and the canvas write run on region rows
      ``[m_start, m_start + nby_loc)`` only, accepting where ``own_rmask``
      ([nby_loc * nbx], the rows the rank owns) is set, with the volume's
      image row 0 at array row ``vol_row_base``. The expansion kernel
      launches the full color's plan (``plan_n``), as without sharding.
    - ``dshard``: ``(d_base, d_owned, d_total)`` of a disparity shard
      (:mod:`..parallel.dvolume`): the raw unary is merged over the ranks
      (:func:`energy.unary_windows`), and everything else runs on every
      rank alike.
    """
    s = unit_size
    ss = 3 * s
    t4 = 4 * s
    p = cfg.pad
    cw = torch.clamp(cfg.width - ox, 1, s)
    ch = torch.clamp(cfg.height - oy, 1, s)
    local = m_start is not None
    if local:
        nby_u, coy_u = nby_loc, coy + m_start * t4
        ox_u = _slice_rows(ox, m_start, nby, nbx, nby_loc)
        oy_u = _slice_rows(oy, m_start, nby, nbx, nby_loc)
        rmask_u = own_rmask
    else:
        nby_u, coy_u, ox_u, oy_u, rmask_u = nby, coy, ox, oy, rmask
    tmask = energy_mod.in_image_windows(cfg, ox_u, oy_u, -s, ss) > 0
    live = tmask & rmask_u[:, None, None]
    # Proposal-independent per color step (the Reusable cache,
    # StereoEnergy.h:616-626): statistic windows and pairwise weights. No
    # statistic windows where the fused kernel filters: it reads the
    # statistics itself.
    fsize = ss + 2 * cfg.params.guided_radius
    route = ("kernel" if energy_mod.fused_unary(cfg, data.coeff8.device,
                                                fsize) else "plain")
    stat_windows = (None if energy_mod.kernel_filters(
        cfg, data.coeff8.device, fsize) else energy_mod.dense_filter_windows(
            data, cfg, mode, ox_u, oy_u, cox + s, coy_u + s, nby_u, nbx, t4,
            -s, ss))
    if do_gc:
        coeff_win = windows.dense_windows_leading(
            data.coeff8[mode], coy_u + p, cox + p, nby_u, nbx, t4,
            ss).contiguous()                              # [N, 8, S, S]
        tox = (ox_u - s).to(torch.float32)
        toy = (oy_u - s).to(torch.float32)
        rounds, sweeps = mincut_knobs(ss)

    n_u = nby_u * nbx
    for idx, step in enumerate(plan):
        with span("proposal", kind=step[0]):
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
            if local:
                props = _slice_rows(props, m_start, nby, nbx, nby_loc)
            props = props.contiguous()

        with span("unary", route=route):
            pcost = energy_mod.unary_windows(
                data, cfg, mode, props, ox_u, oy_u, -s, ss, stat_windows,
                clamp_slabs=False, kernel=True, vol_row_base=vol_row_base,
                dshard=dshard)
            ccost = windows.dense_windows(cost_m, coy_u + p, cox + p, nby_u,
                                          nbx, t4, ss).contiguous()
        if do_gc:
            # The module attribute is looked up at the call, inside the
            # span: a caller may stand in for the kernel's module.
            with span("accept", kernel="expansion", S=ss, N=n_u):
                halo = windows.dense_windows(labeling_m, coy_u + p - 1,
                                             cox + p - 1, nby_u, nbx, t4,
                                             ss + 2).contiguous()
                accept = mincut_cuda.expansion_accept(
                    halo, props, tox, toy, coeff_win, ccost, pcost,
                    lam=cfg.params.lambda_, tau=cfg.params.th_smooth,
                    max_global_rounds=rounds, sweeps_per_round=sweeps,
                    plan_n=nby * nbx) & live
        else:
            with span("accept", kernel="greedy", S=ss, N=n_u):
                accept = mincut.greedy_accept(ccost, pcost) & live

        with span("write"):
            lab_tiles = props[:, None, None, :].expand(props.shape[0], ss,
                                                       ss, 4)
            _write_canvas(labeling_m, cost_m, coy_u + p, cox + p,
                          _to_canvas(accept, nby_u, nbx, s),
                          _to_canvas(pcost, nby_u, nbx, s),
                          _to_canvas(lab_tiles, nby_u, nbx, s))


def layer_sweep(data, cfg, labeling_m, cost_m, layer: grid.Layer, li: int,
                plan: tuple, dzs, nrs, key: torch.Tensor, *, do_gc: bool,
                mode: int, dshard: Optional[Tuple[int, int, int]] = None
                ) -> None:
    """All color steps of one layer, in the reference's order j = 0..15
    (``FastGCStereo.h:26``); updates the state in place. ``dshard``: as
    :func:`_color_body`'s."""
    dev = labeling_m.device
    for ci, (i0, j0) in enumerate(layer.colors):
        with span("color", layer=li, color=ci):
            ox, oy, rmask = layer.color_regions(i0, j0)
            cox, coy = layer.canvas_origin(i0, j0)
            _color_body(data, cfg, labeling_m, cost_m,
                        torch.as_tensor(ox, dtype=torch.int64, device=dev),
                        torch.as_tensor(oy, dtype=torch.int64, device=dev),
                        torch.as_tensor(rmask, device=dev), cox, coy, dzs,
                        nrs, rng.fold_in(key, li * 100 + ci),
                        unit_size=layer.unit_size, nbx=layer.nbx,
                        nby=layer.nby, plan=plan, do_gc=do_gc, mode=mode,
                        dshard=dshard)


def _init_canvas(x: torch.Tensor, hb: int, wb: int, s: int) -> torch.Tensor:
    trail = tuple(x.shape[3:])
    x = x.reshape((hb, wb, s, s) + trail)
    x = x.permute((0, 2, 1, 3) + tuple(range(4, 4 + len(trail))))
    return x.reshape((hb * s, wb * s) + trail)


def init_step(data: energy_mod.EnergyData, cfg: energy_mod.EnergyConfig,
              key: torch.Tensor, *, unit_size: int, mode: int,
              seed_labeling_m: Optional[torch.Tensor] = None,
              hb_loc: int = 0, m_start: Optional[int] = None,
              own_rmask: Optional[torch.Tensor] = None,
              vol_row_base: Optional[int] = None,
              dshard: Optional[Tuple[int, int, int]] = None):
    """Random per-cell initialization (``initCurrentFast``,
    ``FastGCStereo.h:94-115``): one random label at a random pixel of each
    layer-0 cell, assigned cell-wide, its unary evaluated on the cell.
    Returns the padded (labeling_m [Hp, Wp, 4], cost_m [Hp, Wp]). The
    unary runs the plain sampler on every route, as the JAX init does.

    With ``seed_labeling_m`` (a padded [Hp, Wp, 4] labeling on the
    energy's device) each cell's label is read from it at the cell's
    random pixel instead of drawn: the "cell" warm start of the serving
    path, at the cost of a random init (the reference's per-pixel warm
    evaluation, ``FastGCStereo.h:117-130``, is "very slow").

    The sharding arguments are :func:`_color_body`'s: labels are drawn for
    every cell (the same random streams), the unary runs on cell rows
    ``[m_start, m_start + hb_loc)`` only, and only the cells where
    ``own_rmask`` ([hb_loc * wb]) is set are written; the rest of the
    state is zero. Bands of cell rows so written assemble the whole init
    bit for bit (:func:`init_in_bands`)."""
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
    if seed_labeling_m is None:
        labels = plane_ops.random_label(kl, (ox + xx).to(torch.float32),
                                        (oy + yy).to(torch.float32),
                                        cfg.min_disp, cfg.max_disp,
                                        cfg.max_vdisp)
    else:
        labels = seed_labeling_m[p + oy + yy, p + ox + xx].contiguous()
    row0 = 0
    if m_start is not None:
        hb, row0 = hb_loc, m_start * s
        ox, oy, labels = (_slice_rows(x, m_start, -(-cfg.height // s), wb,
                                      hb_loc) for x in (ox, oy, labels))
        labels = labels.contiguous()
    stat_windows = energy_mod.dense_filter_windows(
        data, cfg, mode, ox, oy, 0, row0, hb, wb, s, 0, s)
    cost = energy_mod.unary_windows(data, cfg, mode, labels, ox, oy, 0, s,
                                    stat_windows, vol_row_base=vol_row_base,
                                    dshard=dshard)
    mask = energy_mod.in_image_windows(cfg, ox, oy, 0, s) > 0
    if own_rmask is not None:
        mask = mask & own_rmask[:, None, None]

    n = hb * wb
    labeling_m = torch.zeros((cfg.height + 2 * p, cfg.width + 2 * p, 4),
                             dtype=torch.float32, device=dev)
    cost_m = torch.zeros(labeling_m.shape[:2], dtype=torch.float32,
                         device=dev)
    lab_tiles = labels[:, None, None, :].expand(n, s, s, 4)
    _write_canvas(labeling_m, cost_m, p + row0, p,
                  _init_canvas(mask, hb, wb, s),
                  _init_canvas(cost, hb, wb, s),
                  _init_canvas(lab_tiles, hb, wb, s))
    return labeling_m, cost_m


def init_in_bands(data: energy_mod.EnergyData, cfg: energy_mod.EnergyConfig,
                  key: torch.Tensor, *, unit_size: int, mode: int,
                  rows: int, dshard: Optional[Tuple[int, int, int]] = None):
    """:func:`init_step` in bands of ``rows`` cell rows (the whole image in
    one band when ``rows`` covers it): each band's unary is evaluated on
    its own, which bounds the init's transient memory, and the bands'
    disjoint rows are copied into one state, equal to the one-call init
    bit for bit. ``dshard``: as :func:`_color_body`'s."""
    s = unit_size
    hb = -(-cfg.height // s)
    wb = -(-cfg.width // s)
    if rows >= hb:
        return init_step(data, cfg, key, unit_size=s, mode=mode,
                         dshard=dshard)
    p = cfg.pad
    labeling_m = cost_m = None
    for m0 in range(0, hb, rows):
        n_rows = min(rows, hb - m0)
        own = torch.ones(n_rows * wb, dtype=torch.bool,
                         device=data.coeff8.device)
        lab, cost = init_step(data, cfg, key, unit_size=s, mode=mode,
                              hb_loc=n_rows, m_start=m0, own_rmask=own,
                              dshard=dshard)
        if labeling_m is None:
            labeling_m, cost_m = lab, cost
        else:
            band = slice(p + m0 * s, p + (m0 + n_rows) * s)
            labeling_m[band] = lab[band]
            cost_m[band] = cost[band]
    return labeling_m, cost_m


def init_from_labeling(data: energy_mod.EnergyData,
                       cfg: energy_mod.EnergyConfig, labeling, mode: int):
    """Padded (labeling_m, cost_m) state of a given [H, W, 4] labeling
    (numpy or tensor), every pixel's unary evaluated under its own label:
    the warm start of ``initCurrentFast`` (``FastGCStereo.h:117-130``)."""
    h, w, p = cfg.height, cfg.width, cfg.pad
    dev = data.coeff8.device
    if not isinstance(labeling, torch.Tensor):
        labeling = np.array(labeling, np.float32)
    lab = torch.as_tensor(labeling, dtype=torch.float32, device=dev)
    if tuple(lab.shape) != (h, w, 4):
        raise ValueError(f"labeling: expected {(h, w, 4)}, got "
                         f"{tuple(lab.shape)}")
    labeling_m = torch.zeros((h + 2 * p, w + 2 * p, 4), dtype=torch.float32,
                             device=dev)
    cost_m = torch.zeros(labeling_m.shape[:2], dtype=torch.float32,
                         device=dev)
    labeling_m[p:p + h, p:p + w] = lab
    cost_m[p:p + h, p:p + w] = energy_mod.pixel_unary(data, cfg, mode, lab)
    return labeling_m, cost_m


def fusion_color_step(data: energy_mod.EnergyData,
                      cfg: energy_mod.EnergyConfig, labeling_m: torch.Tensor,
                      cost_m: torch.Tensor, ext_lab_m: torch.Tensor,
                      ext_cost_m: torch.Tensor, ox: torch.Tensor,
                      oy: torch.Tensor, rmask: torch.Tensor, cox: int,
                      coy: int, *, unit_size: int, nbx: int, nby: int,
                      mode: int) -> None:
    """One (layer, color) fusion move, updating the state in place: every
    region of the color solves a binary min-cut choosing per pixel between
    its current and the external label (``fusionMoveBK``,
    ``FastGCStereo.h:241-410``), guarded by the exact region energy
    change, as the truncated non-submodular edges make the cut
    approximate."""
    s = unit_size
    ss = 3 * s
    t4 = 4 * s
    p = cfg.pad
    tmask = energy_mod.in_image_windows(cfg, ox, oy, -s, ss) > 0
    halo0 = windows.dense_windows(labeling_m, coy + p - 1, cox + p - 1, nby,
                                  nbx, t4, ss + 2)
    halo1 = windows.dense_windows(ext_lab_m, coy + p - 1, cox + p - 1, nby,
                                  nbx, t4, ss + 2)
    ccost = windows.dense_windows(cost_m, coy + p, cox + p, nby, nbx, t4, ss)
    pcost = windows.dense_windows(ext_cost_m, coy + p, cox + p, nby, nbx, t4,
                                  ss)
    coeff_win = windows.dense_windows_leading(data.coeff8[mode], coy + p,
                                              cox + p, nby, nbx, t4, ss)
    terms = mincut_cuda.fusion_terms(halo0, halo1, (ox - s).to(torch.float32),
                                     (oy - s).to(torch.float32), coeff_win,
                                     ccost, pcost, cfg.params.lambda_,
                                     cfg.params.th_smooth)
    accept = mincut_cuda.fusion_accept(*terms)
    delta = mincut.fusion_move_energy_delta(accept, *terms)
    accept = accept & (delta <= 0.0)[:, None, None] & tmask \
        & rmask[:, None, None]
    _write_canvas(labeling_m, cost_m, coy + p, cox + p,
                  _to_canvas(accept, nby, nbx, s),
                  _to_canvas(pcost, nby, nbx, s),
                  _to_canvas(halo1[:, 1:-1, 1:-1], nby, nbx, s))


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


def _image(image):
    """An image as float32: a tensor stays on its device."""
    if isinstance(image, torch.Tensor):
        return image.to(torch.float32)
    return np.asarray(image, np.float32)


class LocalExpansionSolver:
    """Host-side orchestration (the reference's ``FastGCStereo`` object)
    for one or both views of a stereo pair: with cost volumes ``vol0`` and
    ``vol1`` on the V3 energy, without them on the V2 image-warp energy
    (``max_vdisp`` > 0 lets planes shift the other view vertically too).

    ``device`` holds every tensor of :class:`energy.EnergyData` and the
    padded state: the card (the default; building the energy raises
    without one) or, when asked, the CPU. On a CUDA device the graph-cut
    sweeps run the hand-written expansion kernel and the fusion sweeps the
    min-cut kernel, on the CPU their plain versions.
    The V3 sweeps' unary runs the fused sampling + guided-filter kernel
    (under the bilateral filter it samples, and the filter runs after it;
    :func:`energy.fused_unary`): on ``unary_backend`` "auto" on a CUDA
    device wherever the kernel has a launch plan for the window, else the
    plain sampler (the JAX engine's, on the CPU); on "dma" always (its
    plain version on the CPU). The init's unary runs the plain sampler on
    either; the V2 energy has the warp sampler on either.
    ``interp``: the V3 volume's d-interpolation, 0 nearest, 1 linear (the
    default), 2 quadratic; methods 0 and 2 run the plain method sampler,
    and as the kernel samples linearly only, "dma" with them raises.
    ``vol_dtype``: "uint8", "bfloat16" or "float32" volume storage.
    ``stats_backend``: the uint8 volume range of :func:`energy.build_energy`
    (which builds on ``device`` either way), "host" (data-dependent, the
    JAX package's default) or "device" (static; needed by
    :meth:`update_frame`). Images and volumes may be numpy arrays or
    tensors, on the card already.
    """

    def __init__(self, im0_bgr, im1_bgr, params: Parameters,
                 max_disp: float, vol0=None, vol1=None,
                 min_disp: float = 0.0, max_vdisp: float = 0.0,
                 seed: int = 0, device="cuda", unary_backend: str = "auto",
                 vol_dtype: str = "uint8", stats_backend: str = "host",
                 interp: int = 1):
        if unary_backend not in ("auto", "dma"):
            raise ValueError(f"unary_backend {unary_backend!r}: the port "
                             f"has 'auto' and 'dma'")
        if interp not in (0, 1, 2):
            raise ValueError(f"interp {interp!r}: 0, 1 or 2")
        if unary_backend == "dma" and interp != 1:
            raise ValueError(f"unary_backend 'dma' samples linearly only: "
                             f"interp {interp} needs 'auto'")
        self.im0 = _image(im0_bgr)
        self.im1 = _image(im1_bgr)
        self.params = params
        self.max_disp = float(max_disp)
        self.min_disp = float(min_disp)
        self.max_vdisp = float(max_vdisp)
        self.vol0 = vol0
        self.vol1 = vol1
        self.seed = seed
        self.device = torch.device(device)
        self.unary_backend = unary_backend
        self.vol_dtype = vol_dtype
        self.stats_backend = stats_backend
        self.interp = interp
        self.unit_sizes: List[int] = []
        self.layer_proposers: List[Tuple[str, ...]] = []
        self.evaluator = None
        self.data: Optional[energy_mod.EnergyData] = None
        self.cfg: Optional[energy_mod.EnergyConfig] = None
        self.layers: List[grid.Layer] = []
        #: Padded (labeling_m [Hp, Wp, 4], cost_m [Hp, Wp]) by view.
        self._state: Optional[Dict[int, Tuple[torch.Tensor,
                                              torch.Tensor]]] = None

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
        """Builds the layers and, unless one was set, the energy; sets the
        energy's unary route and d-interpolation to the solver's."""
        h, w = self.im0.shape[:2]
        self.layers = grid.build_layers(w, h, self.unit_sizes)
        if self.data is None:
            pad = grid.required_padding(self.unit_sizes, self.params.windR)
            with span("build"):
                self.data, self.cfg = self._build_energy(
                    self.im0, self.im1, self.vol0, self.vol1, pad)
        self.cfg = dataclasses.replace(self.cfg,
                                       unary_backend=self.unary_backend,
                                       interp=self.interp)

    def _build_energy(self, im0, im1, vol0, vol1, pad: int):
        h, w = im0.shape[:2]
        vol_pad = grid.required_volume_padding(w, h, self.unit_sizes,
                                               self.params.guided_radius)
        return energy_mod.build_energy(
            im0, im1, self.params, self.max_disp, pad, vol0, vol1,
            self.min_disp, self.max_vdisp, vol_pad=vol_pad,
            device=self.device, vol_dtype=self.vol_dtype,
            stats_backend=self.stats_backend, interp=self.interp)

    def update_frame(self, im0_bgr, im1_bgr, vol0=None, vol1=None,
                     seed: Optional[int] = None):
        """Swaps a new frame of the same geometry into a finalized solver
        (the serving path's per-frame update; JAX ``update_frame``): only
        :attr:`data` is built again, on the device, and the configuration
        must come out unchanged (``stats_backend="device"`` is required:
        the "host" uint8 range depends on the volume). The layers
        stay. Images and volumes may live on the card already; the image
        and volume attributes follow the frame. ``seed``, when given, is
        the next :meth:`run`'s."""
        if self.data is None:
            raise RuntimeError("update_frame needs finalize() first")
        if self.stats_backend != "device":
            raise ValueError("update_frame needs stats_backend='device' "
                             "(a frame-independent configuration)")
        if (int(im0_bgr.shape[0]), int(im0_bgr.shape[1])) != \
                (self.cfg.height, self.cfg.width):
            raise ValueError("update_frame: the frame geometry changed")
        im0, im1 = _image(im0_bgr), _image(im1_bgr)
        with span("build"):
            data, cfg = self._build_energy(im0, im1, vol0, vol1,
                                           self.cfg.pad)
        if (data.vol is not None and self.data.vol is not None
                and data.vol.shape != self.data.vol.shape):
            raise ValueError("update_frame: the frame geometry changed "
                             "(the volume's disparities)")
        if dataclasses.replace(cfg, unary_backend=self.unary_backend) \
                != self.cfg:
            raise ValueError("update_frame: the frame changed the energy's "
                             "configuration")
        self.data = data
        self.im0, self.im1 = im0, im1
        self.vol0, self.vol1 = vol0, vol1
        if seed is not None:
            self.seed = seed

    def _layer_inputs(self, li: int, outer_iter: int):
        """(plan, dzs, nrs) of layer ``li`` in sweep ``outer_iter``: the
        proposal plan and the perturbation schedule of its "random"
        entries (float32 like the reference's schedule arrays)."""
        plan = make_plan(self.layer_proposers[li], outer_iter,
                         self.min_disp, self.max_disp)
        n_random = max(sum(1 for st in plan if st[0] == "random"), 1)
        dzs = np.asarray([(self.max_disp - self.min_disp)
                          * 0.5 ** (outer_iter + i + 1)
                          for i in range(n_random)], np.float32)
        nrs = np.asarray([0.5 ** (outer_iter + i)
                          for i in range(n_random)], np.float32)
        return plan, dzs.tolist(), nrs.tolist()

    def _sweep(self, state_m, mode: int, outer_iter: int, do_gc: bool,
               key: torch.Tensor) -> None:
        """One full sweep over all layers and colors, updating the padded
        state (labeling_m, cost_m) in place (a sharded solver overrides
        it)."""
        labeling_m, cost_m = state_m
        for li, layer in enumerate(self.layers):
            plan, dzs, nrs = self._layer_inputs(li, outer_iter)
            layer_sweep(self.data, self.cfg, labeling_m, cost_m, layer, li,
                        plan, dzs, nrs, key, do_gc=do_gc, mode=mode)

    def _init_state(self, key: torch.Tensor, mode: int):
        """The random init of view ``mode`` under ``key`` (a sharded solver
        overrides it)."""
        return init_step(self.data, self.cfg, key,
                         unit_size=self.layers[0].unit_size, mode=mode)

    def run(self, iterations: int, view_modes: Sequence[int] = (0,),
            pm_iterations: int = 0, fuse_with=None, init_labeling=None,
            init_mode: str = "exact", checkpoint_path: Optional[str] = None,
            checkpoint_every: int = 0, resume_from: Optional[str] = None):
        """Full optimization (cf. ``FastGCStereo::run``) of view 0, or of
        both views with ``view_modes=(0, 1)`` (the JAX engine's default;
        the port's is view 0 alone). Returns ``(final, raw)``, unpadded
        [H, W, 4] labelings of view 0 on the solver's device: ``raw`` before
        the dual-view post-process, ``final`` after it; a single-view run
        returns the same tensor twice.

        The views interleave as in the JAX engine: each sweep runs on view
        0, then view 1, one key step a (sweep, view), and a dual run saves
        the evaluator's consistency images after each sweep pair, where
        the evaluator has ``save_consistency``.

        ``init_labeling``: an [H, W, 4] labeling (numpy or tensor) to start
        every view from instead of the random init (the reference's
        non-empty ``initCurrentFast``). ``init_mode`` "exact" evaluates
        every pixel's unary under its own label (:func:`init_from_labeling`,
        the reference's semantics); "cell" gives each layer-0 cell the
        labeling's label at the cell's random pixel (:func:`init_step` with
        a seed labeling, under the random init's key): one init's cost, the
        serving path's warm start.

        ``checkpoint_path`` / ``checkpoint_every``: after every
        ``checkpoint_every`` completed sweeps (greedy and graph-cut
        counted together) the views' padded state, the seed and the sweep
        counters go to ``checkpoint_path`` (:mod:`..utils.checkpoint`, the
        JAX package's format). ``resume_from``: a checkpoint to continue
        from: its state replaces the init, the completed sweeps are
        skipped, and the key counter restarts where it stood, so the
        resumed run ends where an uninterrupted one does, bit for bit.

        ``fuse_with``: external labelings (numpy or tensors, applied to view
        0) or ``{mode: labeling}`` dicts (applied to each view they name),
        fused into the solution after the graph-cut sweeps, each at every
        layer, coarsest first: one per-pixel unary evaluation of the
        labeling, one 16-color fusion sweep per layer. A single-view run
        then logs one more evaluator row, at index ``iterations + 1 +
        pm_iterations``; its energy ends no higher than the plain solve's.

        A dual run ends with :func:`postprocess.post_process` at threshold
        1.5, writes both labelings back into the state and logs both views
        at index ``iterations + 1 + pm_iterations``.
        """
        with span("solve"):
            modes = tuple(view_modes)
            if modes not in ((0,), (0, 1)):
                raise ValueError(f"view_modes {view_modes!r}: (0,) or (0, 1)")
            if init_mode not in ("exact", "cell"):
                raise ValueError(f"init_mode {init_mode!r}: 'exact' or 'cell'")
            self.finalize()
            root = rng.PRNGKey(self.seed)
            self._state = {}
            pm_done = gc_done = 0
            if resume_from is not None:
                ck = checkpoint.load_checkpoint(resume_from)
                if ck.pad != self.cfg.pad:
                    raise ValueError(f"checkpoint pad {ck.pad}: the "
                                     f"solver's is {self.cfg.pad}")
                for mode in modes:
                    self._state[mode] = energy_mod.state_from_numpy(
                        ck.labeling[mode], ck.cost[mode], self.device)
                pm_done, gc_done = ck.pm_iterations_done, ck.iterations_done
            else:
                for mode in modes:
                    with span("init"):
                        self._state[mode] = self._init_view(
                            root, mode, init_labeling, init_mode)
                    self._evaluate(mode, 0)
            if self.evaluator is not None:
                self.evaluator.start()
            step = len(modes) * (pm_done + gc_done)
            for do_gc, base, done, sweeps, first in (
                    (False, 2000, pm_done, pm_iterations, 1),
                    (True, 3000, gc_done, iterations, 1 + pm_iterations)):
                for it in range(done, sweeps):
                    for mode in modes:
                        with span("sweep",
                                  kind="graph_cut" if do_gc else "greedy",
                                  index=it + first, view=mode):
                            self._sweep(self._state[mode], mode, it, do_gc,
                                        rng.fold_in(root, base + step))
                        step += 1
                        self._evaluate(mode, it + first)
                    self._save_consistency(it + first)
                    # it + first sweeps completed, greedy and graph-cut.
                    if (checkpoint_path and checkpoint_every
                            and (it + first) % checkpoint_every == 0):
                        self._checkpoint(checkpoint_path,
                                         *((pm_iterations, it + 1) if do_gc
                                           else (it + 1, 0)))
            last = iterations + 1 + pm_iterations
            if fuse_with:
                coarsest_first = tuple(reversed(range(len(self.layers))))
                for ext in fuse_with:
                    for mode in modes:
                        lab = (ext.get(mode) if isinstance(ext, dict)
                               else ext if mode == 0 else None)
                        if lab is None:
                            continue
                        self._fuse_layers(*init_from_labeling(
                            self.data, self.cfg, lab, mode), mode,
                            coarsest_first)
                if len(modes) == 1:
                    self._evaluate(0, last)
            final = raw = self._unpadded_labeling(0)
            if len(modes) == 2:
                raw = raw.clone()
                labs = postprocess.post_process(
                    raw, self._unpadded_labeling(1), self.im0, self.im1,
                    self.params, threshold=1.5)
                for mode, lab in zip(modes, labs):
                    # As the JAX engine's _set_unpadded_labeling: the labeling
                    # is replaced and the pre-process unary costs are kept, so
                    # the last row's energy is the old data sum plus the
                    # smoothness of the post-processed labeling.
                    self._unpadded_labeling(mode).copy_(lab)
                final = labs[0]
                for mode in modes:
                    self._evaluate(mode, last)
            if self.evaluator is not None:
                self.evaluator.stop()
            return final, raw

    def fuse(self, labeling, mode: int = 0, layer_index: int = 0):
        """Fuses an external [H, W, 4] labeling into view ``mode`` of a
        completed :meth:`run` with one 16-color fusion sweep at one layer
        (the reference's unused ``fusionMoveBK`` hook,
        ``FastGCStereo.h:241-410``): each region's min-cut chooses per
        pixel between its current and external label, guarded to be
        energy-non-increasing. Returns the fused unpadded labeling."""
        if self._state is None:
            raise RuntimeError("fuse() needs a completed run()")
        self._fuse_layers(*init_from_labeling(self.data, self.cfg, labeling,
                                              mode),
                          mode, (layer_index,))
        return self._unpadded_labeling(mode)

    def _fuse_layers(self, ext_lab_m, ext_cost_m, mode: int, layer_indices):
        """Fusion sweeps of the state against an evaluated external state
        (from :func:`init_from_labeling`) at each listed layer."""
        labeling_m, cost_m = self._state[mode]
        dev = labeling_m.device
        for li in layer_indices:
            layer = self.layers[li]
            for i0, j0 in layer.colors:
                ox, oy, rmask = layer.color_regions(i0, j0)
                cox, coy = layer.canvas_origin(i0, j0)
                fusion_color_step(
                    self.data, self.cfg, labeling_m, cost_m, ext_lab_m,
                    ext_cost_m,
                    torch.as_tensor(ox, dtype=torch.int64, device=dev),
                    torch.as_tensor(oy, dtype=torch.int64, device=dev),
                    torch.as_tensor(rmask, device=dev), cox, coy,
                    unit_size=layer.unit_size, nbx=layer.nbx, nby=layer.nby,
                    mode=mode)

    def _init_view(self, root: torch.Tensor, mode: int, init_labeling,
                   init_mode: str):
        """View ``mode``'s padded state at the start of :meth:`run`."""
        key = rng.fold_in(root, 1000 + mode)
        if init_labeling is None:
            return self._init_state(key, mode)
        if init_mode == "cell":
            return init_step(self.data, self.cfg, key,
                             unit_size=self.layers[0].unit_size, mode=mode,
                             seed_labeling_m=self._padded_labeling(
                                 init_labeling))
        return init_from_labeling(self.data, self.cfg, init_labeling, mode)

    def _padded_labeling(self, labeling) -> torch.Tensor:
        """An [H, W, 4] labeling in a zero [Hp, Wp, 4] canvas."""
        h, w, p = self.cfg.height, self.cfg.width, self.cfg.pad
        lab = torch.as_tensor(labeling, dtype=torch.float32,
                              device=self.device)
        out = torch.zeros((h + 2 * p, w + 2 * p, 4), dtype=torch.float32,
                          device=self.device)
        out[p:p + h, p:p + w] = lab
        return out

    def _checkpoint(self, path: str, pm_done: int, gc_done: int) -> None:
        checkpoint.save_checkpoint(
            path, {m: tuple(x.cpu().numpy() for x in st)
                   for m, st in self._state.items()},
            self.seed, pm_done, gc_done, self.cfg.pad)

    def _unpadded_labeling(self, mode: int = 0) -> torch.Tensor:
        """View ``mode``'s [H, W, 4] labeling, a view into the state."""
        p = self.cfg.pad
        return self._state[mode][0][p:p + self.cfg.height,
                                    p:p + self.cfg.width]

    def _evaluate(self, mode, index):
        if self.evaluator is not None:
            self.evaluator.evaluate(self, *self._state[mode], mode=mode,
                                    index=index)

    def _save_consistency(self, index):
        save = getattr(self.evaluator, "save_consistency", None)
        if save is not None and len(self._state) == 2:
            save(self, self._state, index)

    def disparity_map(self, mode: int = 0) -> torch.Tensor:
        """[H, W] disparity of view ``mode`` after :meth:`run`."""
        return plane_ops.disparity_map(self._unpadded_labeling(mode))
