"""The solver over a cost volume sharded along image height (counterpart
of ``localexpstereo_tpu.parallel.volume``; BASELINE config 4).

One process per rank (:mod:`.collectives`). Rank ``i`` holds the padded
volume rows of image rows ``[i*hq - halo, (i+1)*hq + halo)`` (``hq =
ceil(H / n)``, ``halo = 8 * s_max + R``: the farthest a window of any layer
reads beyond the rows it owns) that the padded volume has, read-only, so
no window needs a runtime halo exchange. (The JAX shards have the fixed
``hq + 2 halo`` rows ``shard_map`` needs, zero beyond the volume; where
the halo exceeds the image, as at the main path's geometry, a JAX shard is
larger than the whole volume, and a rank here holds the whole volume.) The whole solver (init, greedy and graph-cut sweeps, both
views, the post-process) runs on it and equals the single-device engine
bit for bit:

- proposals are drawn for every region of a color from the replicated
  state, as without sharding (the same random streams); the unary, the
  accept and the canvas write run on the region rows the rank owns
  (``engine._color_body``'s sharding arguments), and the expansion kernel
  launches the whole color's plan (``plan_n``);
- after every color step the ranks' changes are merged
  (:func:`_merge_state`): the 16-color geometry gives every changed pixel
  one writer, so one SUM of the changed pixels' bit patterns rebuilds the
  replicated state exactly.

Communication per color step: one all-reduce of 6 int32 planes over the
color's canvas (the change count, the cost and the 4 label planes).
"""
from __future__ import annotations

from typing import Optional

import torch

from ..config import Parameters
from ..models import energy as energy_mod
from ..models import engine as engine_mod
from ..models import grid
from ..ops import rng
from . import collectives


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int32)


def _merge_state(old_lab: torch.Tensor, old_cost: torch.Tensor,
                 new_lab: torch.Tensor, new_cost: torch.Tensor):
    """The replicated (labeling, cost) rebuilt from every rank's update of
    the same (old_lab, old_cost): a pixel whose bits a rank changed takes
    that rank's value. Exact while every changed pixel has one writer."""
    changed = ((_bits(new_cost) != _bits(old_cost))
               | (_bits(new_lab) != _bits(old_lab)).any(-1))
    planes = torch.cat([changed[None].to(torch.int32),
                        torch.where(changed, _bits(new_cost), 0)[None],
                        torch.where(changed[..., None], _bits(new_lab),
                                    0).permute(2, 0, 1)])
    planes = collectives.psum(planes)
    taken = planes[0] > 0
    cost = torch.where(taken, planes[1].view(torch.float32), old_cost)
    lab = torch.where(taken[..., None],
                      planes[2:].permute(1, 2, 0).contiguous().view(
                          torch.float32), old_lab)
    return lab, cost


def shard_rows(rank: int, hq: int, halo: int, vol_pad: int,
               hp: int) -> range:
    """The padded volume rows rank ``rank`` holds (of ``hp``)."""
    start = rank * hq - halo + vol_pad
    return range(max(start, 0), min(start + hq + 2 * halo, hp))


def build_vol_shards(vol: torch.Tensor, rank: int, hq: int, halo: int,
                     vol_pad: int) -> torch.Tensor:
    """Rank ``rank``'s shard [V, D, rows, Wp] of a padded [V, D, Hp, Wp]
    volume (:func:`shard_rows`; its storage dtype kept). The solver builds
    the same part straight from the unpadded volumes
    (:func:`row_window`)."""
    rows = shard_rows(rank, hq, halo, vol_pad, vol.shape[2])
    return vol[:, :, rows.start:rows.stop].clone()


def row_window(rows: range) -> energy_mod.VolumeWindow:
    """The padded volume rows ``rows``, for
    ``energy.build_energy(vol_transform=)``."""
    return energy_mod.VolumeWindow(1, rows.start, len(rows))


def sharded_init_step(data, cfg, key, *, unit_size: int, mode: int, hq: int,
                      hb_loc: int, vol_row_base: int, rank: int):
    """:func:`engine.init_step` on the rank's rows (the same labels; each
    rank evaluates the unary of the cell rows it owns), merged."""
    s = unit_size
    hb = -(-cfg.height // s)
    wb = -(-cfg.width // s)
    m_start = min(max((rank * hq) // s, 0), max(hb - hb_loc, 0))
    dev = data.coeff8.device
    oy = (m_start + torch.arange(hb_loc, device=dev)).repeat_interleave(wb) * s
    own = (oy >= rank * hq) & (oy < (rank + 1) * hq)
    lab, cost = engine_mod.init_step(
        data, cfg, key, unit_size=s, mode=mode, hb_loc=hb_loc,
        m_start=m_start, own_rmask=own, vol_row_base=vol_row_base)
    return _merge_state(torch.zeros_like(lab), torch.zeros_like(cost), lab,
                        cost)


def sharded_layer_sweep(data, cfg, labeling_m, cost_m, layer: grid.Layer,
                        li: int, plan: tuple, dzs, nrs, key, *, do_gc: bool,
                        mode: int, hq: int, nby_loc: int, vol_row_base: int,
                        rank: int) -> None:
    """:func:`engine.layer_sweep` on the rank's rows: each color step on
    the region rows it owns, then the merge; updates the state in place."""
    s = layer.unit_size
    t4 = 4 * s
    p = cfg.pad
    dev = labeling_m.device
    for ci, (i0, j0) in enumerate(layer.colors):
        ox, oy, rmask = layer.color_regions(i0, j0)
        cox, coy = layer.canvas_origin(i0, j0)
        m_start = min(max((rank * hq - (coy + s)) // t4, 0),
                      max(layer.nby - nby_loc, 0))
        oy_l = engine_mod._slice_rows(torch.as_tensor(oy), m_start,
                                      layer.nby, layer.nbx, nby_loc)
        rm_l = engine_mod._slice_rows(torch.as_tensor(rmask), m_start,
                                      layer.nby, layer.nbx, nby_loc)
        own = rm_l & (oy_l >= rank * hq) & (oy_l < (rank + 1) * hq)
        sy, sx = engine_mod._canvas_slices(cost_m, coy + p, cox + p,
                                           layer.nby * t4, layer.nbx * t4)
        old_lab, old_cost = labeling_m[sy, sx].clone(), cost_m[sy, sx].clone()
        engine_mod._color_body(
            data, cfg, labeling_m, cost_m,
            torch.as_tensor(ox, dtype=torch.int64, device=dev),
            torch.as_tensor(oy, dtype=torch.int64, device=dev),
            torch.as_tensor(rmask, device=dev), cox, coy, dzs, nrs,
            rng.fold_in(key, li * 100 + ci), unit_size=s,
            nbx=layer.nbx, nby=layer.nby, plan=plan, do_gc=do_gc, mode=mode,
            nby_loc=nby_loc, m_start=m_start, own_rmask=own.to(dev),
            vol_row_base=vol_row_base)
        labeling_m[sy, sx], cost_m[sy, sx] = _merge_state(
            old_lab, old_cost, labeling_m[sy, sx], cost_m[sy, sx])


class ShardedSolver(engine_mod.LocalExpansionSolver):
    """What the sharded solvers share: the rank and the group's size, run
    on every rank alike; the evaluator's files and checkpoints written by
    rank 0 only. The random init and the sweeps run; the warm starts and
    the fusion move, which read the volume by other paths, raise."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.rank = collectives.rank()
        self.n_dev = collectives.world()

    def set_evaluator(self, evaluator):
        if self.rank == 0:
            super().set_evaluator(evaluator)

    def _checkpoint(self, path: str, pm_done: int, gc_done: int) -> None:
        if self.rank == 0:
            super()._checkpoint(path, pm_done, gc_done)

    def run(self, iterations: int, view_modes=(0,), pm_iterations: int = 0,
            fuse_with=None, init_labeling=None, **kwargs):
        if fuse_with or init_labeling is not None:
            raise ValueError(f"{type(self).__name__}: the random init and "
                             f"the sweeps only (no fuse_with, no "
                             f"init_labeling)")
        return super().run(iterations, view_modes=view_modes,
                           pm_iterations=pm_iterations, **kwargs)

    def _window(self, vol_pad: int) -> energy_mod.VolumeWindow:
        raise NotImplementedError

    def _build_energy(self, im0, im1, vol0, vol1, pad: int):
        if vol0 is None:
            raise ValueError(f"{type(self).__name__}: the cost-volume "
                             f"energy only")
        h, w = im0.shape[:2]
        vol_pad = grid.required_volume_padding(w, h, self.unit_sizes,
                                               self.params.guided_radius)
        return energy_mod.build_energy(
            im0, im1, self.params, self.max_disp, pad, vol0, vol1,
            self.min_disp, self.max_vdisp, vol_pad=vol_pad,
            device=self.device, vol_dtype=self.vol_dtype,
            stats_backend=self.stats_backend, interp=self.interp,
            vol_transform=self._window(vol_pad))


class ShardedVolumeSolver(ShardedSolver):
    """:class:`engine.LocalExpansionSolver` on a volume sharded along image
    height, one rank of it (the JAX class's arguments, the rank's
    ``device`` in place of the mesh). Every rank passes the whole pair
    (``vol0``, ``vol1``: arrays or tensors that slice; only the rank's rows
    are read) and calls the same methods; :meth:`run` returns the same
    labelings on every rank, equal to the single-device solve's bit for
    bit."""

    def __init__(self, im0_bgr, im1_bgr, params: Parameters,
                 max_disp: float, vol0, vol1, device="cuda",
                 min_disp: float = 0.0, seed: int = 0, interp: int = 1,
                 vol_dtype: str = "uint8"):
        super().__init__(im0_bgr, im1_bgr, params, max_disp, vol0=vol0,
                         vol1=vol1, min_disp=min_disp, seed=seed,
                         device=device, vol_dtype=vol_dtype, interp=interp)
        self.hq: Optional[int] = None
        self.halo: Optional[int] = None
        #: The local volume's row of image row 0.
        self.vol_row_base: Optional[int] = None

    def _window(self, vol_pad: int) -> energy_mod.VolumeWindow:
        h = int(self.im0.shape[0])
        self.hq = -(-h // self.n_dev)
        # The farthest reach of any layer's windows beyond the owned rows:
        # coarse layers read ~6s + R; 8s + R leaves room for the clamped
        # region band at the group's edges.
        self.halo = 8 * max(self.unit_sizes) + self.params.guided_radius
        rows = shard_rows(self.rank, self.hq, self.halo, vol_pad,
                          h + 2 * vol_pad)
        self.vol_row_base = vol_pad - rows.start
        return row_window(rows)

    def _init_state(self, key, mode: int):
        s = self.layers[0].unit_size
        hb = -(-self.cfg.height // s)
        return sharded_init_step(
            self.data, self.cfg, key, unit_size=s, mode=mode, hq=self.hq,
            hb_loc=min(hb, -(-self.hq // s) + 1),
            vol_row_base=self.vol_row_base, rank=self.rank)

    def _sweep(self, state_m, mode: int, outer_iter: int, do_gc: bool,
               key) -> None:
        labeling_m, cost_m = state_m
        for li, layer in enumerate(self.layers):
            plan, dzs, nrs = self._layer_inputs(li, outer_iter)
            nby_loc = min(layer.nby, -(-self.hq // (4 * layer.unit_size)) + 1)
            sharded_layer_sweep(
                self.data, self.cfg, labeling_m, cost_m, layer, li, plan,
                dzs, nrs, key, do_gc=do_gc, mode=mode, hq=self.hq,
                nby_loc=nby_loc, vol_row_base=self.vol_row_base,
                rank=self.rank)

