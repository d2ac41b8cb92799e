"""The solver over a cost volume sharded along the disparity axis
(counterpart of ``localexpstereo_tpu.parallel.dvolume``; BASELINE config 4
at full resolution).

Height sharding (:mod:`.volume`) needs a halo of ``8 * s_max + R`` rows;
at MiddV3 geometry (s_max 9 % of the width) that exceeds the image, and
every height shard is a full copy. Here rank ``i`` holds planes ``[i*Dq,
(i+1)*Dq)`` (``Dq = ceil(D / n)``) and one plane on each side (zero beyond
the volume's ends), ``1/n + 2/D`` of the volume whatever the layer sizes:
the sampler's taps reach one plane beyond the primary one at most.

- The raw window cost is merged before the filter: each rank samples the
  pixels whose primary tap it owns, with the unsharded sampler's
  operations, and gives 0 elsewhere; the merge of the partials
  (:func:`.collectives.merge_owned`) is the unsharded raw cost bit for bit
  (``unary_volume``'s ``dshard``).
- Everything else runs on every rank alike (proposals, filter, min-cut,
  canvas updates: the same keys, the same merged unaries, ops that do not
  depend on the rank), so the state needs no merge: every rank returns the
  same state. This mode is for memory, not speed: the work outside the
  unary is done n times.

One all-reduce of an [N, F, F] float32 window (as int32 bits) per
proposal step.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..config import Parameters
from ..models import energy as energy_mod
from ..models import engine as engine_mod
from .volume import ShardedSolver


def build_vol_dshards(vol: torch.Tensor, rank: int, dq: int) -> torch.Tensor:
    """Rank ``rank``'s shard [V, dq + 2, Hp, Wp] of a padded [V, D, Hp, Wp]
    volume (its storage dtype kept): local plane 0 is global plane ``rank *
    dq - 1``, zero outside [0, D). The solver builds the same part straight
    from the unpadded volumes (:func:`plane_window`)."""
    d_ = vol.shape[1]
    src0 = rank * dq - 1
    out = vol.new_zeros((vol.shape[0], dq + 2) + tuple(vol.shape[2:]))
    lo, hi = max(src0, 0), min(src0 + dq + 2, d_)
    if hi > lo:
        out[:, lo - src0:hi - src0] = vol[:, lo:hi]
    return out


def plane_window(rank: int, dq: int) -> energy_mod.VolumeWindow:
    """The planes rank ``rank`` holds, for
    ``energy.build_energy(vol_transform=)``."""
    return energy_mod.VolumeWindow(0, rank * dq - 1, dq + 2)


def dshard_of(rank: int, dq: int, d_total: int) -> Tuple[int, int, int]:
    """``(d_base, d_owned, d_total)`` of rank ``rank``: the sampler's
    ``dshard``."""
    return rank * dq, min(dq, max(d_total - rank * dq, 0)), d_total


class ShardedDVolumeSolver(ShardedSolver):
    """:class:`engine.LocalExpansionSolver` on a volume sharded along the
    disparity axis, one rank of it (the JAX class's arguments, the rank's
    ``device`` in place of the mesh). Every rank passes the whole pair
    (``vol0``, ``vol1``: arrays or tensors that slice; only the rank's
    planes are read) and calls the same methods; :meth:`run` returns the
    same labelings on every rank. The unary is the plain sampler's, merged
    (the fused kernel reads whole volumes).

    ``init_row_chunk``: evaluate the init's unary in bands of this many
    cell rows (0: one call), which bounds its transient at full
    resolution; the state is the same bit for bit.
    """

    def __init__(self, im0_bgr, im1_bgr, params: Parameters,
                 max_disp: float, vol0, vol1, device="cuda",
                 min_disp: float = 0.0, seed: int = 0, interp: int = 1,
                 vol_dtype: str = "uint8", init_row_chunk: int = 0):
        super().__init__(im0_bgr, im1_bgr, params, max_disp, vol0=vol0,
                         vol1=vol1, min_disp=min_disp, seed=seed,
                         device=device, vol_dtype=vol_dtype, interp=interp)
        self.init_row_chunk = init_row_chunk
        self.d_total = int(vol0.shape[0])
        self.dq = -(-self.d_total // self.n_dev)
        self.dshard = dshard_of(self.rank, self.dq, self.d_total)

    def _window(self, vol_pad: int) -> energy_mod.VolumeWindow:
        return plane_window(self.rank, self.dq)

    def _init_state(self, key, mode: int):
        s = self.layers[0].unit_size
        # The same labels as engine.init_step, on the merged unaries.
        return engine_mod.init_in_bands(
            self.data, self.cfg, key, unit_size=s, mode=mode,
            rows=self.init_row_chunk or -(-self.cfg.height // s),
            dshard=self.dshard)

    def _sweep(self, state_m, mode: int, outer_iter: int, do_gc: bool,
               key) -> None:
        labeling_m, cost_m = state_m
        for li, layer in enumerate(self.layers):
            plan, dzs, nrs = self._layer_inputs(li, outer_iter)
            # The raw unary merged before the filter; the rest alike on
            # every rank.
            engine_mod.layer_sweep(self.data, self.cfg, labeling_m, cost_m,
                                   layer, li, plan, dzs, nrs, key,
                                   do_gc=do_gc, mode=mode, dshard=self.dshard)
