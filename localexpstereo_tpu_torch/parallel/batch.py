"""A batch of same-sized stereo pairs over the ranks of a group
(counterpart of ``localexpstereo_tpu.parallel.batch``; BASELINE config 3).

The JAX package ``vmap``s the move engine over a leading pair axis and
shards that axis over the mesh's ``data`` axis. The port runs one process
per rank (:mod:`.collectives`): rank ``r`` holds the contiguous block of
pairs ``P('data')`` would give it (``ceil(B / n)`` pairs a rank, the last
block shorter) and runs its pairs one after the other through the
unchanged :class:`..models.engine.LocalExpansionSolver`, pair ``b`` with
seed ``seed + b``. So pair ``b`` follows the schedule and the random
streams of ``LocalExpansionSolver(seed=seed + b)`` bit for bit, by
construction (the JAX ``vmap`` is an amortization with the same results).

The group meets where the JAX functions reduce or gather over the batch:
the per-pair energies and their mean (:meth:`BatchedSolver.energies`),
the labelings and disparities every rank returns, and the checkpoints
(the JAX format, [B, ...] arrays, written by rank 0).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..config import Parameters
from ..models import engine as engine_mod
from ..models import postprocess
from ..ops import plane as plane_ops
from ..ops import rng
from ..utils import checkpoint as ckpt_mod
from . import collectives


def post_process_batch(solver, state, p: int, h: int, w: int):
    """The dual-view post-process of the rank's pairs: the port's
    :func:`..models.postprocess.post_process` at threshold 1.5, pair by
    pair (the path the JAX function takes for a pair beyond its static
    capacity, so the results are the same). ``state``: {mode: (labeling
    [b, Hp, Wp, 4], cost [b, Hp, Wp])} of the rank's pairs. Returns the
    rank's (left, right) [b, H, W, 4] labelings."""
    left, right = [], []
    for i, pair in enumerate(solver.solvers):
        ll, lr = postprocess.post_process(
            state[0][0][i, p:p + h, p:p + w], state[1][0][i, p:p + h, p:p + w],
            pair.im0, pair.im1, solver.params, threshold=1.5)
        left.append(ll)
        right.append(lr)
    return torch.stack(left), torch.stack(right)


class BatchedSolver:
    """Local-expansion stereo over a batch of same-sized pairs, one rank's
    block of it (the JAX class's arguments, the rank's ``device`` in place
    of the mesh; the unary route is "auto", the fused kernel on the card
    as in the single-pair solver, where the JAX class forces its "xla"
    route: the same arithmetic). Every rank passes the whole batch (``ims0``,
    ``ims1``: [B, H, W, 3]; ``vols0``, ``vols1``: [B, D, H, W] or
    sequences; only the rank's pairs are read) and calls the same methods.

    A state is ``(labeling [b, Hp, Wp, 4], cost [b, Hp, Wp])`` of the
    rank's ``b`` pairs; what a method returns for the batch ([B, ...]) is
    the same on every rank.
    """

    def __init__(self, ims0, ims1, params: Parameters, max_disp: float,
                 unit_sizes: Sequence[int], device="cuda",
                 layer_proposers: Optional[List] = None, vols0=None,
                 vols1=None, min_disp: float = 0.0, seed: int = 0,
                 vol_dtype: str = "uint8"):
        if len(ims0) != len(ims1):
            raise ValueError(f"{len(ims0)} left and {len(ims1)} right images")
        self.batch = len(ims0)
        self.params = params
        self.seed = int(seed)
        self.rank, self.n_dev = collectives.rank(), collectives.world()
        self.per = -(-self.batch // self.n_dev)
        if (self.n_dev - 1) * self.per >= self.batch:
            raise ValueError(f"{self.batch} pairs leave a rank of "
                             f"{self.n_dev} without one")
        self.pairs = range(self.rank * self.per,
                           min((self.rank + 1) * self.per, self.batch))
        proposers = (layer_proposers or
                     [engine_mod.LAYER0_PROPOSERS]
                     + [engine_mod.COARSE_PROPOSERS] * (len(unit_sizes) - 1))
        self.solvers: List[engine_mod.LocalExpansionSolver] = []
        for b in self.pairs:
            pair = engine_mod.LocalExpansionSolver(
                ims0[b], ims1[b], params, max_disp,
                vol0=None if vols0 is None else vols0[b],
                vol1=None if vols1 is None else vols1[b], min_disp=min_disp,
                seed=self.seed + b, device=device, vol_dtype=vol_dtype)
            for size, names in zip(unit_sizes, proposers):
                pair.add_layer(size, names)
            pair.finalize()
            self.solvers.append(pair)
        self.cfg = self.solvers[0].cfg
        self.layers = self.solvers[0].layers
        self.evaluators: Optional[List] = None
        self._state: Optional[Dict[int, Tuple]] = None

    def set_evaluators(self, evaluators: List):
        """One evaluator (or None) per pair of the batch; a rank uses its
        pairs' (each logs its own pair, as the JAX class's)."""
        if len(evaluators) != self.batch:
            raise ValueError(f"{len(evaluators)} evaluators for "
                             f"{self.batch} pairs")
        self.evaluators = [evaluators[b] for b in self.pairs]

    # ---------------------------------------------------------- gathers --

    def _gather(self, local: torch.Tensor) -> torch.Tensor:
        """[B, ...] of every rank's [b, ...] block, on every rank."""
        pad = self.per - local.shape[0]
        if pad:
            local = torch.cat([local, local.new_zeros((pad,)
                                                      + local.shape[1:])])
        return torch.cat(collectives.all_gather(local))[:self.batch]

    def _roots(self) -> List[torch.Tensor]:
        return [rng.PRNGKey(self.seed + b) for b in self.pairs]

    # ------------------------------------------------------------ steps --

    def init(self, mode: int = 0):
        """The rank's pairs' random init; pair ``b``'s equals the single
        pair engine's under root ``PRNGKey(seed + b)`` folded at 1000 +
        mode."""
        states = [pair._init_state(rng.fold_in(root, 1000 + mode), mode)
                  for pair, root in zip(self.solvers, self._roots())]
        return (torch.stack([lab for lab, _ in states]),
                torch.stack([cost for _, cost in states]))

    def _sweep(self, state, mode: int, outer_iter: int, do_gc: bool,
               keys) -> None:
        """One sweep of every pair of the rank, in place; ``keys``: each
        pair's sweep key."""
        for i, (pair, key) in enumerate(zip(self.solvers, keys)):
            pair._sweep((state[0][i], state[1][i]), mode, outer_iter, do_gc,
                        key)

    def sweep(self, state, outer_iter: int, do_gc: bool, mode: int = 0,
              key: Optional[torch.Tensor] = None):
        """One sweep with ad-hoc keys (the lower-level API; :meth:`run`
        drives the reference schedule): pair ``b`` takes
        ``split(key, B)[b]``. Returns the new state."""
        key = key if key is not None else rng.PRNGKey(
            self.seed + 17 * (outer_iter + 1))
        keys = rng.split(key, self.batch)
        state = (state[0].clone(), state[1].clone())
        self._sweep(state, mode, outer_iter, do_gc,
                    [keys[b] for b in self.pairs])
        return state

    # -------------------------------------------------------------- run --

    def run(self, iterations: int, view_modes: Sequence[int] = (0,),
            pm_iterations: int = 0, checkpoint_path: Optional[str] = None,
            checkpoint_every: int = 0, resume_from: Optional[str] = None):
        """``LocalExpansionSolver.run``'s schedule for every pair: the init,
        the greedy and the graph-cut sweeps (the views interleaved, one key
        step a sweep and view), the evaluators, the post-process with two
        views, and checkpoints of the whole batch every
        ``checkpoint_every`` sweeps (``resume_from`` continues one).
        Returns (final, raw): [B, H, W, 4] labelings of view 0, on every
        rank."""
        modes = tuple(view_modes)
        roots = self._roots()
        state: Dict[int, Tuple] = {}
        pm_done = gc_done = 0
        if resume_from is not None:
            ck = ckpt_mod.load_checkpoint(resume_from)
            if ck.pad != self.cfg.pad:
                raise ValueError(f"checkpoint pad {ck.pad}: the solver's is "
                                 f"{self.cfg.pad}")
            block = slice(self.pairs.start, self.pairs.stop)
            dev = self.solvers[0].device
            for mode in modes:
                state[mode] = tuple(
                    torch.as_tensor(x[block], dtype=torch.float32,
                                    device=dev)
                    for x in (ck.labeling[mode], ck.cost[mode]))
            pm_done, gc_done = ck.pm_iterations_done, ck.iterations_done
        else:
            for mode in modes:
                state[mode] = self.init(mode)
                self._evaluate(state, mode, 0)
        for ev in self.evaluators or []:
            if ev is not None:
                ev.start()
        step = len(modes) * (pm_done + gc_done)
        for do_gc, base, done, sweeps, first in (
                (False, 2000, pm_done, pm_iterations, 1),
                (True, 3000, gc_done, iterations, 1 + pm_iterations)):
            for it in range(done, sweeps):
                for mode in modes:
                    self._sweep(state[mode], mode, it, do_gc,
                                [rng.fold_in(r, base + step) for r in roots])
                    step += 1
                    self._evaluate(state, mode, it + first)
                if (checkpoint_path and checkpoint_every
                        and (it + first) % checkpoint_every == 0):
                    self._checkpoint(state, checkpoint_path,
                                     *((pm_iterations, it + 1) if do_gc
                                       else (it + 1, 0)))
        p, h, w = self.cfg.pad, self.cfg.height, self.cfg.width
        raw = state[0][0][:, p:p + h, p:p + w].clone()
        final = raw
        if len(modes) == 2:
            left, right = post_process_batch(self, state, p, h, w)
            state[0][0][:, p:p + h, p:p + w] = left
            state[1][0][:, p:p + h, p:p + w] = right
            final = left
            for mode in modes:
                self._evaluate(state, mode, iterations + 1 + pm_iterations)
        for ev in self.evaluators or []:
            if ev is not None:
                ev.stop()
        self._state = state
        return self._gather(final), self._gather(raw)

    def _checkpoint(self, state, path: str, pm_done: int,
                    gc_done: int) -> None:
        full = {m: tuple(self._gather(x) for x in st)
                for m, st in state.items()}
        if self.rank == 0:
            ckpt_mod.save_checkpoint(
                path, {m: tuple(x.cpu().numpy() for x in st)
                       for m, st in full.items()},
                self.seed, pm_done, gc_done, self.cfg.pad)

    def _evaluate(self, state, mode: int, index: int) -> None:
        for i, (pair, ev) in enumerate(zip(self.solvers,
                                           self.evaluators or [])):
            if ev is not None:
                ev.evaluate(pair, state[mode][0][i], state[mode][1][i],
                            mode=mode, index=index)

    # ---------------------------------------------------------- metrics --

    def energies(self, state, mode: int = 0):
        """Per-pair (total, data, smooth) energies [B] and the batch's mean
        total (float64: the ranks' sums of their pairs, summed over the
        ranks), on every rank."""
        rows = torch.stack([torch.stack(engine_mod.energy_audit(
            pair.data, pair.cfg, state[0][i], state[1][i], mode))
            for i, pair in enumerate(self.solvers)])          # [b, 3]
        full = self._gather(rows)
        total = collectives.psum(rows[:, 0].to(torch.float64).sum()[None])
        return (full[:, 0], full[:, 1], full[:, 2]), float(total) / self.batch

    def disparities(self, state=None) -> torch.Tensor:
        """[B, H, W] disparities of a state (default: view 0 at the end of
        :meth:`run`), on every rank."""
        labeling = (state if state is not None else self._state[0])[0]
        p = self.cfg.pad
        lab = labeling[:, p:p + self.cfg.height, p:p + self.cfg.width]
        return self._gather(torch.stack([plane_ops.disparity_map(x)
                                         for x in lab]))
