"""The port's ReplicaSolver (``parallel/replica.py``): one pair at a time
on each device.

Contract: pair ``b`` equals ``LocalExpansionSolver(seed=seed + b)`` on the
same device, bitwise, on one view and on two views with the post-process
(in this process, the one-device route); three pairs on two CPU worker
processes (``devices=["cpu", "cpu"]``: two waves on the first) equal the
in-process results, bitwise; the evaluators of a group start together
and, in the workers, come back with their clocks; and the port's batch
against the JAX package's ReplicaSolver on a one-device mesh, each pair's
final energy within 0.002·|E| + 1e-3 (the JAX side's min-cut knobs set
to the port's (16, 16)). 28 x 36 pixels, 6 disparities, one layer.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from localexpstereo_tpu.config import PARAMS_GF as J_PARAMS
from localexpstereo_tpu.parallel import mesh as jmesh
from localexpstereo_tpu.parallel.replica import ReplicaSolver as JReplica
from localexpstereo_tpu_torch.config import PARAMS_GF as T_PARAMS
from localexpstereo_tpu_torch.models.engine import LocalExpansionSolver
from localexpstereo_tpu_torch.models.evaluator import Evaluator
from localexpstereo_tpu_torch.parallel import mesh
from localexpstereo_tpu_torch.parallel.replica import ReplicaSolver

torch.set_num_threads(1)

PARAMS = dict(windR=4, lambda_=0.5, th_col=0.5)
PROPOSERS = [("expansion", "ransac", "random7")]
LAYERS = [3]
ND = 6


def _problems(b, h=28, w=36, nd=ND, seed=0):
    rng = np.random.default_rng(seed)
    ims = (rng.random((b, h, w, 3)) * 255).astype(np.float32)
    dd = np.arange(nd, dtype=np.float32)[:, None, None]
    vols = []
    for _ in range(b):
        d_true = rng.random((h, w), np.float32) * (nd - 1)
        vols.append(np.minimum(np.abs(dd - d_true[None]) * 0.4, 1.0))
    return ims, np.stack(vols).astype(np.float32)


def _replica(ims, vols, devices, seed=7):
    return ReplicaSolver(ims, ims, T_PARAMS.replace(**PARAMS), ND - 1.0,
                         LAYERS, devices=devices, layer_proposers=PROPOSERS,
                         vols0=vols, vols1=vols, seed=seed)


def _single(ims, vols, b, seed=7, modes=(0,), iterations=1):
    s = LocalExpansionSolver(ims[b], ims[b], T_PARAMS.replace(**PARAMS),
                             ND - 1.0, vol0=vols[b], vol1=vols[b],
                             seed=seed + b, device="cpu")
    s.add_layer(LAYERS[0], PROPOSERS[0])
    final, raw = s.run(iterations, view_modes=modes, pm_iterations=1)
    return s, final.numpy(), raw.numpy()


@pytest.fixture(scope="module")
def three():
    ims, vols = _problems(3)
    rs = _replica(ims, vols, ["cpu"])
    final, raw = rs.run(1, (0,), 1)
    return ims, vols, rs, final, raw


def test_pairs_equal_single_solves(three):
    ims, vols, rs, final, raw = three
    assert raw is final and rs.waves == 3
    for b in range(3):
        solver, want, _ = _single(ims, vols, b)
        assert np.array_equal(final[b], want), f"pair {b} diverged"
        assert np.array_equal(rs.labeling(b), want)
        np.testing.assert_array_equal(rs.disparities()[b],
                                      solver.disparity_map().numpy())


def test_two_views_with_post_process_equal_single_solves():
    """One greedy sweep of each view, then the post-process."""
    ims, vols = _problems(2, seed=1)
    rs = _replica(ims, vols, ["cpu"], seed=3)
    final, raw = rs.run(0, (0, 1), 1)
    for b in range(2):
        solver, want, want_raw = _single(ims, vols, b, seed=3, modes=(0, 1),
                                         iterations=0)
        assert np.array_equal(final[b], want)
        assert np.array_equal(raw[b], want_raw)
        assert np.array_equal(rs.labeling(b, 1),
                              solver._unpadded_labeling(1).numpy())
    assert not np.array_equal(final, raw)     # the post-process ran


def test_workers_equal_in_process(three, tmp_path):
    """Two worker processes on the CPU (pairs 0 and 2 on the first, in
    waves), each pair with an evaluator that the workers pickle, fill and
    send back with its clock."""
    ims, vols, rs, final, _ = three
    two = _replica(ims, vols, ["cpu", "cpu"])
    evs = [Evaluator(None, None, 1.0, save_dir=str(tmp_path / f"p{b}"))
           for b in range(3)]
    two.set_evaluators(evs)
    got, _ = two.run(1, (0,), 1)
    assert two.waves == 2
    assert np.array_equal(got, final)
    for b in range(3):
        assert two.energies()[0][0][b] == rs.energies()[0][0][b]
        evs[b].close()
        rows = (tmp_path / f"p{b}" / "log_output.txt").read_text().split("\n")
        assert rows[0].startswith("Time\t") and len(rows[1:-1]) == 3
        assert evs[b].get_current_time() > 0.0
        assert not evs[b].timer.is_ticking()


class _Events:
    """Evaluator stand-in that records (event, pair) in a shared list."""

    def __init__(self, log, b):
        self.log, self.b = log, b

    def start(self):
        self.log.append(("start", self.b))

    def stop(self):
        self.log.append(("stop", self.b))

    def evaluate(self, solver, labeling_m, cost_m, mode, index):
        self.log.append(("evaluate", self.b, index))


def test_group_clock_starts_together():
    """Pair 1's evaluator starts when pair 0's timed solve starts (its
    clock runs through pair 0's sweeps), every evaluator is stopped
    before pair 1's energy is built, and all stop at the end."""
    ims, vols = _problems(2, seed=2)
    rs = _replica(ims, vols, ["cpu"])
    log = []
    rs.set_evaluators([_Events(log, 0), _Events(log, 1)])
    rs.run(1, (0,), 1)
    first_start = log.index(("start", 1))
    assert ("start", 0) in log[:first_start + 1]
    assert first_start < log.index(("evaluate", 0, 2))
    pair1_init = log.index(("evaluate", 1, 0))
    assert log[pair1_init - 2:pair1_init] == [("stop", 0), ("stop", 1)]
    assert log[-2:] == [("stop", 0), ("stop", 1)]


def test_streamed_volumes_are_read_once():
    ims, vols = _problems(2, seed=4)
    rs = ReplicaSolver(ims, ims, T_PARAMS.replace(**PARAMS), ND - 1.0,
                       LAYERS, devices=["cpu"], layer_proposers=PROPOSERS,
                       volumes=((v, v) for v in vols))
    rs.run(0, (0,), 1)
    with pytest.raises(RuntimeError, match="read by an earlier run"):
        rs.run(0, (0,), 1)


def test_make_devices():
    assert mesh.make_devices(2, kind="cpu") == [torch.device("cpu")] * 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mesh.make_devices()


def test_matches_jax_replica(three):
    ims, vols, rs, final, _ = three
    m = jmesh.make_mesh((1,), ("data",), jax.devices()[:1])
    js = JReplica(ims, ims, J_PARAMS.replace(**PARAMS), max_disp=ND - 1.0,
                  mesh=m, unit_sizes=LAYERS, layer_proposers=PROPOSERS,
                  vols0=vols, vols1=vols, seed=7)
    js.cfg = dataclasses.replace(js.cfg, gc_rounds=16, gc_sweeps=16)
    js.run(iterations=1, view_modes=(0,), pm_iterations=1)
    (want, _, _), _ = js.energies(js._state[0])
    (got, _, _), _ = rs.energies()
    for g, w in zip(got, np.asarray(want)):
        assert abs(g - w) <= 0.002 * abs(w) + 1e-3, (got, want)
