"""Checkpoint / resume and the "exact" warm start of the port's engine,
against itself and against the JAX package's.

One V3 scene built in the test (32 x 48, 12 disparities, a random image
and a quadratic-basin volume around a planted plane, with noise), one
layer of unit 8 with the layer-0 proposer set, seed 0. The JAX side's
min-cut knobs are set to the port's (16, 16), and the port runs on the
JAX side's energy (``energy_from_numpy``), so a state carried from one to
the other meets the same costs. Tolerances: a resumed port run is bitwise
the uninterrupted one; across the packages, energies within the
trajectory tolerance 0.002·|E| + 1e-3, init states within 1e-5 and final
disparities within 0.5 px at 99 % of the pixels.
"""
import dataclasses

import numpy as np
import pytest
import torch

from localexpstereo_tpu.config import PARAMS_GF as J_PARAMS
from localexpstereo_tpu.models import engine as jeng
from localexpstereo_tpu.utils import checkpoint as jckpt
from localexpstereo_tpu_torch.config import PARAMS_GF as T_PARAMS
from localexpstereo_tpu_torch.models import energy as tenergy
from localexpstereo_tpu_torch.models import engine as teng
from localexpstereo_tpu_torch.utils import checkpoint

torch.set_num_threads(1)

H, W, ND = 32, 48, 12
PARAMS = dict(windR=6, lambda_=0.5, th_col=0.5)


def _scene():
    r = np.random.default_rng(11)
    im = (r.random((H, W, 3)) * 255).astype(np.uint8).astype(np.float32)
    xs, ys = np.meshgrid(np.arange(W, dtype=np.float32),
                         np.arange(H, dtype=np.float32))
    truth = np.clip(0.05 * xs - 0.04 * ys + 4.0, 1, ND - 2)
    d = np.arange(ND, dtype=np.float32)[:, None, None]
    vol = np.minimum((d - truth[None]) ** 2 * 0.2, 1.0).astype(np.float32)
    vol += (r.random(vol.shape) * 0.02).astype(np.float32)
    return im, vol, truth


class _Rows:
    def __init__(self, audit):
        self.audit = audit
        self.rows = []

    def start(self):
        pass

    def stop(self):
        pass

    def evaluate(self, solver, labeling_m, cost_m, mode, index):
        e = self.audit(solver.data, solver.cfg, labeling_m, cost_m, mode)
        self.rows.append((index, float(e[0]), np.array(labeling_m),
                          np.array(cost_m)))


@pytest.fixture(scope="module")
def jax_solver():
    """A finalized JAX solver of the scene, its knobs at (16, 16)."""
    im, vol, _ = _scene()
    js = jeng.LocalExpansionSolver(im, im, J_PARAMS.replace(**PARAMS),
                                   max_disp=float(ND - 1), vol0=vol,
                                   vol1=vol, seed=0)
    js.add_layer(8, jeng.LAYER0_PROPOSERS)
    js.finalize()
    js.cfg = dataclasses.replace(js.cfg, gc_rounds=16, gc_sweeps=16)
    return js


def _port(jax_solver):
    """A port solver of the scene on the JAX solver's energy."""
    im, vol, _ = _scene()
    ts = teng.LocalExpansionSolver(im, im, T_PARAMS.replace(**PARAMS),
                                   max_disp=float(ND - 1), vol0=vol,
                                   vol1=vol, seed=0, device="cpu")
    ts.add_layer(8, teng.LAYER0_PROPOSERS)
    ts.data, ts.cfg = tenergy.energy_from_numpy(jax_solver.data,
                                                jax_solver.cfg, device="cpu")
    return ts


def _close(got, want):
    return abs(got - want) <= 0.002 * abs(want) + 1e-3


def test_checkpoint_round_trip(tmp_path):
    """The port's file round-trips, and carries the JAX package's keys
    both ways."""
    r = np.random.default_rng(0)
    state = {m: (r.random((10, 12, 4)).astype(np.float32),
                 r.random((10, 12)).astype(np.float32)) for m in (0, 1)}
    checkpoint.save_checkpoint(str(tmp_path / "port.npz"), state, seed=7,
                               pm_done=1, gc_done=2, pad=3)
    jckpt.save_checkpoint(str(tmp_path / "jax.npz"), state, seed=7,
                          pm_done=1, gc_done=2, pad=3)
    for ck in (checkpoint.load_checkpoint(str(tmp_path / "port.npz")),
               checkpoint.load_checkpoint(str(tmp_path / "jax.npz")),
               jckpt.load_checkpoint(str(tmp_path / "port.npz"))):
        assert (ck.seed, ck.pm_iterations_done, ck.iterations_done,
                ck.pad) == (7, 1, 2, 3)
        assert sorted(ck.labeling) == sorted(ck.cost) == [0, 1]
        for m in (0, 1):
            np.testing.assert_array_equal(ck.labeling[m], state[m][0])
            np.testing.assert_array_equal(ck.cost[m], state[m][1])


def _disparity(labeling_m):
    """[H, W] disparity of a padded labeling."""
    p = (labeling_m.shape[0] - H) // 2
    lab = labeling_m[p:p + H, p:p + W]
    return (lab[..., 0] * np.arange(W) + lab[..., 1] * np.arange(H)[:, None]
            + lab[..., 2])


@pytest.fixture(scope="module")
def full_runs(jax_solver, tmp_path_factory):
    """1 greedy + 2 graph-cut sweeps by each package, each writing a
    checkpoint every 2 sweeps (so the files hold the state after 1 + 1)."""
    root = tmp_path_factory.mktemp("ckpt")
    out = {"dir": root}
    ts = _port(jax_solver)
    rec = _Rows(teng.energy_audit)
    ts.set_evaluator(rec)
    lab, _ = ts.run(iterations=2, pm_iterations=1,
                    checkpoint_path=str(root / "port.npz"),
                    checkpoint_every=2)
    out["port"] = (rec.rows, lab, ts._state[0][1].clone())
    js = jax_solver
    rec = _Rows(jeng.energy_audit)
    js.set_evaluator(rec)
    js.run(iterations=2, view_modes=(0,), pm_iterations=1,
           checkpoint_path=str(root / "jax.npz"), checkpoint_every=2)
    js.evaluator = None
    out["jax"] = rec.rows
    return out


@pytest.mark.parametrize("first", [(1, 0), (1, 1)],
                         ids=["after-greedy", "after-graph-cut"])
def test_resume_is_bitwise_the_uninterrupted_run(tmp_path, jax_solver,
                                                 full_runs, first):
    """1 greedy + 2 graph-cut sweeps at once, or resumed from the
    checkpoint of a shorter run (1 + 0 sweeps, checkpoint every sweep; or
    the full run's own file, after 1 + 1): the same rows after the
    checkpoint, the same final state, bit for bit."""
    rows_full, lab_full, cost_full = full_runs["port"]
    path = str(full_runs["dir"] / "port.npz")
    if first == (1, 0):
        path = str(tmp_path / "ck.npz")
        _port(jax_solver).run(iterations=0, pm_iterations=1,
                              checkpoint_path=path, checkpoint_every=1)
    ck = checkpoint.load_checkpoint(path)
    assert (ck.pm_iterations_done, ck.iterations_done) == first
    assert ck.seed == 0 and sorted(ck.labeling) == [0]

    resumed = _port(jax_solver)
    rec = _Rows(teng.energy_audit)
    resumed.set_evaluator(rec)
    lab, _ = resumed.run(iterations=2, pm_iterations=1, resume_from=path)
    assert torch.equal(lab, lab_full)
    assert torch.equal(resumed._state[0][1], cost_full)
    done = sum(first)
    assert [r[:2] for r in rec.rows] == [r[:2] for r in rows_full][
        1 + done:]


def test_checkpoints_cross_between_the_packages(jax_solver, full_runs):
    """A JAX checkpoint (after 1 + 1 sweeps) resumed by the port lands on
    the JAX run's last energy, and a port checkpoint resumed by JAX on the
    port's, within the trajectory tolerance; the disparities within 0.5
    px at 99 % of the pixels."""
    js = jax_solver
    ends = {"jax": full_runs["jax"][-1], "port": full_runs["port"][0][-1]}
    rec = _Rows(jeng.energy_audit)
    js.set_evaluator(rec)
    js.run(iterations=2, view_modes=(0,), pm_iterations=1,
           resume_from=str(full_runs["dir"] / "port.npz"))
    js.evaluator = None
    ends["jax_of_port"] = rec.rows[-1]
    ts = _port(js)
    rec = _Rows(teng.energy_audit)
    ts.set_evaluator(rec)
    ts.run(iterations=2, pm_iterations=1,
           resume_from=str(full_runs["dir"] / "jax.npz"))
    ends["port_of_jax"] = rec.rows[-1]
    assert all(row[0] == 3 for row in ends.values())
    for got, want in (("port_of_jax", "jax"), ("jax_of_port", "port")):
        assert _close(ends[got][1], ends[want][1]), ends
        near = np.abs(_disparity(ends[got][2])
                      - _disparity(ends[want][2])) < 0.5
        assert near.mean() >= 0.99


def test_exact_init_matches_jax(jax_solver):
    """run(init_labeling=, init_mode="exact"): the init state within 1e-5
    of the JAX package's init_from_labeling, then one graph-cut sweep's
    energy within the trajectory tolerance."""
    js = jax_solver
    _, _, truth = _scene()
    r = np.random.default_rng(4)
    lab = np.zeros((H, W, 4), np.float32)
    lab[..., 0:2] = r.normal(0, 0.02, (H, W, 2))
    lab[..., 2] = truth + r.uniform(-1.0, 1.0, truth.shape)
    lab[..., 2] -= lab[..., 0] * np.arange(W) + lab[..., 1] * np.arange(
        H)[:, None]
    jl, jc = jeng.init_from_labeling(js.data, js.cfg, lab, 0)
    jrec = _Rows(jeng.energy_audit)
    js.set_evaluator(jrec)
    js.run(iterations=1, view_modes=(0,), init_labeling=lab)
    js.evaluator = None
    ts = _port(js)
    trec = _Rows(teng.energy_audit)
    ts.set_evaluator(trec)
    ts.run(iterations=1, init_labeling=torch.from_numpy(lab),
           init_mode="exact")
    np.testing.assert_allclose(trec.rows[0][2], np.asarray(jl), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(trec.rows[0][3], np.asarray(jc), rtol=1e-5,
                               atol=1e-5)
    assert len(trec.rows) == len(jrec.rows) == 2
    for got, want in zip(trec.rows, jrec.rows):
        assert _close(got[1], want[1]), (trec.rows, jrec.rows)
    with pytest.raises(ValueError, match="init_mode"):
        ts.run(iterations=1, init_labeling=lab, init_mode="pixel")
