"""The port's two-view solve (``run(view_modes=(0, 1))``, ``-doDual 1``)
against the JAX engine and command line, end to end.

A synthetic V3 scene built here (32 x 64, 12 disparities, the right volume
recovered from the left with ``convert_volume_l2r``), 2 layers with the
reference proposer sets, 1 greedy + 1 graph-cut sweep on both views, seed 0
and the min-cut knobs (16, 16) set on the JAX side (the port's fixed values
for these layers). The port runs on the JAX side's EnergyData, carried
across with energy_from_numpy.

Tolerances: the init states of both views allclose (1e-5); every row of
each view's energy trajectory within 0.002·|E| + 1e-3; the post-processed
labelings equal JAX's ``post_process`` of the port's own raw labelings,
off the failed pixels exactly and at most MEDIAN_FLIP_SHARE of the failed
ones differing (the weighted median's float64 against float32 sums; none
expected). The command line (``-doDual 1``, default 2 + 5 schedule) is
held against the JAX command line's log to the same trajectory tolerance.
"""
import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from localexpstereo_tpu.cli import main as jcli
from localexpstereo_tpu.config import PARAMS_GF as J_PARAMS
from localexpstereo_tpu.models import engine as jeng
from localexpstereo_tpu.models import postprocess as jpost
from localexpstereo_tpu_torch.cli import main as tcli
from localexpstereo_tpu_torch.config import PARAMS_GF as T_PARAMS
from localexpstereo_tpu_torch.models import energy as tenergy
from localexpstereo_tpu_torch.models import engine as teng
from localexpstereo_tpu_torch.models import postprocess as tpost
from localexpstereo_tpu_torch.ops import plane as plane_ops
from localexpstereo_tpu_torch.utils import acrt, pfm, png
from tests.test_torch_cli import H as CLI_H
from tests.test_torch_cli import W as CLI_W
from tests.test_torch_cli import _log, _write_scene

torch.set_num_threads(1)

H, W, ND = 32, 64, 12
LAYERS = [4, 8]
PARAMS = dict(lambda_=0.5, th_col=0.5, windR=6)
PM, GC = 1, 1
ROWS = 1 + PM + GC + 1
#: Share of the failed pixels whose weighted-median label may differ from
#: the JAX version's; 0 expected.
MEDIAN_FLIP_SHARE = 0.01


def _scene():
    r = np.random.default_rng(11)
    im = (100 + r.random((H, W, 3)) * 60).astype(np.uint8).astype(np.float32)
    xs, ys = np.meshgrid(np.arange(W, dtype=np.float32),
                         np.arange(H, dtype=np.float32))
    truth = np.clip(0.04 * xs + 0.03 * ys + 3.0, 1, ND - 2)
    d = np.arange(ND, dtype=np.float32)[:, None, None]
    vol = np.minimum((d - truth[None]) ** 2 * 0.2, 1.0).astype(np.float32)
    vol += (r.random(vol.shape) * 0.02).astype(np.float32)
    vol_l = acrt.fill_out_of_view(vol, 0)
    vol_r = acrt.fill_out_of_view(acrt.convert_volume_l2r(vol_l), 1)
    return im, vol_l, vol_r


class _Recorder:
    """Evaluator hook: per view, the total energy and a copy of the state
    after the init and after every sweep; the consistency indices."""

    def __init__(self, audit):
        self.audit = audit
        self.energies = {0: [], 1: []}
        self.states = {0: [], 1: []}
        self.consistency = []

    def start(self):
        pass

    def stop(self):
        pass

    def evaluate(self, solver, labeling_m, cost_m, mode, index):
        e = self.audit(solver.data, solver.cfg, labeling_m, cost_m, mode)
        self.energies[mode].append(float(e[0]))
        self.states[mode].append((np.array(labeling_m, copy=True),
                                  np.array(cost_m, copy=True)))

    def save_consistency(self, solver, state, index):
        self.consistency.append(index)


def _jax_solver(im, vol_l, vol_r, seed):
    js = jeng.LocalExpansionSolver(im, im, J_PARAMS.replace(**PARAMS),
                                   max_disp=float(ND - 1), vol0=vol_l,
                                   vol1=vol_r, seed=seed)
    for i, s in enumerate(LAYERS):
        js.add_layer(s, jeng.LAYER0_PROPOSERS if i == 0
                     else jeng.COARSE_PROPOSERS)
    js.finalize()
    js.cfg = dataclasses.replace(js.cfg, gc_rounds=16, gc_sweeps=16)
    return js


def _port_solver(im, vol_l, vol_r, js):
    ts = teng.LocalExpansionSolver(im, im, T_PARAMS.replace(**PARAMS),
                                   max_disp=float(ND - 1), vol0=vol_l,
                                   vol1=vol_r, seed=js.seed, device="cpu")
    for i, s in enumerate(LAYERS):
        ts.add_layer(s, teng.LAYER0_PROPOSERS if i == 0
                     else teng.COARSE_PROPOSERS)
    ts.data, ts.cfg = tenergy.energy_from_numpy(js.data, js.cfg,
                                                device="cpu")
    return ts


def _solve_both(im, vol_l, vol_r, fuse_with=None):
    """The JAX and the port's dual solve of seed 0; the port's
    post-process inputs are captured."""
    js = _jax_solver(im, vol_l, vol_r, 0)
    jrec = _Recorder(jeng.energy_audit)
    js.set_evaluator(jrec)
    js.run(iterations=GC, view_modes=(0, 1), pm_iterations=PM,
           fuse_with=fuse_with)

    ts = _port_solver(im, vol_l, vol_r, js)
    trec = _Recorder(teng.energy_audit)
    ts.set_evaluator(trec)
    raw_views = []
    inner = tpost.post_process

    def capture(lab_l, lab_r, *args, **kwargs):
        raw_views.extend((lab_l.clone(), lab_r.clone()))
        return inner(lab_l, lab_r, *args, **kwargs)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tpost, "post_process", capture)
        final, raw = ts.run(iterations=GC, view_modes=(0, 1),
                            pm_iterations=PM, fuse_with=fuse_with)
    return dict(js=js, ts=ts, jrec=jrec, trec=trec, final=final, raw=raw,
                raw_views=raw_views)


@pytest.fixture(scope="module")
def scene():
    return _scene()


@pytest.fixture(scope="module")
def solves(scene):
    return _solve_both(*scene)


@pytest.fixture(scope="module")
def fused(scene):
    """Both solves of seed 0 with ``fuse_with=[{0: lab0, 1: lab1}]``, the
    labelings of the JAX dual solve of seed 1."""
    aux = _jax_solver(*scene, 1)
    aux.run(iterations=GC, view_modes=(0, 1), pm_iterations=PM)
    ext = {m: np.asarray(aux._unpadded_labeling(aux._state, m))
           for m in (0, 1)}
    return _solve_both(*scene, fuse_with=[ext])


def _close(got, want):
    return abs(got - want) <= 0.002 * abs(want) + 1e-3


def _post_process_matches(run, scene):
    """The port's final labelings against JAX's post_process of the port's
    raw ones."""
    im = scene[0]
    raw_l, raw_r = run["raw_views"]
    want = jpost.post_process(jnp.asarray(raw_l.numpy()),
                              jnp.asarray(raw_r.numpy()), im, im,
                              J_PARAMS.replace(**PARAMS), threshold=1.5)
    ts = run["ts"]
    got = (run["final"], ts._unpadded_labeling(1))
    fails = tpost.consistency_check(plane_ops.disparity_map(raw_l),
                                    plane_ops.disparity_map(raw_r), 1.5)
    repaired = 0
    for g, wnt, raw, fail in zip(got, want, (raw_l, raw_r), fails):
        g, wnt, fail = g.numpy(), np.asarray(wnt), fail.numpy() > 0
        np.testing.assert_array_equal(g[~fail], wnt[~fail])
        np.testing.assert_array_equal(g[~fail], raw.numpy()[~fail])
        differ = (g[fail] != wnt[fail]).any(-1).mean() if fail.any() else 0
        assert differ <= MEDIAN_FLIP_SHARE, differ
        repaired += int((g != raw.numpy()).any(-1).sum())
    assert repaired > 0


def test_init_states_match(solves):
    for mode in (0, 1):
        (jl, jc), (tl, tc) = (solves["jrec"].states[mode][0],
                              solves["trec"].states[mode][0])
        np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(tc, jc, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode", [0, 1])
def test_energy_trajectories_match(solves, mode):
    je, te = solves["jrec"].energies[mode], solves["trec"].energies[mode]
    assert len(je) == len(te) == ROWS
    for got, want in zip(te, je):
        assert _close(got, want), (mode, te, je)


def test_post_process_matches_jax(solves, scene):
    _post_process_matches(solves, scene)


def test_dual_run_outputs(solves):
    """raw is view 0 after the last sweep; final is the state's view 0
    after the post-process; the last row keeps the pre-process unary
    costs (as the JAX engine does); the consistency images were asked
    for after each sweep pair."""
    ts, trec = solves["ts"], solves["trec"]
    p = ts.cfg.pad
    last_lab, last_cost = trec.states[0][ROWS - 2]
    np.testing.assert_array_equal(solves["raw"].numpy(),
                                  last_lab[p:p + H, p:p + W])
    assert torch.equal(solves["final"], ts._unpadded_labeling(0))
    assert not torch.equal(solves["final"], solves["raw"])
    for mode in (0, 1):
        np.testing.assert_array_equal(trec.states[mode][-1][1],
                                      trec.states[mode][-2][1])
    assert trec.consistency == solves["jrec"].consistency == [1, 2]
    assert torch.equal(ts.disparity_map(1),
                       plane_ops.disparity_map(ts._unpadded_labeling(1)))


@pytest.mark.parametrize("mode", [0, 1])
def test_fused_dual_run_matches_jax(fused, mode):
    je, te = fused["jrec"].energies[mode], fused["trec"].energies[mode]
    assert len(je) == len(te) == ROWS
    for got, want in zip(te, je):
        assert _close(got, want), (mode, te, je)


def test_fused_dual_post_process_matches_jax(fused, scene):
    _post_process_matches(fused, scene)


def test_view_modes_are_checked(scene):
    ts = _port_solver(*scene, _jax_solver(*scene, 0))
    with pytest.raises(ValueError, match="view_modes"):
        ts.run(iterations=1, view_modes=(1,))


# ---------------------------------------------------------- command line --

def test_cli_do_dual_matches_jax(tmp_path):
    """-doDual 1 through both command lines on the CLI tests' scene (40 x
    72 x 12, no im1.acrt, so the right volume is recovered from the left),
    1 greedy + 1 graph-cut sweep (the default 2 + 5 takes the port alone
    about 100 s on one CPU thread; chip_smoke.py runs it on the card):
    1 + 1 + 1 + 1 log rows each, energies within the trajectory tolerance,
    disp0.pfm and disp0raw.pfm, and the consistency images of both views
    after every sweep pair, as the JAX command line writes them."""
    _write_scene(tmp_path / "scene")
    scene = str(tmp_path / "scene")
    schedule = ["-doDual", "1", "-pmIterations", "1", "-iterations", "1",
                "-seed", "0", "-warmup", "0"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jeng.LocalExpansionSolver, "_apply_cfg_overrides",
                   lambda self, cfg: dataclasses.replace(
                       cfg, gc_rounds=16, gc_sweeps=16))
        assert jcli.main(["-mode", "MiddV3", "-targetDir", scene,
                          "-outputDir", str(tmp_path / "jax"), "-platform",
                          "cpu", *schedule]) == 0
    assert tcli.main(["-mode", "MiddV3", "-targetDir", scene, "-outputDir",
                      str(tmp_path / "port"), "-device", "cpu",
                      *schedule]) == 0
    want, got = _log(tmp_path / "jax"), _log(tmp_path / "port")
    assert got.shape == want.shape == (1 + 1 + 1 + 1, 6)
    for g, w in zip(got[:, 1], want[:, 1]):
        assert abs(g - w) <= 0.002 * abs(w) + 1e-3, (got[:, 1], want[:, 1])
    out = tmp_path / "port"
    disp = pfm.read_pfm(str(out / "disp0.pfm"))
    raw = pfm.read_pfm(str(out / "disp0raw.pfm"))
    assert disp.shape == raw.shape == (CLI_H, CLI_W)
    assert np.isfinite(disp).all() and np.isfinite(raw).all()
    names = set(os.listdir(out / "debug"))
    assert {n for n in names if "C" in n} == {
        n for n in os.listdir(tmp_path / "jax" / "debug") if "C" in n} == {
        f"result{mode}C{index:02d}.png" for mode in (0, 1)
        for index in (1, 2)}
    for name in ("result0C02.png", "result1C02.png"):
        img = png.read_color(str(out / "debug" / name))
        assert img.shape == (CLI_H, CLI_W, 3)
        # Gray where consistent, blue or red where the check failed.
        jimg = png.read_color(str(tmp_path / "jax" / "debug" / name))
        assert ((img[..., 0] == 255) | (img[..., 2] == 255)).any()
        assert ((jimg[..., 0] == 255) | (jimg[..., 2] == 255)).any()
