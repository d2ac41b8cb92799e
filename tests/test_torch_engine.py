"""The port's single-view V3 solve against the JAX engine, end to end.

A synthetic V3 scene built in the test (planted slanted-plane truth and a
quadratic-basin cost volume, 64 x 128, 16 disparities), 3 layers with the
reference proposer sets, 1 greedy + 2 graph-cut sweeps, seed 0 and the
min-cut knobs (16, 16) on both sides: the port's fixed values for these
layers, set on the JAX side, whose CPU defaults differ. On the CPU the JAX
engine resolves to its XLA min-cut and "xla" sampler by itself. Each side
is solved once per module; the port runs on the JAX side's EnergyData,
carried across with energy_from_numpy.

A second, smaller scene (32 x 64, 12 disparities, one layer, 1 greedy + 1
graph-cut sweep) is solved on the "dma" unary route by both: the JAX
solver through its fused Pallas sampler in interpret mode, the port
through the fused kernel's plain version.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from localexpstereo_tpu.config import PARAMS_GF as J_PARAMS
from localexpstereo_tpu.models import engine as jeng
from localexpstereo_tpu_torch.config import PARAMS_GF as T_PARAMS
from localexpstereo_tpu_torch.models import energy as tenergy
from localexpstereo_tpu_torch.models import engine as teng
from localexpstereo_tpu_torch.ops import rng

torch.set_num_threads(1)

H, W, ND = 64, 128, 16
LAYERS = [4, 8, 16]
PM, GC = 1, 2


def _scene(h=H, w=W, nd=ND):
    r = np.random.default_rng(7)
    im = (r.random((h, w, 3)) * 255).astype(np.uint8).astype(np.float32)
    xs, ys = np.meshgrid(np.arange(w, dtype=np.float32),
                         np.arange(h, dtype=np.float32))
    truth = np.clip(0.04 * xs + 0.03 * ys + 3.0, 1, nd - 2)
    d = np.arange(nd, dtype=np.float32)[:, None, None]
    vol = np.minimum((d - truth[None]) ** 2 * 0.2, 1.0).astype(np.float32)
    vol += (r.random(vol.shape) * 0.02).astype(np.float32)
    return im, vol, truth


class _Recorder:
    """Evaluator hook: total energy and a copy of the state after the init
    and after every sweep."""

    def __init__(self, audit):
        self.audit = audit
        self.energies, self.smooth, self.states = [], [], []

    def start(self):
        pass

    def stop(self):
        pass

    def evaluate(self, solver, labeling_m, cost_m, mode, index):
        e = self.audit(solver.data, solver.cfg, labeling_m, cost_m, mode)
        self.energies.append(float(e[0]))
        self.smooth.append(float(e[2]))
        self.states.append((np.array(labeling_m, copy=True),
                            np.array(cost_m, copy=True)))


def _bad_rates(lab, truth, nd=ND):
    h, w = truth.shape
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    disp = lab[..., 0] * xs + lab[..., 1] * ys + lab[..., 2]
    err = np.abs(disp - truth)[8:-8, nd:-8]
    return float((err > 0.5).mean() * 100), float((err > 1.0).mean() * 100)


@pytest.fixture(scope="module")
def solves():
    im, vol, truth = _scene()
    params = dict(lambda_=0.5, th_col=0.5)

    js = jeng.LocalExpansionSolver(im, im, J_PARAMS.replace(**params),
                                   max_disp=float(ND - 1), vol0=vol,
                                   vol1=vol, seed=0)
    for i, s in enumerate(LAYERS):
        js.add_layer(s, jeng.LAYER0_PROPOSERS if i == 0
                     else jeng.COARSE_PROPOSERS)
    js.finalize()
    js.cfg = dataclasses.replace(js.cfg, gc_rounds=16, gc_sweeps=16)
    jrec = _Recorder(jeng.energy_audit)
    js.set_evaluator(jrec)
    jlab, _ = js.run(iterations=GC, view_modes=(0,), pm_iterations=PM)

    ts = teng.LocalExpansionSolver(im, im, T_PARAMS.replace(**params),
                                   max_disp=float(ND - 1), vol0=vol,
                                   vol1=vol, seed=0, device="cpu")
    for i, s in enumerate(LAYERS):
        ts.add_layer(s, teng.LAYER0_PROPOSERS if i == 0
                     else teng.COARSE_PROPOSERS)
    ts.data, ts.cfg = tenergy.energy_from_numpy(js.data, js.cfg,
                                                device="cpu")
    assert all(teng.mincut_knobs(3 * s) == (16, 16) for s in LAYERS)
    trec = _Recorder(teng.energy_audit)
    ts.set_evaluator(trec)
    tlab, raw = ts.run(iterations=GC, pm_iterations=PM)
    assert raw is tlab
    return dict(js=js, ts=ts, jrec=jrec, trec=trec, truth=truth,
                jlab=np.asarray(jlab), tlab=tlab.numpy())


def _close(got, want):
    return abs(got - want) <= 0.002 * abs(want) + 1e-3


def test_init_state_matches(solves):
    (jl, jc), (tl, tc) = solves["jrec"].states[0], solves["trec"].states[0]
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tc, jc, rtol=1e-5, atol=1e-5)


def test_energy_trajectory_matches(solves):
    je, te = solves["jrec"].energies, solves["trec"].energies
    assert len(je) == len(te) == 1 + PM + GC
    for got, want in zip(te, je):
        assert _close(got, want), (te, je)


def test_gc_energies_monotone(solves):
    te = solves["trec"].energies
    assert all(b <= a for a, b in zip(te[PM:], te[PM + 1:])), te


def test_bad_rates_match(solves):
    jb = _bad_rates(solves["jlab"], solves["truth"])
    tb = _bad_rates(solves["tlab"], solves["truth"])
    assert abs(tb[0] - jb[0]) <= 0.5 and abs(tb[1] - jb[1]) <= 0.5, (tb, jb)
    assert tb[1] < 5.0


def test_gc_sweep_from_shared_state(solves):
    """One graph-cut sweep of the port from the JAX engine's post-greedy
    state, with the JAX run's key, lands on the JAX energy."""
    ts = solves["ts"]
    state = tenergy.state_from_numpy(*solves["jrec"].states[PM],
                                     device="cpu")
    key = rng.fold_in(rng.PRNGKey(0), 3000 + PM)
    ts._sweep(state, 0, 0, True, key)
    e = float(teng.energy_audit(ts.data, ts.cfg, *state, 0)[0])
    assert _close(e, solves["jrec"].energies[PM + 1])


DMA_H, DMA_W, DMA_ND, DMA_LAYER = 32, 64, 12, 8
DMA_PROPOSERS = ("expansion", "ransac")


@pytest.fixture(scope="module")
def dma_solves():
    """One layer, 1 greedy + 1 graph-cut sweep on the "dma" unary route:
    the JAX solver runs its fused Pallas sampler in interpret mode (its
    energy built with the DMA alignment padding and the statistics stack),
    the port the kernel's plain version on that energy."""
    from localexpstereo_tpu.models import energy as jenergy
    im, vol, truth = _scene(DMA_H, DMA_W, DMA_ND)
    params = dict(lambda_=0.5, th_col=0.5, windR=6)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jenergy, "DMA_INTERPRET", True)
        js = jeng.LocalExpansionSolver(im, im, J_PARAMS.replace(**params),
                                       max_disp=float(DMA_ND - 1), vol0=vol,
                                       vol1=vol, seed=0, unary_backend="dma")
        js.add_layer(DMA_LAYER, DMA_PROPOSERS)
        js.finalize()
        assert js.data.gf_stack is not None
        js.cfg = dataclasses.replace(js.cfg, gc_rounds=16, gc_sweeps=16)
        jrec = _Recorder(jeng.energy_audit)
        js.set_evaluator(jrec)
        jlab, _ = js.run(iterations=1, view_modes=(0,), pm_iterations=1)

    ts = teng.LocalExpansionSolver(im, im, T_PARAMS.replace(**params),
                                   max_disp=float(DMA_ND - 1), vol0=vol,
                                   vol1=vol, seed=0, unary_backend="dma",
                                   device="cpu")
    ts.add_layer(DMA_LAYER, DMA_PROPOSERS)
    ts.data, ts.cfg = tenergy.energy_from_numpy(js.data, js.cfg,
                                                device="cpu")
    trec = _Recorder(teng.energy_audit)
    ts.set_evaluator(trec)
    tlab, _ = ts.run(iterations=1, pm_iterations=1)
    assert ts.cfg.unary_backend == "dma"
    return dict(jrec=jrec, trec=trec, truth=truth, jlab=np.asarray(jlab),
                tlab=tlab.numpy())


def test_dma_solve_matches_jax(dma_solves):
    je, te = dma_solves["jrec"].energies, dma_solves["trec"].energies
    assert len(je) == len(te) == 3
    for got, want in zip(te, je):
        assert _close(got, want), (te, je)
    assert te[2] <= te[1]
    # The totals are dominated by COST_FOR_INVALID at the pixels no valid
    # label has reached yet, so also hold the invalid counts equal and the
    # rest of the energy (valid costs in float64, plus smoothness) to the
    # trajectory tolerance.
    parts = []
    for rec in (dma_solves["jrec"], dma_solves["trec"]):
        rows = []
        for (_, cost_m), smooth in zip(rec.states, rec.smooth):
            p = (cost_m.shape[0] - DMA_H) // 2
            cost = cost_m[p:p + DMA_H, p:p + DMA_W].astype(np.float64)
            valid = cost < 1e5
            rows.append((int((~valid).sum()), cost[valid].sum() + smooth))
        parts.append(rows)
    for (jn, je_valid), (tn, te_valid) in zip(*parts):
        assert tn == jn and _close(te_valid, je_valid), parts
    jb = _bad_rates(dma_solves["jlab"], dma_solves["truth"], DMA_ND)
    tb = _bad_rates(dma_solves["tlab"], dma_solves["truth"], DMA_ND)
    assert abs(tb[0] - jb[0]) <= 0.5 and abs(tb[1] - jb[1]) <= 0.5, (tb, jb)


def test_port_runs_without_jax(tmp_path):
    """The package, its parallel modules included, imports and solves on
    the CPU with jax unimportable."""
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        import numpy as np, torch
        torch.set_num_threads(1)
        import localexpstereo_tpu_torch
        from localexpstereo_tpu_torch.config import PARAMS_GF
        from localexpstereo_tpu_torch.models import engine
        from localexpstereo_tpu_torch.parallel import (batch, collectives,
                                                       dvolume, mesh,
                                                       replica, spatial,
                                                       volume)
        from localexpstereo_tpu_torch.tools import (gc_cap_audit,
                                                    mccnn_v3_eval, multichip,
                                                    train_mccnn)
        from localexpstereo_tpu_torch.utils import synthetic
        img, vol, h, w, nd, truth = synthetic.build_problem(0.03)
        s = engine.LocalExpansionSolver(
            img, img, PARAMS_GF.replace(windR=6, lambda_=0.5, th_col=0.5),
            max_disp=float(nd - 1), vol0=vol, vol1=vol, device="cpu")
        s.add_layer(16, engine.COARSE_PROPOSERS)
        lab, _ = s.run(iterations=1, pm_iterations=0)
        assert lab.shape == (h, w, 4) and bool(torch.isfinite(lab).all())
        assert not any(m == "jax" or m.startswith(("jax.", "localexpstereo_tpu."))
                       for m in sys.modules if sys.modules[m] is not None)
        print("OK")
    """)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=tmp_path, timeout=300)
    assert res.returncode == 0 and res.stdout.strip() == "OK", res.stderr


def test_solver_wants_the_card_unless_asked_for_the_cpu():
    """With no ``device`` the solver and the energy helpers put their
    tensors on the card, and raise on a host without one."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    im, vol, _ = _scene(16, 24, 6)
    params = T_PARAMS.replace(windR=4, lambda_=0.5, th_col=0.5)
    solver = teng.LocalExpansionSolver(im, im, params, max_disp=5.0,
                                       vol0=vol, vol1=vol)
    solver.add_layer(4, teng.COARSE_PROPOSERS)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        solver.run(iterations=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tenergy.build_energy(im, im, params, 5.0, 8, vol, vol)
    data, cfg = tenergy.build_energy(im, im, params, 5.0, 8, vol, vol,
                                     device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tenergy.energy_from_numpy(data, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tenergy.state_from_numpy(np.zeros((4, 4, 4)), np.zeros((4, 4)))
