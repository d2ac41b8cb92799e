"""The port's joint bilateral filter ("BF", ``ops/bilateral.py``) against
the JAX package's.

``filter_windows`` on the same seeded windows at (N, F, R) = (2, 10, 3) and
(2, 30, 20), within rtol 1e-5 / atol 1e-6 (the port sums in float64, a
window row's taps at once, the JAX scan in float32 tap by tap); then a
``PARAMS_BF`` solve (windR 6, 2 layers, 1 greedy + 1 graph-cut sweep) on
``tests/test_torch_engine.py``'s scene size (64 x 128, 16 disparities)
against the JAX engine on the port's "auto" and "dma" routes (on the CPU
"dma" samples by the fused kernel's plain version, raw, and the bilateral
filter runs after it), the energy trajectory within that file's
0.002·|E| + 1e-3 per row. The bilateral costs' last bits decide many
greedy near-ties: one greedy sweep from the same state already differs
by about 0.1 %, and at 32 x 64 the trajectories part by 0.36 %.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from localexpstereo_tpu.config import PARAMS_BF as J_PARAMS
from localexpstereo_tpu.models import engine as jeng
from localexpstereo_tpu.ops import bilateral as jbil
from localexpstereo_tpu_torch.config import PARAMS_BF as T_PARAMS
from localexpstereo_tpu_torch.models import energy as ten
from localexpstereo_tpu_torch.models import engine as teng
from localexpstereo_tpu_torch.ops import bilateral as tbil

torch.set_num_threads(1)


@pytest.mark.parametrize("n,f,r", [(2, 10, 3), (2, 30, 20)])
def test_filter_windows_matches_jax(n, f, r):
    rng = np.random.default_rng(f + r)
    p = rng.uniform(0, 1.0, (n, f, f)).astype(np.float32)
    guide = (rng.random((n, f, f, 3)) * 255).astype(np.float32)
    mask = (rng.random((n, f, f)) > 0.25).astype(np.float32)
    want = np.asarray(jbil.filter_windows(jnp.asarray(p), jnp.asarray(guide),
                                          jnp.asarray(mask), r, 10.0))
    got = tbil.filter_windows(torch.from_numpy(p), torch.from_numpy(guide),
                              torch.from_numpy(mask), r, 10.0).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_filter_windows_chunks_agree(monkeypatch):
    """The chunking over windows does not change a value."""
    rng = np.random.default_rng(1)
    args = [torch.from_numpy(a) for a in (
        rng.random((5, 12, 12), np.float32),
        (rng.random((5, 12, 12, 3)) * 255).astype(np.float32),
        (rng.random((5, 12, 12)) > 0.3).astype(np.float32))]
    whole = tbil.filter_windows(*args, 4, 10.0)
    monkeypatch.setattr(tbil, "CHUNK_BYTES", 12 * 9 * 12 * 8 * 2)
    assert torch.equal(tbil.filter_windows(*args, 4, 10.0), whole)


H, W, ND = 64, 128, 16
LAYERS = [4, 8]
PARAMS = dict(windR=6, th_col=0.5)


def _scene():
    r = np.random.default_rng(7)
    im = (r.random((H, W, 3)) * 255).astype(np.uint8).astype(np.float32)
    xs, ys = np.meshgrid(np.arange(W, dtype=np.float32),
                         np.arange(H, dtype=np.float32))
    truth = np.clip(0.04 * xs + 0.03 * ys + 3.0, 1, ND - 2)
    d = np.arange(ND, dtype=np.float32)[:, None, None]
    vol = np.minimum((d - truth[None]) ** 2 * 0.2, 1.0).astype(np.float32)
    vol += (r.random(vol.shape) * 0.02).astype(np.float32)
    return im, vol


class _Recorder:
    def __init__(self, audit):
        self.audit = audit
        self.energies = []

    def start(self):
        pass

    def stop(self):
        pass

    def evaluate(self, solver, labeling_m, cost_m, mode, index):
        self.energies.append(float(self.audit(solver.data, solver.cfg,
                                              labeling_m, cost_m, mode)[0]))


@pytest.fixture(scope="module")
def jax_solve():
    im, vol = _scene()
    js = jeng.LocalExpansionSolver(im, im, J_PARAMS.replace(**PARAMS),
                                   max_disp=float(ND - 1), vol0=vol,
                                   vol1=vol, seed=0)
    for i, s in enumerate(LAYERS):
        js.add_layer(s, jeng.LAYER0_PROPOSERS if i == 0
                     else jeng.COARSE_PROPOSERS)
    js.finalize()
    js.cfg = dataclasses.replace(js.cfg, gc_rounds=16, gc_sweeps=16)
    rec = _Recorder(jeng.energy_audit)
    js.set_evaluator(rec)
    js.run(iterations=1, view_modes=(0,), pm_iterations=1)
    return js, rec.energies


@pytest.mark.parametrize("route", ["auto", "dma"])
def test_bf_solve_matches_jax(jax_solve, route):
    js, want = jax_solve
    im, vol = _scene()
    ts = teng.LocalExpansionSolver(im, im, T_PARAMS.replace(**PARAMS),
                                   max_disp=float(ND - 1), vol0=vol,
                                   vol1=vol, seed=0, device="cpu",
                                   unary_backend=route)
    for i, s in enumerate(LAYERS):
        ts.add_layer(s, teng.LAYER0_PROPOSERS if i == 0
                     else teng.COARSE_PROPOSERS)
    ts.data, ts.cfg = ten.energy_from_numpy(js.data, js.cfg, device="cpu")
    rec = _Recorder(teng.energy_audit)
    ts.set_evaluator(rec)
    ts.run(iterations=1, pm_iterations=1)
    assert ts.cfg.params.filter_name == "BF"
    fsize = 3 * LAYERS[0] + 2 * ts.cfg.params.guided_radius
    assert ten.fused_unary(ts.cfg, "cpu", fsize) == (route == "dma")
    assert not ten.kernel_filters(ts.cfg, "cpu", fsize)
    got = rec.energies
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert abs(g - w) <= 0.002 * abs(w) + 1e-3, (got, want)
