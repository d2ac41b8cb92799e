"""The port's d-interpolation methods against the JAX package's.

``unary_volume.sample_windows`` (methods 0 nearest, 1 linear, 2 quadratic)
is held against the JAX package's gather on the same float32 and uint8
volumes (the port's padded by ``vol_pad``), with planes inside, below,
above and across the disparity range and non-finite planes; the energy's
unary on the method route against the JAX ``unary_windows``; and a
2-layer solve (1 greedy + 1 graph-cut sweep) with ``interp`` 0 and 2
against the JAX engine with the same ``interp`` and min-cut knobs (16,
16), the energy trajectory within 0.002·|E| + 1e-3 per row.

The quadratic's degenerate taps at the volume's ends (d within half a
disparity of either end) give NaN unaries on both sides, which the
reference's range branches do not catch; their pixels keep a NaN cost
through the solve, so an interp 2 solve's energy is NaN. There the test
holds the NaN pixels' count equal and the energy of the finite pixels
(NaN costs counted as 0) within the trajectory tolerance.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from localexpstereo_tpu.config import PARAMS_GF as J_PARAMS
from localexpstereo_tpu.models import energy as jen
from localexpstereo_tpu.models import engine as jeng
from localexpstereo_tpu.models import grid as jgrid
from localexpstereo_tpu.ops import unary_volume as juv
from localexpstereo_tpu_torch.config import PARAMS_GF as T_PARAMS
from localexpstereo_tpu_torch.models import energy as ten
from localexpstereo_tpu_torch.models import engine as teng
from localexpstereo_tpu_torch.models import grid as tgrid
from localexpstereo_tpu_torch.ops import unary_volume as tuv
from localexpstereo_tpu_torch.parallel.replica import ReplicaSolver

torch.set_num_threads(1)

D, H, W, F, VP = 12, 20, 24, 9, 3


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _planes(rng, n=48):
    props = np.zeros((n, 4), np.float32)
    props[:, 0] = rng.uniform(-0.4, 0.4, n)
    props[:, 1] = rng.uniform(-0.4, 0.4, n)
    props[:, 2] = rng.uniform(-4.0, D + 3.0, n)
    special = [[0, 0, np.nan], [0, 0, np.inf], [0, 0, -np.inf],
               [0, 0, 0.2], [0, 0, -0.4], [0, 0, -2.0],      # low end
               [0, 0, D - 1.2], [0, 0, D - 0.6], [0, 0, D + 2.0],  # high
               [2.0, 0, -6.0], [-2.0, 0.5, D + 4.0]]   # across both ends
    props[:len(special), :3] = special
    return props


@pytest.mark.parametrize("dtype", ["float32", "uint8"])
@pytest.mark.parametrize("method", [0, 1, 2])
def test_sample_windows_matches_jax(dtype, method):
    rng = np.random.default_rng(10 + method)
    if dtype == "uint8":
        vol = (rng.random((D, H, W)) * 255).astype(np.uint8)
        scale, zero = 2.0 / 255.0, -0.1
    else:
        vol = rng.uniform(0, 1.5, (D, H, W)).astype(np.float32)
        scale, zero = 1.0, 0.0
    props = _planes(rng)
    ox = rng.integers(-6, W, len(props)).astype(np.int32)
    oy = rng.integers(-6, H, len(props)).astype(np.int32)
    want = np.asarray(juv.sample_windows(
        jnp.asarray(vol), jnp.asarray(props), jnp.asarray(ox),
        jnp.asarray(oy), F, 0.0, D - 1.0, 0.8, method, scale=scale,
        zero=zero))
    vpad = np.zeros((D, H + 2 * VP, W + 2 * VP), vol.dtype)
    vpad[:, VP:VP + H, VP:VP + W] = vol
    got = tuv.sample_windows(
        _t(vpad), VP, _t(props), _t(ox).long(), _t(oy).long(), F, H, W,
        min_disp=0.0, max_disp=D - 1.0, th_col=0.8, method=method,
        scale=scale, zero=zero).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    if method == 2:
        assert np.isnan(want).any()      # the degenerate taps were reached


def test_sample_windows_rejects_unknown_method():
    with pytest.raises(ValueError, match="interpolation method 3"):
        tuv.sample_windows(torch.zeros((2, 4, 4)), 0, torch.zeros((1, 4)),
                           torch.zeros(1, dtype=torch.int64),
                           torch.zeros(1, dtype=torch.int64), 2, 4, 4,
                           min_disp=0.0, max_disp=1.0, th_col=1.0, method=3)


@pytest.mark.parametrize("interp", [0, 2])
def test_unary_windows_method_route_matches_jax(interp):
    """The energy's unary of one color step with ``interp`` 0 / 2 on the
    JAX energy: the method sampler, then the guided filter."""
    h, w, nd, layers = 40, 64, 12, [4, 8]
    rng = np.random.default_rng(4)
    img = (rng.random((h, w, 3)) * 255).astype(np.float32)
    vol = rng.uniform(0, 1.2, (nd, h, w)).astype(np.float32)
    params = J_PARAMS.replace(windR=6, lambda_=0.5, th_col=0.5)
    pad = jgrid.required_padding(layers, params.windR)
    vp = jgrid.required_volume_padding(w, h, layers, params.guided_radius)
    jdata, jcfg = jen.build_energy(img, img, params, nd - 1.0, pad,
                                   vol0=vol, vol1=vol, vol_pad=vp,
                                   interp=interp)
    tdata, tcfg = ten.energy_from_numpy(jdata, jcfg, device="cpu")
    assert tcfg.interp == interp and not any(
        ten.fused_unary(dataclasses.replace(tcfg, unary_backend=route), dev,
                        3 * 4 + 2 * params.guided_radius)
        for route in ("auto", "dma") for dev in ("cpu", "cuda"))
    s = 4
    layer = tgrid.build_layer(w, h, s)
    ox, oy, _ = layer.color_regions(1, 2)
    cox, coy = layer.canvas_origin(1, 2)
    props = np.zeros((len(ox), 4), np.float32)
    props[:, 0] = rng.uniform(-0.1, 0.1, len(ox))
    props[:, 1] = rng.uniform(-0.1, 0.1, len(ox))
    props[:, 2] = rng.uniform(0, nd - 1, len(ox))
    jstat = jen.dense_filter_windows(jdata, jcfg, 0, jnp.asarray(ox),
                                     jnp.asarray(oy), coy, cox, s,
                                     layer.nby, layer.nbx, -s, 3 * s)
    want = np.asarray(jen.unary_windows(
        jdata, jcfg, 0, jnp.asarray(props), jnp.asarray(ox),
        jnp.asarray(oy), -s, 3 * s, stat_windows=jstat))
    tstat = ten.dense_filter_windows(tdata, tcfg, 0, _t(ox).long(),
                                     _t(oy).long(), cox + s, coy + s,
                                     layer.nby, layer.nbx, 4 * s, -s, 3 * s)
    got = ten.unary_windows(tdata, tcfg, 0, _t(props), _t(ox).long(),
                            _t(oy).long(), -s, 3 * s, tstat,
                            kernel=True).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


# -------------------------------------------------------------- the solves --

SH, SW, SND = 32, 64, 16
LAYERS = [4, 8]
PARAMS = dict(lambda_=0.5, th_col=0.5, windR=20)


def _scene():
    r = np.random.default_rng(7)
    im = (r.random((SH, SW, 3)) * 255).astype(np.uint8).astype(np.float32)
    xs, ys = np.meshgrid(np.arange(SW, dtype=np.float32),
                         np.arange(SH, dtype=np.float32))
    truth = np.clip(0.04 * xs + 0.03 * ys + 3.0, 1, SND - 2)
    d = np.arange(SND, dtype=np.float32)[:, None, None]
    vol = np.minimum((d - truth[None]) ** 2 * 0.2, 1.0).astype(np.float32)
    vol += (r.random(vol.shape) * 0.02).astype(np.float32)
    return im, vol


class _Recorder:
    """Evaluator hook: view 0's state after the init and every sweep."""

    def __init__(self):
        self.states = []

    def start(self):
        pass

    def stop(self):
        pass

    def evaluate(self, solver, labeling_m, cost_m, mode, index):
        self.states.append((np.array(labeling_m), np.array(cost_m)))


@pytest.fixture(scope="module", params=[0, 2])
def solves(request):
    interp = request.param
    im, vol = _scene()
    js = jeng.LocalExpansionSolver(im, im, J_PARAMS.replace(**PARAMS),
                                   max_disp=float(SND - 1), vol0=vol,
                                   vol1=vol, seed=0, interp=interp)
    for i, s in enumerate(LAYERS):
        js.add_layer(s, jeng.LAYER0_PROPOSERS if i == 0
                     else jeng.COARSE_PROPOSERS)
    js.finalize()
    js.cfg = dataclasses.replace(js.cfg, gc_rounds=16, gc_sweeps=16)
    jrec = _Recorder()
    js.set_evaluator(jrec)
    js.run(iterations=1, view_modes=(0,), pm_iterations=1)

    ts = teng.LocalExpansionSolver(im, im, T_PARAMS.replace(**PARAMS),
                                   max_disp=float(SND - 1), vol0=vol,
                                   vol1=vol, seed=0, device="cpu",
                                   interp=interp)
    for i, s in enumerate(LAYERS):
        ts.add_layer(s, teng.LAYER0_PROPOSERS if i == 0
                     else teng.COARSE_PROPOSERS)
    ts.data, ts.cfg = ten.energy_from_numpy(js.data, js.cfg, device="cpu")
    trec = _Recorder()
    ts.set_evaluator(trec)
    ts.run(iterations=1, pm_iterations=1)
    assert ts.cfg.interp == interp
    return interp, ts, jrec, trec


def _energy(ts, labeling_m, cost_m):
    """(total energy with NaN costs counted as 0, NaN pixels)."""
    nan = np.isnan(cost_m)
    total = teng.energy_audit(ts.data, ts.cfg, torch.from_numpy(labeling_m),
                              torch.from_numpy(np.where(nan, 0, cost_m)),
                              0)[0]
    return float(total), int(nan.sum())


def test_interp_solve_matches_jax(solves):
    interp, ts, jrec, trec = solves
    assert len(jrec.states) == len(trec.states) == 3
    for (jl, jc), (tl, tc) in zip(jrec.states, trec.states):
        want, want_nan = _energy(ts, jl, jc)
        got, got_nan = _energy(ts, tl, tc)
        assert got_nan == want_nan
        assert (got_nan > 0) == (interp == 2)
        assert abs(got - want) <= 0.002 * abs(want) + 1e-3, (got, want)


def test_dma_route_refuses_other_methods():
    im, vol = _scene()
    for interp in (0, 2):
        with pytest.raises(ValueError, match="samples linearly only"):
            teng.LocalExpansionSolver(im, im, T_PARAMS, float(SND - 1),
                                      vol0=vol, vol1=vol, device="cpu",
                                      unary_backend="dma", interp=interp)
        with pytest.raises(ValueError, match="samples linearly only"):
            ReplicaSolver([im], [im], T_PARAMS, float(SND - 1), [4],
                          devices=["cpu"], vols0=[vol], vols1=[vol],
                          unary_backend="dma", interp=interp)
    with pytest.raises(ValueError, match="interp 3"):
        teng.LocalExpansionSolver(im, im, T_PARAMS, float(SND - 1),
                                  vol0=vol, vol1=vol, device="cpu", interp=3)
