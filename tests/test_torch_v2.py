"""The port's V2 (image-warp, "naive") energy and solve against the JAX
package, on the CPU.

The scene is ``synthetic.v2_scene(48, 64, 16)``: a textured left view and a
right view rendered from planted slanted planes with a depth test (real
occlusions), 16 disparities (max_disp 15). Every input is made from a numpy
seed; JAX and the port run in this process. Tolerances, each stated where
it is used:

- feature images: bitwise;
- raw warp costs: atol 1e-4 against the JAX function run op by op. Its
  jitted program rounds the plane's disparity with a fused multiply-add
  (XLA's ``fma(a, x, b*y) + c``); one ulp of d moves a sample by the
  image's gradient times that ulp. The port is held no further from the
  jitted program than the JAX function's two runs are apart (+ 1e-4);
- filtered unary windows: rtol 1e-5, atol 1e-4 (as the V3 unary);
- init states: labels and costs allclose at rtol/atol 1e-5. Not bitwise:
  the labels come from sin, cos and divisions, which XLA and torch round
  differently in the last ulp at some cells;
- energy trajectories: every row within 0.002·|E| + 1e-3, as the V3
  trajectories (``tests/test_torch_engine.py``).

Solves, 1 greedy + 1 graph-cut sweep each: both views, 2 layers
(``LAYER0_PROPOSERS``, then ``COARSE_PROPOSERS``: ROADMAP C3), then the
fusion of a labeling near the truth into each view and the post-process;
and one view with ``max_vdisp > 0`` on the vertical-disparity oracle's
pair (``tests/test_vdisparity.py``). The JAX side's min-cut knobs are set
to the port's (16, 16); its CPU defaults differ.
"""
import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from localexpstereo_tpu.config import PARAMS_GF as J_PARAMS
from localexpstereo_tpu.models import energy as jen
from localexpstereo_tpu.models import engine as jeng
from localexpstereo_tpu.ops import plane as jplane
from localexpstereo_tpu.ops import unary_warp as jwarp
from localexpstereo_tpu_torch.config import PARAMS_GF as T_PARAMS
from localexpstereo_tpu_torch.models import energy as ten
from localexpstereo_tpu_torch.models import engine as teng
from localexpstereo_tpu_torch.models import grid as tgrid
from localexpstereo_tpu_torch.ops import unary_warp as twarp
from localexpstereo_tpu_torch.utils import synthetic
from tests.test_vdisparity import D0, V0, _pair

torch.set_num_threads(1)

H, W, ND = 48, 64, 16
MAX_DISP = float(ND - 1)
LAYERS = [4, 8]
PM, GC = 1, 1
WARP = dict(th_col=J_PARAMS.th_col, th_grad=J_PARAMS.th_grad,
            alpha=J_PARAMS.alpha)


def _t(x):
    return torch.as_tensor(np.array(x))


def _close(got, want):
    return abs(got - want) <= 0.002 * abs(want) + 1e-3


@pytest.fixture(scope="module")
def images():
    im_l, im_r, disp, _ = synthetic.v2_scene(H, W, ND, seed=1)
    return im_l.astype(np.float32), im_r.astype(np.float32), disp


# ----------------------------------------------------------- the samplers --

def test_feature_image_bitwise(images):
    for im in images[:2]:
        for alpha in (0.9, 0.3):
            np.testing.assert_array_equal(
                twarp.build_feature_image(im, alpha),
                jwarp.build_feature_image(im, alpha))


def _windows(rng, n, f):
    """Windows crossing every border of the image, and planes of which
    some leave [0, max_disp] inside the window."""
    fox = rng.integers(-f, W, n).astype(np.int32)
    foy = rng.integers(-f, H, n).astype(np.int32)
    props = np.stack([rng.uniform(-0.4, 0.4, n), rng.uniform(-0.4, 0.4, n),
                      rng.uniform(-8.0, MAX_DISP + 8.0, n), np.zeros(n)],
                     -1).astype(np.float32)
    return fox, foy, props


def _feature_images(images, texture):
    """Both views' feature images, of the scene or of white noise (where
    the jitted JAX programs' rounding of d shows most)."""
    ims = images[:2]
    if texture == "noise":
        rng = np.random.default_rng(4)
        ims = [(rng.random((H, W, 3)) * 255).astype(np.float32)
               for _ in range(2)]
    return [jwarp.build_feature_image(im, J_PARAMS.alpha) for im in ims]


def _jax_both_ways(fn, *args):
    """A jitted JAX function, run op by op and as its jitted program."""
    with jax.disable_jit():
        eager = np.asarray(fn(*args))
    return eager, np.asarray(fn(*args))


def _held(got, eager, jitted):
    """The port against the JAX function op by op at atol 1e-4, and no
    further from its jitted program than the two JAX runs are apart."""
    np.testing.assert_allclose(got, eager, rtol=0, atol=1e-4)
    assert np.abs(got - jitted).max() <= np.abs(eager - jitted).max() + 1e-4


def _aligned_slabs(exi_self, exi_other, fox, foy, f, sign):
    """The sweeps' slabs as the JAX engine cuts them: windows of the
    zero-padded feature images at the window origin, the other view's
    ``m`` columns wider (``energy.dense_exi_slabs``)."""
    m = int(math.ceil(MAX_DISP)) + 1
    ep = f + m
    pad = ((ep, ep), (ep, ep), (0, 0))
    es, eo = np.pad(exi_self, pad), np.pad(exi_other, pad)
    back = m if sign > 0 else 0
    f_self = np.stack([es[y + ep:y + ep + f, x + ep:x + ep + f]
                       for x, y in zip(fox, foy)])
    f_other = np.stack([eo[y + ep:y + ep + f,
                           x + ep - back:x + ep - back + f + m]
                        for x, y in zip(fox, foy)])
    return jnp.asarray(f_self), jnp.asarray(f_other), m


@pytest.mark.parametrize("texture", ["scene", "noise"])
@pytest.mark.parametrize("mode", [0, 1])
def test_slab_sampler_matches_both_jax_forms(images, mode, texture):
    """The v = 0 sampler against the JAX package's init form
    (``sample_windows_slab``: window and slab clamped into the image) and
    its sweep form (``sample_exi_slabs_aligned``), each with its own slab
    origin. The two JAX forms disagree where a plane leaves the disparity
    range near the border, so the port must take each form's slab at its
    own call site: held here by requiring the wrong pairing to fail."""
    f = 25
    sign = 1.0 if mode == 0 else -1.0
    exi = _feature_images(images, texture)
    es, eo = exi[mode], exi[1 - mode]
    fox, foy, props = _windows(np.random.default_rng(mode), 160, f)
    want_init = _jax_both_ways(
        jwarp.sample_windows_slab, jnp.asarray(es), jnp.asarray(eo),
        jnp.asarray(props), jnp.asarray(fox), jnp.asarray(foy), f, sign,
        WARP["th_col"], WARP["th_grad"], WARP["alpha"], MAX_DISP)
    f_self, f_other, m = _aligned_slabs(es, eo, fox, foy, f, sign)
    sweep = jax.jit(functools.partial(jwarp.sample_exi_slabs_aligned,
                                      height=H, width=W, sign=sign, m=m,
                                      **WARP))
    want_sweep = _jax_both_ways(sweep, f_self, f_other, jnp.asarray(props),
                                jnp.asarray(fox), jnp.asarray(foy))

    fx, fy = _t(fox).long(), _t(foy).long()
    got = {}
    for clamped in (True, False):
        x0, ws = twarp.slab_origin(fx, f, W, MAX_DISP, sign, clamped)
        got[clamped] = twarp.sample_windows_slab(
            _t(es), _t(eo), _t(props), fx, fy, f, x0, ws, sign=sign,
            **WARP).numpy()
    _held(got[True], *want_init)
    _held(got[False], *want_sweep)

    # The trap: the forms differ by far more than rounding, and only
    # where the plane's disparity is outside [0, max_disp].
    a, b = want_init[0], want_sweep[0]
    assert np.abs(a - b).max() > 0.1
    assert np.abs(got[True] - b).max() > 0.1
    it = np.arange(f, dtype=np.float32)
    xs = fox[:, None, None] + it[None, None, :]
    ys = foy[:, None, None] + it[None, :, None]
    d = props[:, 0, None, None] * xs + props[:, 1, None, None] * ys \
        + props[:, 2, None, None]
    in_range = (d >= 0) & (d <= MAX_DISP)
    assert not (in_range & (np.abs(a - b) > 1e-4)).any()


@pytest.mark.parametrize("texture", ["scene", "noise"])
def test_gather_sampler_matches_jax(images, texture):
    """The bilinear gather (any v, border replicated in x and y) against
    JAX's ``sample_windows``, both views."""
    f = 21
    rng = np.random.default_rng(5)
    fox, foy, props = _windows(rng, 120, f)
    props[:, 3] = rng.uniform(-3.0, 3.0, props.shape[0])
    exi = _feature_images(images, texture)
    for mode, sign in ((0, 1.0), (1, -1.0)):
        want = _jax_both_ways(
            jwarp.sample_windows, jnp.asarray(exi[mode]),
            jnp.asarray(exi[1 - mode]), jnp.asarray(props),
            jnp.asarray(fox), jnp.asarray(foy), f, sign, WARP["th_col"],
            WARP["th_grad"], WARP["alpha"])
        got = twarp.sample_windows(_t(exi[mode]), _t(exi[1 - mode]),
                                   _t(props), _t(fox).long(),
                                   _t(foy).long(), f, sign=sign,
                                   **WARP).numpy()
        _held(got, *want)


def test_slab_origin_refuses_a_narrow_image():
    with pytest.raises(ValueError, match="narrower"):
        twarp.slab_origin(torch.zeros(1, dtype=torch.int64), 50, 60, 15.0,
                          1.0, clamped=True)


# ------------------------------------------------------------- the energy --

@pytest.fixture(scope="module")
def energy(images):
    """The JAX package's naive energy (windR 20) and the port's, built by
    each and carried across."""
    params = dict(windR=20)
    pad = tgrid.required_padding(LAYERS, 20)
    jdata, jcfg = jen.build_energy(images[0], images[1],
                                   J_PARAMS.replace(**params), MAX_DISP,
                                   pad, vol_pad=tgrid.required_volume_padding(
                                       W, H, LAYERS, 10))
    tdata, tcfg = ten.build_energy(images[0], images[1],
                                   T_PARAMS.replace(**params), MAX_DISP,
                                   pad, device="cpu")
    return jdata, jcfg, tdata, tcfg


def test_build_energy_naive(energy):
    jdata, jcfg, tdata, tcfg = energy
    assert jcfg.kind == tcfg.kind == "naive" and tdata.vol is None
    ep = jcfg.exi_pad
    np.testing.assert_array_equal(
        tdata.exi.numpy(), np.asarray(jdata.exi)[:, ep:ep + H, ep:ep + W])
    for k in ("guide", "gf_mean", "gf_inv"):
        np.testing.assert_array_equal(getattr(tdata, k).numpy(),
                                      np.asarray(getattr(jdata, k)))
    carried, ccfg = ten.energy_from_numpy(jdata, jcfg, device="cpu")
    assert ccfg == tcfg
    np.testing.assert_array_equal(carried.exi.numpy(), tdata.exi.numpy())
    assert not any(
        ten.fused_unary(dataclasses.replace(tcfg, unary_backend=route), dev,
                        62) for route in ("auto", "dma")
        for dev in ("cpu", "cuda"))


@pytest.mark.parametrize("s,mode,i0,j0", [(4, 0, 0, 0), (4, 1, 2, 3)])
def test_unary_windows_naive(energy, s, mode, i0, j0):
    """The filtered naive unary of one color step (the JAX engine's sweep
    form, its aligned feature slabs) and of the init's unit windows (its
    clamped form), rtol 1e-5 / atol 1e-4; one plane is invalid
    everywhere, one has a non-finite disparity."""
    jdata, jcfg, tdata, tcfg = energy
    layer = tgrid.build_layer(W, H, s)
    ox, oy, _ = layer.color_regions(i0, j0)
    cox, coy = layer.canvas_origin(i0, j0)
    nby, nbx, ss = layer.nby, layer.nbx, 3 * s
    rng = np.random.default_rng(10 * s + mode)
    n = ox.shape[0]
    props = np.stack([rng.uniform(-0.3, 0.3, n), rng.uniform(-0.3, 0.3, n),
                      rng.uniform(-4.0, MAX_DISP + 4.0, n), np.zeros(n)],
                     -1).astype(np.float32)
    props[0, :3] = [0.0, 0.0, 1e9]
    props[1, 2] = np.nan

    jstat = jen.dense_filter_windows(jdata, jcfg, mode, jnp.asarray(ox),
                                     jnp.asarray(oy), coy, cox, s, nby, nbx,
                                     -s, ss)
    slabs = jen.dense_exi_slabs(jdata, jcfg, mode, coy, cox, s, nby, nbx,
                                -s, ss)
    want = np.asarray(jen.unary_windows(
        jdata, jcfg, mode, jnp.asarray(props), jnp.asarray(ox),
        jnp.asarray(oy), -s, ss, stat_windows=jstat, exi_slabs=slabs))
    tstat = ten.dense_filter_windows(tdata, tcfg, mode, _t(ox).long(),
                                     _t(oy).long(), cox + s, coy + s, nby,
                                     nbx, 4 * s, -s, ss)
    got = ten.unary_windows(tdata, tcfg, mode, _t(props), _t(ox).long(),
                            _t(oy).long(), -s, ss, tstat,
                            clamp_slabs=False).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)

    # The init's unit windows: a stride-s grid from the origin.
    hb, wb = -(-H // s), -(-W // s)
    ux = np.tile(np.arange(wb) * s, hb).astype(np.int32)
    uy = np.repeat(np.arange(hb) * s, wb).astype(np.int32)
    uprops = np.resize(props, (ux.shape[0], 4))
    want = np.asarray(jen.unary_windows(
        jdata, jcfg, mode, jnp.asarray(uprops), jnp.asarray(ux),
        jnp.asarray(uy), 0, s))
    tstat = ten.dense_filter_windows(tdata, tcfg, mode, _t(ux).long(),
                                     _t(uy).long(), 0, 0, hb, wb, s, 0, s)
    got = ten.unary_windows(tdata, tcfg, mode, _t(uprops), _t(ux).long(),
                            _t(uy).long(), 0, s, tstat).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def test_naive_energy_has_no_fused_route(energy):
    _, _, tdata, tcfg = energy
    with pytest.raises(ValueError, match="no fused unary route"):
        ten.unary_windows(tdata, tcfg, 0, torch.zeros((1, 4)),
                          torch.zeros(1, dtype=torch.int64),
                          torch.zeros(1, dtype=torch.int64), 0, 4, None)


def test_bilateral_filter_refusal_cites_a12(energy):
    """A12's bilateral filter is ported: the naive unary under "BF" on the
    init's unit windows equals the JAX package's (rtol 1e-5 / atol 1e-4);
    only a call without the statistic windows the filter reads is
    refused."""
    jdata, jcfg, tdata, tcfg = energy
    jcfg = dataclasses.replace(jcfg, params=jcfg.params.replace(
        filter_name="BF", filter_param1=10.0))
    cfg = dataclasses.replace(tcfg, params=tcfg.params.replace(
        filter_name="BF", filter_param1=10.0))
    with pytest.raises(ValueError, match="no fused unary route"):
        ten.unary_windows(tdata, cfg, 0, torch.zeros((1, 4)),
                          torch.zeros(1, dtype=torch.int64),
                          torch.zeros(1, dtype=torch.int64), 0, 4, None)
    s = 8
    hb, wb = -(-H // s), -(-W // s)
    ux = np.tile(np.arange(wb) * s, hb).astype(np.int32)
    uy = np.repeat(np.arange(hb) * s, wb).astype(np.int32)
    rng = np.random.default_rng(5)
    props = np.stack([rng.uniform(-0.2, 0.2, ux.shape[0]),
                      rng.uniform(-0.2, 0.2, ux.shape[0]),
                      rng.uniform(0.0, MAX_DISP, ux.shape[0]),
                      np.zeros(ux.shape[0])], -1).astype(np.float32)
    want = np.asarray(jen.unary_windows(
        jdata, jcfg, 0, jnp.asarray(props), jnp.asarray(ux),
        jnp.asarray(uy), 0, s))
    tstat = ten.dense_filter_windows(tdata, cfg, 0, _t(ux).long(),
                                     _t(uy).long(), 0, 0, hb, wb, s, 0, s)
    got = ten.unary_windows(tdata, cfg, 0, _t(props), _t(ux).long(),
                            _t(uy).long(), 0, s, tstat).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


# -------------------------------------------------------------- the solves --

class _Recorder:
    """Evaluator hook: per view, the total energy and a copy of the state
    after the init and after every sweep."""

    def __init__(self, audit):
        self.audit = audit
        self.energies = {0: [], 1: []}
        self.states = {0: [], 1: []}

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
        pass


def _solve_both(im0, im1, *, layers, proposers, params, max_disp,
                max_vdisp=0.0, view_modes=(0,), fuse_with=None):
    """The JAX solve and the port's on the JAX side's energy, seed 0,
    1 greedy + 1 graph-cut sweep."""
    js = jeng.LocalExpansionSolver(im0, im1, J_PARAMS.replace(**params),
                                   max_disp=max_disp, max_vdisp=max_vdisp,
                                   seed=0)
    ts = teng.LocalExpansionSolver(im0, im1, T_PARAMS.replace(**params),
                                   max_disp=max_disp, max_vdisp=max_vdisp,
                                   seed=0, device="cpu")
    for solver, eng in ((js, jeng), (ts, teng)):
        for s, names in zip(layers, proposers):
            solver.add_layer(s, getattr(eng, names))
    js.finalize()
    js.cfg = dataclasses.replace(js.cfg, gc_rounds=16, gc_sweeps=16)
    ts.data, ts.cfg = ten.energy_from_numpy(js.data, js.cfg, device="cpu")
    recs = []
    for solver, audit in ((js, jeng.energy_audit), (ts, teng.energy_audit)):
        rec = _Recorder(audit)
        solver.set_evaluator(rec)
        solver.run(iterations=GC, view_modes=view_modes, pm_iterations=PM,
                   fuse_with=fuse_with)
        recs.append(rec)
    return js, ts, recs[0], recs[1]


PROPOSERS = ("LAYER0_PROPOSERS", "COARSE_PROPOSERS")


@pytest.fixture(scope="module")
def dual(images):
    """Both views, 2 layers, then the fusion of a labeling per view near
    the truth (fronto-parallel: the left view's truth plus noise, and its
    right-view counterpart), then the post-process."""
    rng = np.random.default_rng(2)
    ext = {}
    for mode in (0, 1):
        lab = np.zeros((H, W, 4), np.float32)
        lab[..., 2] = images[2] + rng.normal(0.0, 0.3, (H, W))
        ext[mode] = lab
    return _solve_both(*images[:2], layers=LAYERS, proposers=PROPOSERS,
                       params=dict(windR=20), max_disp=MAX_DISP,
                       view_modes=(0, 1), fuse_with=[ext])


@pytest.fixture(scope="module")
def vdisp():
    """One view, max_vdisp 3, on the oracle's pair (im1 is im0 shifted by
    (D0, V0)), one layer, windR 6."""
    im0, im1 = _pair()
    return _solve_both(im0, im1, layers=[6], proposers=PROPOSERS[:1],
                       params=dict(windR=6, lambda_=0.5), max_disp=8.0,
                       max_vdisp=3.0)


def _init_states_match(jrec, trec, modes):
    for mode in modes:
        (jl, jc), (tl, tc) = jrec.states[mode][0], trec.states[mode][0]
        np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(tc, jc, rtol=1e-5, atol=1e-5)


def _trajectories_match(jrec, trec, modes, rows):
    for mode in modes:
        je, te = jrec.energies[mode], trec.energies[mode]
        assert len(je) == len(te) == rows, (mode, te, je)
        for got, want in zip(te, je):
            assert _close(got, want), (mode, te, je)


def test_dual_init_states_match(dual):
    _init_states_match(dual[2], dual[3], (0, 1))


@pytest.mark.parametrize("mode", [0, 1])
def test_dual_two_layer_fused_trajectories_match(dual, mode):
    """Each view's init, greedy and graph-cut rows (2 layers), and the
    last row, after the fusion and the post-process."""
    _trajectories_match(dual[2], dual[3], (mode,), 1 + PM + GC + 1)


def test_dual_disparities_match(dual):
    """Both views' final disparities (fused, post-processed) within 0.5 px
    of the JAX solve's at 99 % of the pixels or more (near-tie accepts may
    flip a few)."""
    js, ts = dual[0], dual[1]
    for mode in (0, 1):
        got = ts.disparity_map(mode).numpy()
        want = np.asarray(jplane.disparity_map(jnp.asarray(
            js._unpadded_labeling(js._state, mode))))
        assert np.isfinite(got).all()
        assert (np.abs(got - want) < 0.5).mean() >= 0.99


def test_vdisp_init_state_matches(vdisp):
    _init_states_match(vdisp[2], vdisp[3], (0,))
    lab = vdisp[3].states[0][0][0]
    assert (lab[..., 3] != 0).any() and np.abs(lab[..., 3]).max() <= 3.0


def test_vdisp_one_view_trajectory_matches(vdisp):
    _trajectories_match(vdisp[2], vdisp[3], (0,), 1 + PM + GC)


def test_vdisp_oracle_on_the_port():
    """``tests/test_vdisparity.py``'s oracle on the port's gather sampler:
    at the true (d, v) the warp cost is near zero and well below the cost
    at v = 0, at -v and half a pixel off; each cost within 1e-4 of the
    JAX sampler's."""
    im0, im1 = _pair()
    alpha = J_PARAMS.alpha
    exi0 = twarp.build_feature_image(im0, alpha)
    exi1 = twarp.build_feature_image(im1, alpha)
    ox, oy = np.asarray([20], np.int32), np.asarray([12], np.int32)

    def cost_at(d, v):
        props = np.asarray([[0.0, 0.0, d, v]], np.float32)
        got = twarp.sample_windows(_t(exi0), _t(exi1), _t(props),
                                   _t(ox).long(), _t(oy).long(), 16,
                                   sign=1.0, **WARP).numpy()
        want = np.asarray(jwarp.sample_windows(
            jnp.asarray(exi0), jnp.asarray(exi1), jnp.asarray(props),
            jnp.asarray(ox), jnp.asarray(oy), 16, 1.0, WARP["th_col"],
            WARP["th_grad"], alpha))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
        return float(got.mean())

    c_true = cost_at(D0, V0)
    assert c_true < 1e-3
    assert c_true < 0.2 * cost_at(D0, 0.0)
    assert c_true < 0.2 * cost_at(D0, -V0)
    assert c_true < cost_at(D0, V0 + 0.5)
