"""The port's serving path against the JAX package's: the device-side
statistics and energy build, the "cell" warm start, ``update_frame`` and
``StereoStream`` (``serving.py``).

Scenes are built in the test: a random image and a quadratic-basin volume
around a planted slanted plane (with noise, so that no accept is a tie),
panned by 2 px a frame. The JAX side's min-cut knobs are set to the port's
(16, 16); its CPU defaults differ. Tolerances are stated at each test; the
trajectory tolerance is 0.002·|E| + 1e-3 per frame, and a disparity map
agrees where 99 % of its pixels are within 0.5 px.
"""
import dataclasses
import typing

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from localexpstereo_tpu.config import PARAMS_GF as J_PARAMS
from localexpstereo_tpu.models import energy as jenergy
from localexpstereo_tpu.models import engine as jeng
from localexpstereo_tpu.models import mccnn as jmccnn
from localexpstereo_tpu.ops import guided as jguided
from localexpstereo_tpu.ops import unary_warp as jwarp
from localexpstereo_tpu.serving import StereoStream as JStream
from localexpstereo_tpu_torch.config import PARAMS_GF as T_PARAMS
from localexpstereo_tpu_torch.models import energy as tenergy
from localexpstereo_tpu_torch.models import engine as teng
from localexpstereo_tpu_torch.models import mccnn
from localexpstereo_tpu_torch.ops import guided, rng
from localexpstereo_tpu_torch.serving import StereoStream

torch.set_num_threads(1)

PARAMS = dict(windR=6, lambda_=0.5, th_col=0.5)
ND = 12
FRAMES = 3


def _pan_scene(h, w, nd=ND, frames=FRAMES, seed=7, slope=(0.04, 0.03)):
    """(image, volume, truth) of each frame: columns [2k, 2k + w) of one
    wider scene."""
    r = np.random.default_rng(seed)
    wide = w + 2 * (frames - 1)
    im = (r.random((h, wide, 3)) * 255).astype(np.uint8).astype(np.float32)
    xs, ys = np.meshgrid(np.arange(wide, dtype=np.float32),
                         np.arange(h, dtype=np.float32))
    truth = np.clip(slope[0] * xs + slope[1] * ys + 3.0, 1, nd - 2)
    d = np.arange(nd, dtype=np.float32)[:, None, None]
    vol = np.minimum((d - truth[None]) ** 2 * 0.2, 1.0).astype(np.float32)
    vol += (r.random(vol.shape) * 0.02).astype(np.float32)
    return [(im[:, 2 * k:2 * k + w], vol[:, :, 2 * k:2 * k + w],
             truth[:, 2 * k:2 * k + w].astype(np.float32))
            for k in range(frames)]


def _close(got, want):
    return abs(got - want) <= 0.002 * abs(want) + 1e-3


# ---------------------------------------------------- statistics, energy ---

def _stat_image():
    r = np.random.default_rng(1)
    im = (r.random((30, 41, 3)) * 255).astype(np.uint8).astype(np.float32)
    im[5:15, 5:20] = 100.0       # flat: the variance sits at eps
    im[18:28, 22:40, 1] = 40.0   # one flat channel
    return im


def test_device_stats_match_jax_host_stats():
    """Float64 on the device against the JAX package's float64 host path:
    rtol 1e-5, atol 1e-6 (the two differ only in the order of rounding;
    equal here)."""
    im = _stat_image()
    got = guided.compute_stats_device(torch.from_numpy(im), 10, 1e-4)
    want = jguided.compute_stats(im, 10, 1e-4)
    for k in ("guide", "mean", "inv"):
        assert getattr(got, k).dtype == torch.float32
        np.testing.assert_allclose(getattr(got, k).numpy(),
                                   np.nan_to_num(np.asarray(getattr(want, k))),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


def test_device_stats_match_jax_device_stats():
    """Against the JAX package's float32 device path: guide and mean within
    1e-6; inv, where the JAX path's E[x^2] - mean^2 cancels near eps,
    within 2 % of its value plus 1e-4 of its largest (measured 0.64 %)."""
    im = _stat_image()
    got = guided.compute_stats_device(torch.from_numpy(im), 10, 1e-4)
    want = jguided.compute_stats_device(jnp.asarray(im), 10, 1e-4)
    for k in ("guide", "mean"):
        np.testing.assert_allclose(getattr(got, k).numpy(),
                                   np.asarray(getattr(want, k)), rtol=0,
                                   atol=1e-6, err_msg=k)
    inv = np.asarray(want.inv)
    np.testing.assert_allclose(got.inv.numpy(), inv, rtol=2e-2,
                               atol=1e-4 * np.abs(inv).max())


def _mccnn_volumes(h=24, w=40, nd=8):
    r = np.random.default_rng(2)
    im0, im1 = [(r.random((h, w, 3)) * 255).astype(np.float32)
                for _ in range(2)]
    params = mccnn.load_default_params()
    vol_t = mccnn.cost_volume(mccnn.params_from_jax(params), im0, im1, nd)
    vol_j = np.asarray(jmccnn.cost_volume(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(im0),
        jnp.asarray(im1), ndisp=nd))
    return im0, im1, vol_t, vol_j


def test_device_energy_matches_jax_device_build():
    """build_energy(stats_backend="device") against the JAX package's
    _build_energy_device, each on its own MC-CNN volume of one pair: the
    same static uint8 range, codes equal except at rounding ties (where
    the two volumes, 5e-7 apart, straddle a half step: at most one code,
    and only within 1e-3 of a tie), the statistics within the JAX device
    path's tolerance, the pairwise weights within 1e-6."""
    im0, im1, vol_t, vol_j = _mccnn_volumes()
    jd, jc = jenergy.build_energy(im0, im1, J_PARAMS.replace(**PARAMS), 7.0,
                                  8, vol0=vol_j, vol1=vol_j, vol_pad=5,
                                  vol_dtype="uint8", stats_backend="device")
    td, tc = tenergy.build_energy(im0, im1, T_PARAMS.replace(**PARAMS), 7.0,
                                  8, vol_t, vol_t, vol_pad=5, device="cpu",
                                  stats_backend="device")
    for field in ("kind", "width", "height", "pad", "vol_pad", "vol_scale",
                  "vol_zero", "min_disp", "max_disp", "max_vdisp"):
        assert getattr(tc, field) == getattr(jc, field), field
    assert tc.vol_scale == 2 * 0.5 / 255 and tc.vol_zero == 0.0
    assert td.vol.dtype == torch.uint8
    got = td.vol.numpy().astype(np.int32)
    want = np.asarray(jd.vol)[:, :, :got.shape[2], :got.shape[3]].astype(
        np.int32)
    differ = got != want
    assert np.abs(got - want).max() <= 1
    steps = np.pad(np.stack([vol_j, vol_j]) / tc.vol_scale,
                   ((0, 0), (0, 0), (5, 5), (5, 5)))
    assert (np.abs(steps - np.floor(steps) - 0.5)[differ] < 1e-3).all()
    assert differ.mean() < 1e-3
    np.testing.assert_allclose(td.coeff8.numpy(), np.asarray(jd.coeff8),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(td.gf_mean.numpy(), np.asarray(jd.gf_mean),
                               rtol=0, atol=1e-6)
    inv = np.asarray(jd.gf_inv)
    np.testing.assert_allclose(td.gf_inv.numpy(), inv, rtol=2e-2,
                               atol=1e-4 * np.abs(inv).max())


def test_device_energy_equals_host_energy_but_for_the_range():
    """The port's one build under the JAX package's two names: the
    statistics, the pairwise weights and the feature images of the naive
    kind are the same whether the inputs are arrays or tensors (and the
    feature image equals JAX's); only the volume's uint8 range differs,
    static with "device", data-dependent with "host"."""
    im0, im1, vol_t, _ = _mccnn_volumes()
    p = T_PARAMS.replace(**PARAMS)
    hd, hc = tenergy.build_energy(im0, im1, p, 7.0, 8, vol_t.numpy(),
                                  vol_t.numpy(), vol_pad=5, device="cpu")
    dd, dc = tenergy.build_energy(torch.from_numpy(im0), im1, p, 7.0, 8,
                                  vol_t, vol_t, vol_pad=5, device="cpu",
                                  stats_backend="device")
    for k in ("guide", "gf_mean", "gf_inv", "coeff8"):
        assert torch.equal(getattr(hd, k), getattr(dd, k)), k
    assert hc.vol_zero == min(0.0, float(vol_t.min()))
    assert dc.vol_zero == 0.0
    hd, hc = tenergy.build_energy(im0, im1, p, 7.0, 8, device="cpu")
    dd, dc = tenergy.build_energy(im0, im1, p, 7.0, 8, device="cpu",
                                  stats_backend="device")
    assert hc.kind == dc.kind == "naive"
    assert torch.equal(hd.exi, dd.exi)
    np.testing.assert_array_equal(
        dd.exi[0].numpy(), np.asarray(jwarp.build_feature_image(
            im0, p.alpha)))
    with pytest.raises(ValueError, match="stats_backend"):
        tenergy.build_energy(im0, im1, p, 7.0, 8, device="cpu",
                             stats_backend="gpu")


# ------------------------------------------------------- warm start -------

def test_cell_init_matches_jax():
    """init_step with a seed labeling: labels bitwise equal to the JAX
    package's (they are gathered, no arithmetic), costs within 1e-5 (the
    port runs on the JAX energy, carried across)."""
    (im, vol, truth), = _pan_scene(32, 48, frames=1)
    js = jeng.LocalExpansionSolver(im, im, J_PARAMS.replace(**PARAMS),
                                   max_disp=float(ND - 1), vol0=vol,
                                   vol1=vol, seed=0)
    js.add_layer(4, jeng.LAYER0_PROPOSERS)
    js.finalize()
    data, cfg = tenergy.energy_from_numpy(js.data, js.cfg, device="cpu")
    p = cfg.pad
    r = np.random.default_rng(3)
    lab = np.zeros((32 + 2 * p, 48 + 2 * p, 4), np.float32)
    lab[p:p + 32, p:p + 48] = r.normal(size=(32, 48, 4)).astype(np.float32)
    lab[p:p + 32, p:p + 48, 2] = truth + r.uniform(-0.5, 0.5, truth.shape)
    for mode in (0, 1):
        jl, jc = jeng.init_step(js.data, js.cfg,
                                jax.random.fold_in(jax.random.PRNGKey(5),
                                                   1000 + mode),
                                unit_size=4, mode=mode,
                                seed_labeling_m=jnp.asarray(lab))
        tl, tc = teng.init_step(data, cfg,
                                rng.fold_in(rng.PRNGKey(5), 1000 + mode),
                                unit_size=4, mode=mode,
                                seed_labeling_m=torch.from_numpy(lab))
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5,
                                   atol=1e-5)


def _solver(frame, seed, **kw):
    im, vol, _ = frame
    s = teng.LocalExpansionSolver(im, im, T_PARAMS.replace(**PARAMS),
                                  max_disp=float(ND - 1), vol0=vol,
                                  vol1=vol, seed=seed, device="cpu", **kw)
    s.add_layer(4, ("expansion", "ransac"))
    return s


def test_update_frame_equals_a_fresh_solver():
    """update_frame on a solved solver, then a run, is bitwise the run of a
    fresh solver on the new frame (the port's counterpart of
    tests/test_serving.py::test_update_frame_matches_fresh_solver), also
    when the frame comes as tensors; the image and volume attributes
    follow the frame."""
    frame_a, = _pan_scene(24, 40, frames=1, seed=4)
    frame_b, = _pan_scene(24, 40, frames=1, seed=5, slope=(0.02, -0.03))
    fresh = _solver(frame_b, 9, stats_backend="device")
    lab_fresh, _ = fresh.run(iterations=1, pm_iterations=1)

    upd = _solver(frame_a, 0, stats_backend="device")
    upd.run(iterations=1)
    cfg = upd.cfg
    im, vol, _ = frame_b
    upd.update_frame(torch.from_numpy(im), torch.from_numpy(im),
                     torch.from_numpy(vol), torch.from_numpy(vol), seed=9)
    assert upd.cfg == cfg and upd.seed == 9
    assert upd.vol0 is not None and torch.equal(upd.im0,
                                                torch.from_numpy(im))
    lab_upd, _ = upd.run(iterations=1, pm_iterations=1)
    assert torch.equal(lab_upd, lab_fresh)


def test_update_frame_checks_its_frame():
    frame, = _pan_scene(24, 40, frames=1)
    im, vol, _ = frame
    host = _solver(frame, 0)
    host.finalize()
    with pytest.raises(ValueError, match="stats_backend='device'"):
        host.update_frame(im, im, vol, vol)
    dev = _solver(frame, 0, stats_backend="device")
    with pytest.raises(RuntimeError, match="finalize"):
        dev.update_frame(im, im, vol, vol)
    dev.finalize()
    with pytest.raises(ValueError, match="geometry"):
        dev.update_frame(im[:-1], im[:-1], vol[:, :-1], vol[:, :-1])
    with pytest.raises(ValueError, match="geometry"):
        dev.update_frame(im, im, vol[:-1], vol[:-1])
    with pytest.raises(ValueError, match="configuration"):
        dev.update_frame(im, im)


# ------------------------------------------------------------ streams -----

STREAM_H, STREAM_W = 64, 96
#: The JAX comparison's stream: the reference proposer sets.
STREAM_KW = dict(max_disp=float(ND - 1), unit_sizes=[4, 8],
                 cold_iterations=1, cold_pm_iterations=1, warm_iterations=1)
#: The port-only streams: fewer proposal steps, for the CPU's time.
SMALL_KW = dict(max_disp=float(ND - 1), unit_sizes=[4, 8],
                layer_proposers=[("expansion", "random7"), ("expansion",)],
                cold_iterations=1, cold_pm_iterations=1, warm_iterations=1)


class _Frames:
    """A stream's outputs and, after each frame, its solver's energy."""

    def __init__(self):
        self.disps, self.energies = [], []


@pytest.fixture(scope="module")
def streams():
    """The 64 x 96 pan, 3 frames, through the JAX stream and the port's
    (sync, on the CPU), layers [4, 8]: a cold frame of 1 greedy + 1
    graph-cut sweep, then 1 warm graph-cut sweep a frame."""
    frames = _pan_scene(STREAM_H, STREAM_W)
    out = {"frames": frames}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jeng.LocalExpansionSolver, "_apply_cfg_overrides",
                   lambda self, cfg: dataclasses.replace(
                       cfg, gc_rounds=16, gc_sweeps=16))
        js = JStream(J_PARAMS.replace(**PARAMS), **STREAM_KW)
        rec = out["jax"] = _Frames()
        for im, vol, _ in frames:
            rec.disps.append(js.process(im, im, vol, vol))
            rec.energies.append(float(jeng.energy_audit(
                js._solver.data, js._solver.cfg, *js._solver._state[0],
                0)[0]))
    ts = StereoStream(T_PARAMS.replace(**PARAMS), device="cpu", **STREAM_KW)
    rec = out["port"] = _Frames()
    for im, vol, _ in frames:
        rec.disps.append(ts.process(im, im, vol, vol))
        rec.energies.append(float(teng.energy_audit(
            ts.solver.data, ts.solver.cfg, *ts.solver._state[0], 0)[0]))
    out["stream"] = ts
    return out


def test_stream_matches_jax(streams):
    """Each frame's energy within the trajectory tolerance of the JAX
    stream's, each disparity map within 0.5 px of its at 99 % of the
    pixels; the warm frames keep the cold frame's accuracy."""
    jr, tr = streams["jax"], streams["port"]
    for got, want in zip(tr.energies, jr.energies):
        assert _close(got, want), (tr.energies, jr.energies)
    for got, want, (_, _, truth) in zip(tr.disps, jr.disps,
                                        streams["frames"]):
        assert got.dtype == np.float32 and got.shape == truth.shape
        assert np.isfinite(got).all()
        assert (np.abs(got - want) < 0.5).mean() >= 0.99
    bad = [float((np.abs(d - t) > 1.0).mean())
           for d, (_, _, t) in zip(tr.disps, streams["frames"])]
    assert max(bad[1:]) <= bad[0] + 0.02, bad
    assert streams["stream"].frame_index == FRAMES


def test_pipelined_stream_equals_sync():
    """pipelined=True returns None first and frame i - 1's map at frame
    i, bitwise the sync stream's; flush() drains the last and then has
    nothing. process() is annotated Optional[np.ndarray]."""
    frames = _pan_scene(24, 40)
    kw = dict(SMALL_KW, unit_sizes=[8], layer_proposers=[("expansion",)])
    sync, pipe = (StereoStream(T_PARAMS.replace(**PARAMS), device="cpu",
                               pipelined=p, **kw) for p in (False, True))
    sync = [sync.process(im, im, vol, vol) for im, vol, _ in frames]
    outs = [pipe.process(im, im, vol, vol) for im, vol, _ in frames]
    assert outs[0] is None
    for got, want in zip(outs[1:], sync):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(pipe.flush(), sync[-1])
    assert pipe.flush() is None
    hints = typing.get_type_hints(StereoStream.process)
    assert hints["return"] == typing.Optional[np.ndarray]


def test_reset_returns_the_frame_in_flight():
    """reset() hands back the pipelined frame still in flight (it used to
    drop it) and drops the warm start: the next frame is cold, and its map
    is pending again. Without a frame in flight reset() returns None."""
    (im, vol, truth), = _pan_scene(24, 40, frames=1)
    kw = dict(max_disp=float(ND - 1), unit_sizes=[4],
              layer_proposers=[("expansion",)], cold_iterations=1,
              cold_pm_iterations=0, warm_iterations=1)
    sync = StereoStream(T_PARAMS.replace(**PARAMS), device="cpu", **kw)
    want = sync.process(im, im, vol, vol)
    assert sync.reset() is None
    pipe = StereoStream(T_PARAMS.replace(**PARAMS), device="cpu",
                        pipelined=True, **kw)
    assert pipe.process(im, im, vol, vol) is None
    np.testing.assert_array_equal(pipe.reset(), want)
    assert pipe.flush() is None and pipe.reset() is None
    assert pipe.process(im, im, vol, vol) is None
    last = pipe.flush()
    assert last.shape == truth.shape and np.isfinite(last).all()


def test_profile_splits_the_frame():
    (im, vol, _), = _pan_scene(24, 40, frames=1)
    stream = StereoStream(T_PARAMS.replace(**PARAMS), device="cpu",
                          profile=True, max_disp=float(ND - 1),
                          unit_sizes=[4], layer_proposers=[("expansion",)],
                          cold_iterations=1, cold_pm_iterations=0)
    stream.process(im, im, vol, vol)
    t = stream.last_timings
    assert sorted(t) == ["build_s", "output_s", "solve_s"]
    assert min(t.values()) >= 0
    assert sum(t.values()) <= stream.last_frame_seconds + 1e-6


def test_stream_adapts_to_scene_change():
    """A new scene pulls the warm-started solution toward its own truth
    (the warm start does not pin the old solution): the port's counterpart
    of tests/test_serving.py::test_stream_adapts_to_scene_change."""
    (im0, vol0, truth0), = _pan_scene(48, 72, frames=1, seed=1)
    (im1, vol1, truth1), = _pan_scene(48, 72, frames=1, seed=2,
                                      slope=(-0.03, 0.05))
    stream = StereoStream(T_PARAMS.replace(**PARAMS), device="cpu",
                          **dict(SMALL_KW, warm_iterations=2))
    stream.process(im0, im0, vol0, vol0)
    d1 = stream.process(im1, im1, vol1, vol1)
    assert np.abs(d1 - truth1).mean() < np.abs(d1 - truth0).mean()


def test_stream_wants_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StereoStream(T_PARAMS, max_disp=11.0, unit_sizes=[4])


def test_stream_takes_the_static_range_only():
    """A stream's frames share one configuration: any stats_backend but
    "device" is refused when the stream is made, not at its second
    frame."""
    with pytest.raises(ValueError, match="stats_backend 'host'"):
        StereoStream(T_PARAMS, max_disp=11.0, unit_sizes=[4],
                     stats_backend="host", device="cpu")
