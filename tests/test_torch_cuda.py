"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Every test here needs a CUDA device and skips without one. The file imports
no JAX, so it runs on a machine that has only the port's dependencies:

    python -m pytest -m cuda --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from localexpstereo_tpu_torch.config import PARAMS_GF
from localexpstereo_tpu_torch.models import engine
from localexpstereo_tpu_torch.ops import boxfilter, mincut, mincut_cuda
from localexpstereo_tpu_torch.ops import unary_cuda
from localexpstereo_tpu_torch.utils import synthetic

RTOL, ATOL = 1e-5, 1e-4
#: sample_windows against its plain version: raw costs (the same float32
#: operations, unfused) and guided-filtered costs on positions whose box
#: holds an in-image pixel (float64 box sums in another order).
UNARY_RAW_ATOL, UNARY_GF_ATOL = 1e-6, 2e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


#: Plans forced on the kernels beside the card's own: an empty band
#: (S < K), a short last band (S not a multiple of K), one region on a
#: cluster, the global state on a cluster and on one block.
FORCED_PLANS = {
    "S<K": (3, 9, lambda s: mincut_cuda.cluster_plan(s, 16)),
    "short-band": (2, 40, lambda s: mincut_cuda.cluster_plan(s, 16)),
    "N=1": (1, 30, lambda s: mincut_cuda.cluster_plan(s, 4)),
    "global-cluster": (2, 70, lambda s: mincut_cuda.cluster_plan(
        s, 8, "global")),
    "global-block": (4, 20, lambda s: mincut_cuda.Plan(1, 1024, 0, "global",
                                                       s)),
}


def _expansion_problem(cuda, n, s):
    arrays, lam, tau = synthetic.fused_move_problem(
        np.random.default_rng(n), n, s)
    return [torch.as_tensor(a, device=cuda) for a in arrays], lam, tau


def _fusion_graph(cuda, n, s):
    arrays, lam, tau = synthetic.fusion_move_problem(
        np.random.default_rng(n), n, s)
    terms = mincut_cuda.fusion_terms(
        *[torch.as_tensor(a, device=cuda) for a in arrays], lam, tau)
    return [x.contiguous() for x in mincut.build_fusion_graph(*terms)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,s,rounds,sweeps", [
    (16, 12, 16, 16), (3, 40, 16, 64), (5, 9, 2, 3),   # last: truncated solve
    (2, 260, 2, 4),     # a cluster of 16, short last band, truncated
    (1, 130, 16, 16),   # one region on a cluster of 16
    # The V2 path's at 450 x 375 (layers {5, 15, 25}).
    (437, 15, 16, 16), (56, 45, 16, 16), (20, 75, 16, 16),
])
def test_expansion_kernel_matches_plain(cuda, n, s, rounds, sweeps):
    """Masks bitwise equal to the plain version's, at the card's plan."""
    args, lam, tau = _expansion_problem(cuda, n, s)
    kw = dict(lam=lam, tau=tau, max_global_rounds=rounds,
              sweeps_per_round=sweeps)
    before = mincut_cuda.expansion_accept.launches
    got = mincut_cuda.expansion_accept(*args, **kw)
    torch.cuda.synchronize()
    assert mincut_cuda.expansion_accept.launches == before + 1
    assert got.dtype == torch.bool and got.shape == (n, s, s)
    want = mincut_cuda.expansion_accept_reference(*args, **kw)
    assert torch.equal(got, want)
    c00, c01, c10, t0, t1 = mincut_cuda.fused_terms(*args, lam, tau)
    e_got = mincut.move_energy_delta(got, t0, t1, c00, c01, c10).cpu()
    e_want = mincut.move_energy_delta(want, t0, t1, c00, c01, c10).cpu()
    np.testing.assert_allclose(e_got.numpy(), e_want.numpy(), rtol=RTOL,
                               atol=ATOL)
    assert bool((e_got <= 1e-5).all())


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(FORCED_PLANS))
def test_expansion_kernel_forced_plans(cuda, case):
    n, s, plan = FORCED_PLANS[case]
    args, lam, tau = _expansion_problem(cuda, n, s)
    kw = dict(lam=lam, tau=tau, max_global_rounds=16, sweeps_per_round=16)
    before = mincut_cuda.expansion_accept.launches
    got = mincut_cuda.launch_expansion(*args, plan=plan(s), **kw)
    torch.cuda.synchronize()
    assert mincut_cuda.expansion_accept.launches == before + 1
    assert torch.equal(got, mincut_cuda.expansion_accept_reference(*args,
                                                                   **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("n,s,rounds,sweeps", [
    (16, 12, 64, 16), (3, 40, 64, 16), (5, 9, 2, 3),   # last: truncated solve
    (2, 260, 2, 4),     # a cluster of 16, short last band, truncated
    (1, 130, 64, 16),   # one region on a cluster of 16
])
def test_mincut_kernel_matches_plain(cuda, n, s, rounds, sweeps):
    """The min-cut of prebuilt (fusion) graphs: equal accept masks."""
    graph = _fusion_graph(cuda, n, s)
    before = mincut_cuda.solve_graph.launches
    got = mincut_cuda.solve_graph(*graph, max_global_rounds=rounds,
                                  sweeps_per_round=sweeps)
    torch.cuda.synchronize()
    assert mincut_cuda.solve_graph.launches == before + 1
    assert got.dtype == torch.bool and got.shape == (n, s, s)
    want = mincut.solve_preflow(*graph, rounds, sweeps)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(FORCED_PLANS))
def test_mincut_kernel_forced_plans(cuda, case):
    n, s, plan = FORCED_PLANS[case]
    graph = _fusion_graph(cuda, n, s)
    before = mincut_cuda.solve_graph.launches
    got = mincut_cuda.launch_mincut(*graph, max_global_rounds=64,
                                    sweeps_per_round=16, plan=plan(s))
    torch.cuda.synchronize()
    assert mincut_cuda.solve_graph.launches == before + 1
    assert torch.equal(got, mincut.solve_preflow(*graph, 64, 16))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["expansion_accept", "mincut_accept",
                                    "sample_windows"])
def test_card_plans_match_the_recorded_ones(cuda, kernel):
    """The card's answer for how many clusters (or unary blocks) fit leads
    to the plans that launch_plan gives without it at the main path's
    shapes (for sample_windows, on every volume type)."""
    if kernel == "sample_windows":
        for f, n in ((62, 468), (149, 54), (407, 6)):
            for r in (0, 10):
                for vol_type in unary_cuda.VOL_TYPES.values():
                    assert unary_cuda.card_plan(f, n, r, vol_type) == \
                        unary_cuda.launch_plan(f, n, r)
        return
    for s, n in ((42, 468), (129, 54), (387, 6)):
        assert mincut_cuda.card_plan(kernel, s, n) == \
            mincut_cuda.launch_plan(s, n)


def _unary_check(cuda, dtype, n, f, d, r, h, w, plan=None):
    """One launch of sample_windows (the card's plan, or ``plan``) against
    its plain version: raw costs within 1e-6, filtered ones within 2e-4 on
    positions whose box holds an in-image pixel. Returns the share of
    those positions whose values are bitwise equal."""
    vp = 12
    vol, props, fox, foy, stats, scale, th = \
        synthetic.unary_window_problem(
            np.random.default_rng(n + f), n, f, d, h, w, vp,
            "float32" if dtype == "bfloat16" else dtype)
    vol = torch.as_tensor(vol, device=cuda)
    if dtype == "bfloat16":
        vol = vol.to(torch.bfloat16)
    args = (vol, vp,
            torch.as_tensor(props, device=cuda),
            torch.as_tensor(fox, device=cuda),
            torch.as_tensor(foy, device=cuda), f, h, w)
    kw = dict(min_disp=0.0, th_col=th, scale=scale, zero=0.0, pad=vp, r_gf=r,
              stats=tuple(torch.as_tensor(a, device=cuda) for a in stats))
    before = unary_cuda.sample_windows.launches
    if plan is None:
        got = unary_cuda.sample_windows(*args, **kw)
    else:
        got = unary_cuda.launch_windows(*args, **kw, plan=plan)
    torch.cuda.synchronize()
    assert unary_cuda.sample_windows.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == (n, f, f)
    want = unary_cuda.sample_windows_reference(*args, **kw)
    if r == 0:
        torch.testing.assert_close(got, want, rtol=0, atol=UNARY_RAW_ATOL)
        return float((got == want).double().mean())
    ys = args[4][:, None, None] + torch.arange(f, device=cuda)[None, :, None]
    xs = args[3][:, None, None] + torch.arange(f, device=cuda)[None, None, :]
    fmask = ((xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)).float()
    support = boxfilter.boxsum2d(fmask, r) > 0.5
    torch.testing.assert_close(torch.where(support, got, 0.0),
                               torch.where(support, want, 0.0), rtol=0,
                               atol=UNARY_GF_ATOL)
    return float((got == want)[support].double().mean())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "uint8", "bfloat16"])
@pytest.mark.parametrize("n,f,d,r", [
    (5, 7, 6, 0), (17, 9, 12, 0), (9, 11, 6, 3), (20, 62, 24, 10),
])
def test_unary_kernel_matches_plain(cuda, dtype, n, f, d, r):
    _unary_check(cuda, dtype, n, f, d, r, 40, 52)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "uint8", "bfloat16"])
@pytest.mark.parametrize("f", [149, 407])
def test_unary_kernel_main_path_sizes(cuda, dtype, f):
    """The main path's middle and widest windows (N = 2, r = 10) on an
    image larger than F, under the card's plan (strips and row chunks)."""
    assert _unary_check(cuda, dtype, 2, f, 24, 10, 430, 470) >= 0.999


#: Plans forced on the unary kernel: (F, r, W, Hc).
UNARY_PLANS = {
    "narrow-strips": (62, 10, 32, 62),
    "row-chunks": (62, 10, 62, 9),
    "strips-and-chunks": (149, 10, 64, 40),
    "one-tile": (149, 10, 149, 149),
    "short-last-strip": (50, 3, 32, 17),
    "raw-one-row": (62, 0, 62, 1),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(UNARY_PLANS))
def test_unary_kernel_forced_plans(cuda, case):
    f, r, width, rows = UNARY_PLANS[case]
    plan = unary_cuda.tile_plan(f, r, width, rows)
    _unary_check(cuda, "uint8", 6, f, 16, r, 120, 150, plan=plan)


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["auto", "dma"])
@pytest.mark.parametrize("windr", [6, 20])
def test_solve_on_card_matches_cpu(cuda, windr, route):
    """A small V3 solve on the card lands on the CPU solve's energies, at a
    narrow filter window and at the main path's (windR 20), on both unary
    routes; the "dma" route launches the unary kernel on the card."""
    img, vol, h, w, nd, truth = synthetic.build_problem(0.06)
    energies = {}
    launches = unary_cuda.sample_windows.launches
    for device in (cuda, torch.device("cpu")):
        solver = engine.LocalExpansionSolver(
            img, img, PARAMS_GF.replace(windR=windr, lambda_=0.5, th_col=0.5),
            max_disp=float(nd - 1), vol0=vol, vol1=vol, device=device,
            unary_backend=route)
        for i, size in enumerate([4, 8, 16]):
            solver.add_layer(size, engine.LAYER0_PROPOSERS if i == 0
                             else engine.COARSE_PROPOSERS)
        out = []

        class Rec:
            def start(self):
                pass

            def stop(self):
                pass

            def evaluate(self, solver, lab, cost, mode, index):
                out.append(float(engine.energy_audit(
                    solver.data, solver.cfg, lab, cost, mode)[0]))

        solver.set_evaluator(Rec())
        lab, _ = solver.run(iterations=2, pm_iterations=1)
        assert lab.device.type == device.type
        energies[device.type] = out
    launched = unary_cuda.sample_windows.launches - launches
    assert (launched > 0) == (route == "dma")
    for got, want in zip(energies["cuda"], energies["cpu"]):
        assert abs(got - want) <= 0.002 * abs(want) + 1e-3, energies


@pytest.mark.cuda
@pytest.mark.parametrize("shape,modes,max_vdisp", [
    ((96, 144, 24), (0,), 0.0), ((96, 144, 24), (0, 1), 0.0),
    ((96, 144, 24), (0,), 1.0), ((48, 72, 16), (0,), 0.0),
    ((64, 96, 24), (0, 1), 0.0)])
def test_v2_solve_on_card_matches_cpu(cuda, shape, modes, max_vdisp):
    """A small V2 (image-warp) solve on the card lands on the CPU solve's
    energies, one view, both views (with the post-process) and one view
    with vertical disparity; the graph-cut sweeps launch the expansion
    kernel, and nothing launches the volume kernel. 48 x 72 and 64 x 96
    are the sizes where the two parted by up to 1 % while the card rounded
    the proposals' sums and trigonometry otherwise (ROADMAP C8)."""
    energies = {}
    launches = (mincut_cuda.expansion_accept.launches,
                unary_cuda.sample_windows.launches)
    for device in (cuda, torch.device("cpu")):
        solver, _, _, _ = synthetic.v2_solver(*shape, device,
                                              sizes=[4, 8, 16],
                                              max_vdisp=max_vdisp)
        out = {m: [] for m in modes}

        class Rec:
            def start(self):
                pass

            def stop(self):
                pass

            def evaluate(self, solver, lab, cost, mode, index):
                out[mode].append(float(engine.energy_audit(
                    solver.data, solver.cfg, lab, cost, mode)[0]))

        solver.set_evaluator(Rec())
        lab, _ = solver.run(iterations=1, view_modes=modes, pm_iterations=1)
        assert lab.device.type == device.type
        energies[device.type] = out
    assert mincut_cuda.expansion_accept.launches > launches[0]
    assert unary_cuda.sample_windows.launches == launches[1]
    for mode in modes:
        assert len(energies["cuda"][mode]) == len(energies["cpu"][mode])
        for got, want in zip(energies["cuda"][mode], energies["cpu"][mode]):
            assert abs(got - want) <= 0.002 * abs(want) + 1e-3, energies


#: MC-CNN on the card against the CPU: both in full float32 (TF32 off for
#: the card's convolutions), differing in the order of their sums.
MCCNN_ATOL = 1e-5


@pytest.mark.cuda
def test_mccnn_on_card_matches_cpu(cuda):
    """features and cost_volume with the bundled weights on the card
    within MCCNN_ATOL of the CPU's; cuDNN's TF32 setting is the caller's
    again afterwards."""
    from localexpstereo_tpu_torch.models import mccnn
    left, right, _, _ = synthetic.v2_scene(96, 128, 32)
    params = mccnn.load_default_params()
    gpu = mccnn.params_from_jax(params).to(cuda)
    cpu = mccnn.params_from_jax(params)
    tf32 = torch.backends.cudnn.allow_tf32
    got = mccnn.features(gpu, left)
    assert got.device.type == "cuda"
    assert float((got.cpu() - mccnn.features(cpu, left)).abs().max()) \
        <= MCCNN_ATOL
    vol = mccnn.cost_volume(gpu, left, right, 32)
    assert vol.shape == (32, 96, 128) and vol.device.type == "cuda"
    assert float((vol.cpu() - mccnn.cost_volume(cpu, left, right, 32))
                 .abs().max()) <= MCCNN_ATOL
    assert torch.backends.cudnn.allow_tf32 == tf32


@pytest.mark.cuda
def test_device_stats_on_card_match_cpu(cuda):
    """compute_stats_device in float64 on the card and on the CPU: equal up
    to the order of rounding (rtol 1e-5, atol 1e-6)."""
    from localexpstereo_tpu_torch.ops import guided
    img, _, _, _, _, _ = synthetic.build_problem(0.1)
    img[10:30, 10:40] = 90.0
    got = guided.compute_stats_device(torch.as_tensor(img, device=cuda), 10,
                                      1e-4)
    want = guided.compute_stats_device(torch.as_tensor(img), 10, 1e-4)
    for g, w in zip(got, want):
        assert g.device.type == "cuda"
        np.testing.assert_allclose(g.cpu().numpy(), w.numpy(), rtol=1e-5,
                                   atol=1e-6)


def _stream_run(device, frames, pipelined=False):
    from localexpstereo_tpu_torch.serving import StereoStream
    stream = StereoStream(PARAMS_GF.replace(windR=20, lambda_=0.5,
                                            th_col=0.5),
                          max_disp=23.0, unit_sizes=[4, 8, 16],
                          cold_iterations=1, cold_pm_iterations=1,
                          pipelined=pipelined, device=device)
    energies, maps = [], []
    for img, vol, _ in frames:
        maps.append(stream.process(img, img, vol, vol))
        s = stream.solver
        energies.append(float(engine.energy_audit(s.data, s.cfg,
                                                  *s._state[0], 0)[0]))
    return stream, energies, maps


@pytest.mark.cuda
def test_stream_on_card_matches_cpu(cuda):
    """A 3-frame StereoStream (96 x 144 x 24, a pan of 2 px a frame, the
    device-side energy build, the "cell" warm start) on the card lands on
    the CPU stream's energies within the trajectory tolerance, frame by
    frame; the graph-cut sweeps launch the expansion kernel."""
    frames = synthetic.pan_frames(96, 144, 24, 3)
    before = mincut_cuda.expansion_accept.launches
    _, e_gpu, maps = _stream_run(cuda, frames)
    assert mincut_cuda.expansion_accept.launches > before
    _, e_cpu, _ = _stream_run(torch.device("cpu"), frames)
    for m in maps:
        assert m.shape == (96, 144) and np.isfinite(m).all()
    for got, want in zip(e_gpu, e_cpu):
        assert abs(got - want) <= 0.002 * abs(want) + 1e-3, (e_gpu, e_cpu)


@pytest.mark.cuda
def test_pipelined_stream_on_card_equals_sync(cuda):
    """On the card, pipelined maps (copied through pinned buffers) are
    bitwise the sync stream's one frame later; flush() drains the last;
    reset() returns the frame in flight."""
    frames = synthetic.pan_frames(48, 72, 12, 3)
    _, _, sync = _stream_run(cuda, frames)
    stream, _, pipe = _stream_run(cuda, frames, pipelined=True)
    assert pipe[0] is None
    for got, want in zip(pipe[1:], sync):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(stream.flush(), sync[-1])
    assert stream.flush() is None
    img, vol, _ = frames[0]
    assert stream.process(img, img, vol, vol) is None
    assert np.isfinite(stream.reset()).all()
    assert stream.reset() is None


@pytest.mark.cuda
def test_expansion_guard_selects_accepted_unaries(cuda):
    """A NaN unary where the move keeps its label leaves the kernel's
    guard finite, as the plain guard's select (mincut.move_energy_delta):
    equal masks with NaN proposal costs in some regions."""
    args, lam, tau = _expansion_problem(cuda, 16, 12)
    pcost = args[6].clone()
    pcost[::3, 2, 5] = float("nan")
    args = args[:6] + [pcost]
    kw = dict(lam=lam, tau=tau, max_global_rounds=16, sweeps_per_round=16)
    got = mincut_cuda.expansion_accept(*args, **kw)
    want = mincut_cuda.expansion_accept_reference(*args, **kw)
    assert torch.equal(got, want)
    assert bool(got[1::3].any())


@pytest.mark.cuda
@pytest.mark.parametrize("method", [0, 1, 2])
def test_method_sampler_on_card_matches_cpu(cuda, method):
    """unary_volume.sample_windows on the card against the same call on
    the CPU (plain torch on both): equal NaN positions, atol 1e-6."""
    from localexpstereo_tpu_torch.ops import unary_volume
    rng = np.random.default_rng(method)
    d, h, w, f, n, vp = 24, 40, 56, 21, 64, 4
    vol = (rng.random((d, h + 2 * vp, w + 2 * vp)) * 255).astype(np.uint8)
    props = np.stack([rng.uniform(-0.3, 0.3, n), rng.uniform(-0.3, 0.3, n),
                      rng.uniform(-3.0, d + 2.0, n), np.zeros(n)],
                     -1).astype(np.float32)
    props[0, 2] = np.nan
    fox = rng.integers(-10, w, n)
    foy = rng.integers(-10, h, n)
    out = {}
    for dev in ("cpu", cuda):
        def t(x):
            return torch.as_tensor(x, device=dev)
        out[str(dev)] = unary_volume.sample_windows(
            t(vol), vp, t(props), t(fox), t(foy), f, h, w, min_disp=0.0,
            max_disp=d - 1.0, th_col=0.5, method=method, scale=1.0 / 255,
            zero=0.0).cpu().numpy()
    got, want = out["cuda"], out["cpu"]
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.cuda
def test_bilateral_filter_on_card_matches_cpu(cuda):
    from localexpstereo_tpu_torch.ops import bilateral
    rng = np.random.default_rng(3)
    n, f, r = 6, 42, 20
    args = [rng.random((n, f, f)).astype(np.float32),
            (rng.random((n, f, f, 3)) * 255).astype(np.float32),
            (rng.random((n, f, f)) > 0.2).astype(np.float32)]
    want = bilateral.filter_windows(*map(torch.from_numpy, args), r, 10.0)
    got = bilateral.filter_windows(
        *[torch.from_numpy(a).to(cuda) for a in args], r, 10.0)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.cuda
def test_replica_workers_on_card_equal_in_process(cuda):
    """Two worker processes on cuda:0 (three pairs, two waves on the
    first) give the in-process results on the card, bitwise."""
    from localexpstereo_tpu_torch.parallel.replica import ReplicaSolver
    rng = np.random.default_rng(0)
    b, h, w, nd = 3, 48, 64, 12
    ims = (rng.random((b, h, w, 3)) * 255).astype(np.float32)
    dd = np.arange(nd, dtype=np.float32)[:, None, None]
    vols = np.stack([np.minimum(np.abs(dd - rng.random((h, w), np.float32)
                                       * (nd - 1)) * 0.4, 1.0)
                     for _ in range(b)]).astype(np.float32)
    finals = []
    for devices in (["cuda:0"], ["cuda:0", "cuda:0"]):
        rs = ReplicaSolver(ims, ims, PARAMS_GF.replace(windR=6, lambda_=0.5,
                                                       th_col=0.5),
                           nd - 1.0, [4, 8], devices=devices, vols0=vols,
                           vols1=vols, seed=5)
        finals.append(rs.run(1, (0,), 1)[0])
        assert all(rs.pair_stats(k)["launches"]["expansion_accept"] > 0
                   for k in range(b))
    assert np.array_equal(finals[0], finals[1])


@pytest.mark.cuda
@pytest.mark.parametrize("n,s,rows", [(54, 129, (18, 36)), (6, 387, (2, 5))])
def test_expansion_kernel_plan_n_on_a_row_slice(cuda, n, s, rows):
    """A height shard's call: a slice of the regions with ``plan_n`` the
    whole batch's N launches the whole call's plan and returns exactly its
    rows (the main path's S = 129 and 387); the plain version ignores
    ``plan_n``."""
    args, lam, tau = _expansion_problem(cuda, n, s)
    kw = dict(lam=lam, tau=tau, max_global_rounds=16,
              sweeps_per_round=64 if s >= 256 else 16)
    full = mincut_cuda.expansion_accept(*args, **kw)
    part = [a[rows[0]:rows[1]] for a in args]
    got = mincut_cuda.expansion_accept(*part, plan_n=n, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, full[rows[0]:rows[1]])
    plain = [a.cpu() for a in part]
    assert torch.equal(
        mincut_cuda.expansion_accept(*plain, plan_n=n, **kw),
        mincut_cuda.expansion_accept(*plain, **kw))
    assert torch.equal(got.cpu(), mincut_cuda.expansion_accept(*plain, **kw))


def _sharded_problem():
    from localexpstereo_tpu_torch.tools import multichip
    img, vol = multichip.small_problem(48, 64, 12, 3)
    return img, vol, 11.0


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["volume", "dvolume"])
def test_sharded_solve_on_card_equals_single(cuda, kind):
    """Two ranks on cuda:0 (gloo): the height- and the disparity-sharded
    solves (1 + 1, layers [4, 8]) equal the single-device solve on the
    card, bit for bit, on both ranks."""
    from localexpstereo_tpu_torch.parallel import collectives
    from localexpstereo_tpu_torch.tools import multichip
    img, vol, md = _sharded_problem()
    ref = multichip.solve_single(img, vol, md, [4, 8], 7, "cuda:0")
    outs = collectives.launch(multichip.solve, ["cuda:0", "cuda:0"], kind,
                              img, vol, md, [4, 8], 7, timeout_s=600)
    assert [o["collective_calls"] > 0 for o in outs] == [True, True]
    for o in outs:
        assert np.array_equal(o["labels"], ref["labels"])
        assert np.array_equal(o["cost"], ref["cost"])


@pytest.mark.cuda
@pytest.mark.parametrize("s,n", [(42, 6), (129, 3)])
def test_graph_cut_kernels_match_dinic(cuda, s, n):
    """Both graph-cut kernels against the exact min cut (Dinic, on the
    host), through tools/gc_cap_audit.py's three parts with a few
    instances: mincut_accept on random tables of the certified regimes and
    expansion_accept on fused moves under the engine's caps, mincut_accept
    on fusion graphs under the fusion caps. No region truncated, every
    mask the 64-round solve's and the plain twin's, every cut within rel
    1e-5 / abs 1e-2 of Dinic's (the tool's RTOL / ATOL)."""
    from localexpstereo_tpu_torch.tools import gc_cap_audit as audit
    sweeps = engine.mincut_knobs(s)[1]
    rows = [audit.audit_tables(s, sweeps, ri, n, device=cuda)
            for ri in audit.CERTIFIED]
    rows += [audit.audit_expansion(s, sweeps, n, device=cuda),
             audit.audit_fusion(s, n, device=cuda)]
    for row in rows:
        assert row["instances"] == n
        assert [row[k] for k in ("truncated", "mismatch_64", "mismatch_plain",
                                 "outside_dinic")] == [0, 0, 0, 0], row


@pytest.mark.cuda
def test_mccnn_v3_wta_on_card_matches_cpu(cuda):
    """The MC-CNN V3 pair (tools/mccnn_v3_eval.py) at scale 0.125: the
    card's WTA map equals the CPU's wherever the CPU's two lowest costs
    are more than 2 MCCNN_ATOL apart (the volumes agree within
    MCCNN_ATOL), and its bad rates are within 0.05 point of the CPU's."""
    from localexpstereo_tpu_torch.models import mccnn
    from localexpstereo_tpu_torch.tools import mccnn_v3_eval as tool
    h, w, nd = tool.geometry(0.125)
    im_l, im_r, truth, valid = tool.build_pair(h, w, nd)
    params = mccnn.load_default_params()
    vol_gpu, _, _ = tool.volume(mccnn.params_from_jax(params).to(cuda),
                                im_l, im_r, nd)
    vol_cpu, _, _ = tool.volume(mccnn.params_from_jax(params), im_l, im_r,
                                nd)
    got, want = tool.wta(vol_gpu), tool.wta(vol_cpu)
    two = torch.topk(vol_cpu, 2, dim=0, largest=False).values
    clear = ((two[1] - two[0]) > 2 * MCCNN_ATOL).numpy()
    np.testing.assert_array_equal(got[clear], want[clear])
    assert tool.bad_rates(got, truth, valid) == pytest.approx(
        tool.bad_rates(want, truth, valid), abs=0.05)


@pytest.mark.cuda
@pytest.mark.parametrize("s,n", [(14, 468), (43, 54), (129, 6)])
def test_refit_sums_on_card(cuda, s, n):
    """RANSAC's refit sums at the main path's cell sizes and region counts:
    the kernel equal to its plain version bit for bit (the same fused
    multiply-add chain), both within the float32 summation bound of the
    exact sums; one launch a call."""
    from localexpstereo_tpu_torch.models import proposals
    r = np.random.default_rng(s)
    feats, w, d = _refit_inputs(r, n, s)
    launches = proposals.refit_sums.launches
    got = proposals.refit_sums(feats.to(cuda), w.to(cuda), d.to(cuda))
    torch.cuda.synchronize()
    assert proposals.refit_sums.launches == launches + 1
    want = proposals.refit_sums(feats, w, d)
    for g, p, (exact, bound) in zip(got, want, _refit_exact(feats, w, d)):
        assert torch.equal(g.cpu(), p)
        assert (np.abs(p.numpy() - exact) <= bound).all()


@pytest.mark.cuda
def test_xla_math_on_card_matches_cpu(cuda):
    """ops/xla_math on the card equals it on the CPU bit for bit, on
    1,000,000 draws of each function's arguments."""
    from localexpstereo_tpu_torch.ops import xla_math
    r = np.random.default_rng(0)
    n = 1_000_000

    def f32(*a):
        return torch.as_tensor(r.uniform(*a).astype(np.float32))

    cases = [
        (xla_math.sincosf, (f32(0, 2 * np.pi, n),)),
        (xla_math.sincosf, (f32(-np.pi, np.pi, n),)),
        (xla_math.sqrt, (f32(0, 10, n),)),
        (xla_math.rsqrt, (f32(1, 20, n),)),
        (xla_math.norm3, (f32(-2, 2, (n, 3)),)),
        (xla_math.fma, (f32(-3, 3, n), f32(-3, 3, n), f32(-3, 3, n))),
        (xla_math.matvec3, (f32(-100, 100, (n, 3, 3)), f32(-9, 9, (n, 3))))]
    for fn, args in cases:
        on_cpu = fn(*args)
        on_card = fn(*(a.to(cuda) for a in args))
        for c, g in zip(*(o if isinstance(o, tuple) else (o,)
                          for o in (on_cpu, on_card))):
            assert torch.equal(g.cpu(), c), fn.__name__


@pytest.mark.cuda
def test_proposals_on_card_match_cpu(cuda):
    """The init's random labels and the three proposers on the card equal
    the CPU's bit for bit from the same keys and cell labels."""
    from localexpstereo_tpu_torch.models import proposals
    from localexpstereo_tpu_torch.ops import plane, rng
    r = np.random.default_rng(1)
    key = rng.fold_in(rng.PRNGKey(3), 7)
    x = torch.as_tensor(r.uniform(0, 1400, 5000).astype(np.float32))
    y = torch.as_tensor(r.uniform(0, 990, 5000).astype(np.float32))
    assert torch.equal(
        plane.random_label(key, x.to(cuda), y.to(cuda), 0.0, 144.0).cpu(),
        plane.random_label(key, x, y, 0.0, 144.0))
    for s, n in ((14, 468), (43, 54), (129, 6)):
        lab = np.zeros((n, s, s, 4), np.float32)
        lab[..., 0] = r.uniform(-0.3, 0.3, (n, 1, 1))
        lab[..., 1] = r.uniform(-0.3, 0.3, (n, 1, 1))
        lab[..., 2] = r.uniform(10, 130, (n, 1, 1)) + r.normal(
            0, 0.4, (n, s, s))
        ox = torch.arange(n) * s
        oy = torch.arange(n) % 7 * s
        cw = torch.full((n,), s)
        ch = torch.clamp(torch.full((n,), s) - torch.arange(n) % 3, min=1)
        cells = (torch.as_tensor(lab), ox, oy, cw, ch)
        for name, extra in (("expansion", ()), ("ransac", ()),
                            ("random_perturbation",
                             (18.0, 0.25, 0.0, 144.0))):
            fn = getattr(proposals, name)
            want = fn(key, *cells, *extra)
            got = fn(key, *(c.to(cuda) for c in cells), *extra)
            assert torch.equal(got.cpu(), want), (name, s)


def _refit_inputs(r, n, s):
    """Cell-local (x, y, 1) of an s x s cell, 0/1 inlier weights and
    disparities, as RANSAC's refit gets them."""
    iy, ix = np.mgrid[0:s, 0:s].astype(np.float32)
    feats = np.stack([ix.ravel(), iy.ravel(), np.ones(s * s, np.float32)],
                     -1)[None].repeat(n, 0)
    w = (r.random((n, s * s)) < 0.6).astype(np.float32)
    d = r.uniform(0, 300, (n, s * s)).astype(np.float32)
    return torch.as_tensor(feats), torch.as_tensor(w), torch.as_tensor(d)


def _refit_exact(feats, w, d):
    """(A^T W A, its bound), (A^T W d, its bound): the sums in float64 and
    the float32 error bound of a sum of rounded products in any order,
    (P + 1) u sum |terms| (u = 2^-24)."""
    f, w, d = feats.double(), w.double(), d.double()
    fw = f * w[..., None]
    out = []
    for terms in (fw[..., :, None] * f[..., None, :], fw * (d * w)[..., None]):
        terms = terms.numpy()
        out.append((terms.sum(1), (terms.shape[1] + 1) * 2.0 ** -24
                    * np.abs(terms).sum(1)))
    return out


#: The MC-CNN trainer on the card against the CPU. One step: the loss within
#: TRAIN_LOSS_RTOL, each gradient tensor within TRAIN_GRAD_RTOL of its
#: largest entry (tests/test_torch_train_mccnn.py's tolerances against JAX;
#: the card's index backward adds with atomics, so in no fixed order). A
#: 20-step run: each step's loss within TRAIN_RUN_RTOL and accuracy within
#: TRAIN_RUN_ACC (Adam carries the rounding on: the CPU run parts from the
#: JAX tool's by 5e-5 in the loss over 20 steps, accuracies equal).
TRAIN_LOSS_RTOL, TRAIN_GRAD_RTOL = 1e-6, 1e-5
TRAIN_RUN_RTOL, TRAIN_RUN_ACC = 1e-3, 2e-3


def _train_scenes(dev, n=3):
    out = []
    for seed in range(n):
        im_l, im_r, disp, nonocc = synthetic.v2_scene(96, 128, 16, seed)
        gt = (np.clip(np.rint(disp * 4.0), 1, 255) / 4.0).astype(np.float32)
        gt[~nonocc] = np.inf
        out.append(tuple(torch.as_tensor(a, device=dev) for a in (
            im_l.astype(np.float32), im_r.astype(np.float32), gt,
            np.isfinite(gt))))
    return out


def _train_net(dev):
    from localexpstereo_tpu_torch.models import mccnn
    from localexpstereo_tpu_torch.ops import rng
    params = mccnn.init_params_from_key(rng.PRNGKey(0))
    return mccnn.params_from_jax(params).to(dev).requires_grad_(True)


@pytest.mark.cuda
def test_hinge_loss_step_on_card_matches_cpu(cuda):
    from localexpstereo_tpu_torch.ops import rng
    from localexpstereo_tpu_torch.tools import train_mccnn as tool
    key = rng.split(rng.PRNGKey(0))[1]
    out = {}
    for dev in (cuda, torch.device("cpu")):
        net = _train_net(dev)
        loss, acc = tool.hinge_loss(net, *_train_scenes(dev, 1)[0], key)
        loss.backward()
        out[dev.type] = (float(loss.detach()), float(acc),
                         [p.grad.cpu() for p in net.parameters()])
    assert out["cuda"][0] == pytest.approx(out["cpu"][0], rel=TRAIN_LOSS_RTOL)
    assert out["cuda"][1] == out["cpu"][1]
    for g, want in zip(out["cuda"][2], out["cpu"][2]):
        assert float((g - want).abs().max()) <= (
            TRAIN_GRAD_RTOL * float(want.abs().max()))


@pytest.mark.cuda
def test_training_run_on_card_matches_cpu(cuda):
    """20 steps of the tool's loop (its keys, Adam, the scenes in turn)."""
    from localexpstereo_tpu_torch.ops import rng
    from localexpstereo_tpu_torch.tools import train_mccnn as tool
    runs = {}
    for dev in (cuda, torch.device("cpu")):
        scenes = _train_scenes(dev)
        net = _train_net(dev)
        opt = tool.adam(net)
        key = rng.PRNGKey(0)
        rows = []
        for it in range(20):
            key, k = rng.split(key)
            loss, acc = tool.train_step(net, opt, scenes[it % 3], k)
            rows.append((float(loss), float(acc)))
        runs[dev.type] = np.array(rows)
    got, want = runs["cuda"], runs["cpu"]
    assert np.isfinite(got).all() and got[-1, 0] < got[0, 0]
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=TRAIN_RUN_RTOL)
    np.testing.assert_allclose(got[:, 1], want[:, 1], rtol=0,
                               atol=TRAIN_RUN_ACC)


@pytest.mark.cuda
def test_recorder_counts_each_wait_on_the_card(cuda):
    """Under a profiler of the card's activity alone (the traced
    benchmark's), a pageable copy to the card, ``.item()`` and
    ``torch.cuda.synchronize`` each count one sync in the span that holds
    them, none is shown, and the first span after the window puts the
    sync debug mode back. The sync debug mode does not report
    ``torch.cuda.synchronize``: the program counts it where it calls it,
    as the stream's profile split does."""
    import warnings

    from torch.profiler import ProfilerActivity, profile

    from localexpstereo_tpu_torch.serving import StereoStream
    from localexpstereo_tpu_torch.utils import profiling
    x = torch.ones(4, device=cuda)
    host = torch.ones(4)
    stream = StereoStream(PARAMS_GF, 15.0, [8], profile=True, device=cuda)
    with warnings.catch_warnings(record=True) as shown:
        with profile(activities=[ProfilerActivity.CUDA]):
            with profiling.span("copy"):
                host.to(cuda)
            with profiling.span("item"):
                x.sum().item()
            with profiling.span("synchronize"):
                stream._sync()
            with profiling.span("none"):
                x + 1
            assert torch.cuda.get_sync_debug_mode() == 1
        with profiling.span("off"):
            host.to(cuda)
    recs = profiling.records()
    assert [(r.name, r.syncs) for r in recs] == [
        ("copy", 1), ("item", 1), ("synchronize", 1), ("none", 0)]
    assert torch.cuda.get_sync_debug_mode() == 0
    assert not [w for w in shown
                if profiling.SYNC_MESSAGE in str(w.message)]
