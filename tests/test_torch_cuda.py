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
@pytest.mark.parametrize("kernel", ["expansion_accept", "mincut_accept"])
def test_card_plans_match_the_recorded_ones(cuda, kernel):
    """The card's answer for how many clusters fit leads to the plans that
    launch_plan gives without it at the main path's shapes."""
    for s, n in ((42, 468), (129, 54), (387, 6)):
        assert mincut_cuda.card_plan(kernel, s, n) == \
            mincut_cuda.launch_plan(s, n)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "uint8"])
@pytest.mark.parametrize("n,f,d,r", [
    (5, 7, 6, 0), (17, 9, 12, 0), (9, 11, 6, 3), (20, 62, 24, 10),
])
def test_unary_kernel_matches_plain(cuda, dtype, n, f, d, r):
    h, w, vp = 40, 52, 12
    vol, props, fox, foy, stats, scale, th = \
        synthetic.unary_window_problem(np.random.default_rng(n), n, f, d, h,
                                       w, vp, dtype)
    args = (torch.as_tensor(vol, device=cuda), vp,
            torch.as_tensor(props, device=cuda),
            torch.as_tensor(fox, device=cuda),
            torch.as_tensor(foy, device=cuda), f, h, w)
    kw = dict(min_disp=0.0, th_col=th, scale=scale, zero=0.0, pad=vp, r_gf=r,
              stats=tuple(torch.as_tensor(a, device=cuda) for a in stats))
    before = unary_cuda.sample_windows.launches
    got = unary_cuda.sample_windows(*args, **kw)
    torch.cuda.synchronize()
    assert unary_cuda.sample_windows.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == (n, f, f)
    want = unary_cuda.sample_windows_reference(*args, **kw)
    if r == 0:
        torch.testing.assert_close(got, want, rtol=0, atol=UNARY_RAW_ATOL)
        return
    ys = args[4][:, None, None] + torch.arange(f, device=cuda)[None, :, None]
    xs = args[3][:, None, None] + torch.arange(f, device=cuda)[None, None, :]
    fmask = ((xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)).float()
    support = boxfilter.boxsum2d(fmask, r) > 0.5
    torch.testing.assert_close(torch.where(support, got, 0.0),
                               torch.where(support, want, 0.0), rtol=0,
                               atol=UNARY_GF_ATOL)


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
        lab = solver.run(iterations=2, pm_iterations=1)
        assert lab.device.type == device.type
        energies[device.type] = out
    launched = unary_cuda.sample_windows.launches - launches
    assert (launched > 0) == (route == "dma")
    for got, want in zip(energies["cuda"], energies["cpu"]):
        assert abs(got - want) <= 0.002 * abs(want) + 1e-3, energies
