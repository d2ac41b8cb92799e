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
from localexpstereo_tpu_torch.ops import mincut, mincut_cuda
from localexpstereo_tpu_torch.utils import synthetic

RTOL, ATOL = 1e-5, 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n,s,rounds,sweeps", [
    (16, 12, 16, 16), (3, 40, 16, 64), (5, 9, 2, 3),   # last: truncated solve
])
def test_expansion_kernel_matches_plain(cuda, n, s, rounds, sweeps):
    arrays, lam, tau = synthetic.fused_move_problem(
        np.random.default_rng(n), n, s)
    args = [torch.as_tensor(a, device=cuda) for a in arrays]
    kw = dict(lam=lam, tau=tau, max_global_rounds=rounds,
              sweeps_per_round=sweeps)
    before = mincut_cuda.expansion_accept.launches
    got = mincut_cuda.expansion_accept(*args, **kw)
    torch.cuda.synchronize()
    assert mincut_cuda.expansion_accept.launches == before + 1
    assert got.dtype == torch.bool and got.shape == (n, s, s)
    want = mincut_cuda.expansion_accept_reference(*args, **kw)
    c00, c01, c10, t0, t1 = mincut_cuda.fused_terms(*args, lam, tau)
    e_got = mincut.move_energy_delta(got, t0, t1, c00, c01, c10).cpu()
    e_want = mincut.move_energy_delta(want, t0, t1, c00, c01, c10).cpu()
    np.testing.assert_allclose(e_got.numpy(), e_want.numpy(), rtol=RTOL,
                               atol=ATOL)
    assert bool((e_got <= 1e-5).all())


@pytest.mark.cuda
@pytest.mark.parametrize("windr", [6, 20])
def test_solve_on_card_matches_cpu(cuda, windr):
    """A small V3 solve on the card lands on the CPU solve's energies, at a
    narrow filter window and at the main path's (windR 20)."""
    img, vol, h, w, nd, truth = synthetic.build_problem(0.06)
    energies = {}
    for device in (cuda, torch.device("cpu")):
        solver = engine.LocalExpansionSolver(
            img, img, PARAMS_GF.replace(windR=windr, lambda_=0.5, th_col=0.5),
            max_disp=float(nd - 1), vol0=vol, vol1=vol, device=device)
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
    for got, want in zip(energies["cuda"], energies["cpu"]):
        assert abs(got - want) <= 0.002 * abs(want) + 1e-3, energies
