"""The benchmark's plain reference against the port at a tiny size on the
CPU: the energy build, the cell unary of the init, and the energy of a
labeling against ``engine.energy_audit``."""
import numpy as np
import pytest
import torch

from benchmark.reference import energy as ref
from benchmark.scenes import planted

H, W, ND = 40, 56, 16
CONFIG = {"height": H, "width": W, "ndisp": ND,
          "energy": {"windR": 6, "lambda": 0.5, "th_col": 0.5,
                     "th_smooth": 1.0, "omega": 10.0, "epsilon": 0.01,
                     "gf_eps": 0.0001}}
P = ref.params_of(CONFIG)


@pytest.fixture(scope="module")
def problem():
    from localexpstereo_tpu_torch.config import PARAMS_GF
    from localexpstereo_tpu_torch.models import engine
    img, vol, truth, labels = planted.planted_problem(H, W, ND, 4)
    solver = engine.LocalExpansionSolver(
        img, img, PARAMS_GF.replace(windR=6, lambda_=0.5, th_col=0.5),
        float(ND - 1), vol0=vol, vol1=vol, device="cpu")
    for i, s in enumerate((2, 4, 8)):
        solver.add_layer(s, engine.LAYER0_PROPOSERS if i == 0
                         else engine.COARSE_PROPOSERS)
    solver.finalize()
    return solver, torch.as_tensor(img), torch.as_tensor(vol), labels


def test_build_equals_the_ports(problem):
    solver, img, vol, _ = problem
    d, c = solver.data, solver.cfg
    p = c.pad
    stats = ref.guide_stats(img, P.radius, P.gf_eps)
    assert ref.relative_gap(d.gf_mean[0, p:p + H, p:p + W], stats.mean) \
        < 1e-6
    assert ref.relative_gap(d.gf_inv[0, p:p + H, p:p + W], stats.inv) < 1e-6
    wts = ref.weights(img, P.omega, P.epsilon)
    assert ref.relative_gap(d.coeff8[0, :, p:p + H, p:p + W], wts) < 1e-6
    codes, _ = ref.quantize(vol, P.th_col)
    vp = c.vol_pad
    assert torch.equal(d.vol[0, :, vp:vp + H, vp:vp + W], codes)


def test_cell_unary_equals_the_inits(problem):
    from localexpstereo_tpu_torch.models import engine
    from localexpstereo_tpu_torch.ops import rng
    solver, img, vol, _ = problem
    s, p = 2, solver.cfg.pad
    lab_m, cost_m = engine.init_step(solver.data, solver.cfg,
                                     rng.PRNGKey(3), unit_size=s, mode=0)
    cy, cx = np.meshgrid(np.arange(0, H, s), np.arange(0, W, s),
                         indexing="ij")
    cy, cx = torch.as_tensor(cy.ravel()), torch.as_tensor(cx.ravel())
    labels = lab_m[cy + p, cx + p]
    it = torch.arange(s)
    win_y = cy[:, None, None] - P.radius + torch.arange(s + 2 * P.radius)[
        None, :, None]
    win_x = cx[:, None, None] - P.radius + torch.arange(s + 2 * P.radius)[
        None, None, :]
    inside = (win_y >= 0) & (win_y < H) & (win_x >= 0) & (win_x < W)
    wins = (vol[:, win_y.clamp(0, H - 1), win_x.clamp(0, W - 1)]
            * inside).permute(1, 0, 2, 3)
    stats = ref.guide_stats(img, P.radius, P.gf_eps)
    want = ref.cell_unary(wins, labels, cx, cy, s, stats, P, (H, W))
    got = cost_m[(cy[:, None, None] + it[None, :, None]) + p,
                 (cx[:, None, None] + it[None, None, :]) + p]
    assert float((got.double() - want).abs().max()) < 1e-6


def test_energy_equals_the_ports_audit(problem):
    from localexpstereo_tpu_torch.models import engine
    solver, img, vol, labels = problem
    lab = torch.as_tensor(labels)
    lab_m, cost_m = engine.init_from_labeling(solver.data, solver.cfg, lab,
                                              0)
    total, data, smooth = engine.energy_audit(solver.data, solver.cfg, lab_m,
                                              cost_m, 0)
    stats = ref.guide_stats(img, P.radius, P.gf_eps)
    wts = ref.weights(img, P.omega, P.epsilon)
    codes, scale = ref.quantize(vol, P.th_col)
    want_data = ref.pixel_data_cost(codes, scale, lab, stats, P)
    want_smooth = ref.smoothness(lab, wts, P)
    assert float(smooth) == pytest.approx(float(want_smooth), rel=1e-5)
    assert float(data) == pytest.approx(float(want_data), rel=1e-5)
    assert float(total) == pytest.approx(float(want_data + want_smooth),
                                         rel=1e-5)


def test_control_precision_moves_the_numbers(problem):
    _, img, _, labels = problem
    lab = torch.as_tensor(labels)
    hi = ref.guide_stats(img, P.radius, P.gf_eps)
    lo = ref.guide_stats(img, P.radius, P.gf_eps, torch.float32)
    assert ref.relative_gap(lo.inv, hi.inv) > 1e-6
    wts = ref.weights(img, P.omega, P.epsilon)
    s64 = float(ref.smoothness(lab, wts, P))
    s16 = float(ref.smoothness(lab, wts, P, torch.bfloat16))
    assert abs(s16 - s64) / s64 > 1e-4
    d = ref.disparity(lab)
    assert float((ref.disparity(lab, torch.bfloat16).double() - d).abs()
                 .max()) > 1e-2
