"""The reference's expansion move on small windows: its max-flow finds the
least energy that a search over every mask finds, its energy of a mask
agrees with the energy reference's, and a captured move of a CPU solve
reads no gap."""
import itertools

import numpy as np
import pytest
import torch

from benchmark.reference import cut
from benchmark.reference import energy as ref


def _move(rng, s, invalid=False):
    g = s + 2
    halo = np.zeros((g, g, 4))
    halo[..., :2] = rng.normal(0.0, 0.2, (g, g, 2))
    halo[..., 2] = rng.uniform(0.0, 10.0, (g, g))
    alpha = np.array([rng.normal(0, 0.2), rng.normal(0, 0.2),
                      rng.uniform(0, 10), 0.0])
    u0 = rng.uniform(0.0, 0.5, (s, s))
    u1 = rng.uniform(0.0, 0.5, (s, s))
    if invalid:
        u1[0, 0] = ref.COST_FOR_INVALID
    w = rng.uniform(0.01, 1.0, (8, g, g))
    return halo, alpha, u0, u1, w


@pytest.mark.parametrize("trial", range(12))
def test_min_cut_is_least_over_every_mask(trial):
    rng = np.random.default_rng(trial)
    s = 3
    halo, alpha, u0, u1, w = _move(rng, s, invalid=trial % 3 == 0)
    move = cut.move_terms(halo, alpha, 5.0, 7.0, u0, u1, w, 0.5, 1.0)
    least = min(cut.energy(move, np.array(m, bool))
                for m in itertools.product((0, 1), repeat=s * s))
    assert cut.energy(move, cut.min_cut(move)) == pytest.approx(least,
                                                                abs=1e-6)


def test_move_energy_is_the_energy_references():
    """On a labeling that the window's pixels and halo make whole, the
    move's energy of a mask differs from the energy reference's smoothness
    of the moved labeling by the same constant for every mask."""
    rng = np.random.default_rng(5)
    s, tox, toy = 4, 3, 2
    h, w = 9, 11
    lab = np.zeros((h, w, 4))
    lab[..., :2] = rng.normal(0.0, 0.2, (h, w, 2))
    lab[..., 2] = rng.uniform(0.0, 10.0, (h, w))
    img = torch.as_tensor(rng.uniform(0, 255, (h, w, 3)))
    wts = ref.weights(img, 10.0, 0.01).numpy()
    p = ref.Params(windR=2, lambda_=0.5, th_col=0.5, th_smooth=1.0,
                   omega=10.0, epsilon=0.01, gf_eps=1e-4, min_disp=0.0,
                   max_disp=15.0)
    alpha = np.array([0.1, -0.05, 6.0, 0.0])
    zero = np.zeros((s, s))
    win = (slice(toy - 1, toy + s + 1), slice(tox - 1, tox + s + 1))
    move = cut.move_terms(lab[win], alpha, tox, toy, zero, zero,
                          wts[:, win[0], win[1]], p.lambda_, p.th_smooth)
    gaps = []
    for trial in range(6):
        x = rng.random((s, s)) < 0.5
        moved = lab.copy()
        moved[toy:toy + s, tox:tox + s][x] = alpha
        full = float(ref.smoothness(torch.as_tensor(moved),
                                    torch.as_tensor(wts), p))
        gaps.append(full - cut.energy(move, x))
    assert max(gaps) - min(gaps) < 1e-9


def test_a_control_in_bfloat16_reads_at_or_above_the_least():
    rng = np.random.default_rng(9)
    halo, alpha, u0, u1, w = _move(rng, 6)
    args = (halo, alpha, 0.0, 0.0, u0, u1, w, 0.5, 1.0)
    move = cut.move_terms(*args)
    low = cut.min_cut(cut.move_terms(*args, dtype=torch.bfloat16))
    assert cut.gap(move, low) >= -1e-9
    assert cut.gap(move, cut.min_cut(move)) == 0.0
