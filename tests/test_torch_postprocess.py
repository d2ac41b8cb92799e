"""The port's dual-view post-process (``localexpstereo_tpu_torch.models.
postprocess``) against the JAX package's host ``post_process`` and its
parts, on labelings built here from a numpy seed.

Tolerances: the consistency check, the 3x3 dilation and the hole fill are
bitwise equal to JAX's. The weighted median sums its weights in float64
(the JAX version in float32), so a pick may differ where half the total
weight falls within a float32 rounding of a cumulative sum: at most
MEDIAN_FLIP_SHARE of the failed pixels may take another label, and on these
inputs none does.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from localexpstereo_tpu.config import PARAMS_GF as J_PARAMS
from localexpstereo_tpu.models import postprocess as jpost
from localexpstereo_tpu_torch.config import PARAMS_GF as T_PARAMS
from localexpstereo_tpu_torch.models import postprocess as tpost
from localexpstereo_tpu_torch.ops import plane as plane_ops

torch.set_num_threads(1)

#: Share of the failed pixels whose weighted-median label may differ from
#: the JAX version's (float64 against float32 weight sums); 0 expected.
MEDIAN_FLIP_SHARE = 0.01


def _planes(rng, d, slope=0.05):
    """[H, W, 4] labels whose plane gives disparity ``d`` at its pixel,
    with random small slopes."""
    h, w = d.shape
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    lab = np.zeros((h, w, 4), np.float32)
    lab[..., 0] = rng.uniform(-slope, slope, (h, w))
    lab[..., 1] = rng.uniform(-slope, slope, (h, w))
    lab[..., 2] = d - lab[..., 0] * xs - lab[..., 1] * ys
    return lab


def _dual_case(seed, h, w, nd=8.0, noise=1.2):
    """A noisy left-right pair of labelings with real consistency failures
    (the recipe of the JAX package's post-process tests) and images of
    integer intensities within 24 levels, so that the median's weights
    exp(-L1 / omega) do not all vanish beside the centre's."""
    rng = np.random.default_rng(seed)
    d_l = np.clip(rng.normal(nd / 2, nd / 4, (h, w)), 0, nd)
    d_r = np.clip(d_l + rng.normal(0, noise, (h, w)), 0, nd)
    im0, im1 = (100 + np.floor(rng.random((h, w, 3)) * 24).astype(np.float32)
                for _ in range(2))
    return (_planes(rng, d_l.astype(np.float32)),
            _planes(rng, d_r.astype(np.float32)), im0, im1)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("seed,threshold", [(0, 1.5), (1, 1.0), (2, 0.5)])
def test_consistency_check_is_bitwise_jax(seed, threshold):
    lab_l, lab_r, _, _ = _dual_case(seed, 13, 29)
    disp_l = plane_ops.disparity_map(_t(lab_l))
    disp_r = plane_ops.disparity_map(_t(lab_r))
    want = jpost.consistency_check(jnp.asarray(disp_l.numpy()),
                                   jnp.asarray(disp_r.numpy()), threshold)
    got = tpost.consistency_check(disp_l, disp_r, threshold)
    for g, wnt in zip(got, want):
        assert g.dtype == torch.uint8
        np.testing.assert_array_equal(g.numpy(), np.asarray(wnt))
    # Both kinds of failure occur.
    values = set(np.unique(got[0].numpy())) | set(np.unique(got[1].numpy()))
    assert {0, 128, 255} <= values


@pytest.mark.parametrize("seed,density", [(3, 0.05), (4, 0.3), (5, 0.7)])
def test_dilate3_is_bitwise_jax(seed, density):
    fail = np.random.default_rng(seed).random((11, 17)) < density
    fail[0, 0] = fail[-1, -1] = True          # corners touch the border
    want = np.asarray(jpost._dilate3(jnp.asarray(fail)))
    got = tpost._dilate3(_t(fail))
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed,density", [(6, 0.05), (7, 0.15), (8, 0.3)])
def test_fill_holes_is_bitwise_jax(seed, density):
    rng = np.random.default_rng(seed)
    lab, _, _, _ = _dual_case(seed, 12, 31)
    fail = rng.random((12, 31)) < density
    fail[3] = True                            # a row with no valid pixel
    fail2 = np.asarray(jpost._dilate3(jnp.asarray(fail)))
    want = np.asarray(jpost.fill_holes(jnp.asarray(lab), jnp.asarray(fail),
                                       jnp.asarray(fail2)))
    got = tpost.fill_holes(_t(lab), _t(fail), _t(fail2))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.numpy() != lab).any()


def _median_pair(lab, img, fail, wind_r, omega=10.0):
    want = jpost.weighted_median_at(lab, img, fail, wind_r, omega)
    got = tpost.weighted_median_at(_t(lab), _t(img), _t(fail), wind_r,
                                   omega, chunk=64)
    return got.numpy(), np.asarray(want)


def _assert_median_equal(got, want, fail):
    """Equal off the failed pixels; at most MEDIAN_FLIP_SHARE of the failed
    ones differ (none expected)."""
    np.testing.assert_array_equal(got[~fail], want[~fail])
    differ = (got[fail] != want[fail]).any(-1).mean()
    assert differ <= MEDIAN_FLIP_SHARE, f"{differ:.4f} of the failed " \
        f"pixels differ"


@pytest.mark.parametrize("seed,h,w,wind_r", [
    (9, 14, 22, 4),     # the window fits the image
    (10, 32, 48, 20),   # windR 20: the window is larger than the image
    (11, 50, 13, 6),    # wider window than the image, taller image
])
def test_weighted_median_matches_jax(seed, h, w, wind_r):
    rng = np.random.default_rng(seed)
    lab, _, img, _ = _dual_case(seed, h, w)
    fail = rng.random((h, w)) < 0.3
    got, want = _median_pair(lab, img, fail, wind_r)
    _assert_median_equal(got, want, fail)
    assert (got[fail] != lab[fail]).any()


def test_weighted_median_on_uniform_guide_is_the_median():
    """Uniform guide, uniform weights: the plain median of the patch's
    disparities (the JAX package's test, on the port)."""
    rng = np.random.default_rng(1)
    lab = np.zeros((9, 9, 4), np.float32)
    vals = rng.permutation(81).astype(np.float32).reshape(9, 9)
    lab[..., 2] = vals
    img = np.full((9, 9, 3), 100.0, np.float32)
    fail = np.zeros((9, 9), bool)
    fail[4, 4] = True
    got = tpost.weighted_median_at(_t(lab), _t(img), _t(fail), 4, 10.0)
    assert float(got[4, 4, 2]) == np.median(vals)
    assert torch.equal(got[fail == 0], _t(lab)[fail == 0])
    none = tpost.weighted_median_at(_t(lab), _t(img), _t(fail & False), 4,
                                    10.0)
    assert torch.equal(none, _t(lab))


@pytest.mark.parametrize("seed,h,w,wind_r,threshold", [
    (12, 14, 22, 4, 1.0),
    (13, 20, 36, 6, 1.5),
    (14, 32, 40, 20, 1.5),   # windR 20 on an image smaller than the window
])
def test_post_process_matches_jax(seed, h, w, wind_r, threshold):
    lab_l, lab_r, im0, im1 = _dual_case(seed, h, w)
    params_j = J_PARAMS.replace(windR=wind_r)
    params_t = T_PARAMS.replace(windR=wind_r)
    want = jpost.post_process(jnp.asarray(lab_l), jnp.asarray(lab_r), im0,
                              im1, params_j, threshold=threshold)
    got = tpost.post_process(_t(lab_l), _t(lab_r), im0, im1, params_t,
                             threshold=threshold)
    disp = [plane_ops.disparity_map(_t(x)) for x in (lab_l, lab_r)]
    fails = tpost.consistency_check(*disp, threshold)
    for g, wnt, lab, fail in zip(got, want, (lab_l, lab_r), fails):
        fail = fail.numpy() > 0
        assert 0 < fail.mean() < 1
        _assert_median_equal(g.numpy(), np.asarray(wnt), fail)
        np.testing.assert_array_equal(g.numpy()[~fail], lab[~fail])


def test_post_process_of_a_consistent_pair_is_a_no_op():
    """Both views at the same small disparity (|d| < 0.5, so no lookup
    leaves the image): no pixel fails, and neither labeling changes, on
    either side."""
    rng = np.random.default_rng(15)
    h, w = 10, 18
    d = rng.uniform(0.0, 0.4, (h, w)).astype(np.float32)
    lab = _planes(rng, d, slope=0.0)
    im = np.floor(rng.random((h, w, 3)) * 255).astype(np.float32)
    disp = plane_ops.disparity_map(_t(lab))
    for fail in tpost.consistency_check(disp, disp, 1.5):
        assert not fail.any()
    got = tpost.post_process(_t(lab), _t(lab), im, im, T_PARAMS, 1.5)
    want = jpost.post_process(jnp.asarray(lab), jnp.asarray(lab), im, im,
                              J_PARAMS, threshold=1.5)
    for g, wnt in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), lab)
        np.testing.assert_array_equal(np.asarray(wnt), lab)
