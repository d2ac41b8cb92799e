"""Port proposals against the JAX package's with the same keys."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from localexpstereo_tpu.models import proposals as jprop
from localexpstereo_tpu.ops import plane as jplane
from localexpstereo_tpu_torch.models import proposals as tprop
from localexpstereo_tpu_torch.ops import plane as tplane
from localexpstereo_tpu_torch.ops import rng

torch.set_num_threads(1)

S = 8
NBX, NBY = 4, 3


def _cells(seed):
    """Cell labels, origins and clipped cell sizes of one color grid."""
    r = np.random.default_rng(seed)
    n = NBX * NBY
    lab = np.zeros((n, S, S, 4), np.float32)
    lab[..., 0] = r.uniform(-0.2, 0.2, (n, S, S))
    lab[..., 1] = r.uniform(-0.2, 0.2, (n, S, S))
    lab[..., 2] = r.uniform(2, 12, (n, S, S))
    # A few cells are a clean plane, so RANSAC has inliers to find.
    lab[:4, ..., 0], lab[:4, ..., 1], lab[:4, ..., 2] = 0.05, -0.03, 6.0
    ox = (np.arange(NBX)[None, :].repeat(NBY, 0).reshape(-1) * 4 * S + S)
    oy = (np.arange(NBY)[:, None].repeat(NBX, 1).reshape(-1) * 4 * S)
    width, height = 4 * S * NBX - 3, 4 * S * NBY - 5
    cw = np.clip(width - ox, 1, S)
    ch = np.clip(height - oy, 1, S)
    j = [jnp.asarray(a.astype(np.int32)) for a in (ox, oy, cw, ch)]
    t = [torch.as_tensor(a.astype(np.int64)) for a in (ox, oy, cw, ch)]
    return lab, j, t


def _keys(seed):
    return (jax.random.fold_in(jax.random.PRNGKey(seed), 5),
            rng.fold_in(rng.PRNGKey(seed), 5))


@pytest.mark.parametrize("seed", [0, 1])
def test_expansion(seed):
    lab, j, t = _cells(seed)
    kj, kt = _keys(seed)
    want = np.asarray(jprop.expansion(kj, jnp.asarray(lab), *j))
    got = tprop.expansion(kt, torch.as_tensor(lab), *t).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed,outer", [(0, 0), (1, 2)])
def test_random_perturbation(seed, outer):
    lab, j, t = _cells(seed)
    kj, kt = _keys(seed)
    dz = np.float32(15.0 * 0.5 ** (outer + 1))
    nr = np.float32(0.5 ** outer)
    want = np.asarray(jprop.random_perturbation(
        kj, jnp.asarray(lab), *j, jnp.float32(dz), jnp.float32(nr), 0.0,
        15.0))
    got = tprop.random_perturbation(kt, torch.as_tensor(lab), *t, float(dz),
                                    float(nr), 0.0, 15.0).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1])
def test_ransac(seed):
    lab, j, t = _cells(seed)
    kj, kt = _keys(seed)
    want = np.asarray(jprop.ransac(kj, jnp.asarray(lab), *j))
    got = tprop.ransac(kt, torch.as_tensor(lab), *t).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # the planted planes are recovered exactly enough to be inliers
    np.testing.assert_allclose(got[:4, :2], [[0.05, -0.03]] * 4, atol=1e-4)


def test_random_label_and_unit_vector():
    kj = jax.random.fold_in(jax.random.PRNGKey(0), 1000)
    kt = rng.fold_in(rng.PRNGKey(0), 1000)
    x = np.arange(50, dtype=np.float32) * 3.0
    y = np.arange(50, dtype=np.float32)[::-1] * 2.0
    want = np.asarray(jplane.random_label(kj, jnp.asarray(x), jnp.asarray(y),
                                          0.0, 144.0))
    got = tplane.random_label(kt, torch.as_tensor(x), torch.as_tensor(y),
                              0.0, 144.0).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    want = np.asarray(jplane.random_unit_vector(kj, np.pi, (20,)))
    got = tplane.random_unit_vector(kt, np.pi, (20,)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_random_proposal_count():
    for outer in range(4):
        for lo, hi in ((0.0, 15.0), (0.0, 144.0), (2.0, 2.3)):
            assert (tprop.random_proposal_count(7, outer, lo, hi)
                    == jprop.random_proposal_count(7, outer, lo, hi))
