"""The port's threefry RNG against jax.random, bit for bit."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from localexpstereo_tpu_torch.ops import rng

torch.set_num_threads(1)


def _bits(k):
    return np.asarray(k).astype(np.int64)


@pytest.mark.parametrize("seed", [0, 1, 12345, 2**31 - 1])
def test_prngkey_and_fold_in(seed):
    kj = jax.random.PRNGKey(seed)
    kt = rng.PRNGKey(seed)
    np.testing.assert_array_equal(_bits(kj), kt.numpy())
    for data in (0, 1, 1000, 2003, 3107, 99999):
        np.testing.assert_array_equal(_bits(jax.random.fold_in(kj, data)),
                                      rng.fold_in(kt, data).numpy())


@pytest.mark.parametrize("num", [2, 3, 4])
def test_split(num):
    kj = jax.random.fold_in(jax.random.PRNGKey(0), 1000)
    kt = rng.fold_in(rng.PRNGKey(0), 1000)
    np.testing.assert_array_equal(_bits(jax.random.split(kj, num)),
                                  rng.split(kt, num).numpy())


@pytest.mark.parametrize("shape,lo,hi", [
    ((468,), 0.0, 1.0),                 # _cell_pixel at the fine layer
    ((32 * 54,), 0.0, 1.0),             # RANSAC hypotheses
    ((7313,), 0.0, 144.0),              # init disparities
    ((468,), 0.0, 2.0 * np.pi),         # random_unit_vector theta
    ((5, 7), -3.5, 2.25),
])
def test_uniform_bits(shape, lo, hi):
    kj = jax.random.fold_in(jax.random.PRNGKey(7), 42)
    kt = rng.fold_in(rng.PRNGKey(7), 42)
    want = np.asarray(jax.random.uniform(kj, shape, minval=lo, maxval=hi))
    got = rng.uniform(kt, shape, lo, hi).numpy()
    np.testing.assert_array_equal(got, want)


def test_uniform_cos_minval():
    """random_unit_vector's z range starts at cos(angle) in float32."""
    kj = jax.random.PRNGKey(3)
    kt = rng.PRNGKey(3)
    want = np.asarray(jax.random.uniform(kj, (100,),
                                         minval=jnp.cos(jnp.pi / 3),
                                         maxval=1.0))
    got = rng.uniform(kt, (100,),
                      torch.cos(torch.tensor(np.pi / 3, dtype=torch.float32)),
                      1.0).numpy()
    np.testing.assert_array_equal(got, want)
