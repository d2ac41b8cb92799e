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


#: Seeds at the ends of their range: JAX without 64-bit types keeps a
#: seed's low 32 bits, so the JAX key is made from the port's key words.
INT_KEY_SEEDS = [0, 1, 2 ** 32 - 1, 2 ** 63 - 1]


def _key_pair(seed):
    kt = rng.PRNGKey(seed)
    return jnp.asarray(kt.numpy().astype(np.uint32)), kt


def _tensor_twin(key, hi, lo):
    """threefry2x32 of the counters (hi, lo) by the tensor hash."""
    b1, b2 = rng.threefry2x32(key[0], key[1],
                              torch.as_tensor(hi, dtype=torch.int64),
                              torch.as_tensor(lo, dtype=torch.int64))
    return torch.stack([b1, b2], dim=-1)


@pytest.mark.parametrize("seed", INT_KEY_SEEDS)
@pytest.mark.parametrize("data", [0, 2 ** 32 - 1])
def test_int_fold_in_equals_jax_and_tensor_hash(seed, data):
    """fold_in's Python-integer hash against jax.random.fold_in and the
    tensor hash of the counter (0, data)."""
    kj, kt = _key_pair(seed)
    got = rng.fold_in(kt, data)
    assert got.dtype == torch.int64 and got.shape == (2,)
    np.testing.assert_array_equal(got.numpy(),
                                  _bits(jax.random.fold_in(kj, data)))
    assert torch.equal(got, _tensor_twin(kt, [0], [data])[0])


@pytest.mark.parametrize("seed", INT_KEY_SEEDS)
@pytest.mark.parametrize("num", [1, 2, 3, 4, 8])
def test_int_split_equals_jax_and_tensor_hash(seed, num):
    """split's Python-integer hashes against jax.random.split and the
    tensor hash of the counters (0, i)."""
    kj, kt = _key_pair(seed)
    got = rng.split(kt, num)
    assert got.dtype == torch.int64 and got.shape == (num, 2)
    np.testing.assert_array_equal(got.numpy(),
                                  _bits(jax.random.split(kj, num)))
    assert torch.equal(got, _tensor_twin(kt, [0] * num, list(range(num))))


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


@pytest.mark.parametrize("bounds", [(torch.tensor(0.0), 1.0),
                                    (0.0, torch.tensor(1.0))])
def test_card_uniform_refuses_tensor_bounds(bounds):
    """A draw for the card takes Python bounds: reading a tensor bound
    there would wait for the card. It refuses before touching a device."""
    with pytest.raises(TypeError, match="Python numbers"):
        rng.uniform(rng.PRNGKey(3), (4,), *bounds, device="cuda")


#: The MC-CNN trainer's draws: its batch (4096 pixels), a small shape, and
#: spans of 1, 7, the negatives' 7 (4..10), 48, 64, 375 and 450 (the
#: scenes' heights and widths); minval > 0; maxval <= minval (span 1); and
#: the int32 extremes, where the multiplier's square wraps.
RANDINT_RANGES = [(0, 1), (0, 7), (4, 11), (0, 48), (0, 64), (0, 375),
                  (0, 450), (3, 51), (5, 5), (9, 2), (-3, 100),
                  (-2 ** 31, 2 ** 31 - 1), (0, 2 ** 31 - 1)]
KEYS = [(0, 0), (1, 5), (12345, 999)]


def _keys(seed, data):
    return (jax.random.fold_in(jax.random.PRNGKey(seed), data),
            rng.fold_in(rng.PRNGKey(seed), data))


@pytest.mark.parametrize("seed,data", KEYS)
@pytest.mark.parametrize("shape", [(4096,), (7, 3)])
def test_randint_bits(seed, data, shape):
    kj, kt = _keys(seed, data)
    for lo, hi in RANDINT_RANGES:
        want = np.asarray(jax.random.randint(kj, shape, lo, hi))
        got = rng.randint(kt, shape, lo, hi)
        assert got.dtype == torch.int32 and got.shape == want.shape
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"{lo, hi}")


@pytest.mark.parametrize("seed,data", KEYS)
@pytest.mark.parametrize("shape", [(4096,), (7, 3)])
def test_bernoulli_bits(seed, data, shape):
    kj, kt = _keys(seed, data)
    for p in (0.5, 0.1, 0.0, 1.0):
        want = np.asarray(jax.random.bernoulli(kj, p, shape))
        got = rng.bernoulli(kt, p, shape)
        assert got.dtype == torch.bool
        np.testing.assert_array_equal(got.numpy(), want)


#: jax.random.normal is sqrt(2) * erf_inv(u): the port evaluates XLA's
#: erf_inv polynomial with fused multiply-adds, but torch's float32 log1p
#: rounds otherwise than XLA's, so about 1 % of the draws part by an ulp
#: (measured: at most 2.4e-7 relative over 100,000 draws). Equal draws over
#: these tests' keys and shapes and 200,000 draws a key: 656,401 of 662,592
#: (99.066 %) with erf_inv's root by xla_math.sqrt, 656,391 (99.064 %) with
#: torch.sqrt, whose float32 root misrounds 0.7 % of draws on the CPU. torch.erfinv in
#: its place parts 59 % of the draws, by up to 5.8e-6 relative (five keys,
#: 100,000 draws each and the init's shapes): beyond 1e-6.
NORMAL_RTOL = 5e-7


@pytest.mark.parametrize("seed,data", KEYS)
@pytest.mark.parametrize("shape", [(20000,), (3, 3, 3, 32)])
def test_normal_close(seed, data, shape):
    """Within NORMAL_RTOL of jax.random.normal, and equal on more than
    95 % of the draws: 99.066 % over these keys and shapes with 200,000
    draws a key added (erf_inv's root by xla_math.sqrt; 99.064 % with
    torch.sqrt before it)."""
    kj, kt = _keys(seed, data)
    want = np.asarray(jax.random.normal(kj, shape))
    got = rng.normal(kt, shape)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=NORMAL_RTOL, atol=0)
    assert (got.numpy() == want).mean() > 0.95


def test_erfinv_edges():
    """erf_inv's ends (+-1 -> +-inf), zero, and the branch at w = 5."""
    x = np.float32([-1.0, 1.0, 0.0, -0.5, 0.9966, 0.9967,
                    np.nextafter(np.float32(-1), np.float32(0))])
    want = np.asarray(jax.lax.erf_inv(jnp.asarray(x)))
    got = rng.erfinv(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=NORMAL_RTOL, atol=0)
    assert np.isinf(got[:2]).all() and (np.sign(got[:2]) == [-1, 1]).all()


def test_randint_refuses_bounds_beyond_int32():
    with pytest.raises(ValueError, match="int32"):
        rng.randint(rng.PRNGKey(0), (3,), 0, 2 ** 31)
