"""The port's float32 math as XLA computes it on the CPU
(``ops/xla_math.py``) against ``jnp`` on seeded draws: ``sincosf`` and
``cosf`` (glibc's ``sinf`` / ``cosf``), ``sqrt``, ``norm3``, the fused multiply-add and the 3-term dot
chain bit for bit, ``rsqrt`` within an ulp of ``lax.rsqrt``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from localexpstereo_tpu_torch.ops import xla_math

torch.set_num_threads(1)

DRAWS = 1_000_000
TRIG_RANGES = {"0-2pi": (0.0, 2 * np.pi), "pm-pi": (-np.pi, np.pi),
               "pm-pi/4": (-np.pi / 4, np.pi / 4),
               "tiny": (-2.0 ** -12, 2.0 ** -12)}


def _draws(seed, lo, hi, n=DRAWS):
    return np.random.default_rng(seed).uniform(lo, hi, n).astype(np.float32)


@pytest.mark.parametrize("name", sorted(TRIG_RANGES))
def test_sinf_cosf_are_jnp(name):
    x = _draws(len(name), *TRIG_RANGES[name])
    sin, cos = xla_math.sincosf(torch.from_numpy(x))
    assert sin.dtype == cos.dtype == torch.float32
    np.testing.assert_array_equal(sin.numpy(), np.asarray(jnp.sin(x)))
    np.testing.assert_array_equal(cos.numpy(), np.asarray(jnp.cos(x)))
    np.testing.assert_array_equal(xla_math.cosf(torch.from_numpy(x)).numpy(),
                                  cos.numpy())


def test_sinf_cosf_on_every_angle_a_draw_can_give():
    """theta = uniform(0, 2 pi) takes 2^23 values (23 random mantissa
    bits): every one of them, in four parts."""
    u = (np.arange(2 ** 23, dtype=np.uint32) | 0x3F800000).view(
        np.float32) - np.float32(1.0)
    theta = np.array(jax.jit(lambda v: v * np.float32(2 * np.pi)
                             + np.float32(0.0))(u))
    for part in np.array_split(theta, 4):
        sin, cos = xla_math.sincosf(torch.from_numpy(part))
        np.testing.assert_array_equal(sin.numpy(), np.asarray(jnp.sin(part)))
        np.testing.assert_array_equal(cos.numpy(), np.asarray(jnp.cos(part)))


def test_sincosf_refuses_arguments_beyond_its_range():
    for bad in (120.0, -300.0, np.inf, np.nan):
        with pytest.raises(ValueError):
            xla_math.sincosf(torch.tensor([0.5, bad], dtype=torch.float32))
    x = torch.tensor([119.9, -119.9, 0.0, -0.0], dtype=torch.float32)
    np.testing.assert_array_equal(xla_math.sincosf(x)[0].numpy(),
                                  np.asarray(jnp.sin(x.numpy())))


def test_sqrt_is_jnp():
    r = np.random.default_rng(3)
    x = np.concatenate([
        r.uniform(0, 1, DRAWS), r.uniform(0, 1e6, DRAWS),
        np.exp(r.uniform(-80, 80, DRAWS))]).astype(np.float32)
    np.testing.assert_array_equal(xla_math.sqrt(torch.from_numpy(x)).numpy(),
                                  np.asarray(jnp.sqrt(x)))


def test_norm3_is_jnp():
    v = _draws(4, -2.0, 2.0, 3 * DRAWS).reshape(-1, 3)
    got = xla_math.norm3(torch.from_numpy(v)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jnp.linalg.norm(v, axis=-1)))


def test_fma_is_xlas_contracted_multiply_add():
    r = np.random.default_rng(5)
    a, b, c = (r.normal(0, s, DRAWS).astype(np.float32) for s in (1, 3, 2))
    want = np.asarray(jax.jit(lambda a, b, c: a * b + c)(a, b, c))
    got = xla_math.fma(*map(torch.from_numpy, (a, b, c))).numpy()
    np.testing.assert_array_equal(got, want)


def test_matvec3_is_xlas_dot():
    r = np.random.default_rng(6)
    a = r.normal(0, 100, (DRAWS, 3, 3)).astype(np.float32)
    b = r.normal(0, 10, (DRAWS, 3)).astype(np.float32)
    want = np.asarray(jnp.einsum("...ij,...j->...i", a, b))
    got = xla_math.matvec3(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(got, want)


#: rsqrt against lax.rsqrt (the processor's estimate and two Newton steps):
#: within an ulp, and equal on at least this share of the draws (measured
#: on these draws: 0.8688 of 1 + a^2 + b^2, 0.8641 of exp(U(-20, 20))).
RSQRT_EQUAL_SHARE = 0.86


def test_rsqrt_within_an_ulp_of_lax():
    r = np.random.default_rng(7)
    a, b = (r.uniform(-3, 3, 2 * DRAWS).astype(np.float32) for _ in (0, 1))
    for x in ((np.float32(1.0) + a * a + b * b).astype(np.float32),
              np.exp(r.uniform(-20, 20, DRAWS)).astype(np.float32)):
        want = np.asarray(jax.lax.rsqrt(x))
        got = xla_math.rsqrt(torch.from_numpy(x)).numpy()
        assert np.abs(got.view(np.int32) - want.view(np.int32)).max() <= 1
        assert (got == want).mean() >= RSQRT_EQUAL_SHARE
