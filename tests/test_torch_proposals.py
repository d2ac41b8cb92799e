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


def _cells(seed, s=S, nbx=NBX, nby=NBY):
    """Cell labels, origins and clipped cell sizes of one color grid."""
    r = np.random.default_rng(seed)
    n = nbx * nby
    lab = np.zeros((n, s, s, 4), np.float32)
    lab[..., 0] = r.uniform(-0.2, 0.2, (n, s, s))
    lab[..., 1] = r.uniform(-0.2, 0.2, (n, s, s))
    lab[..., 2] = r.uniform(2, 12, (n, s, s))
    # A few cells are a clean plane, so RANSAC has inliers to find.
    lab[:4, ..., 0], lab[:4, ..., 1], lab[:4, ..., 2] = 0.05, -0.03, 6.0
    ox = (np.arange(nbx)[None, :].repeat(nby, 0).reshape(-1) * 4 * s + s)
    oy = (np.arange(nby)[:, None].repeat(nbx, 1).reshape(-1) * 4 * s)
    width, height = 4 * s * nbx - 3, 4 * s * nby - 5
    cw = np.clip(width - ox, 1, s)
    ch = np.clip(height - oy, 1, s)
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
    # and bit for bit as the JAX engine computes them, under jit
    want = np.asarray(jax.jit(jprop.ransac)(kj, jnp.asarray(lab), *j))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("s,nbx,nby", [(14, 6, 4), (43, 3, 2), (129, 2, 1)])
def test_ransac_is_the_jitted_reference(s, nbx, nby):
    """At the main path's cell sizes (P = 196, 1849, 16641 pixels a cell)
    the port's RANSAC equals the JAX function under jit, as the JAX engine
    runs it: the refit's sums, the 3 x 3 solves and every contracted
    multiply-add."""
    lab, j, t = _cells(s, s, nbx, nby)
    kj, kt = _keys(s)
    want = np.asarray(jax.jit(jprop.ransac)(kj, jnp.asarray(lab), *j))
    got = tprop.ransac(kt, torch.as_tensor(lab), *t).numpy()
    np.testing.assert_array_equal(got, want)


def test_random_label_and_unit_vector():
    """Bit for bit with the JAX functions under jit (the JAX engine's
    form: XLA contracts 1 - z^2 and the plane's offset into fused
    multiply-adds, and its sin, cos and sqrt are glibc's sinf, cosf and a
    rounded root)."""
    kj = jax.random.fold_in(jax.random.PRNGKey(0), 1000)
    kt = rng.fold_in(rng.PRNGKey(0), 1000)
    x = np.arange(500, dtype=np.float32) * 3.0
    y = np.arange(500, dtype=np.float32)[::-1] * 2.0
    want = np.asarray(jax.jit(jplane.random_label, static_argnums=(3, 4))(
        kj, jnp.asarray(x), jnp.asarray(y), 0.0, 144.0))
    got = tplane.random_label(kt, torch.as_tensor(x), torch.as_tensor(y),
                              0.0, 144.0).numpy()
    np.testing.assert_array_equal(got, want)
    for angle in (np.pi, np.pi / 3):
        want = np.asarray(jax.jit(jplane.random_unit_vector,
                                  static_argnums=(1, 2))(kj, angle, (2000,)))
        got = tplane.random_unit_vector(kt, angle, (2000,)).numpy()
        np.testing.assert_array_equal(got, want)


def test_random_proposal_count():
    for outer in range(4):
        for lo, hi in ((0.0, 15.0), (0.0, 144.0), (2.0, 2.3)):
            assert (tprop.random_proposal_count(7, outer, lo, hi)
                    == jprop.random_proposal_count(7, outer, lo, hi))


@pytest.mark.parametrize("s", [8, 43, 129])
def test_refit_sums_are_the_cpu_float32_sums(s):
    """The refit's normal equations equal the JAX package's float32 einsums
    bit for bit, eagerly and under jit as RANSAC computes them (each a
    fused multiply-add chain over the cell's pixels in order), and lie
    within the float32 error bound of a sum of rounded products in any
    order, (P + 1) u sum |terms|, of the exact (float64) sums."""
    r = np.random.default_rng(s)
    n = 7
    iy, ix = np.mgrid[0:s, 0:s].astype(np.float32)
    feats = np.stack([ix.ravel(), iy.ravel(), np.ones(s * s, np.float32)],
                     -1)[None].repeat(n, 0)
    w = (r.random((n, s * s)) < 0.6).astype(np.float32)
    d = r.uniform(0, 300, (n, s * s)).astype(np.float32)
    got = tprop.refit_sums(*map(torch.as_tensor, (feats, w, d)))
    fw = feats * w[..., None]
    jax_sums = (jnp.einsum("npi,npj->nij", fw, feats),
                jnp.einsum("npi,np->ni", fw, d * w))

    @jax.jit
    def jitted(feats, w, d):
        wgt = w[..., None]
        return (jnp.einsum("npi,npj->nij", feats * wgt, feats),
                jnp.einsum("npi,np->ni", feats * wgt, d * w))

    f64 = feats.astype(np.float64)
    fw64 = f64 * w[..., None]
    for g, j, jj, terms in zip(got, jax_sums, jitted(feats, w, d), (
            fw64[..., :, None] * f64[..., None, :],
            fw64 * (d.astype(np.float64) * w)[..., None])):
        assert g.dtype == torch.float32 and g.shape == j.shape
        np.testing.assert_array_equal(g.numpy(), np.asarray(j))
        np.testing.assert_array_equal(g.numpy(), np.asarray(jj))
        want = terms.sum(1)
        bound = (s * s + 1) * 2.0 ** -24 * np.abs(terms).sum(1)
        assert (np.abs(g.numpy() - want) <= bound).all()
