"""Port min-cut: the plain fused expansion move against the JAX package's
Pallas kernel (interpret mode, both layouts) and its split XLA pipeline.
The CUDA kernel against the plain version is in test_torch_cuda.py, which
imports no JAX so that it runs on the card."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from localexpstereo_tpu.ops import mincut as jmc
from localexpstereo_tpu.ops import mincut_pallas as jmp
from localexpstereo_tpu.ops import pairwise as jpw
from localexpstereo_tpu_torch.ops import mincut as tmc
from localexpstereo_tpu_torch.ops import mincut_cuda
from localexpstereo_tpu_torch.utils.synthetic import fused_move_problem

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-4


def _xla_terms(arrays, lam, tau):
    """(t0, t1, c00, c01, c10) of the JAX split pipeline."""
    halo, props, tox, toy, coeff8, ccost, pcost = map(jnp.asarray, arrays)
    coeff_fwd = coeff8[:, list(jpw.FORWARD)]
    c00, c01, c10 = jax.vmap(
        lambda hl, pr, cf, x0, y0: jpw.expansion_tables(
            hl, pr, cf, x0, y0, lam, tau))(halo, props, coeff_fwd, tox, toy)
    t0b, t1b = jax.vmap(
        lambda hl, pr, cf, x0, y0: jpw.boundary_tlinks(
            hl, pr, cf, x0, y0, lam, tau))(halo, props, coeff8, tox, toy)
    return ccost + t0b, pcost + t1b, c00, c01, c10


def _cut_energy(accept, terms):
    return np.asarray(jmc.move_energy_delta(jnp.asarray(np.asarray(accept)),
                                            *terms))


@pytest.mark.parametrize("n,s,seed", [(6, 6, 0), (3, 9, 0),
                                      (jmp._RL_B // 2 + 6, 5, 2)])
def test_reference_matches_pallas_kernel(n, s, seed):
    """Against the Pallas kernel in interpret mode: the [b, S, S] layout,
    and at n >= 64 with small S its region-on-lanes layout."""
    arrays, lam, tau = fused_move_problem(np.random.default_rng(seed), n, s)
    kw = dict(lam=lam, tau=tau, max_global_rounds=16, sweeps_per_round=16)
    want = jmp.expansion_accept_pallas(*map(jnp.asarray, arrays),
                                       interpret=True, **kw)
    got = mincut_cuda.expansion_accept(*map(torch.as_tensor, arrays), **kw)
    assert got.dtype == torch.bool and got.shape == (n, s, s)
    terms = _xla_terms(arrays, lam, tau)
    e_want, e_got = _cut_energy(want, terms), _cut_energy(got, terms)
    np.testing.assert_allclose(e_got, e_want, rtol=RTOL, atol=ATOL)
    assert np.all(e_got <= 1e-5)


@pytest.mark.parametrize("n,s,seed", [(6, 6, 3), (4, 10, 4)])
def test_reference_matches_xla_pipeline(n, s, seed):
    """Against tables + t-links + mincut_accept + guard of the XLA path."""
    arrays, lam, tau = fused_move_problem(np.random.default_rng(seed), n, s)
    terms = _xla_terms(arrays, lam, tau)
    want = jmc.mincut_accept(*terms)
    want = want & (jmc.move_energy_delta(want, *terms) <= 0.0)[:, None, None]
    got = mincut_cuda.expansion_accept_reference(
        *map(torch.as_tensor, arrays), lam=lam, tau=tau)
    e_want, e_got = _cut_energy(want, terms), _cut_energy(got, terms)
    np.testing.assert_allclose(e_got, e_want, rtol=RTOL, atol=ATOL)
    assert np.all(e_got <= 1e-5)


def test_fused_terms_match_split_tables():
    """The pairwise module's tables and t-links, which fused_terms
    assembles, against the JAX split pipeline's."""
    arrays, lam, tau = fused_move_problem(np.random.default_rng(5), 4, 7)
    c00, c01, c10, t0, t1 = mincut_cuda.fused_terms(
        *map(torch.as_tensor, arrays), lam, tau)
    jt0, jt1, j00, j01, j10 = _xla_terms(arrays, lam, tau)
    for got, want in ((c00, j00), (c01, j01), (c10, j10), (t0, jt0),
                      (t1, jt1)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)


def test_split_pipeline_parts_match_jax():
    """build_graph, mincut_accept, move_energy_delta and greedy_accept of
    ops/mincut.py against their JAX counterparts."""
    arrays, lam, tau = fused_move_problem(np.random.default_rng(6), 5, 8)
    terms = _xla_terms(arrays, lam, tau)
    tterms = [torch.as_tensor(np.array(t)) for t in terms]
    for got, want in zip(tmc.build_graph(*tterms), jmc.build_graph(*terms)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)
    acc = tmc.mincut_accept(*tterms, max_global_rounds=64,
                            sweeps_per_round=16)
    np.testing.assert_allclose(
        _cut_energy(acc, terms), _cut_energy(jmc.mincut_accept(*terms),
                                             terms), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tmc.move_energy_delta(acc, *tterms).numpy(),
                               _cut_energy(acc, terms), rtol=1e-5, atol=1e-4)
    c, p = tterms[0], tterms[1]
    assert torch.equal(tmc.greedy_accept(c, p), p < c)


def test_wrapper_checks_inputs():
    arrays, lam, tau = fused_move_problem(np.random.default_rng(7), 2, 4)
    args = list(map(torch.as_tensor, arrays))
    bad = list(args)
    bad[4] = args[4].double()
    with pytest.raises(TypeError):
        mincut_cuda.expansion_accept(*bad, lam=lam, tau=tau)
    bad = list(args)
    bad[5] = args[5][:, :3]
    with pytest.raises(ValueError):
        mincut_cuda.expansion_accept(*bad, lam=lam, tau=tau)
    bad = list(args)
    bad[4] = args[4].transpose(2, 3)
    with pytest.raises(ValueError):
        mincut_cuda.expansion_accept(*bad, lam=lam, tau=tau)
    before = mincut_cuda.expansion_accept.launches
    mincut_cuda.expansion_accept(*args, lam=lam, tau=tau)
    assert mincut_cuda.expansion_accept.launches == before  # CPU: no kernel
