"""The port's exact min-cut oracle (``native.grid_mincut_oracle``, Dinic) and
the push-relabel certificate (``mincut.solve_preflow``'s ``active_left``,
``mincut.mincut_accept(with_stats=True)``) against the JAX package's, on
the CPU; and the port's cap audit (``tools/gc_cap_audit.py``) against the
JAX tool's problem generator.

Tolerances: the oracle's flow within rel 1e-6 of the JAX oracle's and its
accept mask equal (the same Dinic on the same float32 graph); rounds and
``active_left`` equal to JAX's; a push-relabel cut's region energy within
rel 1e-4 / abs 1e-2 of Dinic's (``tests/test_mincut_oracle.py``; the
labelings may differ on zero-cost ties), and within rel 1e-5 / abs 1e-2
where the certificate is checked (``tests/test_gc_caps.py``).
"""
import os
import sys
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from localexpstereo_tpu import native as jnative
from localexpstereo_tpu.ops import mincut as jmc
from localexpstereo_tpu_torch import native
from localexpstereo_tpu_torch.ops import mincut
from localexpstereo_tpu_torch.tools import gc_cap_audit as audit
from tests.test_mincut import _energy, _random_problem

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import gc_cap_audit as jaudit  # noqa: E402

torch.set_num_threads(1)


def _graphs(arrays):
    """The JAX package's graph and the port's of the same tables."""
    jg = [np.asarray(v) for v in jmc.build_graph(*map(jnp.asarray, arrays))]
    tg = [v.numpy() for v in mincut.build_graph(*map(torch.as_tensor,
                                                     arrays))]
    return jg, tg


@pytest.mark.parametrize("seed,s", [(0, 8), (1, 12), (2, 16), (3, 129)])
def test_oracle_matches_jax(seed, s):
    rng = np.random.default_rng(seed)
    n = 3 if s < 64 else 1
    arrays = (_random_problem(rng, n, s) if s < 64
              else audit.random_problem(rng, n, s, 1.0, 1.0, 1.0, 5.0))
    jg, tg = _graphs(arrays)
    for g in range(3):
        np.testing.assert_array_equal(tg[g], jg[g])
    for i in range(n):
        want_acc, want_flow = jnative.grid_mincut_oracle(jg[0][i], jg[1][i],
                                                         jg[2][i])
        got_acc, got_flow = native.grid_mincut_oracle(
            torch.as_tensor(tg[0][i]), torch.as_tensor(tg[1][i]),
            torch.as_tensor(tg[2][i]))
        assert got_flow == pytest.approx(want_flow, rel=1e-6)
        np.testing.assert_array_equal(got_acc, want_acc)
        # Max flow = min cut: the oracle's own cut has its flow's capacity.
        cut = audit.cut_capacity(got_acc[None], *(x[i:i + 1] for x in tg))
        assert cut[0] == pytest.approx(got_flow, rel=1e-6, abs=1e-3)


def test_oracle_refuses_bad_shapes():
    e = np.zeros((4, 4), np.float32)
    with pytest.raises(ValueError, match="cap_fw"):
        native.grid_mincut_oracle(e, e, np.zeros((4, 4, 3), np.float32))


def test_oracle_build_is_cached_by_source():
    path = native.build(native.ORACLE_SOURCE)
    assert path.parent == native.BUILD_DIR
    assert path.name.startswith("maxflow_") and path.exists()
    assert native.build(native.ORACLE_SOURCE) == path == native.output(
        native.ORACLE_SOURCE)
    assert native.output() != path          # the loader's is another


@pytest.mark.parametrize("seed,s", [(0, 8), (1, 12), (2, 16)])
@pytest.mark.parametrize("rounds,sweeps", [(64, 16), (1, 2)])
def test_stats_match_jax_and_cut_matches_dinic(seed, s, rounds, sweeps):
    """rounds and active_left equal to JAX's (at (1, 2) the solve is cut
    short, so the certificate is not trivially 0); with the full budget
    the cut's energy is Dinic's."""
    rng = np.random.default_rng(seed)
    arrays = _random_problem(rng, 3, s)
    want = [np.asarray(v) for v in jmc.mincut_accept(
        *map(jnp.asarray, arrays), max_global_rounds=rounds,
        sweeps_per_round=sweeps, with_stats=True)]
    acc, got_rounds, got_left = mincut.mincut_accept(
        *map(torch.as_tensor, arrays), max_global_rounds=rounds,
        sweeps_per_round=sweeps, with_stats=True)
    assert int(got_rounds) == int(want[1])
    assert int(got_left) == int(want[2])
    assert (int(got_left) > 0) == (rounds == 1)
    # The default return is unchanged.
    plain = mincut.mincut_accept(*map(torch.as_tensor, arrays),
                                 max_global_rounds=rounds,
                                 sweeps_per_round=sweeps)
    assert torch.equal(plain, acc)
    if rounds == 1:
        return
    _, tg = _graphs(arrays)
    for i in range(3):
        oracle_acc, _ = native.grid_mincut_oracle(tg[0][i], tg[1][i],
                                                  tg[2][i])
        e_got = _energy(acc[i].numpy(), *(a[i] for a in arrays))
        e_ora = _energy(oracle_acc, *(a[i] for a in arrays))
        assert e_got == pytest.approx(e_ora, rel=1e-4, abs=1e-2)


def test_solve_preflow_stats_per_region():
    """active_left per region: [N] int64, its sum the batch's."""
    rng = np.random.default_rng(5)
    arrays = [torch.as_tensor(a) for a in _random_problem(rng, 4, 12)]
    stats = {}
    acc = mincut.solve_preflow(*mincut.build_graph(*arrays), 1, 1, stats)
    assert stats["active_left"].shape == (4,)
    assert stats["active_left"].dtype == torch.int64
    _, rounds, left = mincut.mincut_accept(*arrays, max_global_rounds=1,
                                           sweeps_per_round=1,
                                           with_stats=True)
    assert int(left) == int(stats["active_left"].sum()) > 0
    assert int(rounds) == int(stats["rounds"].max()) == 1
    assert torch.equal(acc, mincut.mincut_accept(
        *arrays, max_global_rounds=1, sweeps_per_round=1))


@pytest.mark.parametrize("s,sweeps,n", [(129, 16, 3), (387, 64, 1)])
def test_capped_rounds_certified_exact(s, sweeps, n):
    """The engine's budget (16 rounds, its sweeps) ends with the
    certificate and the 64-round solve's accepts, in the regimes of
    tests/test_gc_caps.py; the cut's energy is Dinic's."""
    t_start = time.perf_counter()
    assert (16, sweeps) == audit.engine.mincut_knobs(s)
    for ri in audit.CERTIFIED:
        rng = np.random.default_rng(7 + 100 * ri + s)
        arrays = audit.random_problem(rng, n, s, *audit.REGIMES[ri])
        tables = [torch.as_tensor(a) for a in arrays]
        graph = mincut.build_graph(*tables)
        stats = {}
        capped = mincut.solve_preflow(*graph, 16, sweeps, stats)
        assert int(stats["active_left"].sum()) == 0, (s, ri, stats)
        exact = mincut.solve_preflow(*graph, 64, sweeps)
        assert torch.equal(capped, exact)
        oracle_acc, _ = audit.oracle(graph)
        got = audit.region_energy(capped.numpy(), *arrays)
        want = audit.region_energy(oracle_acc, *arrays)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-2)
    print(f"S={s}: {time.perf_counter() - t_start:.1f} s")


@pytest.mark.parametrize("regime", range(5))
def test_random_problem_matches_jax_tool(regime):
    assert audit.REGIMES == jaudit.REGIMES
    params = audit.REGIMES[regime]
    want = jaudit.random_problem(np.random.default_rng(regime), 2, 9,
                                 *params)
    got = audit.random_problem(np.random.default_rng(regime), 2, 9,
                               *params)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.float32
        np.testing.assert_array_equal(g, w)
    x = np.random.default_rng(regime + 10).random((2, 9, 9)) < 0.5
    np.testing.assert_array_equal(audit.region_energy(x, *got),
                                  jaudit.region_energy(x, *want))


@pytest.mark.parametrize("part", ["tables", "expansion", "fusion"])
def test_audit_parts_on_cpu(part):
    """The audit's parts run on the CPU too (the wrappers' plain versions):
    no truncation, the 64-round solve's masks, Dinic's energies."""
    if part == "tables":
        row = audit.audit_tables(42, 16, 2, 3, device="cpu")
    elif part == "expansion":
        row = audit.audit_expansion(42, 16, 3, device="cpu")
    else:
        row = audit.audit_fusion(42, 3, device="cpu")
    assert row["instances"] == 3
    assert 1 <= row["max_rounds"] <= row["rounds"]
    assert row["truncated"] == row["mismatch_64"] == 0
    assert row["mismatch_plain"] == row["outside_dinic"] == 0
    assert row["max_gap_vs_dinic"] <= audit.RTOL
