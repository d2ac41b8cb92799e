"""The port's batched solver (``localexpstereo_tpu_torch.parallel.batch``)
against the JAX package's ``BatchedSolver`` on a one-device mesh: two
pairs over two gloo ranks on the CPU. ``sweep()`` with a given key and
with its default key (``split(key, B)``, one key a pair), the ``run()``
trajectory, and a checkpoint the port wrote, which the JAX package reads
and resumes into the end of the port's run. Energies agree within the
engine tests' trajectory tolerance, 0.002 |E| + 1e-3. The port's solves
run (with a timeout) in the background while this process runs the JAX
ones."""
import concurrent.futures
import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from localexpstereo_tpu.config import PARAMS_GF as J_PARAMS
from localexpstereo_tpu.models import engine as jeng
from localexpstereo_tpu.parallel import batch as jbatch
from localexpstereo_tpu.parallel import mesh as jmesh
from localexpstereo_tpu.utils import checkpoint as jckpt
from localexpstereo_tpu_torch.config import PARAMS_GF
from localexpstereo_tpu_torch.models import engine
from localexpstereo_tpu_torch.ops import rng
from localexpstereo_tpu_torch.parallel import collectives
from localexpstereo_tpu_torch.parallel.batch import BatchedSolver
from localexpstereo_tpu_torch.utils import checkpoint

torch.set_num_threads(1)

TIMEOUT_S = 300
B, H, W, ND = 2, 20, 28, 5
SEED = 5
#: The run's greedy and graph-cut sweeps; the checkpoint every 2 sweeps
#: holds the state after 1 + 1.
PM, GC = 1, 2
LAYERS = [3, 6]
#: The key of the first ad-hoc sweep (the second takes the default key).
SWEEP_KEY = 3
KNOBS = {"windR": 4, "lambda_": 0.5, "th_col": 0.5}


def _pairs():
    r = np.random.default_rng(4)
    ims = (r.random((B, H, W + 3, 3)) * 255).astype(np.float32)
    dd = np.arange(ND, dtype=np.float32)[:, None, None]
    vols = np.stack([np.minimum(np.abs(dd - r.random((H, W), np.float32)
                                       * (ND - 1)) * 0.4, 1.0)
                     for _ in range(B)]).astype(np.float32)
    return ims[:, :, :W], ims[:, :, 3:], vols


def _close(got, want):
    return abs(got - want) <= 0.002 * abs(want) + 1e-3


class _Energies:
    """Records each (pair, index) total energy through ``audit``."""

    def __init__(self, b, audit):
        self.b, self.audit, self.rows = b, audit, {}

    def start(self):
        pass

    def stop(self):
        pass

    def evaluate(self, solver, labeling_m, cost_m, mode, index):
        self.rows[(self.b, index)] = float(self.audit(
            solver.data, solver.cfg, labeling_m, cost_m, mode)[0])


def _totals(energies):
    (tot, _, _), _ = energies
    return [float(x) for x in np.asarray(tot)]


def _port_rank(rank, device, ck):
    ims0, ims1, vols = _pairs()
    args = (ims0, ims1, PARAMS_GF.replace(**KNOBS), float(ND - 1), LAYERS)
    kw = {"device": device, "vols0": vols, "vols1": vols, "seed": SEED,
          "vol_dtype": "float32"}
    bs = BatchedSolver(*args, **kw)
    st = bs.init(0)
    sweeps = [_totals(bs.energies(st))]
    st = bs.sweep(st, 0, False, key=rng.PRNGKey(SWEEP_KEY))
    sweeps.append(_totals(bs.energies(st)))
    st = bs.sweep(st, 1, True)
    sweeps.append(_totals(bs.energies(st)))
    bs = BatchedSolver(*args, **kw)
    recs = [_Energies(b, engine.energy_audit) for b in range(B)]
    bs.set_evaluators(recs)
    bs.run(GC, pm_iterations=PM, checkpoint_path=ck, checkpoint_every=2)
    rows = {}
    for rec in recs:
        rows.update(rec.rows)
    return {"sweeps": sweeps, "rows": rows,
            "end": _totals(bs.energies(bs._state[0]))}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    ck = os.fspath(tmp_path_factory.mktemp("batched_jax") / "port.npz")
    pool = concurrent.futures.ThreadPoolExecutor(1)
    future = pool.submit(collectives.launch, _port_rank, ["cpu"] * 2, ck,
                         timeout_s=TIMEOUT_S)
    ims0, ims1, vols = _pairs()
    mesh = jmesh.make_mesh((1,), ("data",), jax.devices()[:1])

    def solver():
        js = jbatch.BatchedSolver(
            ims0, ims1, J_PARAMS.replace(**KNOBS), float(ND - 1), mesh=mesh,
            unit_sizes=LAYERS, vols0=vols, vols1=vols, seed=SEED,
            vol_dtype="float32")
        # The port's min-cut knobs at these window sizes (16, 16); the JAX
        # engine's CPU defaults differ.
        js.cfg = dataclasses.replace(js.cfg, gc_rounds=16, gc_sweeps=16)
        return js

    js = solver()
    st = js.init(0)
    sweeps = [_totals(js.energies(st))]
    st = js.sweep(st, 0, False, key=jax.random.PRNGKey(SWEEP_KEY))
    sweeps.append(_totals(js.energies(st)))
    st = js.sweep(st, 1, True)
    sweeps.append(_totals(js.energies(st)))
    js = solver()
    recs = [_Energies(b, jeng.energy_audit) for b in range(B)]
    js.set_evaluators(recs)
    js.run(GC, pm_iterations=PM)
    rows = {}
    for rec in recs:
        rows.update(rec.rows)
    jax_out = {"sweeps": sweeps, "rows": rows,
               "end": _totals(js.energies(js._state[0]))}
    ports = future.result(timeout=TIMEOUT_S)
    pool.shutdown()
    resumed = solver()
    resumed.run(GC, pm_iterations=PM, resume_from=ck)
    jax_out["resumed"] = _totals(resumed.energies(resumed._state[0]))
    return jax_out, ports, ck


def test_sweep_keys_follow_jax(runs):
    """The init, ``sweep(key=PRNGKey(3))`` (greedy) and ``sweep()`` with
    the default key ``PRNGKey(seed + 17 (outer_iter + 1))`` (graph cut):
    every pair's energy, on every rank, within the tolerance of JAX's."""
    jax_out, ports, _ = runs
    for port in ports:
        for got_row, want_row in zip(port["sweeps"], jax_out["sweeps"]):
            for got, want in zip(got_row, want_row):
                assert _close(got, want), (port["sweeps"], jax_out["sweeps"])
    # The keys differ by pair: the two pairs end on different energies.
    assert jax_out["sweeps"][2][0] != jax_out["sweeps"][2][1]


def test_run_trajectory_follows_jax(runs):
    """Each pair's energy after the init and every sweep of ``run()``."""
    jax_out, ports, _ = runs
    rows = {}
    for port in ports:
        rows.update(port["rows"])
    assert sorted(rows) == sorted(jax_out["rows"]) == [
        (b, i) for b in range(B) for i in range(1 + PM + GC)]
    for k, want in jax_out["rows"].items():
        assert _close(rows[k], want), (rows, jax_out["rows"])
    for port in ports:
        for got, want in zip(port["end"], jax_out["end"]):
            assert _close(got, want)


def test_jax_reads_and_resumes_the_ports_checkpoint(runs):
    """The JAX package loads the port's mid-run checkpoint ([B, ...]
    arrays, the state after 1 + 1 sweeps) as the port does, and its run
    resumed from it ends where the port's uninterrupted run ends."""
    jax_out, ports, ck = runs
    jck, tck = jckpt.load_checkpoint(ck), checkpoint.load_checkpoint(ck)
    assert (jck.seed, jck.pm_iterations_done, jck.iterations_done,
            jck.pad) == (tck.seed, tck.pm_iterations_done,
                         tck.iterations_done, tck.pad) == (SEED, 1, 1,
                                                           tck.pad)
    assert sorted(jck.labeling) == sorted(jck.cost) == [0]
    assert jck.labeling[0].shape[:1] == (B,)
    np.testing.assert_array_equal(jck.labeling[0], tck.labeling[0])
    np.testing.assert_array_equal(jck.cost[0], tck.cost[0])
    for got, want in zip(jax_out["resumed"], ports[0]["end"]):
        assert _close(got, want), (jax_out["resumed"], ports[0]["end"])
