"""The port's ReplicaSolver (``parallel/replica.py``): one pair at a time
on each device.

Contract: pair ``b`` equals ``LocalExpansionSolver(seed=seed + b)`` on the
same device, bitwise, on one view and on two views with the post-process
(in this process, the one-device route); three pairs on two CPU worker
processes (``devices=["cpu", "cpu"]``: two waves on the first) equal the
in-process results, bitwise; the evaluators of a group start together
and, in the workers, come back with their clocks; and the port's batch
against the JAX package's ReplicaSolver on a one-device mesh, each pair's
final energy within 0.002·|E| + 1e-3 (the JAX side's min-cut knobs set
to the port's (16, 16)). 28 x 36 pixels, 6 disparities, one layer.

The standing pool (``ReplicaPool``, which ``run`` uses with more than one
device): pairs routed to the free worker come back one by one as their
solves end, each with its ``b``, equal to its single solve; a traced pool
hands back both sides' ``replica.*`` spans and counts the bytes handed each
way; a worker's error is raised with its traceback; ``close`` drops a pair
in flight at its next sweep boundary and leaves no process. The pool's
queues read each message into one buffer: a large array comes through
whole, and so does a message behind the long (8-byte) size header.
"""
import dataclasses
import multiprocessing
import os
import struct
import time

import jax
import numpy as np
import pytest
import torch

from localexpstereo_tpu.config import PARAMS_GF as J_PARAMS
from localexpstereo_tpu.parallel import mesh as jmesh
from localexpstereo_tpu.parallel.replica import ReplicaSolver as JReplica
from localexpstereo_tpu_torch.config import PARAMS_GF as T_PARAMS
from localexpstereo_tpu_torch.models.engine import LocalExpansionSolver
from localexpstereo_tpu_torch.models.evaluator import Evaluator
from localexpstereo_tpu_torch.parallel import mesh
from localexpstereo_tpu_torch.parallel.replica import ReplicaSolver

torch.set_num_threads(1)

PARAMS = dict(windR=4, lambda_=0.5, th_col=0.5)
PROPOSERS = [("expansion", "ransac", "random7")]
LAYERS = [3]
ND = 6


def _problems(b, h=28, w=36, nd=ND, seed=0):
    rng = np.random.default_rng(seed)
    ims = (rng.random((b, h, w, 3)) * 255).astype(np.float32)
    dd = np.arange(nd, dtype=np.float32)[:, None, None]
    vols = []
    for _ in range(b):
        d_true = rng.random((h, w), np.float32) * (nd - 1)
        vols.append(np.minimum(np.abs(dd - d_true[None]) * 0.4, 1.0))
    return ims, np.stack(vols).astype(np.float32)


def _replica(ims, vols, devices, seed=7):
    return ReplicaSolver(ims, ims, T_PARAMS.replace(**PARAMS), ND - 1.0,
                         LAYERS, devices=devices, layer_proposers=PROPOSERS,
                         vols0=vols, vols1=vols, seed=seed)


def _single(ims, vols, b, seed=7, modes=(0,), iterations=1):
    s = LocalExpansionSolver(ims[b], ims[b], T_PARAMS.replace(**PARAMS),
                             ND - 1.0, vol0=vols[b], vol1=vols[b],
                             seed=seed + b, device="cpu")
    s.add_layer(LAYERS[0], PROPOSERS[0])
    final, raw = s.run(iterations, view_modes=modes, pm_iterations=1)
    return s, final.numpy(), raw.numpy()


@pytest.fixture(scope="module")
def three():
    ims, vols = _problems(3)
    rs = _replica(ims, vols, ["cpu"])
    final, raw = rs.run(1, (0,), 1)
    return ims, vols, rs, final, raw


def test_pairs_equal_single_solves(three):
    ims, vols, rs, final, raw = three
    assert raw is final and rs.waves == 3
    for b in range(3):
        solver, want, _ = _single(ims, vols, b)
        assert np.array_equal(final[b], want), f"pair {b} diverged"
        assert np.array_equal(rs.labeling(b), want)
        np.testing.assert_array_equal(rs.disparities()[b],
                                      solver.disparity_map().numpy())


def test_two_views_with_post_process_equal_single_solves():
    """One greedy sweep of each view, then the post-process."""
    ims, vols = _problems(2, seed=1)
    rs = _replica(ims, vols, ["cpu"], seed=3)
    final, raw = rs.run(0, (0, 1), 1)
    for b in range(2):
        solver, want, want_raw = _single(ims, vols, b, seed=3, modes=(0, 1),
                                         iterations=0)
        assert np.array_equal(final[b], want)
        assert np.array_equal(raw[b], want_raw)
        assert np.array_equal(rs.labeling(b, 1),
                              solver._unpadded_labeling(1).numpy())
    assert not np.array_equal(final, raw)     # the post-process ran


def test_workers_equal_in_process(three, tmp_path):
    """Two worker processes on the CPU (pairs 0 and 2 on the first, in
    waves), each pair with an evaluator that the workers pickle, fill and
    send back with its clock."""
    ims, vols, rs, final, _ = three
    two = _replica(ims, vols, ["cpu", "cpu"])
    evs = [Evaluator(None, None, 1.0, save_dir=str(tmp_path / f"p{b}"))
           for b in range(3)]
    two.set_evaluators(evs)
    got, _ = two.run(1, (0,), 1)
    assert two.waves == 2
    assert np.array_equal(got, final)
    for b in range(3):
        assert two.energies()[0][0][b] == rs.energies()[0][0][b]
        evs[b].close()
        rows = (tmp_path / f"p{b}" / "log_output.txt").read_text().split("\n")
        assert rows[0].startswith("Time\t") and len(rows[1:-1]) == 3
        assert evs[b].get_current_time() > 0.0
        assert not evs[b].timer.is_ticking()


class _Events:
    """Evaluator stand-in that records (event, pair) in a shared list."""

    def __init__(self, log, b):
        self.log, self.b = log, b

    def start(self):
        self.log.append(("start", self.b))

    def stop(self):
        self.log.append(("stop", self.b))

    def evaluate(self, solver, labeling_m, cost_m, mode, index):
        self.log.append(("evaluate", self.b, index))


def test_group_clock_starts_together():
    """Pair 1's evaluator starts when pair 0's timed solve starts (its
    clock runs through pair 0's sweeps), every evaluator is stopped
    before pair 1's energy is built, and all stop at the end."""
    ims, vols = _problems(2, seed=2)
    rs = _replica(ims, vols, ["cpu"])
    log = []
    rs.set_evaluators([_Events(log, 0), _Events(log, 1)])
    rs.run(1, (0,), 1)
    first_start = log.index(("start", 1))
    assert ("start", 0) in log[:first_start + 1]
    assert first_start < log.index(("evaluate", 0, 2))
    pair1_init = log.index(("evaluate", 1, 0))
    assert log[pair1_init - 2:pair1_init] == [("stop", 0), ("stop", 1)]
    assert log[-2:] == [("stop", 0), ("stop", 1)]


def test_streamed_volumes_are_read_once():
    ims, vols = _problems(2, seed=4)
    rs = ReplicaSolver(ims, ims, T_PARAMS.replace(**PARAMS), ND - 1.0,
                       LAYERS, devices=["cpu"], layer_proposers=PROPOSERS,
                       volumes=((v, v) for v in vols))
    rs.run(0, (0,), 1)
    with pytest.raises(RuntimeError, match="read by an earlier run"):
        rs.run(0, (0,), 1)


def test_make_devices():
    assert mesh.make_devices(2, kind="cpu") == [torch.device("cpu")] * 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mesh.make_devices()


def test_matches_jax_replica(three):
    ims, vols, rs, final, _ = three
    m = jmesh.make_mesh((1,), ("data",), jax.devices()[:1])
    js = JReplica(ims, ims, J_PARAMS.replace(**PARAMS), max_disp=ND - 1.0,
                  mesh=m, unit_sizes=LAYERS, layer_proposers=PROPOSERS,
                  vols0=vols, vols1=vols, seed=7)
    js.cfg = dataclasses.replace(js.cfg, gc_rounds=16, gc_sweeps=16)
    js.run(iterations=1, view_modes=(0,), pm_iterations=1)
    (want, _, _), _ = js.energies(js._state[0])
    (got, _, _), _ = rs.energies()
    for g, w in zip(got, np.asarray(want)):
        assert abs(g - w) <= 0.002 * abs(w) + 1e-3, (got, want)


# ------------------------------------------------------------ the pool --


@pytest.fixture(scope="module")
def pooled():
    """Three pairs through a standing pool of two CPU workers, each pair to
    the worker with the fewest in flight: (results in the order they came,
    the workers' hand-back, the counters, the pairs)."""
    ims, vols = _problems(3, seed=5)
    rs = _replica(ims, vols, ["cpu", "cpu"])
    rs.precompile((0,), 1, 1)
    with rs.pool(1, (0,), 1) as pool:
        pool.start((ims[0], (vols[0], vols[0])))
        for b in range(3):
            pool.submit(b, ims[b], ims[b], (vols[b], vols[b]))
        got = [pool.next_result(timeout=120) for _ in range(3)]
    return got, pool.workers, pool.counts(), (ims, vols)


@pytest.mark.parametrize("b", range(3))
def test_pool_results_equal_single_solves(pooled, b):
    """Pair b comes back once, with its b, equal to its single solve."""
    got, _, _, (ims, vols) = pooled
    mine = [g for g in got if g["b"] == b]
    assert len(mine) == 1
    _, want, _ = _single(ims, vols, b)
    assert np.array_equal(mine[0]["result"]["labelings"][0], want)
    st = mine[0]["stamps"]
    assert st["submit"][0] <= st["receive"][1] <= st["build"][0] \
        <= st["solve"][1] <= st["ret"] <= st["collect"][1]
    assert [i for i, _ in st["marks"]] == [0, 1, 2]


def test_pool_returns_each_pair_as_it_completes(pooled):
    """The results come in the order the solves ended, the first pair each
    worker solved carrying its warm-up; the counters count the pairs and
    the arrays handed each way (each object once, as pickling sends
    it)."""
    got, workers, counts, (ims, vols) = pooled
    ends = [g["stamps"]["collect"][1] for g in got]
    assert ends == sorted(ends)
    assert {g["worker"] for g in got} == {0, 1}
    first = {}
    for g in sorted(got, key=lambda g: g["stamps"]["solve"][0]):
        first.setdefault(g["worker"], g["b"])
    for g in got:
        warm = g["result"]["warmup_s"]
        assert (warm > 0.0) is (first[g["worker"]] == g["b"])
    assert [w["worker"] for w in workers] == [0, 1]
    assert counts["submitted"] == counts["completed"] == 3
    # Each view of ims and vols is its own object, pickled on its own.
    assert counts["bytes_in"] == 3 * 2 * (ims[0].nbytes + vols[0].nbytes)
    assert counts["bytes_out"] >= 3 * ims[0][..., 0].nbytes * 5
    assert counts["max_in_flight"] == 3


def test_traced_pool_hands_back_both_sides_spans():
    """With ``trace``, the worker's window holds its ``replica.receive``
    and ``replica.return`` spans and the solver's, each pair's with its
    b, and this process's profiled window its ``replica.submit`` and
    ``replica.collect``."""
    from torch.profiler import ProfilerActivity, profile

    from localexpstereo_tpu_torch.utils import profiling
    ims, vols = _problems(2, seed=8)
    with profile(activities=[ProfilerActivity.CPU]):
        with _replica(ims, vols, ["cpu"]).pool(0, (0,), 1,
                                               trace=True) as pool:
            pool.start()
            for b in range(2):
                pool.submit(b, ims[b], ims[b], (vols[b], vols[b]))
            got = [pool.next_result(timeout=120) for _ in range(2)]
            # A CPU window records every op: its stop takes a while.
            workers = pool.close(timeout=300.0)
        main = profiling.span_rows(profiling.records())
    assert sorted(g["b"] for g in got) == [0, 1]
    for name in ("replica.submit", "replica.collect"):
        assert sorted(r[1]["b"] for r in main if r[0] == name) == [0, 1]
    rows = workers[0]["spans"]
    for name in ("replica.receive", "replica.return"):
        assert sorted(r[1]["b"] for r in rows if r[0] == name) == [0, 1]
    assert [r[0] for r in rows if r[0] in ("build", "solve")] == \
        ["build", "solve"] * 2
    assert len(workers[0]["ops"][1]) == 0 and workers[0]["peak_bytes"] == 0


def test_pool_raises_a_workers_error_with_its_traceback():
    ims, vols = _problems(1, seed=6)
    with _replica(ims, vols, ["cpu"]).pool(1, (0,), 1) as pool:
        pool.start()
        pool.submit(0, ims[0], ims[0], ("no volume", "no volume"))
        with pytest.raises(RuntimeError, match="(?s)worker on cpu.*Traceback"):
            pool.next_result(timeout=120)
        procs = list(pool._procs)
    assert not any(p.is_alive() for p in procs)


def test_pool_close_drops_the_pair_in_flight():
    """close() while a long solve runs: the pair is dropped at its next
    sweep boundary, the worker exits on its own, and nothing is left."""
    ims, vols = _problems(1, seed=7)
    pool = _replica(ims, vols, ["cpu"]).pool(200, (0,), 1)
    pool.start()
    pool.submit(0, ims[0], ims[0], (vols[0], vols[0]))
    procs = list(pool._procs)
    while not pool._tasks[0].empty():
        time.sleep(0.01)
    time.sleep(1.0)
    t0 = time.perf_counter()
    workers = pool.close()
    assert time.perf_counter() - t0 < 20.0
    assert "peak_bytes" in workers[0]         # closed, not terminated
    assert not any(p.is_alive() for p in procs)
    assert pool.counts()["completed"] == 0
    assert pool.close() is workers


@pytest.mark.parametrize("how", ["queue", "long_header"])
def test_pool_queue_reads_a_message_whole(how):
    from localexpstereo_tpu_torch.parallel import replica
    arr = np.random.default_rng(3).random(300_000)  # 2.4 MB: many pipe reads
    if how == "queue":
        q = replica._Queue(ctx=multiprocessing.get_context("spawn"))
        q.put((5, arr))
        b, got = q.get(timeout=30)
        q.close()
        assert b == 5 and np.array_equal(got, arr)
        return
    reader, writer = multiprocessing.Pipe(duplex=False)
    payload = arr[:4000].tobytes()  # 32 KB: the pipe holds it unread
    os.write(writer.fileno(), struct.pack("!i", -1)
             + struct.pack("!Q", len(payload)) + payload)
    assert bytes(replica._recv_whole(reader)) == payload
    reader.close()
    writer.close()
