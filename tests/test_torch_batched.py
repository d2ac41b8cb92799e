"""The batched solver (``localexpstereo_tpu_torch.parallel.batch``): four
pairs over two gloo ranks on the CPU, both views. Pair b is
``LocalExpansionSolver(seed + b)`` bit for bit, a run resumed from a
checkpoint ends where the uninterrupted one does, and the mean energy over
the ranks is the mean of the pairs'. The sharded runs are launched (with a
timeout) in the background while this process solves the references."""
import concurrent.futures
import os

import numpy as np
import pytest
import torch

from localexpstereo_tpu_torch.config import PARAMS_GF
from localexpstereo_tpu_torch.models import engine
from localexpstereo_tpu_torch.parallel import collectives
from localexpstereo_tpu_torch.parallel.batch import BatchedSolver
from localexpstereo_tpu_torch.utils import checkpoint

torch.set_num_threads(1)

TIMEOUT_S = 300
B, H, W, ND = 4, 20, 28, 5
SEED = 5
PM, GC = 1, 2
PARAMS = PARAMS_GF.replace(windR=4, lambda_=0.5, th_col=0.5)


def _pairs():
    r = np.random.default_rng(4)
    ims = (r.random((B, H, W + 3, 3)) * 255).astype(np.float32)
    dd = np.arange(ND, dtype=np.float32)[:, None, None]
    vols = np.stack([np.minimum(np.abs(dd - r.random((H, W), np.float32)
                                       * (ND - 1)) * 0.4, 1.0)
                     for _ in range(B)]).astype(np.float32)
    return ims[:, :, :W], ims[:, :, 3:], vols


def _batch(device):
    ims0, ims1, vols = _pairs()
    return BatchedSolver(ims0, ims1, PARAMS, float(ND - 1), [3, 6],
                         device=device, vols0=vols, vols1=vols, seed=SEED,
                         vol_dtype="float32")


def _batch_rank(rank, device, ck):
    bs = _batch(device)
    final, raw = bs.run(GC, view_modes=(0, 1), pm_iterations=PM,
                        checkpoint_path=ck, checkpoint_every=2)
    (tot, dc, sc), mean = bs.energies(bs._state[0])
    resumed, _ = _batch(device).run(GC, view_modes=(0, 1),
                                    pm_iterations=PM, resume_from=ck)
    return {"pairs": list(bs.pairs), "final": final, "raw": raw,
            "tot": tot, "dc": dc, "sc": sc, "mean": mean,
            "resumed": resumed, "disp": bs.disparities()}


@pytest.fixture(scope="module")
def batched(tmp_path_factory):
    ck = os.fspath(tmp_path_factory.mktemp("batched") / "ck.npz")
    pool = concurrent.futures.ThreadPoolExecutor(1)
    future = pool.submit(collectives.launch, _batch_rank, ["cpu"] * 2, ck,
                         timeout_s=TIMEOUT_S)
    ims0, ims1, vols = _pairs()
    refs = []
    for b in range(B):
        s = engine.LocalExpansionSolver(
            ims0[b], ims1[b], PARAMS, float(ND - 1), vol0=vols[b],
            vol1=vols[b], seed=SEED + b, device="cpu", vol_dtype="float32")
        s.add_layer(3, engine.LAYER0_PROPOSERS)
        s.add_layer(6, engine.COARSE_PROPOSERS)
        final, raw = s.run(GC, view_modes=(0, 1), pm_iterations=PM)
        refs.append({"final": final.numpy(), "raw": raw.numpy(),
                     "energy": [float(x) for x in engine.energy_audit(
                         s.data, s.cfg, *s._state[0], 0)]})
    outs = future.result(timeout=TIMEOUT_S)
    pool.shutdown()
    return refs, outs, ck


def test_blocks_of_pairs_by_rank(batched):
    _, outs, _ = batched
    assert [o["pairs"] for o in outs] == [[0, 1], [2, 3]]


def test_pair_b_is_the_single_solve_of_seed_plus_b(batched):
    """Both views and the post-process: every pair's final and raw
    labelings, on both ranks, equal LocalExpansionSolver(seed + b)'s."""
    refs, outs, _ = batched
    for o in outs:
        for b, ref in enumerate(refs):
            np.testing.assert_array_equal(o["final"][b], ref["final"])
            np.testing.assert_array_equal(o["raw"][b], ref["raw"])
            d = ref["final"]
            ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
            np.testing.assert_allclose(
                o["disp"][b], d[..., 0] * xs + d[..., 1] * ys + d[..., 2],
                rtol=1e-6, atol=1e-5)


def test_energies_and_their_mean_over_ranks(batched):
    refs, outs, _ = batched
    for o in outs:
        for b, ref in enumerate(refs):
            assert [float(o[k][b]) for k in ("tot", "dc", "sc")] == \
                ref["energy"]
        want = float(np.mean(np.asarray(o["tot"], np.float64)))
        assert o["mean"] == pytest.approx(want, rel=1e-12)


def test_resumed_run_ends_where_the_whole_run_ends(batched):
    """The checkpoint written after 2 sweeps (the JAX format: [B, ...]
    arrays) resumes into the uninterrupted run's end, bit for bit."""
    _, outs, ck = batched
    ck = checkpoint.load_checkpoint(ck)
    assert (ck.pm_iterations_done, ck.iterations_done) == (1, 1)
    assert ck.labeling[0].shape[0] == B and sorted(ck.labeling) == [0, 1]
    for o in outs:
        np.testing.assert_array_equal(o["resumed"], o["final"])
