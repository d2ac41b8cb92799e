"""The port's collectives (``localexpstereo_tpu_torch.parallel.collectives``)
over gloo ranks on the CPU: one spawned process a rank, each launch with a
timeout, so that a hung collective fails its test instead of the suite."""
import os
import time

import numpy as np
import pytest
import torch

from localexpstereo_tpu_torch.parallel import collectives

torch.set_num_threads(1)

TIMEOUT_S = 120


def _collectives_rank(rank, device, x):
    n = collectives.world()
    block = torch.as_tensor(collectives.row_block(x, rank, n))
    bits = torch.tensor([-0.0, float("nan"), 1.5, 0.0])
    owned = torch.where(torch.arange(4) % n == rank, bits, 0.0)
    return {"halo": collectives.exchange_halo(block, 2),
            "psum": collectives.psum(torch.tensor([1.0, rank + 1.0])),
            "min": collectives.reduce_min(10.0 - rank),
            "gather": torch.stack(collectives.all_gather(
                torch.tensor([rank, 2 * rank]))),
            "merged": collectives.merge_owned(owned),
            "backend": collectives.backend(), "device": str(device)}


@pytest.fixture(scope="module")
def three_ranks():
    x = np.arange(9 * 2, dtype=np.float32).reshape(9, 2)
    return x, collectives.launch(_collectives_rank, ["cpu"] * 3, x,
                                 timeout_s=TIMEOUT_S)


def test_exchange_halo_zero_at_the_border(three_ranks):
    """Each rank's 3 rows with 2 rows of each neighbour; zeros beyond the
    first and the last rank (the JAX ``_exchange_halo``)."""
    x, outs = three_ranks
    padded = np.concatenate([np.zeros((2, 2), np.float32), x,
                             np.zeros((2, 2), np.float32)])
    for r, o in enumerate(outs):
        np.testing.assert_array_equal(o["halo"], padded[3 * r:3 * r + 7])


def test_psum_min_gather_over_three_ranks(three_ranks):
    _, outs = three_ranks
    for o in outs:
        np.testing.assert_array_equal(o["psum"], [3.0, 6.0])
        assert o["min"] == 8.0
        np.testing.assert_array_equal(o["gather"], [[0, 0], [1, 2], [2, 4]])
        assert o["backend"] == "gloo" and o["device"] == "cpu"


def test_merge_owned_keeps_the_owners_bits(three_ranks):
    """One owner per element: its bits come back, -0.0 and NaN too."""
    _, outs = three_ranks
    want = np.array([-0.0, np.nan, 1.5, 0.0], np.float32).view(np.int32)
    for o in outs:
        np.testing.assert_array_equal(o["merged"].view(np.int32), want)


def _failing_rank(rank, device):
    if rank == 1:
        raise ValueError("rank one fails on purpose")
    collectives.psum(torch.ones(2))
    return rank


def test_a_failing_rank_raises_with_its_traceback():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank one fails on purpose"):
        collectives.launch(_failing_rank, ["cpu"] * 3, timeout_s=TIMEOUT_S)
    assert time.monotonic() - t0 < TIMEOUT_S


def _hanging_rank(rank, device):
    if rank == 0:
        time.sleep(60)
    collectives.psum(torch.ones(2))
    return rank


def test_a_hung_collective_times_out():
    """Rank 1 waits in a collective for a rank that does not come: the
    launch ends after its timeout (or the collective's), never hangs."""
    t0 = time.monotonic()
    with pytest.raises((TimeoutError, RuntimeError)):
        collectives.launch(_hanging_rank, ["cpu"] * 2, timeout_s=6)
    assert time.monotonic() - t0 < 40


@pytest.mark.parametrize("devices,backend", [
    (["cpu", "cpu"], "gloo"), (["cuda:0", "cuda:0"], "gloo"),
    (["cuda:0", "cuda:1"], "nccl"), (["cuda", "cuda:1"], "nccl"),
    (["cuda:0", "cpu"], "gloo")])
def test_backend_follows_the_device_list(devices, backend):
    """nccl when every rank has a card of its own, gloo otherwise."""
    assert collectives.choose_backend(devices) == backend


def test_nccl_start_never_falls_back_to_gloo(tmp_path):
    """Ranks with a card each need nccl: without it (this CPU build of
    torch), joining the group raises."""
    if torch.distributed.is_nccl_available():
        pytest.skip("this torch has nccl")
    with pytest.raises(RuntimeError, match="nccl"):
        collectives.init_group(0, ["cuda:0", "cuda:1"],
                               os.fspath(tmp_path / "rendezvous"))
    assert not torch.distributed.is_initialized()
