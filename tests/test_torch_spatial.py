"""The halo-exchanged whole-image guided aggregation
(``localexpstereo_tpu_torch.parallel.spatial``) over four gloo ranks on
the CPU against the port's whole-image filter, and that filter against the
JAX package's (``tests/test_parallel.py``'s tolerance)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from localexpstereo_tpu.ops import guided as j_guided
from localexpstereo_tpu_torch.ops import boxfilter, guided
from localexpstereo_tpu_torch.parallel import collectives, spatial

torch.set_num_threads(1)

TIMEOUT_S = 120
N_RANKS = 4
H, W, R = 64, 48, 3


def _inputs():
    r = np.random.default_rng(1)
    img = (r.random((H, W, 3)) * 255).astype(np.float32)
    p = r.random((H, W)).astype(np.float32)
    x = r.random((2, H, W)).astype(np.float32)
    return img, p, x


def _spatial_rank(rank, device, x, p, stats):
    def block(a):
        return torch.as_tensor(collectives.row_block(a, rank, N_RANKS))
    xs = torch.as_tensor(x)[:, rank * (H // N_RANKS):
                            (rank + 1) * (H // N_RANKS)]
    return {"box": spatial.sharded_boxsum2d(xs, R),
            "box2d": spatial.sharded_boxsum2d(xs[0], R),
            "q": spatial.sharded_cost_aggregation(
                block(p), *(block(a) for a in stats), R)}


@pytest.fixture(scope="module")
def sharded():
    img, p, x = _inputs()
    stats = guided.compute_stats(torch.as_tensor(img), R, 1e-4)
    outs = collectives.launch(_spatial_rank, ["cpu"] * N_RANKS, x, p,
                              tuple(a.numpy() for a in stats),
                              timeout_s=TIMEOUT_S)
    return stats, outs


def test_sharded_boxsum_equals_the_whole_box_sum(sharded):
    """[C, H, W] and [H, W] box sums with H over 4 ranks: the ranks' rows
    of boxfilter.boxsum2d."""
    _, outs = sharded
    _, _, x = _inputs()
    want = boxfilter.boxsum2d(torch.as_tensor(x), R).numpy()
    np.testing.assert_array_equal(np.concatenate([o["box"] for o in outs],
                                                 axis=1), want)
    np.testing.assert_array_equal(
        np.concatenate([o["box2d"] for o in outs]), want[0])


def test_sharded_aggregation_matches_filter_image(sharded):
    stats, outs = sharded
    _, p, _ = _inputs()
    want = guided.filter_image(torch.as_tensor(p), stats, R).numpy()
    got = np.concatenate([o["q"] for o in outs])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_filter_image_matches_jax():
    img, p, _ = _inputs()
    want = np.asarray(j_guided.filter_image(
        jnp.asarray(p), j_guided.compute_stats(img, R, 1e-4), R))
    got = guided.filter_image(
        torch.as_tensor(p), guided.compute_stats(torch.as_tensor(img), R,
                                                 1e-4), R).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
