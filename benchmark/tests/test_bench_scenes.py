"""The benchmark's frozen generators equal the port's at a small size, and
their truth labels give the truth disparity."""
import numpy as np
import pytest

from benchmark.scenes import planted, v2


@pytest.mark.parametrize("seed", [0, 5])
def test_planted_equals_the_ports_generator(seed):
    from localexpstereo_tpu_torch.utils import synthetic
    img, vol, truth, labels = planted.planted_problem(40, 56, 16, seed)
    want = synthetic.planted_problem(40, 56, 16, seed)
    np.testing.assert_array_equal(img, want[0])
    np.testing.assert_array_equal(vol, want[1])
    np.testing.assert_array_equal(truth, want[5])
    ys, xs = np.mgrid[0:40, 0:56].astype(np.float32)
    d = labels[..., 0] * xs + labels[..., 1] * ys + labels[..., 2]
    np.testing.assert_allclose(d, truth, atol=1e-4)


@pytest.mark.parametrize("seed", [0, 3])
def test_v2_equals_the_ports_generator(seed):
    from localexpstereo_tpu_torch.utils import synthetic
    got = v2.v2_scene(48, 64, 16, seed)
    want = synthetic.v2_scene(48, 64, 16, seed)
    for a, b in zip(got[:4], want):
        np.testing.assert_array_equal(a, b)
    labels = v2.frame_labels(got[4], 6, 50)
    ys, xs = np.mgrid[0:48, 0:50].astype(np.float32)
    d = labels[..., 0] * xs + labels[..., 1] * ys + labels[..., 2]
    np.testing.assert_allclose(d, got[2][:, 6:56], atol=1e-3)


def test_pairs_are_drawn_from_the_seed_and_the_index():
    cfg = {"height": 24, "width": 32, "ndisp": 8}
    a = planted.make(cfg, 2 ** 40 + 3, 0)
    b = planted.make(cfg, 2 ** 40 + 3, 0)
    c = planted.make(cfg, 2 ** 40 + 3, 1)
    np.testing.assert_array_equal(a["vol"], b["vol"])
    assert not np.array_equal(a["vol"], c["vol"])
