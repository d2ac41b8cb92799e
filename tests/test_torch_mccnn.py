"""The port's MC-CNN volume (``models/mccnn.py``) against the JAX package's.

The same seeded images go through both: with ``init_params`` weights of the
port carried to JAX (channels (8, 8), 20 x 28, ndisp 6) and with the
bundled trained weights (24 x 40, ndisp 8, and ndisp 50 > W, where every
column of a plane is out of view). Tolerance: 2e-6 absolute on the
features and the volume (the two sum the 3 x 3 x C products and the
channel dot product in other orders; measured 5.4e-7).
"""
import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from localexpstereo_tpu.models import mccnn as jmccnn
from localexpstereo_tpu_torch.models import mccnn

torch.set_num_threads(1)

ATOL = 2e-6


def _images(seed, h, w):
    r = np.random.default_rng(seed)
    return [(r.random((h, w, 3)) * 255).astype(np.float32) for _ in range(2)]


def _jax(params):
    return {k: jnp.asarray(v) for k, v in params.items()}


def test_features_and_volume_match_jax_with_random_weights():
    params = mccnn.init_params(np.random.default_rng(0), channels=(8, 8))
    net = mccnn.params_from_jax(params)
    im0, im1 = _images(1, 20, 28)
    got = mccnn.features(net, im0).numpy()
    want = np.asarray(jmccnn.features(_jax(params), jnp.asarray(im0)))
    assert got.shape == want.shape == (20, 28, 8)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    vol = mccnn.cost_volume(net, im0, im1, 6)
    assert vol.dtype == torch.float32 and vol.shape == (6, 20, 28)
    np.testing.assert_allclose(
        vol.numpy(), np.asarray(jmccnn.cost_volume(
            _jax(params), jnp.asarray(im0), jnp.asarray(im1), ndisp=6)),
        atol=ATOL, rtol=0)


@pytest.mark.parametrize("ndisp", [8, 50])
def test_volume_matches_jax_with_bundled_weights(ndisp):
    params = mccnn.load_default_params()
    net = mccnn.params_from_jax(params)
    im0, im1 = _images(2, 24, 40)
    np.testing.assert_allclose(
        mccnn.cost_volume(net, im0, im1, ndisp).numpy(),
        np.asarray(jmccnn.cost_volume(_jax(params), jnp.asarray(im0),
                                      jnp.asarray(im1), ndisp=ndisp)),
        atol=ATOL, rtol=0)


def test_out_of_view_columns():
    """vol[d, y, x] = vol[d, y, min(d, W - 1)] for x < d; the in-view
    columns are 1 - <f0(x), f1(x - d)>."""
    params = mccnn.init_params(np.random.default_rng(3), channels=(8, 8))
    net = mccnn.params_from_jax(params)
    im0, im1 = _images(4, 12, 10)
    vol = mccnn.cost_volume(net, im0, im1, 14).numpy()
    f0 = mccnn.features(net, im0).numpy()
    f1 = mccnn.features(net, im1).numpy()
    for d in range(14):
        for x in range(10):
            if x >= d:
                want = 1.0 - np.sum(f0[:, x] * f1[:, x - d], axis=-1)
            else:
                want = vol[d, :, min(d, 9)]
            np.testing.assert_allclose(vol[d, :, x], want, atol=ATOL, rtol=0)


def test_weights_file_is_the_jax_packages():
    ours = mccnn.default_weights_path()
    assert "localexpstereo_tpu_torch" in ours
    with open(ours, "rb") as a, open(jmccnn.default_weights_path(),
                                     "rb") as b:
        assert a.read() == b.read()
    params = mccnn.load_default_params()
    assert mccnn.num_layers(params) == 4
    assert params["w0"].shape == (3, 3, 3, 32)
    assert params["w3"].shape == (3, 3, 64, 64)
    net = mccnn.params_from_jax(params)
    assert [c.out_channels for c in net.convs] == list(
        mccnn.DEFAULT_CHANNELS)


def test_params_round_trip_and_jax_file(tmp_path):
    params = mccnn.init_params(np.random.default_rng(5), channels=(4, 6))
    mccnn.save_params(str(tmp_path / "port.npz"), params)
    back = mccnn.load_params(str(tmp_path / "port.npz"))
    assert sorted(back) == sorted(params)
    for k in params:
        np.testing.assert_array_equal(back[k], params[k])
    # A file written by the JAX package loads in the port and computes the
    # JAX features.
    import jax
    jparams = jmccnn.init_params(jax.random.PRNGKey(6), channels=(8, 8))
    jmccnn.save_params(str(tmp_path / "jax.npz"), jparams)
    net = mccnn.params_from_jax(mccnn.load_params(str(tmp_path / "jax.npz")))
    im0, _ = _images(7, 16, 24)
    np.testing.assert_allclose(
        net(im0).numpy(),
        np.asarray(jmccnn.features(jparams, jnp.asarray(im0))),
        atol=ATOL, rtol=0)


def test_mccnn_and_serving_import_no_jax(tmp_path):
    """The port's MC-CNN and serving modules load without jax."""
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        import numpy as np
        import localexpstereo_tpu_torch.models.mccnn as mccnn
        import localexpstereo_tpu_torch.serving
        net = mccnn.params_from_jax(mccnn.load_default_params())
        im = np.zeros((8, 12, 3), np.float32)
        assert mccnn.cost_volume(net, im, im, 4).shape == (4, 8, 12)
        bad = [m for m in sys.modules if sys.modules[m] is not None and (
            m == "jax" or m.startswith(("jax.", "localexpstereo_tpu.")))]
        assert not bad, bad
        print("OK")
    """)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=tmp_path, timeout=300,
                         env=dict(os.environ, PYTHONPATH=root))
    assert res.returncode == 0 and res.stdout.strip() == "OK", res.stderr


def test_full_float32_turns_off_tf32_only():
    """The towers' cuDNN context on a CUDA device turns TF32 off and keeps
    the caller's other cuDNN settings; leaving it restores TF32's. (The
    flags are process settings: this runs without a card.)"""
    cudnn = torch.backends.cudnn
    saved = (cudnn.enabled, cudnn.benchmark, cudnn.deterministic,
             cudnn.allow_tf32)
    try:
        cudnn.benchmark, cudnn.deterministic, cudnn.allow_tf32 = \
            True, True, True
        with mccnn._full_float32(torch.device("cuda")):
            assert not cudnn.allow_tf32
            assert cudnn.benchmark and cudnn.deterministic
        assert cudnn.allow_tf32
        assert cudnn.benchmark and cudnn.deterministic
    finally:
        (cudnn.enabled, cudnn.benchmark, cudnn.deterministic,
         cudnn.allow_tf32) = saved
