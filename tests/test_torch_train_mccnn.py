"""The port's MC-CNN trainer (``localexpstereo_tpu_torch/tools/train_mccnn.py``)
against the JAX package's ``tools/train_mccnn.py``, on the CPU.

The same seeded synthetic Middlebury V2 scenes (``utils/synthetic``, 48 x 64
with 12 disparities) and the same keys go through both, at the network's
full width (channels 32, 32, 64, 64; a batch of 4096 pixels). Tolerances,
each beside what was measured here:

- the key-driven init: ``NORMAL_RTOL`` (``jax.random.normal``'s erf_inv
  rounds by an ulp otherwise in about 1 % of the draws; 1.4e-7 measured);
- one hinge loss: ``LOSS_RTOL`` 1e-6 (1.9e-9 absolute on 0.02, the sums
  run in other orders), the accuracy equal;
- its gradients: each tensor's largest gap within ``GRAD_RTOL`` 1e-5 of its
  largest entry (1.2e-6 measured, here and at 375 x 450). The smoke's
  ``train`` phase holds the card against the CPU to the same two;
- five Adam steps on the same gradients: ``ADAM_ATOL`` 2e-7 on weights of
  0.01-1 (8.9e-8 measured, a few ulps: torch divides by
  ``sqrt(v) / sqrt(1 - b2^t) + eps``, optax by ``sqrt(v_hat) + eps``);
- the 3-step loop: the printed lines equal, the written weights within
  ``WEIGHTS_ATOL`` 5e-6 (5.9e-7 measured, against 9e-4 moved by the steps:
  Adam's update of a small gradient carries its rounding).
"""
import contextlib
import hashlib
import io
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from localexpstereo_tpu.models import mccnn as jmccnn
from localexpstereo_tpu_torch.models import mccnn
from localexpstereo_tpu_torch.ops import rng
from localexpstereo_tpu_torch.tools import train_mccnn as tool
from localexpstereo_tpu_torch.utils import synthetic

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import train_mccnn as jtool  # noqa: E402

torch.set_num_threads(1)

NORMAL_RTOL = 5e-7
LOSS_RTOL = 1e-6
GRAD_RTOL = 1e-5
ADAM_ATOL = 2e-7
WEIGHTS_ATOL = 5e-6
SCENE = (48, 64, 12)
SCENES = ("cones", "teddy", "venus", "tsukuba")


def _jax(params):
    return {k: jnp.asarray(v) for k, v in params.items()}


def _grads(net):
    """The module's gradients in the JAX layout."""
    out = {}
    for i, conv in enumerate(net.convs):
        out[f"w{i}"] = conv.weight.grad.permute(2, 3, 1, 0).numpy()
        out[f"b{i}"] = conv.bias.grad.numpy()
    return out


def _scene(seed, unknown=False):
    """(im0, im1, gt, valid) of a v2_scene as ``write_v2_scene`` stores it
    (quarter-pixel ground truth); ``unknown`` marks the occluded pixels
    unknown (+inf), as a zero in ``groundtruth.png`` is."""
    im_l, im_r, disp, nonocc = synthetic.v2_scene(*SCENE, seed)
    gt = (np.clip(np.rint(disp * 4.0), 1, 255) / 4.0).astype(np.float32)
    if unknown:
        gt[~nonocc] = np.inf
    valid = np.isfinite(gt) & (gt > 0)
    return im_l.astype(np.float32), im_r.astype(np.float32), gt, valid


def _sha(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


@pytest.mark.parametrize("seed", [0, 3])
def test_init_from_key_matches_jax(seed):
    got = mccnn.init_params_from_key(rng.PRNGKey(seed))
    want = jmccnn.init_params(jax.random.PRNGKey(seed))
    assert sorted(got) == sorted(want)
    for k in want:
        w = np.asarray(want[k])
        assert got[k].dtype == np.float32 and got[k].shape == w.shape
        np.testing.assert_allclose(got[k], w, rtol=NORMAL_RTOL, atol=0)
    assert got["w0"].shape == (3, 3, 3, 32) and got["w3"].shape == (3, 3, 64, 64)


@pytest.mark.parametrize("source", ["bundled", "generator"])
def test_params_to_jax_inverts_params_from_jax(source):
    params = (mccnn.load_default_params() if source == "bundled"
              else mccnn.init_params(np.random.default_rng(1), (8, 16)))
    net = mccnn.params_from_jax(params)
    assert not any(p.requires_grad for p in net.parameters())
    back = mccnn.params_to_jax(net.requires_grad_(True))
    assert sorted(back) == sorted(params)
    for k in params:
        assert back[k].dtype == np.float32
        np.testing.assert_array_equal(back[k], params[k])


@pytest.mark.parametrize("seed,unknown", [(0, False), (1, True)])
def test_hinge_loss_and_grads_match_jax(seed, unknown):
    im0, im1, gt, valid = _scene(seed, unknown)
    params = mccnn.init_params_from_key(rng.PRNGKey(seed))
    key = rng.split(rng.PRNGKey(seed))[1]
    jkey = jax.random.split(jax.random.PRNGKey(seed))[1]
    (jloss, (jacc,)), jgrads = jax.value_and_grad(
        jtool.hinge_loss, has_aux=True)(
            _jax(params), *[jnp.asarray(a) for a in (im0, im1, gt, valid)],
            jkey)
    net = mccnn.params_from_jax(params).requires_grad_(True)
    loss, acc = tool.hinge_loss(
        net, *[torch.as_tensor(a) for a in (im0, im1, gt, valid)], key)
    loss.backward()
    loss = loss.detach()
    assert loss.dtype == acc.dtype == torch.float32
    assert float(loss) == pytest.approx(float(jloss), rel=LOSS_RTOL)
    assert float(acc) == float(jacc)
    assert 0.0 < float(loss) and 0.5 < float(acc) < 1.0
    grads = _grads(net)
    for k, g in jgrads.items():
        g = np.asarray(g)
        assert np.abs(grads[k] - g).max() <= GRAD_RTOL * np.abs(g).max(), k


def test_adam_matches_optax():
    """Five steps of the tool's Adam on the same seeded gradients as
    ``optax.adam(3e-4)``, at the network's shapes."""
    params = mccnn.init_params_from_key(rng.PRNGKey(2))
    net = mccnn.params_from_jax(params).requires_grad_(True)
    opt = tool.adam(net)
    jparams = _jax(params)
    jopt = optax.adam(tool.LR)
    state = jopt.init(jparams)
    r = np.random.default_rng(0)
    for _ in range(5):
        grads = {k: (r.standard_normal(v.shape) * 10.0 ** r.integers(-6, 0))
                 .astype(np.float32) for k, v in params.items()}
        for i, conv in enumerate(net.convs):
            conv.weight.grad = torch.from_numpy(
                grads[f"w{i}"]).permute(3, 2, 0, 1).contiguous()
            conv.bias.grad = torch.from_numpy(grads[f"b{i}"])
        opt.step()
        updates, state = jopt.update(_jax(grads), state)
        jparams = optax.apply_updates(jparams, updates)
    got = mccnn.params_to_jax(net)
    for k, v in jparams.items():
        np.testing.assert_allclose(got[k], np.asarray(v), rtol=0,
                                   atol=ADAM_ATOL)
        assert np.abs(got[k] - params[k]).max() > 1e-4    # it moved


def _lines(text):
    return [ln for ln in text.splitlines() if ln.startswith("step ")]


def test_train_loop_matches_jax_tool(tmp_path, monkeypatch, capsys):
    """3 steps of both tools on four synthetic V2 scenes: the printed lines
    equal, the written weights within WEIGHTS_ATOL, each ``.npz`` loading in
    the other package, and the port's weights giving the same volume in
    both; the bundled weights of both packages untouched."""
    bundled = [mccnn.default_weights_path(), jmccnn.default_weights_path()]
    before = [_sha(p) for p in bundled]
    data = tmp_path / "MiddV2"
    for seed, name in enumerate(SCENES):
        synthetic.write_v2_scene(str(data / name), *SCENE, seed=seed)
    monkeypatch.setattr(jtool, "DATA", str(data))
    monkeypatch.setattr(sys, "argv", ["train_mccnn.py", "--steps", "3",
                                      "--out", str(tmp_path / "jax.npz")])
    with contextlib.redirect_stdout(io.StringIO()) as out:
        jtool.main()
    want = _lines(out.getvalue())
    rows = tool.main(["--data", str(data), "--device", "cpu", "--steps", "3",
                      "--out", str(tmp_path / "port.npz")])
    got = _lines(capsys.readouterr().out)
    assert len(want) == 2 and got == want
    assert [r["step"] for r in rows] == [0, 2]
    assert rows[-1]["train_hinge"] < rows[0]["train_hinge"]

    wj = jmccnn.load_params(str(tmp_path / "port.npz"))      # port -> JAX
    wt = mccnn.load_params(str(tmp_path / "jax.npz"))        # JAX -> port
    init = mccnn.init_params_from_key(rng.PRNGKey(0))
    assert sorted(wj) == sorted(wt) == sorted(init)
    for k in init:
        np.testing.assert_allclose(np.asarray(wj[k]), wt[k], rtol=0,
                                   atol=WEIGHTS_ATOL)
        assert np.abs(wt[k] - init[k]).max() > 5e-4          # 3 steps moved
    im0, im1, _, _ = _scene(3)
    vol = mccnn.cost_volume(mccnn.params_from_jax(
        mccnn.load_params(str(tmp_path / "port.npz"))), im0, im1, 12)
    jvol = jmccnn.cost_volume(wj, jnp.asarray(im0), jnp.asarray(im1),
                              ndisp=12)
    np.testing.assert_allclose(vol.numpy(), np.asarray(jvol), atol=2e-6,
                               rtol=0)
    assert [_sha(p) for p in bundled] == before


def test_device_cuda_raises_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main(["--data", str(tmp_path), "--steps", "1",
                   "--out", str(tmp_path / "w.npz")])
    assert not (tmp_path / "w.npz").exists()
