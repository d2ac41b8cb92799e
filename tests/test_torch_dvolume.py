"""The disparity-sharded solver (``localexpstereo_tpu_torch.parallel.dvolume``)
against the port's single-device engine and the JAX package's sampler.

The merge of the ranks' partials is the unsharded sampler bit for bit by
construction (the owner of a pixel runs the unsharded sampler's operations
in its order); the JAX package promises its end-to-end solve within
tolerance only (``tests/test_volume_dsharding.py``), so the solve here is
held to that tolerance and the test records whether it is bitwise. Three
gloo ranks on the CPU; every launch has a timeout.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from localexpstereo_tpu.ops import unary_volume as j_unary
from localexpstereo_tpu.parallel.dvolume import (
    build_vol_dshards as j_build_vol_dshards)
from localexpstereo_tpu_torch.config import PARAMS_GF
from localexpstereo_tpu_torch.models import engine
from localexpstereo_tpu_torch.ops import rng, unary_volume
from localexpstereo_tpu_torch.parallel import collectives
from localexpstereo_tpu_torch.parallel.dvolume import (ShardedDVolumeSolver,
                                                       build_vol_dshards,
                                                       dshard_of)

torch.set_num_threads(1)

TIMEOUT_S = 300
#: The JAX package's tolerance of the sharded labels against the
#: single-device ones (``tests/test_volume_dsharding.py``).
LAB_ATOL, LAB_RTOL = 5e-4, 1e-3
N_RANKS = 3
LAYERS = [3, 5]


def _problem(h=37, w=48, nd=12, seed=3):
    """The JAX package's test problem (``tests/test_volume_dsharding.py``)."""
    r = np.random.default_rng(seed)
    img = (r.random((h, w, 3)) * 255).astype(np.float32)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    d_true = np.clip(0.05 * xs - 0.02 * ys + 4.0, 0, nd - 1)
    dd = np.arange(nd, dtype=np.float32)[:, None, None]
    vol = np.minimum(np.abs(dd - d_true[None]) * 0.3, 1.0).astype(np.float32)
    vol += r.random(vol.shape, np.float32) * 0.05
    return img, vol, nd


def _make(cls, **kw):
    img, vol, nd = _problem()
    params = PARAMS_GF.replace(windR=4, lambda_=0.5, th_col=0.5)
    s = cls(img, img, params, max_disp=float(nd - 1), vol0=vol, vol1=vol,
            seed=7, device="cpu", **kw)
    for i, us in enumerate(LAYERS):
        s.add_layer(us, engine.LAYER0_PROPOSERS if i == 0
                    else engine.COARSE_PROPOSERS)
    return s


# ------------------------------------------------------------- sampler --

def _sampler_case(quantized):
    r = np.random.default_rng(0)
    n, d_, f = 6, 13, 9
    if quantized:
        vol = r.integers(0, 256, (d_, 64, 64)).astype(np.uint8)
    else:
        vol = r.random((d_, 64, 64), np.float32)
    fox = r.integers(-3, 50, n).astype(np.int64)
    foy = r.integers(-3, 50, n).astype(np.int64)
    props = r.uniform(-0.2, 0.2, (n, 4)).astype(np.float32)
    props[:, 2] = r.uniform(-3, d_ + 3, n)   # planes past both ends
    props[0, 2] = np.nan                     # a non-finite plane
    return vol, props, fox, foy, f


def _port_sampler(method, vol, vp, props, fox, foy, f, scale, **shard):
    common = dict(min_disp=0.0, th_col=0.7, scale=scale, zero=0.0, **shard)
    args = (torch.as_tensor(vol), vp, torch.as_tensor(props),
            torch.as_tensor(fox), torch.as_tensor(foy), f, 64, 64)
    if method == 1:
        return unary_volume.sample_windows_aligned(*args, **common)
    return unary_volume.sample_windows(*args, max_disp=12.0, method=method,
                                       **common)


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("method", [0, 1, 2])
def test_partials_sum_to_the_unsharded_sampler_bitwise(method, quantized):
    """The owned-pixel partials of a simulated 4-way plane split, summed,
    equal the port's unsharded sampler bit for bit (methods 0, 1, 2; uint8
    and float32; planes past both ends and a NaN plane), and every pixel
    has one owner."""
    vol, props, fox, foy, f = _sampler_case(quantized)
    scale = 1.0 / 255.0 if quantized else 1.0
    vp = f
    padded = np.pad(vol, ((0, 0), (vp, vp), (vp, vp)))
    want = _port_sampler(method, padded, vp, props, fox, foy, f, scale)
    n_dev, d_ = 4, vol.shape[0]
    dq = -(-d_ // n_dev)
    acc = torch.zeros_like(want).view(torch.int32)
    for r in range(n_dev):
        shard = build_vol_dshards(torch.as_tensor(padded)[None], r, dq)[0]
        assert shard.shape[0] == dq + 2
        part = _port_sampler(method, shard, vp, props, fox, foy, f, scale,
                             dshard=dshard_of(r, dq, d_))
        acc += part.view(torch.int32)
    np.testing.assert_array_equal(acc.view(torch.float32).numpy()
                                  .view(np.int32),
                                  want.numpy().view(np.int32))
    if method != 2:
        assert torch.isfinite(want).all()


@pytest.mark.parametrize("method", [0, 1, 2])
def test_partials_agree_with_the_jax_partials(method):
    """The port's merged partials against the sum of the JAX package's
    ``sample_slabs_dshard`` partials on the same split, within 1e-6."""
    vol, props, fox, foy, f = _sampler_case(True)
    scale = 1.0 / 255.0
    n_dev, d_ = 4, vol.shape[0]
    dq = -(-d_ // n_dev)
    padded = np.pad(vol, ((0, 0), (f, f), (f, f)))
    port = _port_sampler(method, padded, f, props, fox, foy, f,
                         scale).numpy()
    shards = j_build_vol_dshards(vol[None], n_dev, dq)
    acc = 0.0
    for r in range(n_dev):
        sh = np.pad(shards[r, 0], ((0, 0), (f, f), (f, f)))
        slabs = np.stack([sh[:, y + f:y + 2 * f, x + f:x + 2 * f]
                          for x, y in zip(fox, foy)])
        acc = acc + np.asarray(j_unary.sample_slabs_dshard(
            jnp.asarray(slabs), jnp.asarray(props), jnp.asarray(fox),
            jnp.asarray(foy), 64, 64, min_disp=0.0, max_disp=12.0,
            th_col=0.7, method=method, d_base=jnp.int32(r * dq),
            d_owned=jnp.int32(min(dq, max(d_ - r * dq, 0))), d_total=d_,
            scale=scale, zero=0.0))
    finite = np.isfinite(port)
    np.testing.assert_array_equal(finite, np.isfinite(acc))
    np.testing.assert_allclose(acc[finite], port[finite], rtol=0, atol=1e-6)


def test_residency_is_dq_plus_two_planes():
    """Each rank holds dq owned planes and one halo plane a side, 1/n +
    2/D of the volume whatever the layers."""
    d_, hp, wp, n_dev = 40, 64, 80, 8
    vol = torch.ones((2, d_, hp, wp), dtype=torch.uint8)
    dq = -(-d_ // n_dev)
    for r in (0, n_dev - 1):
        shard = build_vol_dshards(vol, r, dq)
        assert shard.numel() == 2 * (dq + 2) * hp * wp
        assert shard.numel() / vol.numel() == (dq + 2) / d_


# --------------------------------------------------------------- solves --

def _dshard_rank(rank, device):
    s = _make(ShardedDVolumeSolver)
    s.finalize()
    key = rng.fold_in(rng.PRNGKey(7), 1000)
    whole = s._init_state(key, 0)
    s.init_row_chunk = 2
    banded = s._init_state(key, 0)
    lab, raw = s.run(iterations=1, pm_iterations=1)
    return {"vol": s.data.vol, "dq": s.dq, "init": whole, "banded": banded,
            "lab": lab, "raw": raw, "cost": s._state[0][1],
            "calls": collectives.traffic["calls"]}


@pytest.fixture(scope="module")
def dsolves():
    ref = _make(engine.LocalExpansionSolver)
    lab, raw = ref.run(iterations=1, pm_iterations=1)
    outs = collectives.launch(_dshard_rank, ["cpu"] * N_RANKS,
                              timeout_s=TIMEOUT_S)
    return {"ref": ref, "lab": lab.numpy(), "cost": ref._state[0][1].numpy(),
            "outs": outs}


def test_each_rank_builds_its_own_planes(dsolves):
    """A rank's stored volume is its plane window of the single-device
    one, bit for bit (the uint8 range of the whole volume), dq + 2
    planes."""
    whole = dsolves["ref"].data.vol
    for r, o in enumerate(dsolves["outs"]):
        assert o["vol"].shape[1] == o["dq"] + 2
        np.testing.assert_array_equal(
            o["vol"], build_vol_dshards(whole, r, o["dq"]).numpy())


def test_dsharded_solve_ranks_equal_and_within_tolerance(dsolves):
    """A 1 + 1 solve over 3 ranks: every rank's state is the same, bit for
    bit, and the labels are within the JAX package's tolerance of the
    single-device solve."""
    outs = dsolves["outs"]
    for o in outs:
        assert o["calls"] > 0
        for k in ("lab", "raw", "cost"):
            np.testing.assert_array_equal(o[k], outs[0][k])
    np.testing.assert_allclose(outs[0]["lab"], dsolves["lab"],
                               atol=LAB_ATOL, rtol=LAB_RTOL)


def test_dsharded_solve_is_bitwise(dsolves):
    """Recorded: the merged unaries are the unsharded ones bit for bit, so
    on the CPU the whole solve is too (the JAX package's is not)."""
    out = dsolves["outs"][0]
    np.testing.assert_array_equal(out["lab"], dsolves["lab"])
    np.testing.assert_array_equal(out["cost"], dsolves["cost"])


def test_banded_init_equals_the_whole_init(dsolves):
    """The init in bands of 2 cell rows equals the one-call init bit for
    bit, on every rank."""
    for o in dsolves["outs"]:
        for a, b in zip(o["init"], o["banded"]):
            np.testing.assert_array_equal(a, b)
