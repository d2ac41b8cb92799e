"""Port ops against the JAX package on the same numpy inputs: plane, grid,
windows, pairwise, validity, box filter, guided filter, the uint8 volume
unary and build_energy."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from localexpstereo_tpu.config import PARAMS_GF as J_PARAMS
from localexpstereo_tpu.models import energy as jen
from localexpstereo_tpu.models import grid as jgrid
from localexpstereo_tpu.ops import boxfilter as jbox
from localexpstereo_tpu.ops import guided as jgd
from localexpstereo_tpu.ops import pairwise as jpw
from localexpstereo_tpu.ops import plane as jpl
from localexpstereo_tpu.ops import validity as jval
from localexpstereo_tpu.ops import windows as jwin
from localexpstereo_tpu_torch.config import PARAMS_GF as T_PARAMS
from localexpstereo_tpu_torch.models import energy as ten
from localexpstereo_tpu_torch.models import grid as tgrid
from localexpstereo_tpu_torch.ops import boxfilter as tbox
from localexpstereo_tpu_torch.ops import guided as tgd
from localexpstereo_tpu_torch.ops import pairwise as tpw
from localexpstereo_tpu_torch.ops import plane as tpl
from localexpstereo_tpu_torch.ops import validity as tval
from localexpstereo_tpu_torch.ops import windows as twin

torch.set_num_threads(1)

H, W, ND = 40, 56, 12
LAYERS = [4, 8]


def _t(x):
    return torch.as_tensor(np.array(x))


def _labels(rng, shape):
    lab = np.zeros(shape + (4,), np.float32)
    lab[..., 0] = rng.uniform(-0.2, 0.2, shape)
    lab[..., 1] = rng.uniform(-0.2, 0.2, shape)
    lab[..., 2] = rng.uniform(0, ND - 1, shape)
    return lab


def test_plane_ops():
    rng = np.random.default_rng(0)
    lab = _labels(rng, (9, 11))
    np.testing.assert_allclose(tpl.get_normal(_t(lab)).numpy(),
                               np.asarray(jpl.get_normal(jnp.asarray(lab))),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        tpl.disparity_map(_t(lab), 3, 5).numpy(),
        np.asarray(jpl.disparity_map(jnp.asarray(lab), 3, 5)), rtol=1e-6,
        atol=1e-6)
    n = np.asarray(jpl.get_normal(jnp.asarray(lab)))
    z = rng.uniform(0, 10, (9, 11)).astype(np.float32)
    x = rng.uniform(0, 50, (9, 11)).astype(np.float32)
    y = rng.uniform(0, 50, (9, 11)).astype(np.float32)
    np.testing.assert_allclose(
        tpl.create_plane(_t(n), _t(z), _t(x), _t(y)).numpy(),
        np.asarray(jpl.create_plane(*map(jnp.asarray, (n, z, x, y)))),
        rtol=1e-6, atol=1e-5)


def test_grid_exact():
    for w, h, sizes in ((W, H, LAYERS), (1436, 992, [14, 43, 129]),
                        (97, 61, [5, 15, 25])):
        for s in sizes:
            lj, lt = jgrid.build_layer(w, h, s), tgrid.build_layer(w, h, s)
            assert dataclasses.astuple(lj) == dataclasses.astuple(lt)
            assert lj.colors == lt.colors
            for i0, j0 in lt.colors:
                for a, b in zip(lj.color_regions(i0, j0),
                                lt.color_regions(i0, j0)):
                    np.testing.assert_array_equal(a, b)
                assert lj.canvas_origin(i0, j0) == lt.canvas_origin(i0, j0)
        assert (jgrid.required_padding(sizes, 20)
                == tgrid.required_padding(sizes, 20))
        assert (jgrid.required_volume_padding(w, h, sizes, 10)
                == tgrid.required_volume_padding(w, h, sizes, 10))


@pytest.mark.parametrize("oy0,ox0,nby,nbx,t,f", [
    (3, 5, 3, 4, 8, 6), (0, 0, 2, 3, 8, 14), (7, 2, 2, 2, 4, 12),
    (60, 70, 2, 2, 8, 10),   # origin past the edge: clamped like JAX
])
def test_dense_windows_exact(oy0, ox0, nby, nbx, t, f):
    rng = np.random.default_rng(1)
    arr = rng.normal(size=(64, 72, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        twin.dense_windows(_t(arr), oy0, ox0, nby, nbx, t, f).numpy(),
        np.asarray(jwin.dense_windows(jnp.asarray(arr), oy0, ox0, nby, nbx,
                                      t, f)))
    lead = np.moveaxis(arr, -1, 0).copy()
    np.testing.assert_array_equal(
        twin.dense_windows_leading(_t(lead), oy0, ox0, nby, nbx, t,
                                   f).numpy(),
        np.asarray(jwin.dense_windows_leading(jnp.asarray(lead), oy0, ox0,
                                              nby, nbx, t, f)))


def test_pairwise_and_validity():
    rng = np.random.default_rng(2)
    img = (rng.random((H, W, 3)) * 255).astype(np.float32)
    cj = np.asarray(jpw.smoothness_coeffs(jnp.asarray(img), 10.0, 0.01))
    ct = tpw.smoothness_coeffs(_t(img), 10.0, 0.01).numpy()
    np.testing.assert_allclose(ct, cj, rtol=1e-6, atol=1e-6)
    lab = _labels(rng, (H, W))
    np.testing.assert_allclose(
        float(tpw.smoothness_cost(_t(lab), _t(cj), 0.5, 1.0)),
        float(jpw.smoothness_cost(jnp.asarray(lab), jnp.asarray(cj), 0.5,
                                  1.0)), rtol=1e-5)
    props = _labels(rng, (20,))
    ox = rng.integers(-8, 40, 20).astype(np.int32)
    oy = rng.integers(-8, 30, 20).astype(np.int32)
    want = np.asarray(jval.valid_windows(jnp.asarray(props), jnp.asarray(ox),
                                         jnp.asarray(oy), 9, 0.0, ND - 1.0))
    got = tval.valid_windows(_t(props), _t(ox), _t(oy), 9, 0.0, ND - 1.0)
    np.testing.assert_array_equal(got.numpy(), want)


def test_boxsum_and_guided_filter():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(3, 2, 17, 23)).astype(np.float32)
    np.testing.assert_allclose(tbox.boxsum2d(_t(x), 4).numpy(),
                               np.asarray(jbox.boxsum2d(jnp.asarray(x), 4)),
                               rtol=1e-5, atol=1e-4)
    img = (rng.random((H, W, 3)) * 255).astype(np.float32)
    sj = jgd.compute_stats(img, 5, 1e-4)
    st = tgd.compute_stats(img, 5, 1e-4)
    for a, b in zip(st, sj):
        np.testing.assert_array_equal(a, np.asarray(b))
    p = rng.uniform(0, 1, (2, H, W)).astype(np.float32)
    mask = np.ones((2, H, W), np.float32)
    mask[1, :, W - 7:] = 0.0
    args = [p, np.stack([st.guide] * 2), np.stack([st.mean] * 2),
            np.nan_to_num(np.stack([st.inv] * 2)), mask]
    want = np.asarray(jgd.filter_windows(*map(jnp.asarray, args), 5))
    got = tgd.filter_windows(*map(_t, args), 5).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_boxsum_independent_of_scan_order(monkeypatch):
    """Box sums of guided-filter products are bitwise the same whatever the
    association of the prefix-sum scan (a GPU scans in another order than
    the CPU), while a float32 scan in the two orders is not."""
    rng = np.random.default_rng(8)
    p = rng.uniform(0, 0.5, (6, 62, 62)).astype(np.float32)
    guide = rng.uniform(0, 1, (6, 3, 62, 62)).astype(np.float32)
    x = _t(np.concatenate([p[:, None], p[:, None] * guide], 1))
    cumsum = torch.cumsum

    def suffix_scan(t, dim):
        """The same prefix sums, associated from the other end."""
        return (t.sum(dim, keepdim=True)
                - torch.flip(cumsum(torch.flip(t, [dim]), dim), [dim]) + t)

    want = {r: tbox.boxsum2d(x, r) for r in (3, 10)}
    f32 = tbox._box1d_cumsum(x, 3, 3)
    monkeypatch.setattr(torch, "cumsum", suffix_scan)
    for r in (3, 10):
        assert torch.equal(tbox.boxsum2d(x, r), want[r])
    assert not torch.equal(tbox._box1d_cumsum(x, 3, 3), f32)


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(4)
    img0 = (rng.random((H, W, 3)) * 255).astype(np.float32)
    img1 = (rng.random((H, W, 3)) * 255).astype(np.float32)
    vol = rng.uniform(0, 1.2, (ND, H, W)).astype(np.float32)
    params_j = J_PARAMS.replace(windR=6, lambda_=0.5, th_col=0.5)
    params_t = T_PARAMS.replace(windR=6, lambda_=0.5, th_col=0.5)
    pad = jgrid.required_padding(LAYERS, params_j.windR)
    vp = jgrid.required_volume_padding(W, H, LAYERS, params_j.guided_radius)
    jdata, jcfg = jen.build_energy(img0, img1, params_j, ND - 1.0, pad,
                                   vol0=vol, vol1=vol * 0.7, vol_pad=vp,
                                   vol_dtype="uint8")
    tdata, tcfg = ten.build_energy(img0, img1, params_t, ND - 1.0, pad,
                                   vol, vol * 0.7, vol_pad=vp, device="cpu")
    return jdata, jcfg, tdata, tcfg


def test_build_energy_matches_jax(scene):
    jdata, jcfg, tdata, tcfg = scene
    for name in ("guide", "gf_mean", "gf_inv", "coeff8"):
        np.testing.assert_allclose(getattr(tdata, name).numpy(),
                                   np.asarray(getattr(jdata, name)),
                                   rtol=1e-6, atol=1e-6)
    tv = tdata.vol.numpy()
    np.testing.assert_array_equal(
        tv, np.asarray(jdata.vol)[..., :tv.shape[2], :tv.shape[3]])
    for f in ("width", "height", "pad", "min_disp", "max_disp", "vol_pad",
              "vol_scale", "vol_zero"):
        assert getattr(tcfg, f) == getattr(jcfg, f), f
    assert dataclasses.asdict(tcfg.params) == dataclasses.asdict(jcfg.params)
    carried, ccfg = ten.energy_from_numpy(jdata, jcfg, device="cpu")
    assert ccfg == tcfg
    np.testing.assert_array_equal(carried.coeff8.numpy(),
                                  np.asarray(jdata.coeff8))


@pytest.mark.parametrize("s,mode,i0,j0", [(4, 0, 0, 0), (4, 1, 2, 3),
                                          (8, 0, 1, 1)])
def test_unary_windows_uint8(scene, s, mode, i0, j0):
    """Filter windows and the filtered uint8 unary of one color step
    (the JAX side through its CPU-resolved "xla" slab sampler)."""
    jdata, jcfg, tdata, tcfg = scene
    layer = tgrid.build_layer(W, H, s)
    ox, oy, _ = layer.color_regions(i0, j0)
    cox, coy = layer.canvas_origin(i0, j0)
    nby, nbx, ss = layer.nby, layer.nbx, 3 * s
    rng = np.random.default_rng(s + mode)
    props = _labels(rng, (ox.shape[0],))
    props[0, :3] = [0.0, 0.0, 1e9]             # invalid everywhere
    props[1, 2] = np.nan                       # non-finite disparity

    jstat = jen.dense_filter_windows(jdata, jcfg, mode, jnp.asarray(ox),
                                     jnp.asarray(oy), coy, cox, s, nby, nbx,
                                     -s, ss)
    slabs = jen.dense_volume_slabs(jdata, jcfg, mode, coy, cox, s, nby, nbx,
                                   -s, ss)
    want = np.asarray(jen.unary_windows(
        jdata, jcfg, mode, jnp.asarray(props), jnp.asarray(ox),
        jnp.asarray(oy), -s, ss, stat_windows=jstat, vol_slabs=slabs))
    tstat = ten.dense_filter_windows(tdata, tcfg, mode, _t(ox).long(),
                                     _t(oy).long(), cox + s, coy + s, nby,
                                     nbx, 4 * s, -s, ss)
    for a, b in zip(tstat, jstat):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    got = ten.unary_windows(tdata, tcfg, mode, _t(props), _t(ox).long(),
                            _t(oy).long(), -s, ss, tstat).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def test_in_image_windows(scene):
    jdata, jcfg, tdata, tcfg = scene
    ox = np.array([-5, 0, 50], np.int32)
    oy = np.array([-3, 30, 38], np.int32)
    np.testing.assert_array_equal(
        ten.in_image_windows(tcfg, _t(ox).long(), _t(oy).long(), -2,
                             7).numpy(),
        np.asarray(jen.in_image_windows(jcfg, jnp.asarray(ox),
                                        jnp.asarray(oy), -2, 7)))
