"""The "dma" unary route of the port (``ops/unary_cuda.py``) against the JAX
package's fused sampler ``unary_pallas.sample_windows_dma`` (Pallas, in
interpret mode on the CPU), on the same numpy inputs.

The JAX kernel reads a volume (and a 12-channel statistics stack) with its
DMA alignment padding; the port reads the same values at its own layout:
the volume without the trailing padding, the statistics as [Hp, Wp, C]
arrays. On a CPU tensor ``unary_cuda.sample_windows`` runs the kernel's
plain version, which is what is compared here; the CUDA kernel is held
against that plain version in ``tests/test_torch_cuda.py``.

A bfloat16 volume is made from the float32 one by each side's own cast
(``jnp.asarray(.., jnp.bfloat16)``, ``Tensor.to(torch.bfloat16)``: both
round to nearest even), so the two read the same values.

Tolerances: raw costs 1e-6 (float32 and bfloat16 volumes: the same float32
arithmetic on the same values) and rtol 1e-5 / atol 1e-6 (uint8 decode),
as the JAX package's own tests of the kernel; the fused guided
filter 2e-4 on positions whose box holds an in-image pixel (elsewhere the
filter divides by its 1e-8 clamp, and the engine masks those away). The
JAX kernel's box sums are a float32 scan, the port's are float64.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from localexpstereo_tpu.ops import boxfilter as jbox
from localexpstereo_tpu.ops import unary_pallas
from localexpstereo_tpu_torch.ops import guided, unary_cuda, unary_volume
from localexpstereo_tpu_torch.utils import synthetic

torch.set_num_threads(1)


def _align(arr, sub):
    """The JAX build_energy's trailing DMA alignment padding."""
    return np.pad(arr, ((0, 0), (0, (-arr.shape[1]) % sub + sub),
                        (0, (-arr.shape[2]) % 128 + 128)))


class _Bf16(np.ndarray):
    """A float32 volume that each side casts to bfloat16 itself."""


def _problem(seed, n, f, d, h, w, vp, dtype):
    out = synthetic.unary_window_problem(
        np.random.default_rng(seed), n, f, d, h, w, vp,
        "float32" if dtype == "bfloat16" else dtype)
    if dtype == "bfloat16":
        out = (out[0].view(_Bf16),) + out[1:]
    return out


def _jax(vol, props, fox, foy, vp, f, h, w, th, scale, stats=None, r=0):
    sub = 32 if vol.dtype == np.uint8 else 8
    stack = None
    if r > 0:
        stack = jnp.asarray(_align(
            np.concatenate(stats, -1).transpose(2, 0, 1), sub))
    jvol = jnp.asarray(_align(np.asarray(vol), sub),
                       jnp.bfloat16 if isinstance(vol, _Bf16) else None)
    return np.asarray(unary_pallas.sample_windows_dma(
        jvol, jnp.asarray(props), jnp.asarray(fox),
        jnp.asarray(foy), vp, vp, f=f, height=h, width=w, min_disp=0.0,
        th_col=th, stats=stack, r_gf=r, rb=4, scale=scale, zero=0.0,
        interpret=True))


def _args(vol, props, fox, foy, vp, f, h, w):
    tvol = torch.from_numpy(np.asarray(vol))
    if isinstance(vol, _Bf16):
        tvol = tvol.to(torch.bfloat16)
    return (tvol, vp, torch.from_numpy(props),
            torch.from_numpy(fox), torch.from_numpy(foy), f, h, w)


def _port(vol, props, fox, foy, vp, f, h, w, th, scale, stats=None, r=0):
    before = unary_cuda.sample_windows.launches
    out = unary_cuda.sample_windows(
        *_args(vol, props, fox, foy, vp, f, h, w), min_disp=0.0, th_col=th,
        scale=scale, zero=0.0,
        stats=None if r == 0 else tuple(map(torch.from_numpy, stats)),
        pad=vp, r_gf=r)
    # On the CPU the wrapper runs the plain version and launches nothing.
    assert unary_cuda.sample_windows.launches == before
    assert out.dtype == torch.float32 and out.shape == (len(props), f, f)
    return out.numpy()


@pytest.mark.parametrize("dtype", ["float32", "uint8", "bfloat16"])
@pytest.mark.parametrize("n,f,d", [(5, 7, 6), (17, 9, 12)])
def test_raw_costs_match_jax_kernel(dtype, n, f, d):
    h, w, vp = 25, 31, 10
    vol, props, fox, foy, _, scale, th = _problem(n, n, f, d, h, w, vp,
                                                  dtype)
    want = _jax(vol, props, fox, foy, vp, f, h, w, th, scale)
    got = _port(vol, props, fox, foy, vp, f, h, w, th, scale)
    rtol, atol = (1e-5, 1e-6) if dtype == "uint8" else (1e-6, 1e-6)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)
    # The non-finite plane costs th_col everywhere in the image.
    inside = want[1] != 0
    assert inside.any()
    np.testing.assert_array_equal(got[1][inside], np.float32(th))


@pytest.mark.parametrize("dtype", ["float32", "uint8", "bfloat16"])
def test_fused_guided_filter_matches_jax_kernel(dtype):
    d, h, w, vp, n, f, r = 6, 26, 30, 12, 9, 11, 3
    vol, props, fox, foy, stats, scale, th = _problem(2, n, f, d, h, w, vp,
                                                      dtype)
    want = _jax(vol, props, fox, foy, vp, f, h, w, th, scale, stats, r)
    got = _port(vol, props, fox, foy, vp, f, h, w, th, scale, stats, r)
    ys = foy[:, None, None] + np.arange(f)[None, :, None]
    xs = fox[:, None, None] + np.arange(f)[None, None, :]
    fmask = ((xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)).astype(np.float32)
    support = np.asarray(jbox.boxsum2d(jnp.asarray(fmask), r)) > 0.5
    np.testing.assert_allclose(np.where(support, got, 0.0),
                               np.where(support, want, 0.0), rtol=2e-4,
                               atol=2e-4)


def test_reference_is_sampler_then_filter():
    """The plain version composes the "auto" route's two functions."""
    d, h, w, vp, n, f, r = 5, 20, 24, 9, 6, 9, 2
    vol, props, fox, foy, stats, scale, th = _problem(4, n, f, d, h, w, vp,
                                                      "uint8")
    stats = tuple(map(torch.from_numpy, stats))
    args = _args(vol, props, fox, foy, vp, f, h, w)
    kw = dict(min_disp=0.0, th_col=th, scale=scale, zero=0.0)
    raw = unary_volume.sample_windows_aligned(*args, **kw)
    gwin, mwin, iwin = unary_cuda.stat_windows(stats, vp, args[3], args[4],
                                               f)
    ys = args[4][:, None, None] + torch.arange(f)[None, :, None]
    xs = args[3][:, None, None] + torch.arange(f)[None, None, :]
    fmask = ((xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)).float()
    want = guided.filter_windows(raw, gwin, mwin, iwin, fmask, r)
    got = unary_cuda.sample_windows(*args, **kw, stats=stats, pad=vp, r_gf=r)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    torch.testing.assert_close(unary_cuda.sample_windows(*args, **kw), raw,
                               rtol=0, atol=0)


def test_wrapper_refuses_what_it_cannot_run():
    vol, props, fox, foy, _, _, th = _problem(5, 3, 5, 4, 10, 12, 4,
                                              "float32")
    args = _args(vol, props, fox, foy, 4, 5, 10, 12)
    with pytest.raises(ValueError, match="statistics"):
        unary_cuda.sample_windows(*args, min_disp=0.0, th_col=th, r_gf=2)
    meta = [a.to("meta") if isinstance(a, torch.Tensor) else a for a in args]
    with pytest.raises(ValueError, match="unsupported device"):
        unary_cuda.sample_windows(*meta, min_disp=0.0, th_col=th)


def test_bf16_volume_is_the_jax_energys():
    """build_energy(vol_dtype="bfloat16") holds the bits of the JAX
    package's bfloat16 volume (float32 rounded to nearest even), and
    energy_from_numpy carries a JAX bfloat16 volume across bit for bit."""
    from localexpstereo_tpu.config import PARAMS_GF as J_PARAMS
    from localexpstereo_tpu.models import energy as jenergy
    from localexpstereo_tpu_torch.config import PARAMS_GF as T_PARAMS
    from localexpstereo_tpu_torch.models import energy as tenergy
    rng = np.random.default_rng(6)
    h, w, d, pad, vp = 12, 20, 7, 6, 5
    im = (rng.random((h, w, 3)) * 255).astype(np.float32)
    vols = [rng.normal(0.4, 0.3, (d, h, w)).astype(np.float32)
            for _ in range(2)]
    kw = dict(max_disp=d - 1.0, pad=pad, vol0=vols[0], vol1=vols[1],
              vol_pad=vp, vol_dtype="bfloat16")
    jdata, jcfg = jenergy.build_energy(im, im, J_PARAMS.replace(windR=4),
                                       **kw)
    tdata, tcfg = tenergy.build_energy(im, im, T_PARAMS.replace(windR=4),
                                       device="cpu", **kw)
    jbits = np.asarray(jdata.vol).view(np.int16)
    assert tdata.vol.dtype == torch.bfloat16
    assert (tcfg.vol_scale, tcfg.vol_zero) == (1.0, 0.0)
    np.testing.assert_array_equal(tdata.vol.view(torch.int16).numpy(),
                                  jbits[:, :, :tdata.vol.shape[2],
                                        :tdata.vol.shape[3]])
    carried, _ = tenergy.energy_from_numpy(jdata, jcfg, device="cpu")
    assert carried.vol.dtype == torch.bfloat16
    np.testing.assert_array_equal(carried.vol.view(torch.int16).numpy(),
                                  jbits)
