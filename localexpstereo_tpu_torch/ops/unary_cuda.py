"""Unary cost windows of the cost-volume energy, sampled and guided-filtered
in one pass: the ``dma`` unary route.

Counterpart of ``localexpstereo_tpu.ops.unary_pallas.sample_windows_dma``.
:func:`sample_windows` is the route's one routing point:

- on a CUDA tensor it launches the hand-written kernel of
  ``csrc/sample_windows.cu`` (built by :mod:`.cuda_build`), or raises;
- on a CPU tensor it runs :func:`sample_windows_reference`, the same
  semantics in plain PyTorch: :func:`unary_volume.sample_windows_aligned`,
  then, with ``r_gf > 0``, :func:`guided.filter_windows` on statistic
  windows cut from the same tensors.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import cuda_build, guided, unary_volume

Stats = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


# ------------------------------------------------------------ plain version --

def stat_windows(stats: Stats, pad: int, fox: torch.Tensor,
                 foy: torch.Tensor, size: int):
    """(guide, mean, inv) [Hp, Wp, 3|3|6] padded by ``pad`` -> their
    [N, F, F, C] windows at (fox, foy), each pixel position clamped into
    the array like the kernel's reads."""
    hp, wp = stats[0].shape[:2]
    it = torch.arange(size, device=fox.device)
    iy = torch.clamp(foy.to(torch.int64)[:, None, None] + pad
                     + it[None, :, None], 0, hp - 1)
    ix = torch.clamp(fox.to(torch.int64)[:, None, None] + pad
                     + it[None, None, :], 0, wp - 1)
    return tuple(a[iy, ix] for a in stats)


def sample_windows_reference(vol: torch.Tensor, vol_pad: int,
                             proposals: torch.Tensor, fox: torch.Tensor,
                             foy: torch.Tensor, size: int, height: int,
                             width: int, *, min_disp: float, th_col: float,
                             scale: float = 1.0, zero: float = 0.0,
                             stats: Optional[Stats] = None, pad: int = 0,
                             r_gf: int = 0) -> torch.Tensor:
    """Plain PyTorch version of :func:`sample_windows` (same arguments and
    result)."""
    raw = unary_volume.sample_windows_aligned(
        vol, vol_pad, proposals, fox, foy, size, height, width,
        min_disp=min_disp, th_col=th_col, scale=scale, zero=zero)
    if r_gf == 0:
        return raw
    gwin, mwin, iwin = stat_windows(stats, pad, fox, foy, size)
    it = torch.arange(size, device=fox.device)
    ys = foy[:, None, None] + it[None, :, None]
    xs = fox[:, None, None] + it[None, None, :]
    fmask = ((xs >= 0) & (xs < width) & (ys >= 0)
             & (ys < height)).to(torch.float32)
    return guided.filter_windows(raw, gwin, mwin, iwin, fmask, r_gf)


# ------------------------------------------------------------- the kernel --

def _declare(lib: ctypes.CDLL) -> None:
    fn = lib.sample_windows_launch
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int]
                   + [ctypes.c_void_p] * 9
                   + [ctypes.c_int] * 11
                   + [ctypes.c_float] * 4
                   + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int


LIBRARY = cuda_build.Library("sample_windows", ("sample_windows.cu",),
                             _declare)


def sample_windows(vol: torch.Tensor, vol_pad: int, proposals: torch.Tensor,
                   fox: torch.Tensor, foy: torch.Tensor, size: int,
                   height: int, width: int, *, min_disp: float,
                   th_col: float, scale: float = 1.0, zero: float = 0.0,
                   stats: Optional[Stats] = None, pad: int = 0,
                   r_gf: int = 0) -> torch.Tensor:
    """Unary cost windows of a batch of regions: raw, or guided-filtered
    when ``r_gf > 0``.

    Args:
      vol: [D, Hv, Wv] uint8 or float32 volume, image pixel (x, y) at
        ``[:, y + vol_pad, x + vol_pad]`` (any trailing padding is fine).
      proposals: [N, 4] float32 planes; fox, foy: [N] integer window
        origins in image coordinates (may be negative).
      size: window side F; height, width: the image.
      min_disp, th_col: disparity offset and truncation of the cost.
      scale, zero: uint8 decode ``q * scale + zero``.
      stats: with ``r_gf > 0``, the (guide, mean, inv) float32 statistics
        [Hp, Wp, 3|3|6], image pixel (x, y) at ``[y + pad, x + pad]``.
      r_gf: guided-filter radius; 0 gives the raw costs.
    Returns:
      [N, F, F] float32: the costs truncated at ``th_col`` (0 outside the
      image), filtered when ``r_gf > 0``. Filtered values at window pixels
      whose box holds no in-image pixel are undefined.
    """
    dev = proposals.device
    if r_gf > 0 and stats is None:
        raise ValueError("r_gf > 0 needs the guided-filter statistics")
    if dev.type == "cpu":
        return sample_windows_reference(
            vol, vol_pad, proposals, fox, foy, size, height, width,
            min_disp=min_disp, th_col=th_col, scale=scale, zero=zero,
            stats=stats, pad=pad, r_gf=r_gf)
    if dev.type != "cuda":
        raise ValueError(f"sample_windows: unsupported device {dev}")
    n = proposals.shape[0]
    f32 = (torch.float32,)
    cuda_build.check("vol", vol, dev, (torch.uint8, torch.float32),
                     (None, None, None))
    cuda_build.check("proposals", proposals, dev, f32, (n, 4))
    if 4 * n > 65535:
        raise ValueError(f"sample_windows: {n} regions exceed the grid")
    fox32 = fox.to(torch.int32).contiguous()
    foy32 = foy.to(torch.int32).contiguous()
    cuda_build.check("fox", fox32, dev, (torch.int32,), (n,))
    cuda_build.check("foy", foy32, dev, (torch.int32,), (n,))
    out = torch.empty((n, size, size), dtype=torch.float32, device=dev)
    if n == 0:
        return out
    hp = wp = 0
    ptrs = [0, 0, 0]
    work_f = work_d = None
    if r_gf > 0:
        hp, wp = stats[0].shape[:2]
        for name, a, c in zip(("guide", "mean", "inv"), stats, (3, 3, 6)):
            cuda_build.check(name, a, dev, f32, (hp, wp, c))
        ptrs = [a.data_ptr() for a in stats]
        work_f = torch.empty((n, 4, size, size), dtype=torch.float32,
                             device=dev)
        work_d = torch.empty((n, 4, size, size), dtype=torch.float64,
                             device=dev)
    d_, hv, wv = vol.shape
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = cuda_build.load(LIBRARY).sample_windows_launch(
            vol.data_ptr(), int(vol.dtype == torch.uint8), *ptrs,
            proposals.data_ptr(), fox32.data_ptr(), foy32.data_ptr(),
            out.data_ptr(),
            0 if work_f is None else work_f.data_ptr(),
            0 if work_d is None else work_d.data_ptr(),
            n, int(size), d_, hv, wv, int(vol_pad), hp, wp, int(pad),
            int(height), int(width), float(-min_disp), float(th_col),
            float(scale), float(zero), int(r_gf), stream)
    cuda_build.launch_error("sample_windows", rc)
    sample_windows.launches += 1
    return out


#: Number of kernel launches (incremented only where the kernel launches).
sample_windows.launches = 0
