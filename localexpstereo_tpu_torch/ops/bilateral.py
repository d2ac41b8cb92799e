"""Joint bilateral cost aggregation (reference ``BilateralFilter``,
``GuidedFilter.h:329-374``; counterpart of
``localexpstereo_tpu.ops.bilateral``).

The aggregator of ``paramsBF`` (``main.cpp:72``): a weighted mean over a
(2R+1)^2 window with weights ``exp(-||I(q) - I(p)||_1 / sigma) * mask(q)``,
zero beyond the F x F window. Plain torch, as the JAX function is plain
XLA. The taps go one window row at a time: the 2R+1 shifts of a row are
strided views of the padded arrays (``unfold``), so a call takes 2R+1 steps
a chunk of windows, the chunks sized so that no temporary exceeds
:data:`CHUNK_BYTES`. The sum runs over a row's shifts at once, then row by
row: another order than the JAX package's tap by tap.

The weights and sums are float64, the result float32: a float32 sum
rounds by its order and ``exp`` by its device's implementation, and those
last bits flip near-tie moves, so that a solve on the card leaves its CPU
twin (0.24 % after two greedy sweeps at 360 x 248, windR 6, in float32;
PERF.md §6). In float64 the float32 result depends on neither.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

#: Bytes of one [n, F, 2R+1, F] float64 temporary of a step, at most.
CHUNK_BYTES = 128 << 20


def filter_windows(p: torch.Tensor, guide: torch.Tensor, mask: torch.Tensor,
                   radius: int, sigma: float) -> torch.Tensor:
    """Joint-bilateral filters a batch of cost windows.

    Args:
      p: [N, F, F] raw costs.
      guide: [N, F, F, 3] guide windows (0..255 scale, as the reference
        passes the raw image).
      mask: [N, F, F] in-image indicator.
    Returns:
      [N, F, F] aggregated costs, in ``p``'s dtype.
    """
    n, f = p.shape[0], p.shape[1]
    k = 2 * radius + 1
    wide = torch.float64
    mask = mask.to(wide)
    pad = (radius, radius, radius, radius)
    p_pad = F.pad(p.to(wide) * mask, pad)
    m_pad = F.pad(mask, pad)
    guide = guide.to(wide).permute(0, 3, 1, 2)          # [N, 3, F, F]
    g_pad = F.pad(guide, pad)
    g_ctr = guide[:, :, :, None, :]                     # [N, 3, F, 1, F]
    num = torch.zeros(p.shape, dtype=wide, device=p.device)
    den = torch.zeros_like(num)
    step = max(1, CHUNK_BYTES // (f * k * f * 8))
    for n0 in range(0, n, step):
        sl = slice(n0, min(n0 + step, n))
        for dy in range(k):
            # [n, F, k, F]: element (y, dx, x) is the tap (dy, dx) of
            # pixel (y, x).
            ps = p_pad[sl, dy:dy + f].unfold(2, f, 1)
            ms = m_pad[sl, dy:dy + f].unfold(2, f, 1)
            gs = g_pad[sl, :, dy:dy + f].unfold(3, f, 1)  # [n, 3, F, k, F]
            l1 = torch.abs(gs[:, 0] - g_ctr[sl, 0])
            l1 += torch.abs(gs[:, 1] - g_ctr[sl, 1])
            l1 += torch.abs(gs[:, 2] - g_ctr[sl, 2])
            w = torch.exp(-l1 / sigma) * ms
            num[sl] += (w * ps).sum(2)
            den[sl] += w.sum(2)
    return (num / torch.clamp(den, min=1e-8)).to(p.dtype)
