"""The plain reference of the V3 cost-volume energy that both
configurations solve (the reference C++'s ``CostVolumeEnergy`` with the
``FastGuidedImageFilter`` and the 8-neighbour smoothness term), in plain
torch on whatever device its inputs live on. It imports nothing of the
program: it works the energy out again from the inputs that the benchmark
made (images, the float cost volume, the parameters).

Every function takes the floating type it computes in (``dtype``): the
reference runs in float64 where the configuration states float64 (the
guide statistics) and float32 or float64 elsewhere; the control of the
correctness check runs the same code one precision lower.

The energy (``E = sum_p U_p(f_p) + lambda sum_pq w_pq psi(f_p, f_q)``):

- the volume is stored as uint8 codes over ``[zero, 2 th_col]``
  (:func:`quantize`), decoded as ``code * scale + zero``;
- the raw cost of a plane at a pixel is the volume interpolated linearly
  along d at ``d = a x + b y + c``, truncated at ``th_col``, 0 outside the
  image;
- ``U`` is that raw cost guided-filtered (radius ``windR // 2``, the
  guide's global statistics, the window's own box sums) over the window
  that a move evaluates the plane on, and ``1e6`` where the plane is
  invalid at the pixel (its disparity or one of the four probes
  ``d +- 5a +- 5b`` outside the range);
- ``psi`` is the truncated curvature ``min(|d_p(p) - d_q(p)| + |d_p(q) -
  d_q(q)|, tau)`` over the four forward neighbours, weighted by
  ``w = max(exp(-||I_p - I_q||_1 / omega), epsilon)``.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

COST_FOR_INVALID = 1e6
#: Neighbour offsets (dx, dy) of the weights, in the reference C++'s order
#: (``StereoEnergy.h:99-110``), and the forward ones the smoothness sums.
NEIGHBORS = ((-1, 0), (1, 0), (0, -1), (0, 1), (-1, -1), (1, -1), (-1, 1),
             (1, 1))
FORWARD = (1, 3, 6, 7)


class Params(NamedTuple):
    """The energy's parameters, as the configuration file states them."""

    windR: int
    lambda_: float
    th_col: float
    th_smooth: float
    omega: float
    epsilon: float
    gf_eps: float
    min_disp: float
    max_disp: float

    @property
    def radius(self) -> int:
        return self.windR // 2


def params_of(config: dict) -> Params:
    e = config["energy"]
    return Params(windR=e["windR"], lambda_=e["lambda"], th_col=e["th_col"],
                  th_smooth=e["th_smooth"], omega=e["omega"],
                  epsilon=e["epsilon"], gf_eps=e["gf_eps"], min_disp=0.0,
                  max_disp=float(config["ndisp"] - 1))


def box(x: torch.Tensor, r: int) -> torch.Tensor:
    """Sums over (2r+1)^2 boxes of the last two axes, zero beyond them."""
    for dim in (-2, -1):
        n = x.shape[dim]
        pad = [0, 0] * x.dim()
        k = 2 * (x.dim() - 1 - (dim % x.dim()))
        pad[k], pad[k + 1] = r + 1, r
        c = torch.cumsum(torch.nn.functional.pad(x, pad), dim)
        x = c.narrow(dim, 2 * r + 1, n) - c.narrow(dim, 0, n)
    return x


class Stats(NamedTuple):
    """Global guide statistics of one image: ``guide`` I / 255 [H, W, 3],
    ``mean`` [H, W, 3], ``inv`` [H, W, 6] (rr rg rb gg gb bb)."""

    guide: torch.Tensor
    mean: torch.Tensor
    inv: torch.Tensor


def guide_stats(image: torch.Tensor, r: int, eps: float,
                dtype=torch.float64) -> Stats:
    """The guided filter's per-pixel statistics over full (2r+1)^2 boxes
    clipped to the image, in ``dtype``: the channel means and the inverse
    of the regularized 3x3 colour covariance."""
    i = image.to(dtype) / 255.0
    ch = i.permute(2, 0, 1)
    n = box(torch.ones_like(ch[0]), r)
    mean = box(ch, r) / n
    cov = {}
    for a, b in ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2)):
        v = box(ch[a] * ch[b], r) / n - mean[a] * mean[b]
        cov[a, b] = v + eps if a == b else v
    m = torch.stack([torch.stack([cov[min(a, b), max(a, b)]
                                  for b in range(3)], -1)
                     for a in range(3)], -2)
    inv = torch.linalg.inv(m)
    six = torch.stack([inv[..., 0, 0], inv[..., 0, 1], inv[..., 0, 2],
                       inv[..., 1, 1], inv[..., 1, 2], inv[..., 2, 2]], -1)
    return Stats(guide=i, mean=mean.permute(1, 2, 0),
                 inv=torch.nan_to_num(six))


def weights(image: torch.Tensor, omega: float, eps: float,
            dtype=torch.float64) -> torch.Tensor:
    """[8, H, W] pairwise weights toward each neighbour, 0 where the
    neighbour lies outside the image."""
    i = image.to(dtype)
    h, w = i.shape[:2]
    out = torch.zeros((8, h, w), dtype=dtype, device=i.device)
    for k, (dx, dy) in enumerate(NEIGHBORS):
        ys = slice(max(0, -dy), h - max(0, dy))
        xs = slice(max(0, -dx), w - max(0, dx))
        qs = slice(ys.start + dy, ys.stop + dy)
        qx = slice(xs.start + dx, xs.stop + dx)
        l1 = (i[qs, qx] - i[ys, xs]).abs().sum(-1)
        out[k, ys, xs] = torch.clamp(torch.exp(-l1 / omega), min=eps)
    return out


def quantize(vol: torch.Tensor, th_col: float, zero: float = 0.0):
    """(uint8 codes, scale): the volume over [zero, 2 th_col] in 255
    steps, rounded to nearest even, in float32 as the configuration
    states."""
    hi = max(2.0 * th_col, zero + 1e-6)
    scale = (hi - zero) / 255.0
    v = vol.to(torch.float32).clamp(zero, hi) - zero
    q = torch.round(v / torch.tensor(scale, dtype=torch.float32,
                                     device=v.device))
    return q.to(torch.uint8), scale


def _plane_d(labels, xs, ys):
    """``a x + b y + c`` in float32, the labels' own precision, so that the
    taps and the validity fall as they do for the float32 labels given."""
    lab = labels.to(torch.float32)
    return (lab[..., 0] * xs.to(torch.float32)
            + lab[..., 1] * ys.to(torch.float32) + lab[..., 2])


def _taps(d: torch.Tensor, nd: int, min_disp: float, dtype):
    """The two interpolation taps of float32 disparity ``d``, their
    weights (as ``dtype``) and where ``d`` is finite."""
    finite = torch.isfinite(d)
    dv = torch.where(finite, (d - min_disp).clamp(0.0, nd - 1.0),
                     torch.zeros_like(d))
    lo = torch.floor(dv)
    w_lo = (1.0 - (lo - dv).abs()).clamp(min=0.0)
    w_hi = (1.0 - (lo + 1.0 - dv).abs()).clamp(min=0.0)
    ilo = lo.long()
    return (ilo, (ilo + 1).clamp(max=nd - 1), w_lo.to(dtype), w_hi.to(dtype),
            finite)


def _cost(v_lo, v_hi, w_lo, w_hi, finite, scale, zero, th_col):
    c = (v_lo * w_lo + v_hi * w_hi) * scale + zero
    c = torch.where(finite, c, torch.full_like(c, COST_FOR_INVALID))
    return c.clamp(max=th_col)


def filter_windows(p, guide, mean, inv, mask, r):
    """The fast guided filter of [N, F, F] costs ``p`` over their own
    windows: box sums clipped to the window, the guide's global
    statistics (windows [N, F, F, 3] / [N, F, F, 6], zero outside the
    image, ``mask`` 1 inside it)."""
    p = p * mask
    n = box(mask, r).clamp(min=1e-8)
    sums = box(torch.cat([p[:, None], p[:, None] * guide.permute(0, 3, 1, 2)],
                         1), r)
    mean_p = sums[:, 0] / n
    cov = sums[:, 1:] / n[:, None] - mean.permute(0, 3, 1, 2) * mean_p[:, None]
    iv = inv.permute(0, 3, 1, 2)
    a_r = iv[:, 0] * cov[:, 0] + iv[:, 1] * cov[:, 1] + iv[:, 2] * cov[:, 2]
    a_g = iv[:, 1] * cov[:, 0] + iv[:, 3] * cov[:, 1] + iv[:, 4] * cov[:, 2]
    a_b = iv[:, 2] * cov[:, 0] + iv[:, 4] * cov[:, 1] + iv[:, 5] * cov[:, 2]
    b = mean_p - a_r * mean[..., 0] - a_g * mean[..., 1] - a_b * mean[..., 2]
    ab = box(torch.stack([a_r, a_g, a_b, b], 1) * mask[:, None], r)
    return (ab[:, 0] * guide[..., 0] + ab[:, 1] * guide[..., 1]
            + ab[:, 2] * guide[..., 2] + ab[:, 3]) / n


def _valid(labels, xs, ys, min_disp, max_disp):
    lab = labels.to(torch.float32)
    a, b = lab[..., 0], lab[..., 1]
    d = _plane_d(lab, xs, ys)
    ok = (d >= min_disp) & (d <= max_disp)
    for sa in (1.0, -1.0):
        for sb in (1.0, -1.0):
            probe = d + sa * (a * 5.0) + sb * (b * 5.0)
            ok &= (probe >= min_disp) & (probe <= max_disp)
    return ok


def _stat_windows(stats: Stats, ys, xs, inside, dtype):
    """The statistics at window pixels (ys, xs) [N, F, F], zero outside."""
    h, w = stats.guide.shape[:2]
    yc, xc = ys.clamp(0, h - 1), xs.clamp(0, w - 1)
    m = inside[..., None].to(dtype)
    return tuple(t.to(dtype)[yc, xc] * m for t in stats)


def valid_or_flat(labels: torch.Tensor, p: Params) -> torch.Tensor:
    """A planted truth's labels [H, W, 4] made valid where they lie: a
    slanted plane whose probes leave the disparity range at its pixel (as
    near the range's ends) becomes the fronto-parallel plane of the same
    disparity there, which is valid, so that the truth's energy holds no
    ``1e6`` term."""
    h, w = labels.shape[:2]
    ys = torch.arange(h, device=labels.device)[:, None].expand(h, w)
    xs = torch.arange(w, device=labels.device)[None, :].expand(h, w)
    ok = _valid(labels, xs, ys, p.min_disp, p.max_disp)
    flat = torch.zeros_like(labels)
    flat[..., 2] = _plane_d(labels, xs, ys).clamp(p.min_disp, p.max_disp)
    return torch.where(ok[..., None], labels, flat)


def cell_unary(vol_windows: torch.Tensor, labels: torch.Tensor,
               ox: torch.Tensor, oy: torch.Tensor, s: int, stats: Stats,
               p: Params, shape, dtype=torch.float64) -> torch.Tensor:
    """The unary of each of N cells under its label over the cell's own
    s x s window (the init and the warm start evaluate a layer-0 cell so):
    [N, s, s] costs, 0 outside the image.

    ``vol_windows`` [N, D, F, F] is the float volume on each cell's filter
    window (F = s + 2R, from (ox - R, oy - R); any value outside the
    image); ``labels`` [N, 4]; ``shape`` (h, w) of the image."""
    h, w = shape
    r = p.radius
    f = s + 2 * r
    dev = labels.device
    it = torch.arange(f, device=dev)
    ys = (oy[:, None, None] - r + it[None, :, None]).expand(-1, f, f)
    xs = (ox[:, None, None] - r + it[None, None, :]).expand(-1, f, f)
    inside = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    codes, scale = quantize(vol_windows, p.th_col)
    lab = labels[:, None, None, :]
    d = _plane_d(lab, xs, ys)
    ilo, ihi, w_lo, w_hi, finite = _taps(d, codes.shape[1], p.min_disp,
                                         dtype)
    take = lambda i: torch.gather(codes, 1, i[:, None]).to(dtype)[:, 0]
    raw = _cost(take(ilo), take(ihi), w_lo, w_hi, finite, scale, 0.0,
                p.th_col)
    mask = inside.to(dtype)
    guide, mean, inv = _stat_windows(stats, ys, xs, inside, dtype)
    q = filter_windows(raw * mask, guide, mean, inv, mask, r)
    q = q[:, r:r + s, r:r + s]
    tx, ty, tin = (t[:, r:r + s, r:r + s] for t in (xs, ys, inside))
    ok = _valid(lab, tx, ty, p.min_disp, p.max_disp)
    q = torch.where(ok, q, torch.full_like(q, COST_FOR_INVALID))
    return q * tin.to(dtype)


def pixel_data_cost(codes: torch.Tensor, scale: float, labeling, stats,
                    p: Params, dtype=torch.float64, block: int = 8192):
    """The data term of a labeling [H, W, 4]: each pixel's unary under its
    own label over its own (2R+1)^2 window (the reference C++'s per-pixel
    evaluation, ``FastGCStereo.h:117-130``), summed. ``codes`` [D, H, W]
    uint8 with its ``scale``."""
    h, w = labeling.shape[:2]
    r = p.radius
    f = 2 * r + 1
    nd = codes.shape[0]
    dev = labeling.device
    flat_codes = codes.reshape(nd, -1)
    it = torch.arange(f, device=dev) - r
    total = torch.zeros((), dtype=torch.float64, device=dev)
    lab_flat = labeling.reshape(-1, 4)
    for start in range(0, h * w, block):
        idx = torch.arange(start, min(start + block, h * w), device=dev)
        py, px = idx // w, idx % w
        ys = (py[:, None, None] + it[None, :, None]).expand(-1, f, f)
        xs = (px[:, None, None] + it[None, None, :]).expand(-1, f, f)
        inside = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
        lab = lab_flat[idx][:, None, None, :]
        d = _plane_d(lab, xs, ys)
        ilo, ihi, w_lo, w_hi, finite = _taps(d, nd, p.min_disp, dtype)
        pix = ys.clamp(0, h - 1) * w + xs.clamp(0, w - 1)
        take = lambda i: flat_codes[i, pix].to(dtype)
        raw = _cost(take(ilo), take(ihi), w_lo, w_hi, finite, scale, 0.0,
                    p.th_col)
        mask = inside.to(dtype)
        guide, mean, inv = _stat_windows(stats, ys, xs, inside, dtype)
        q = filter_windows(raw * mask, guide, mean, inv, mask, r)[:, r, r]
        ok = _valid(lab[:, 0, 0], px, py, p.min_disp, p.max_disp)
        q = torch.where(ok, q, torch.full_like(q, COST_FOR_INVALID))
        total += q.sum().to(torch.float64)
    return total


def smoothness(labeling: torch.Tensor, wts: torch.Tensor, p: Params,
               dtype=torch.float64) -> torch.Tensor:
    """lambda * sum over pixels and forward neighbours of the weighted
    truncated curvature."""
    lab = labeling.to(dtype)
    h, w = lab.shape[:2]
    dev = lab.device
    ys = torch.arange(h, dtype=dtype, device=dev)[:, None]
    xs = torch.arange(w, dtype=dtype, device=dev)[None, :]

    def disp(l, x, y):
        return l[..., 0] * x + l[..., 1] * y + l[..., 2]

    total = torch.zeros((), dtype=torch.float64, device=dev)
    for k in FORWARD:
        dx, dy = NEIGHBORS[k]
        ys_p = slice(max(0, -dy), h - max(0, dy))
        xs_p = slice(max(0, -dx), w - max(0, dx))
        ys_q = slice(ys_p.start + dy, ys_p.stop + dy)
        xs_q = slice(xs_p.start + dx, xs_p.stop + dx)
        lp, lq = lab[ys_p, xs_p], lab[ys_q, xs_q]
        x, y = xs[:, xs_p], ys[ys_p]
        curv = ((disp(lp, x, y) - disp(lq, x, y)).abs()
                + (disp(lp, x + dx, y + dy) - disp(lq, x + dx, y + dy)).abs())
        term = curv.clamp(max=p.th_smooth) * wts[k, ys_p, xs_p].to(dtype)
        total += term.sum().to(torch.float64)
    return total * p.lambda_


def disparity(labeling: torch.Tensor, dtype=torch.float64) -> torch.Tensor:
    """[H, W] disparity ``a x + b y + c`` of a labeling."""
    lab = labeling.to(dtype)
    h, w = lab.shape[:2]
    ys = torch.arange(h, dtype=dtype, device=lab.device)[:, None]
    xs = torch.arange(w, dtype=dtype, device=lab.device)[None, :]
    return lab[..., 0] * xs + lab[..., 1] * ys + lab[..., 2]


def relative_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over max |want| (0 where both are 0)."""
    got = got.to(torch.float64)
    want = want.to(torch.float64)
    den = float(want.abs().max()) if want.numel() else 0.0
    num = float((got - want).abs().max()) if want.numel() else 0.0
    return num / den if den > 0 else (0.0 if num == 0 else math.inf)
