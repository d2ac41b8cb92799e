"""The fused unary kernel's launch plan (``unary_cuda.launch_plan``) and its
tile schedule, on the CPU.

- Each plan stays within Hopper's limits, its tiles cover every output
  pixel of a window exactly once, and their halos are clipped at the
  window's edges; the main path's plans are recorded here.
- :func:`emulate` walks a plan tile by tile in plain torch, each tile
  computed only from its own clipped input rectangle with float64 running
  box sums, as the kernel does (``csrc/sample_windows.cu``). It is held
  against ``sample_windows_reference`` and against the JAX package's
  ``unary_pallas.sample_windows_dma`` (Pallas, in interpret mode): the
  check on the kernel's halo and edge arithmetic that runs without a card.

Tolerances: raw costs 1e-6 (the same float32 operations); filtered costs
2e-4 on positions whose box holds an in-image pixel (float64 sums in
another order; the JAX kernel sums in float32).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from localexpstereo_tpu.ops import unary_pallas
from localexpstereo_tpu_torch.ops import boxfilter, unary_volume
from localexpstereo_tpu_torch.ops import unary_cuda as uc
from localexpstereo_tpu_torch.utils import synthetic

torch.set_num_threads(1)

#: The main path's (F, N) with r = 10 and r = 0, and the plan each gets:
#: (W, Hc, threads, dynamic shared-memory bytes).
MAIN_PATH = {
    (62, 468, 10): (62, 62, 256, 55_800),
    (149, 54, 10): (149, 75, 512, 134_100),
    (407, 6, 10): (64, 68, 512, 83_680),
    (62, 468, 0): (62, 17, 256, 0),
    (149, 54, 0): (149, 7, 256, 0),
    (407, 6, 0): (407, 3, 256, 0),
}


def input_rect(f, r, tile):
    """The window pixels tile (x0, x1, y0, y1) samples, as the kernel
    walks them: its output pixels widened by 2r, clipped to the window."""
    x0, x1, y0, y1 = tile
    return (max(x0 - 2 * r, 0), min(x1 + 2 * r, f),
            max(y0 - 2 * r, 0), min(y1 + 2 * r, f))


@pytest.mark.parametrize("r", [0, 3, 10])
@pytest.mark.parametrize("n", [1, 6, 54, 468])
@pytest.mark.parametrize("f", [1, 7, 21, 62, 64, 65, 149, 407])
def test_plan_within_hopper_limits_and_covers_each_pixel_once(f, n, r):
    plan = uc.launch_plan(f, n, r)
    assert 32 <= plan.threads <= 1024 and plan.threads % 32 == 0
    assert uc.MIN_THREADS <= plan.threads <= uc.MAX_THREADS or r == 0
    assert plan.width <= 256 or r == 0
    assert plan.smem_bytes <= 232_448
    assert plan == uc.tile_plan(f, r, plan.width, plan.rows)
    assert uc.static_per_sm(plan) >= 1
    hits = np.zeros((f, f), np.int64)
    for x0, x1, y0, y1 in plan.tiles(f):
        hits[y0:y1, x0:x1] += 1
        # The halos are clipped at the window's edges, not beyond.
        ax0, ax1, ay0, ay1 = input_rect(f, r, (x0, x1, y0, y1))
        assert 0 <= ax0 <= x0 < x1 <= ax1 <= f
        assert 0 <= ay0 <= y0 < y1 <= ay1 <= f
    assert (hits == 1).all()
    assert len(plan.tiles(f)) * n == plan.blocks(f, n)


@pytest.mark.parametrize("shape", sorted(MAIN_PATH))
def test_main_path_plans(shape):
    plan = uc.launch_plan(*shape)
    assert (plan.width, plan.rows, plan.threads, plan.smem_bytes) == \
        MAIN_PATH[shape]


def test_plan_fills_the_card_with_few_windows():
    """Whole-window tiles give 6 or 54 blocks at F = 407 and 149; the plan
    cuts strips or row chunks, up to one wave of the card."""
    for f, n in ((149, 54), (407, 6)):
        plan = uc.launch_plan(f, n, 10)
        blocks = plan.blocks(f, n)
        assert 2 * n <= blocks <= uc.SMS * uc.static_per_sm(plan)
    # One block an SM less (a card's answer) takes fewer blocks.
    fewer = uc.launch_plan(407, 6, 10, lambda p: uc.static_per_sm(p) - 1)
    assert fewer.blocks(407, 6) < uc.launch_plan(407, 6, 10).blocks(407, 6)


@pytest.mark.parametrize("f,r,width,rows", [
    (600, 10, 300, 10),    # 300 output columns: more than 8 a lane
    (400, 30, 256, 400),   # a ring of 65 rows of 316 columns: 398,912 B
    (10, 2, 11, 3),        # wider than the window
    (10, 0, 5, 3),         # raw tiles are whole rows
    (10, 2, 4, 0),
])
def test_sizes_the_kernel_cannot_take_are_refused(f, r, width, rows):
    with pytest.raises(ValueError):
        uc.tile_plan(f, r, width, rows)


def test_launch_plan_refuses_what_no_tile_fits():
    with pytest.raises(ValueError):
        uc.launch_plan(407, 6, 200)
    with pytest.raises(ValueError):
        uc.launch_plan(0, 1, 3)


# ----------------------------------------------------- the tile schedule --

def _running_box(x, r, first_row, rows_out, first_col, cols_out, f):
    """Box sums, clipped to the window [0, f), of x [N, C, R, K] (window
    rows from ``first_row``, columns from ``first_col``) at window rows
    ``rows_out`` and columns ``cols_out``: float64 running sums down the
    rows (add the row entering, subtract the row leaving), float64 prefix
    differences across, rounded to float32 once."""
    xd = x.double()
    nrows = x.shape[2]
    v = torch.zeros_like(xd[:, :, 0])
    kept = {}
    for i in range(nrows + r):
        if i < nrows:
            v = v + xd[:, :, i]
        if 0 <= i - 2 * r - 1 < nrows:
            v = v - xd[:, :, i - 2 * r - 1]
        kept[first_row + i - r] = v
    rows = torch.stack([kept[y] for y in rows_out], 2)
    prefix = torch.cumsum(rows, -1)
    out = []
    for xx in cols_out:
        hi = min(xx + r, f - 1) - first_col
        lo = max(xx - r, 0) - first_col - 1
        out.append(prefix[..., hi] - (prefix[..., lo] if lo >= 0 else 0.0))
    return torch.stack(out, -1).float()


def emulate(vol, vp, props, fox, foy, f, h, w, th, scale, stats, r, plan):
    """The kernel's output under ``plan``, tile by tile, in plain torch."""
    raw = unary_volume.sample_windows_aligned(
        vol, vp, props, fox, foy, f, h, w, min_disp=0.0, th_col=th,
        scale=scale, zero=0.0)
    out = torch.full_like(raw, float("nan"))
    it = torch.arange(f)
    inside = ((fox[:, None, None] + it[None, None, :] >= 0)
              & (fox[:, None, None] + it[None, None, :] < w)
              & (foy[:, None, None] + it[None, :, None] >= 0)
              & (foy[:, None, None] + it[None, :, None] < h)).float()
    if r:
        gwin, mwin, iwin = uc.stat_windows(stats, vp, fox, foy, f)
    for tile in plan.tiles(f):
        x0, x1, y0, y1 = tile
        if r == 0:
            out[:, y0:y1, x0:x1] = raw[:, y0:y1, x0:x1]
            continue
        ax0, ax1, ay0, ay1 = input_rect(f, r, tile)
        p = raw[:, ay0:ay1, ax0:ax1]
        g = gwin[:, ay0:ay1, ax0:ax1].permute(0, 3, 1, 2)
        planes = torch.cat([p[:, None], p[:, None] * g], 1)
        cy = range(max(y0 - r, 0), min(y1 + r, f))
        cx = range(max(x0 - r, 0), min(x1 + r, f))
        s = _running_box(planes, r, ay0, cy, ax0, cx, f)
        msk = inside[:, ay0:ay1, ax0:ax1][:, None]
        cnt = _running_box(msk, r, ay0, cy, ax0, cx, f)[:, 0]
        inv_n = 1.0 / torch.clamp(cnt, min=1e-8)
        sl = (slice(None), slice(cy[0], cy[-1] + 1),
              slice(cx[0], cx[-1] + 1))
        mean, inv = mwin[sl], iwin[sl]
        mean_p = s[:, 0] * inv_n
        cov = s[:, 1:] * inv_n[:, None] - mean.permute(0, 3, 1, 2) \
            * mean_p[:, None]
        ir, ig, ib = cov[:, 0], cov[:, 1], cov[:, 2]
        a_r = inv[..., 0] * ir + inv[..., 1] * ig + inv[..., 2] * ib
        a_g = inv[..., 1] * ir + inv[..., 3] * ig + inv[..., 4] * ib
        a_b = inv[..., 2] * ir + inv[..., 4] * ig + inv[..., 5] * ib
        b = (mean_p - a_r * mean[..., 0] - a_g * mean[..., 1]
             - a_b * mean[..., 2])
        m = inside[sl]
        coef = torch.stack([a_r * m, a_g * m, a_b * m, b * m], 1)
        ys, xs = range(y0, y1), range(x0, x1)
        ab = _running_box(coef, r, cy[0], ys, cx[0], xs, f)
        cnt = _running_box(inside[sl][:, None], r, cy[0], ys, cx[0], xs,
                           f)[:, 0]
        gi = gwin[:, y0:y1, x0:x1]
        out[:, y0:y1, x0:x1] = (ab[:, 0] * gi[..., 0] + ab[:, 1] * gi[..., 1]
                                + ab[:, 2] * gi[..., 2] + ab[:, 3]) \
            * (1.0 / torch.clamp(cnt, min=1e-8))
    return out


def _problem(seed, n, f, d, h, w, vp, dtype):
    """A seeded problem whose first windows are cut by every image edge
    (top-left, top-right, bottom-left, bottom-right, and one larger than
    the image where F > h)."""
    vol, props, fox, foy, stats, scale, th = synthetic.unary_window_problem(
        np.random.default_rng(seed), n, f, d, h, w, vp, dtype)
    corners = [(-4, -3), (w - f // 2, -2), (-2, h - f // 2),
               (w - f // 3, h - f // 3), (-f // 2, -f // 2)]
    for i, (x, y) in enumerate(corners[:n]):
        fox[i], foy[i] = x, y
    return (torch.from_numpy(vol), torch.from_numpy(props),
            torch.from_numpy(fox), torch.from_numpy(foy),
            tuple(map(torch.from_numpy, stats)), scale, th)


def _support(fox, foy, f, h, w, r):
    it = torch.arange(f)
    ys = foy[:, None, None] + it[None, :, None]
    xs = fox[:, None, None] + it[None, None, :]
    fmask = ((xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)).float()
    return boxfilter.boxsum2d(fmask, r) > 0.5


#: (F, r, forced (W, Hc) or None for launch_plan's), d, h, w.
SCHEDULES = {
    "strips-and-chunks": (21, 3, (8, 5), 6, 25, 31),
    "F<W": (13, 2, None, 5, 20, 24),
    "one-tile": (17, 2, (17, 17), 7, 20, 26),
    "narrow-many-chunks": (30, 5, (16, 7), 6, 26, 34),
    "r=1": (9, 1, (4, 2), 5, 12, 14),
    "raw": (15, 0, (15, 4), 6, 20, 24),
}


@pytest.mark.parametrize("dtype", ["float32", "uint8"])
@pytest.mark.parametrize("case", sorted(SCHEDULES))
def test_tile_schedule_matches_plain_version(case, dtype):
    f, r, forced, d, h, w = SCHEDULES[case]
    n, vp = 7, 12
    vol, props, fox, foy, stats, scale, th = _problem(f + r, n, f, d, h, w,
                                                      vp, dtype)
    plan = (uc.tile_plan(f, r, *forced) if forced
            else uc.launch_plan(f, n, r))
    if case != "one-tile" and r:
        assert len(plan.tiles(f)) > 1
    got = emulate(vol, vp, props, fox, foy, f, h, w, th, scale, stats, r,
                  plan)
    want = uc.sample_windows_reference(
        vol, vp, props, fox, foy, f, h, w, min_disp=0.0, th_col=th,
        scale=scale, zero=0.0, stats=stats, pad=vp, r_gf=r)
    if r == 0:
        torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
        return
    support = _support(fox, foy, f, h, w, r)
    assert support.any() and not support.all()
    torch.testing.assert_close(torch.where(support, got, 0.0),
                               torch.where(support, want, 0.0), rtol=0,
                               atol=2e-4)


def _align(arr, sub):
    """The JAX build_energy's trailing DMA alignment padding."""
    return np.pad(arr, ((0, 0), (0, (-arr.shape[1]) % sub + sub),
                        (0, (-arr.shape[2]) % 128 + 128)))


@pytest.mark.parametrize("r", [0, 3])
def test_tile_schedule_matches_jax_kernel(r):
    f, d, h, w, vp, n = 11, 6, 26, 30, 12, 9
    vol, props, fox, foy, stats, scale, th = _problem(3, n, f, d, h, w, vp,
                                                      "uint8")
    plan = uc.tile_plan(f, r, 4 if r else f, 3)
    got = emulate(vol, vp, props, fox, foy, f, h, w, th, scale, stats, r,
                  plan)
    stack = None
    if r:
        stack = jnp.asarray(_align(
            torch.cat(stats, -1).numpy().transpose(2, 0, 1), 32))
    want = np.asarray(unary_pallas.sample_windows_dma(
        jnp.asarray(_align(vol.numpy(), 32)), jnp.asarray(props.numpy()),
        jnp.asarray(fox.numpy()), jnp.asarray(foy.numpy()), vp, vp, f=f,
        height=h, width=w, min_disp=0.0, th_col=th, stats=stack, r_gf=r,
        rb=4, scale=scale, zero=0.0, interpret=True))
    got = got.numpy()
    if r == 0:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        return
    support = _support(fox, foy, f, h, w, r).numpy()
    np.testing.assert_allclose(np.where(support, got, 0.0),
                               np.where(support, want, 0.0), rtol=2e-4,
                               atol=2e-4)
