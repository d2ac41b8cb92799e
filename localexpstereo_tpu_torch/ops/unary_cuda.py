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

The kernel launches once a call, by :func:`launch_plan`: a grid of tiles,
each a strip of output columns by a chunk of output rows of one window,
whose rows stream through shared memory (``csrc/sample_windows.cu``).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Callable, Optional, Tuple

import torch

from . import cuda_build, guided, unary_volume

Stats = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]

#: The volume's element types the kernel takes, by the number the source
#: gives each (``VolType`` in ``csrc/sample_windows.cu``).
VOL_TYPES = {torch.float32: 0, torch.uint8: 1, torch.bfloat16: 2}


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


# ------------------------------------------------------------ launch plan --
# The H100's limits and the kernel's blocks (csrc/sample_windows.cu).

#: Streaming multiprocessors of an H100 SXM.
SMS = 132
#: Dynamic shared memory one block may use; shared memory of an SM, and
#: what the card reserves of it for each block.
SMEM_PER_BLOCK, SMEM_PER_SM, SMEM_RESERVED = 232_448, 233_472, 1024
#: Threads of a filter block: about SM_THREADS over the blocks that
#: shared memory lets an SM hold, a multiple of 32 in [MIN_THREADS,
#: MAX_THREADS] (the kernel keeps 64 registers a thread).
MIN_THREADS, MAX_THREADS, SM_THREADS = 128, 512, 1024
#: Output columns of a filter tile at most.
MAX_WIDTH = 256
#: Rows a filter tile takes per step (the kernel's kBatch).
BATCH_ROWS = 8
#: Strip widths tried beside the whole window.
WIDTHS = (32, 64, 128, 256)
#: The raw kernel: threads a block, and about as many pixels a block.
RAW_THREADS, RAW_PIXELS = 256, 1024


@dataclasses.dataclass(frozen=True)
class Plan:
    """How the kernel lays N windows of F x F pixels on the card: tiles of
    ``width`` output columns (W) by ``rows`` output rows (Hc), a block of
    ``threads`` with ``smem_bytes`` of dynamic shared memory each. Tile
    (i, k) of a window owns columns ``[i W, (i + 1) W)`` and rows
    ``[k Hc, (k + 1) Hc)``, cut at F."""

    width: int
    rows: int
    threads: int
    smem_bytes: int

    def tiles(self, f: int):
        """Every tile of a window as (x0, x1, y0, y1), output pixels."""
        return [(x, min(x + self.width, f), y, min(y + self.rows, f))
                for y in range(0, f, self.rows)
                for x in range(0, f, self.width)]

    def blocks(self, f: int, n: int) -> int:
        return n * math.ceil(f / self.width) * math.ceil(f / self.rows)


def tile_plan(f: int, r: int, width: int, rows: int) -> Plan:
    """The block of tiles of ``width`` x ``rows`` output pixels as the
    kernel lays it out (``filter_layout`` in the source): shared memory for
    a step's float64 sums, each column's sums so far and the rings of both
    stages' rows, and as many threads as keep about :data:`SM_THREADS` on
    an SM. Raises ``ValueError`` for a block the kernel cannot run."""
    if not (0 < width <= f and 0 < rows <= f):
        raise ValueError(f"tile {width} x {rows} does not fit F = {f}")
    if r == 0:
        if width != f:
            raise ValueError("the raw kernel's tiles are whole rows")
        return Plan(f, rows, RAW_THREADS, 0)
    w1, w2 = min(f, width + 4 * r), min(f, width + 2 * r)
    ring = 2 * r + 1 + BATCH_ROWS
    smem = (32 * BATCH_ROWS * w1 + 32 * (w1 + w2) + 4 * ring * w1
            + 16 * ring * w2)
    if width > MAX_WIDTH or smem > SMEM_PER_BLOCK:
        raise ValueError(f"sample_windows: a tile {width} wide at r = {r} "
                         f"needs {smem} bytes of shared memory (at most "
                         f"{SMEM_PER_BLOCK}, and W <= {MAX_WIDTH})")
    per_sm = SMEM_PER_SM // (smem + SMEM_RESERVED)
    threads = SM_THREADS // per_sm if per_sm else MAX_THREADS
    threads = min(max(threads, MIN_THREADS), MAX_THREADS) // 32 * 32
    return Plan(width, rows, threads, smem)


def static_per_sm(plan: Plan) -> int:
    """Blocks of a plan an SM runs at once, estimated without the card (by
    shared memory, threads and 64 registers a thread). The wrapper asks
    the card instead (:func:`card_plan`)."""
    by_smem = SMEM_PER_SM // (plan.smem_bytes + SMEM_RESERVED)
    by_regs = 65536 // (64 * plan.threads)
    return min(32, 2048 // plan.threads, by_smem, by_regs)


def _steps(f: int, r: int, rows: int) -> int:
    """Rows the slowest tile of a row chunk walks, in whole batches."""
    walked = max(min(y + rows, f) + 2 * r - max(y - 2 * r, 0)
                 for y in range(0, f, rows))
    return BATCH_ROWS * math.ceil(walked / BATCH_ROWS)


def launch_plan(f: int, n: int, r: int,
                per_sm: Optional[Callable[[Plan], int]] = None) -> Plan:
    """The launch plan of N windows of F x F pixels at filter radius r.

    - r = 0 (raw costs): bands of whole rows, about :data:`RAW_PIXELS`
      pixels a block.
    - r > 0: of the strip widths (the whole window, then :data:`WIDTHS`)
      whose block fits, and of the row chunks, the pair with the least
      estimated time: waves (blocks over ``per_sm`` x :data:`SMS`) times
      the rows a tile walks (its chunk and up to 4r rows of warm-up) times
      the (row, column) pairs a thread takes a step, so that few windows
      (N = 6 at F = 407) still fill the card without wide halos. Ties go
      to the least work (blocks x rows x columns), then the wider strip.

    ``per_sm`` (blocks of a plan an SM runs at once) defaults to
    :func:`static_per_sm`. Raises ``ValueError`` where no block fits.
    """
    if f <= 0 or n < 0 or r < 0:
        raise ValueError(f"launch_plan: F = {f}, N = {n}, r = {r}")
    if r == 0:
        return tile_plan(f, 0, f, min(f, math.ceil(RAW_PIXELS / f)))
    per_sm = per_sm or static_per_sm
    best, best_key = None, None
    for width in sorted({f, *(w for w in WIDTHS if w < f)}, reverse=True):
        try:
            block = tile_plan(f, r, width, f)
        except ValueError:
            continue
        capacity = max(per_sm(block), 1) * SMS
        strips = math.ceil(f / width)
        cols = min(f, width + 4 * r)
        per_thread = max(1.0, BATCH_ROWS * cols / block.threads)
        for rows in sorted({math.ceil(f / c) for c in range(1, f + 1)},
                           reverse=True):
            blocks = max(n, 1) * strips * math.ceil(f / rows)
            steps = _steps(f, r, rows)
            key = (math.ceil(blocks / capacity) * steps * per_thread,
                   blocks * steps * cols)
            if best_key is None or key < best_key:
                best = dataclasses.replace(block, rows=rows)
                best_key = key
    if best is None:
        raise ValueError(f"sample_windows: no tile fits F = {f} at r = {r}")
    return best


@functools.lru_cache(maxsize=None)
def has_plan(f: int, r: int) -> bool:
    """Whether :func:`launch_plan` has a block for windows of F x F pixels
    at filter radius r (the number of windows changes no block). Asks
    nothing of the card."""
    try:
        launch_plan(f, 1, r)
    except ValueError:
        return False
    return True


# ------------------------------------------------------------- the kernel --

def _declare(lib: ctypes.CDLL) -> None:
    fn = lib.sample_windows_launch
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int]
                   + [ctypes.c_void_p] * 7
                   + [ctypes.c_int] * 11
                   + [ctypes.c_float] * 4
                   + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.sample_windows_configure.argtypes = []
    lib.sample_windows_configure.restype = ctypes.c_int
    fn = lib.sample_windows_occupancy
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 4
    fn.restype = ctypes.c_int


LIBRARY = cuda_build.Library("sample_windows", ("sample_windows.cu",),
                             _declare)


@functools.lru_cache(maxsize=None)
def configured(device: int) -> ctypes.CDLL:
    """The library, its filter kernels set up on CUDA device ``device`` for
    the most dynamic shared memory a block can take, once per device."""
    lib = cuda_build.load(LIBRARY)
    with torch.cuda.device(device):
        rc = lib.sample_windows_configure()
    cuda_build.launch_error("sample_windows configure", rc)
    return lib


@functools.lru_cache(maxsize=None)
def occupancy(f: int, r: int, width: int, vol_type: int = 1):
    """The card's answer for the kernel's tiles ``width`` wide on a volume
    of type ``vol_type`` (:data:`VOL_TYPES`; uint8 by default): (threads,
    shared-memory bytes, blocks an SM runs at once, registers a thread)."""
    lib = configured(torch.cuda.current_device())
    out = [ctypes.c_int(0) for _ in range(4)]
    rc = lib.sample_windows_occupancy(vol_type, f, r, width,
                                      *(ctypes.byref(v) for v in out))
    cuda_build.launch_error("sample_windows occupancy", rc)
    return tuple(v.value for v in out)


@functools.lru_cache(maxsize=None)
def card_plan(f: int, n: int, r: int, vol_type: int = 1) -> Plan:
    """:func:`launch_plan` with the card's answer for how many blocks an SM
    runs, asked once per (F, N, r, volume type): the port's cards are of
    one type. The volume's type changes no block (the shared memory holds
    float32 and float64 values), only, possibly, the registers. Raises if
    the kernel's block differs from the plan's or the card cannot run
    it."""
    def per_sm(plan):
        threads, smem, blocks, _ = occupancy(f, r, plan.width, vol_type)
        if (threads, smem) != (plan.threads, plan.smem_bytes):
            raise RuntimeError(f"sample_windows: the kernel's block "
                               f"({threads}, {smem}) is not {plan}")
        return blocks
    plan = launch_plan(f, n, r, per_sm)
    if per_sm(plan) < 1:
        raise RuntimeError(f"sample_windows: the card cannot run {plan}")
    return plan


def describe(f: int, n: int, r: int, vol_type: int = 1) -> dict:
    """The plan at (F, N, r) with the card's blocks an SM and registers:
    what the unary phase of ``chip_smoke.py`` prints."""
    plan = card_plan(f, n, r, vol_type)
    _, _, per_sm, regs = occupancy(f, r, plan.width, vol_type)
    return {"W": plan.width, "Hc": plan.rows, "threads": plan.threads,
            "smem_bytes": plan.smem_bytes, "blocks": plan.blocks(f, n),
            "blocks_per_sm": per_sm, "registers": regs}


def sample_windows(vol: torch.Tensor, vol_pad: int, proposals: torch.Tensor,
                   fox: torch.Tensor, foy: torch.Tensor, size: int,
                   height: int, width: int, *, min_disp: float,
                   th_col: float, scale: float = 1.0, zero: float = 0.0,
                   stats: Optional[Stats] = None, pad: int = 0,
                   r_gf: int = 0) -> torch.Tensor:
    """Unary cost windows of a batch of regions: raw, or guided-filtered
    when ``r_gf > 0``.

    Args:
      vol: [D, Hv, Wv] uint8, bfloat16 or float32 volume, image pixel
        (x, y) at ``[:, y + vol_pad, x + vol_pad]`` (any trailing padding
        is fine); values widen to float32 exactly before the tent sum.
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
    if vol.dtype not in VOL_TYPES:
        raise TypeError(f"vol: expected {tuple(VOL_TYPES)}, got {vol.dtype}")
    n = proposals.shape[0]
    with torch.cuda.device(dev):
        plan = (card_plan(int(size), n, int(r_gf), VOL_TYPES[vol.dtype])
                if n else None)
        return launch_windows(
            vol, vol_pad, proposals, fox, foy, size, height, width,
            min_disp=min_disp, th_col=th_col, scale=scale, zero=zero,
            stats=stats, pad=pad, r_gf=r_gf, plan=plan)


def launch_windows(vol, vol_pad, proposals, fox, foy, size, height, width,
                   *, min_disp, th_col, scale, zero, stats, pad, r_gf,
                   plan: Optional[Plan]) -> torch.Tensor:
    """Checks the CUDA tensors and launches the kernel with a given plan on
    the current device (:func:`sample_windows` passes the card's plan; the
    card tests and the plan sweep also force others). Allocates only the
    output."""
    dev = proposals.device
    n = proposals.shape[0]
    f32 = (torch.float32,)
    cuda_build.check("vol", vol, dev, tuple(VOL_TYPES), (None, None, None))
    cuda_build.check("proposals", proposals, dev, f32, (n, 4))
    if n > 65535:
        raise ValueError(f"sample_windows: {n} regions exceed the grid")
    fox64 = fox.to(torch.int64).contiguous()
    foy64 = foy.to(torch.int64).contiguous()
    cuda_build.check("fox", fox64, dev, (torch.int64,), (n,))
    cuda_build.check("foy", foy64, dev, (torch.int64,), (n,))
    out = torch.empty((n, size, size), dtype=torch.float32, device=dev)
    if n == 0:
        return out
    hp = wp = 0
    ptrs = [0, 0, 0]
    if r_gf > 0:
        hp, wp = stats[0].shape[:2]
        for name, a, c in zip(("guide", "mean", "inv"), stats, (3, 3, 6)):
            cuda_build.check(name, a, dev, f32, (hp, wp, c))
        ptrs = [a.data_ptr() for a in stats]
    d_, hv, wv = vol.shape
    rc = configured(dev.index).sample_windows_launch(
        vol.data_ptr(), VOL_TYPES[vol.dtype], *ptrs,
        proposals.data_ptr(), fox64.data_ptr(), foy64.data_ptr(),
        out.data_ptr(), n, int(size), d_, hv, wv, int(vol_pad), hp, wp,
        int(pad), int(height), int(width), float(-min_disp), float(th_col),
        float(scale), float(zero), int(r_gf), plan.width, plan.rows,
        torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.launch_error("sample_windows", rc)
    sample_windows.launches += 1
    return out


#: Number of kernel launches, counted where the kernel launches
#: (:func:`launch_windows`).
sample_windows.launches = 0
