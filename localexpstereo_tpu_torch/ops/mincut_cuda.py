"""The graph-cut kernels' wrappers: the fused expansion move and the
min-cut of prebuilt graphs (the fusion move's solve).

- :func:`expansion_accept`, counterpart of
  ``localexpstereo_tpu.ops.mincut_pallas.expansion_accept_pallas`` (both
  its [b, S, S] and region-on-lanes layouts): pairwise tables, boundary
  t-links, graph build, push-relabel min-cut and the exact energy guard,
  per region; the routing point of the graph-cut sweep.
- :func:`solve_graph`, counterpart of the kernel of
  ``mincut_pallas.mincut_accept_pallas``: the push-relabel solve of
  prebuilt graphs (e, cap_t, cap_fw); the routing point of the fusion
  sweep, through :func:`fusion_accept`. :func:`mincut_accept` is
  ``mincut_accept_pallas`` itself (graph build, then the solve).

Each routing point runs, on a CUDA tensor, its hand-written kernel
(``csrc/expansion_accept.cu``, ``csrc/mincut_accept.cu``; one push-relabel
core, ``csrc/push_relabel.cuh``), built by ``nvcc`` for ``sm_90a`` from
the package's sources at first use, or raises; on a CPU tensor, the same
semantics in plain PyTorch. The libraries are built and loaded by
:mod:`.cuda_build` (``nvcc`` into ``build/torch_kernels/``, plain
``extern "C"`` launchers loaded with ``ctypes``).

Both kernels launch by one :func:`launch_plan`: a region is solved by one
block, with its whole solve state in shared memory while it fits, or by a
thread-block cluster of K blocks in row bands, each holding its band's hot
planes in shared memory (``csrc/push_relabel.cuh``).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Callable, Optional

import torch

from . import cuda_build, mincut, pairwise

#: Round structure of the fusion move's solve: the JAX package's
#: ``mincut.fusion_accept`` defaults, at every window size.
FUSION_ROUNDS, FUSION_SWEEPS = 64, 16

# ------------------------------------------------------------ launch plan --
# The H100's limits and the kernels' state (csrc/push_relabel.cuh).

#: Streaming multiprocessors of an H100 SXM.
SMS = 132
#: Shared memory one block may use (dynamic and static), and the static
#: shared memory the kernels declare themselves (votes, sums), rounded up.
SMEM_PER_BLOCK, SMEM_STATIC = 232_448, 1024
#: Cluster sizes tried, largest first; above 8 is a non-portable size.
CLUSTER_SIZES = (16, 8, 4, 2)
#: Where the solve state lives, by the kernels' code (kState*).
STATES = {"global": 0, "banded": 1, "shared": 2}
#: Bytes a pixel of state takes in shared memory: all 13 float planes and
#: the 2 int8 planes ("shared"), or the 5 hot float planes and the 2 int8
#: planes ("banded").
SHARED_PX_BYTES, BANDED_PX_BYTES = 13 * 4 + 2, 5 * 4 + 2
#: Global workspace slots (S*S float32) a region's state takes, by state
#: (the two int8 planes share one slot).
STATE_SLOTS = {"global": 14, "banded": 8, "shared": 0}
#: The expansion kernel's table slots (c00, c01, c10: 4 each; t0; t1).
TABLE_PLANES = 14
#: Threads per block: one region on a block, or a block of a cluster.
BLOCK_THREADS, CLUSTER_THREADS = 512, 1024
#: Windows at least this wide are refused: the kernels find a pixel's row
#: with a float reciprocal, exact only below it (push_relabel.cuh: xy).
MAX_S = 2048


@dataclasses.dataclass(frozen=True)
class Plan:
    """How the graph-cut kernels lay N regions of S x S pixels on the card:
    ``cluster`` blocks per region (K), ``threads`` per block, ``smem_bytes``
    of dynamic shared memory per block, ``state`` ("shared", "banded" or
    "global", see :data:`STATES`) and ``band_rows``, the rows a block owns
    (block r owns ``[r * band_rows, (r + 1) * band_rows)``, cut at S)."""

    cluster: int
    threads: int
    smem_bytes: int
    state: str
    band_rows: int

    def bands(self, s: int):
        """Each block's rows, as (first, end) pairs; empty bands included."""
        return [(min(r * self.band_rows, s), min((r + 1) * self.band_rows, s))
                for r in range(self.cluster)]

    def work_slots(self, tables: int = 0) -> int:
        """Global workspace slots a region takes, after ``tables`` slots."""
        return tables + STATE_SLOTS[self.state]


def static_active(plan: Plan) -> int:
    """Regions of a plan the card runs at once, estimated without it: one
    block an SM, or two where both fit. The kernels' wrappers ask the card
    instead (:func:`card_plan`)."""
    per_sm = 2 if (plan.threads <= BLOCK_THREADS and 2 * (
        plan.smem_bytes + SMEM_STATIC) <= SMEM_PER_BLOCK) else 1
    return SMS * per_sm // plan.cluster


def launch_plan(s: int, n: int,
                active: Optional[Callable[[Plan], int]] = None) -> Plan:
    """The launch plan of N regions of S x S pixels.

    - K = 1 while the region's whole solve state fits one block's shared
      memory (S <= 65): one block of up to 512 threads per region, two
      regions an SM where both fit (S = 42: 95,256 bytes each).
    - Otherwise a cluster of K blocks in row bands, K the largest of
      :data:`CLUSTER_SIZES` for which ``active(plan)`` (how many such
      clusters the card runs at once) reaches N, so that the N regions run
      in one wave; K = 2 if none does. Each block holds its band's hot
      planes in shared memory if they fit ("banded"), else all state lives
      in the global workspace ("global").

    ``active`` defaults to :func:`static_active`. Raises for S >=
    :data:`MAX_S`.
    """
    if not 0 < s < MAX_S:
        raise ValueError(f"launch_plan: window size {s} is outside "
                         f"1..{MAX_S - 1}")
    active = active or static_active
    ss = s * s
    if ss * SHARED_PX_BYTES <= SMEM_PER_BLOCK - SMEM_STATIC:
        threads = min(BLOCK_THREADS, 32 * math.ceil(ss / 32))
        return Plan(1, threads, ss * SHARED_PX_BYTES, "shared", s)
    for k in CLUSTER_SIZES:
        plan = cluster_plan(s, k)
        if active(plan) >= n:
            return plan
    return cluster_plan(s, CLUSTER_SIZES[-1])


def cluster_plan(s: int, k: int, state: Optional[str] = None) -> Plan:
    """A region of S x S pixels on a cluster of K blocks in row bands:
    "banded" if a band's hot planes fit a block's shared memory, else
    "global" (or the ``state`` given)."""
    rows = math.ceil(s / k)
    smem = rows * s * BANDED_PX_BYTES
    if state is None:
        state = ("banded" if smem <= SMEM_PER_BLOCK - SMEM_STATIC
                 else "global")
    return Plan(k, CLUSTER_THREADS, smem if state == "banded" else 0, state,
                rows)


def _declare_plans(lib: ctypes.CDLL, kernel: str) -> None:
    fn = getattr(lib, f"{kernel}_occupancy")
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    fn = getattr(lib, f"{kernel}_configure")
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_int


@functools.lru_cache(maxsize=None)
def configured(kernel: str, state: str, device: int) -> ctypes.CDLL:
    """The library of kernel "expansion_accept" or "mincut_accept", its
    kernel for ``state`` set up for any plan on CUDA device ``device``
    (the most dynamic shared memory a block can take, clusters above 8),
    once per kernel, state and device."""
    lib = cuda_build.load(LIBRARY if kernel == "expansion_accept"
                          else MINCUT_LIBRARY)
    with torch.cuda.device(device):
        rc = getattr(lib, f"{kernel}_configure")(STATES[state])
    cuda_build.launch_error(f"{kernel} configure", rc)
    return lib


@functools.lru_cache(maxsize=None)
def occupancy(kernel: str, plan: Plan):
    """(regions the card runs at once, registers per thread) of a plan, for
    kernel "expansion_accept" or "mincut_accept", asked of the card
    (``cudaOccupancyMaxActiveClusters``, or blocks per SM times SMs)."""
    lib = configured(kernel, plan.state, torch.cuda.current_device())
    active, regs = ctypes.c_int(0), ctypes.c_int(0)
    rc = getattr(lib, f"{kernel}_occupancy")(
        plan.cluster, plan.threads, plan.smem_bytes, STATES[plan.state],
        ctypes.byref(active), ctypes.byref(regs))
    cuda_build.launch_error(f"{kernel} occupancy", rc)
    return active.value, regs.value


@functools.lru_cache(maxsize=None)
def card_plan(kernel: str, s: int, n: int) -> Plan:
    """:func:`launch_plan` with the card's answer for how many clusters fit,
    asked once per (kernel, S, N): the port's cards are of one type.
    Raises if the card cannot run even one region of the plan."""
    plan = launch_plan(s, n, lambda p: occupancy(kernel, p)[0])
    if occupancy(kernel, plan)[0] < 1:
        raise RuntimeError(f"{kernel}: the card cannot run {plan}")
    return plan


def describe(kernel: str, s: int, n: int) -> dict:
    """The plan at (S, N) with the card's occupancy and registers: what the
    kernel phases of ``chip_smoke.py`` print."""
    plan = card_plan(kernel, s, n)
    active, regs = occupancy(kernel, plan)
    return {"K": plan.cluster, "threads": plan.threads,
            "smem_bytes": plan.smem_bytes, "state": plan.state,
            "band_rows": plan.band_rows, "active_clusters": active,
            "registers": regs}


# ------------------------------------------------------------ plain version --

def fused_terms(halo, props, tox, toy, coeff8, ccost, pcost, lam: float,
                tau: float):
    """Tables (c00, c01, c10: [N, 4, S, S]) and total unaries (t0, t1:
    [N, S, S]) of the fused move, in the kernel's expressions and order."""
    c00, c01, c10 = pairwise.expansion_tables(
        halo, props, coeff8[:, list(pairwise.FORWARD)], tox, toy, lam, tau)
    t0b, t1b = pairwise.boundary_tlinks(halo, props, coeff8, tox, toy, lam,
                                        tau)
    return c00, c01, c10, ccost + t0b, pcost + t1b


def fusion_terms(halo0, halo1, tox, toy, coeff8, ccost, pcost, lam: float,
                 tau: float):
    """Total unaries (t0, t1: [N, S, S]) and tables (c00, c01, c10, c11:
    [N, 4, S, S]) of the fusion move of current labels ``halo0`` against
    external labels ``halo1`` ([N, S+2, S+2, 4] each), in
    :func:`fusion_accept`'s argument order."""
    tables = pairwise.fusion_tables(halo0, halo1,
                                    coeff8[:, list(pairwise.FORWARD)], tox,
                                    toy, lam, tau)
    t0b, t1b = pairwise.fusion_boundary_tlinks(halo0, halo1, coeff8, tox,
                                               toy, lam, tau)
    return (ccost + t0b, pcost + t1b, *tables)


def expansion_accept_reference(halo, props, tox, toy, coeff8, ccost, pcost,
                               *, lam: float, tau: float,
                               max_global_rounds: int = 64,
                               sweeps_per_round: int = 0) -> torch.Tensor:
    """Plain PyTorch version of the fused expansion move (same arguments
    and result as :func:`expansion_accept`)."""
    sweeps_per_round = sweeps_per_round or 16
    c00, c01, c10, t0, t1 = fused_terms(halo, props, tox, toy, coeff8,
                                        ccost, pcost, lam, tau)
    accept = mincut.mincut_accept(t0, t1, c00, c01, c10, max_global_rounds,
                                  sweeps_per_round)
    delta = mincut.move_energy_delta(accept, t0, t1, c00, c01, c10)
    return accept & (delta <= 0.0)[:, None, None]


# ------------------------------------------------------------- the kernel --

def _declare(lib: ctypes.CDLL) -> None:
    fn = lib.expansion_accept_launch
    fn.argtypes = ([ctypes.c_void_p] * 9
                   + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                      ctypes.c_float] + [ctypes.c_int] * 7
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    _declare_plans(lib, "expansion_accept")


LIBRARY = cuda_build.Library("expansion_accept", ("expansion_accept.cu",),
                             _declare, headers=("push_relabel.cuh",))


def _check(name, x, shape, device):
    cuda_build.check(name, x, device, (torch.float32,), shape)


def expansion_accept(halo: torch.Tensor, props: torch.Tensor,
                     tox: torch.Tensor, toy: torch.Tensor,
                     coeff8: torch.Tensor, ccost: torch.Tensor,
                     pcost: torch.Tensor, *, lam: float, tau: float,
                     max_global_rounds: int = 64, sweeps_per_round: int = 0,
                     plan_n: Optional[int] = None) -> torch.Tensor:
    """Fused expansion move for a batch of regions.

    Args:
      halo: [N, S+2, S+2, 4] current labels of each move window + 1-px halo.
      props: [N, 4] proposal planes.
      tox, toy: [N] global coords of each window's (0, 0) pixel (float32).
      coeff8: [N, 8, S, S] pairwise weights at p for all 8 directions.
      ccost, pcost: [N, S, S] current / proposal unary (with validity).
      lam, tau: smoothness weight and truncation.
      max_global_rounds, sweeps_per_round: round structure of the solve
        (0 sweeps = 16).
      plan_n: the region count the launch plan is chosen for (default N):
        a height shard passes its rows of a color with the whole color's
        count, so that it launches the plan of the unsharded call and its
        rows come out as that call's (the plan's band split orders the
        solve's float work). The plain version has no plan.
    Returns:
      accept: [N, S, S] bool, zeroed in every region whose move would raise
      the region energy.
    """
    n, s = halo.shape[0], halo.shape[1] - 2
    dev = halo.device
    _check("halo", halo, (n, s + 2, s + 2, 4), dev)
    _check("props", props, (n, 4), dev)
    _check("tox", tox, (n,), dev)
    _check("toy", toy, (n,), dev)
    _check("coeff8", coeff8, (n, 8, s, s), dev)
    _check("ccost", ccost, (n, s, s), dev)
    _check("pcost", pcost, (n, s, s), dev)
    if dev.type == "cpu":
        return expansion_accept_reference(
            halo, props, tox, toy, coeff8, ccost, pcost, lam=lam, tau=tau,
            max_global_rounds=max_global_rounds,
            sweeps_per_round=sweeps_per_round)
    if dev.type != "cuda":
        raise ValueError(f"expansion_accept: unsupported device {dev}")
    if n == 0:
        return torch.empty((n, s, s), dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        plan = card_plan("expansion_accept", s, plan_n or n)
        return launch_expansion(
            halo, props, tox, toy, coeff8, ccost, pcost, lam=lam, tau=tau,
            max_global_rounds=max_global_rounds,
            sweeps_per_round=sweeps_per_round, plan=plan)


def launch_expansion(halo, props, tox, toy, coeff8, ccost, pcost, *,
                     lam: float, tau: float, max_global_rounds: int,
                     sweeps_per_round: int, plan: Plan) -> torch.Tensor:
    """Launches the expansion kernel with a given plan on checked CUDA
    tensors on the current device (:func:`expansion_accept` passes the
    card's plan; the card tests also force others)."""
    n, s = halo.shape[0], halo.shape[1] - 2
    accept = torch.empty((n, s, s), dtype=torch.bool, device=halo.device)
    work = torch.empty((n, plan.work_slots(TABLE_PLANES), s, s),
                       dtype=torch.float32, device=halo.device)
    lib = configured("expansion_accept", plan.state, halo.device.index)
    rc = lib.expansion_accept_launch(
        halo.data_ptr(), props.data_ptr(), tox.data_ptr(), toy.data_ptr(),
        coeff8.data_ptr(), ccost.data_ptr(), pcost.data_ptr(),
        accept.data_ptr(), work.data_ptr(), n, s, float(lam), float(tau),
        int(max_global_rounds), int(sweeps_per_round or 16), *_plan_args(plan),
        torch.cuda.current_stream().cuda_stream)
    cuda_build.launch_error("expansion_accept", rc)
    expansion_accept.launches += 1
    return accept


def _plan_args(plan: Plan):
    return (plan.cluster, plan.threads, plan.smem_bytes, STATES[plan.state],
            plan.band_rows)


#: Number of kernel launches, counted where the kernel launches
#: (:func:`launch_expansion`).
expansion_accept.launches = 0


# ------------------------------------------------ min-cut of prebuilt graphs --

def _declare_mincut(lib: ctypes.CDLL) -> None:
    fn = lib.mincut_accept_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _declare_plans(lib, "mincut_accept")


MINCUT_LIBRARY = cuda_build.Library("mincut_accept", ("mincut_accept.cu",),
                                    _declare_mincut,
                                    headers=("push_relabel.cuh",))


def solve_graph(e: torch.Tensor, cap_t: torch.Tensor, cap_fw: torch.Tensor,
                *, max_global_rounds: int = 64,
                sweeps_per_round: int = 0) -> torch.Tensor:
    """Push-relabel min-cut of N prebuilt S x S grid graphs.

    Args:
      e, cap_t: [N, S, S] float32 excess and sink capacities.
      cap_fw: [N, 4, S, S] float32 forward edge capacities (reverse
        capacities start at 0).
      max_global_rounds, sweeps_per_round: round structure of the solve
        (0 sweeps = 16).
    Returns:
      accept: [N, S, S] bool, the source side.
    """
    n, s = e.shape[0], e.shape[-1]
    dev = e.device
    sweeps = int(sweeps_per_round or 16)
    _check("e", e, (n, s, s), dev)
    _check("cap_t", cap_t, (n, s, s), dev)
    _check("cap_fw", cap_fw, (n, 4, s, s), dev)
    if dev.type == "cpu":
        return mincut.solve_preflow(e, cap_t, cap_fw, max_global_rounds,
                                    sweeps)
    if dev.type != "cuda":
        raise ValueError(f"solve_graph: unsupported device {dev}")
    if n == 0:
        return torch.empty((n, s, s), dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        return launch_mincut(e, cap_t, cap_fw,
                             max_global_rounds=max_global_rounds,
                             sweeps_per_round=sweeps,
                             plan=card_plan("mincut_accept", s, n))


def launch_mincut(e, cap_t, cap_fw, *, max_global_rounds: int,
                  sweeps_per_round: int, plan: Plan) -> torch.Tensor:
    """Launches the min-cut kernel with a given plan on checked CUDA
    tensors on the current device (:func:`solve_graph` passes the card's
    plan; the card tests also force others)."""
    n, s = e.shape[0], e.shape[-1]
    accept = torch.empty((n, s, s), dtype=torch.bool, device=e.device)
    work = torch.empty((n, plan.work_slots(), s, s), dtype=torch.float32,
                       device=e.device)
    lib = configured("mincut_accept", plan.state, e.device.index)
    rc = lib.mincut_accept_launch(
        e.data_ptr(), cap_t.data_ptr(), cap_fw.data_ptr(), accept.data_ptr(),
        work.data_ptr(), n, s, int(max_global_rounds),
        int(sweeps_per_round or 16), *_plan_args(plan),
        torch.cuda.current_stream().cuda_stream)
    cuda_build.launch_error("mincut_accept", rc)
    solve_graph.launches += 1
    return accept


#: Number of kernel launches, counted where the kernel launches
#: (:func:`launch_mincut`).
solve_graph.launches = 0


def mincut_accept(t0, t1, c00, c01, c10, *, max_global_rounds: int = 64,
                  sweeps_per_round: int = 0) -> torch.Tensor:
    """The expansion move's min-cut from its tables (t0, t1: [N, S, S];
    c00, c01, c10: [N, 4, S, S]): :func:`mincut.build_graph`, then
    :func:`solve_graph`. accept[p] == True takes the proposal."""
    graph = mincut.build_graph(t0, t1, c00, c01, c10)
    return solve_graph(*(x.contiguous() for x in graph),
                       max_global_rounds=max_global_rounds,
                       sweeps_per_round=sweeps_per_round)


def fusion_accept(t0, t1, c00, c01, c10, c11, *,
                  max_global_rounds: int = FUSION_ROUNDS,
                  sweeps_per_round: int = FUSION_SWEEPS) -> torch.Tensor:
    """The fusion move between two labelings (``fusionMoveBK``,
    ``FastGCStereo.h:241-410``): :func:`mincut.build_fusion_graph`, then
    :func:`solve_graph`. accept[p] == True takes labeling 1. Truncated
    non-submodular edges make it approximate; the caller guards it with
    :func:`mincut.fusion_move_energy_delta`."""
    graph = mincut.build_fusion_graph(t0, t1, c00, c01, c10, c11)
    return solve_graph(*(x.contiguous() for x in graph),
                       max_global_rounds=max_global_rounds,
                       sweeps_per_round=sweeps_per_round)
