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
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda_build, mincut, pairwise

#: float32 planes of the kernels' per-region workspaces (see the .cu files).
WORK_PLANES = 29
MINCUT_WORK_PLANES = 10
#: Round structure of the fusion move's solve: the JAX package's
#: ``mincut.fusion_accept`` defaults, at every window size.
FUSION_ROUNDS, FUSION_SWEEPS = 64, 16


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
                      ctypes.c_float, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int


LIBRARY = cuda_build.Library("expansion_accept", ("expansion_accept.cu",),
                             _declare, headers=("push_relabel.cuh",))


def _check(name, x, shape, device):
    cuda_build.check(name, x, device, (torch.float32,), shape)


def expansion_accept(halo: torch.Tensor, props: torch.Tensor,
                     tox: torch.Tensor, toy: torch.Tensor,
                     coeff8: torch.Tensor, ccost: torch.Tensor,
                     pcost: torch.Tensor, *, lam: float, tau: float,
                     max_global_rounds: int = 64,
                     sweeps_per_round: int = 0) -> torch.Tensor:
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
    accept = torch.empty((n, s, s), dtype=torch.bool, device=dev)
    if n == 0:
        return accept
    work = torch.empty((n, WORK_PLANES, s, s), dtype=torch.float32,
                       device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = cuda_build.load(LIBRARY).expansion_accept_launch(
            halo.data_ptr(), props.data_ptr(), tox.data_ptr(),
            toy.data_ptr(), coeff8.data_ptr(), ccost.data_ptr(),
            pcost.data_ptr(), accept.data_ptr(), work.data_ptr(), n, s,
            float(lam), float(tau), int(max_global_rounds),
            int(sweeps_per_round or 16), stream)
    cuda_build.launch_error("expansion_accept", rc)
    expansion_accept.launches += 1
    return accept


#: Number of kernel launches (incremented only where the kernel launches).
expansion_accept.launches = 0


# ------------------------------------------------ min-cut of prebuilt graphs --

def _declare_mincut(lib: ctypes.CDLL) -> None:
    fn = lib.mincut_accept_launch
    fn.argtypes = ([ctypes.c_void_p] * 5
                   + [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int


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
    accept = torch.empty((n, s, s), dtype=torch.bool, device=dev)
    if n == 0:
        return accept
    work = torch.empty((n, MINCUT_WORK_PLANES, s, s), dtype=torch.float32,
                       device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = cuda_build.load(MINCUT_LIBRARY).mincut_accept_launch(
            e.data_ptr(), cap_t.data_ptr(), cap_fw.data_ptr(),
            accept.data_ptr(), work.data_ptr(), n, s,
            int(max_global_rounds), sweeps, stream)
    cuda_build.launch_error("mincut_accept", rc)
    solve_graph.launches += 1
    return accept


#: Number of kernel launches (incremented only where the kernel launches).
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
