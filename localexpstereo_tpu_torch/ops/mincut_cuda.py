"""The fused expansion move: pairwise tables, boundary t-links, graph build,
push-relabel min-cut and the exact energy guard, per region.

Counterpart of ``localexpstereo_tpu.ops.mincut_pallas.expansion_accept_pallas``
(both its [b, S, S] and region-on-lanes layouts). :func:`expansion_accept`
is the one routing point of the graph-cut sweep:

- on a CUDA tensor it launches the hand-written kernel of
  ``csrc/expansion_accept.cu``, built by ``nvcc`` for ``sm_90a`` from the
  package's sources at first use, or raises;
- on a CPU tensor it runs :func:`expansion_accept_reference`, the same
  semantics in plain PyTorch.

The build goes to ``build/torch_kernels/`` at the checkout root, keyed by a
hash of the sources and flags, under a file lock. The library exposes a
plain ``extern "C"`` launcher that is loaded with ``ctypes`` (no PyTorch
headers, so a build takes seconds).
"""
from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import pathlib
import subprocess
import time

import torch

from . import mincut, pairwise

_PKG = pathlib.Path(__file__).resolve().parent.parent
_SOURCES = (_PKG / "csrc" / "expansion_accept.cu",)
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC")
#: float32 planes of the kernel's per-region workspace (see the .cu file).
WORK_PLANES = 29


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

def _source_key() -> str:
    h = hashlib.sha256()
    for src in _SOURCES:
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME)")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def build(verbose: bool = False):
    """Compiles the kernel library if it is not built yet for the current
    sources. Returns (path, seconds spent compiling, whether it compiled)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = BUILD_DIR / f"expansion_accept_{_source_key()}.so"
    t0 = time.perf_counter()
    compiled = False
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not out.exists():
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose
                                           else []),
                   "-o", str(tmp), *map(str, _SOURCES)]
            res = subprocess.run(cmd, capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                                   f"{res.stdout}\n{res.stderr}")
            if verbose:
                print(res.stdout + res.stderr, flush=True)
            os.replace(tmp, out)
            compiled = True
    return out, time.perf_counter() - t0, compiled


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    path, _, _ = build()
    lib = ctypes.CDLL(str(path))
    fn = lib.expansion_accept_launch
    fn.argtypes = ([ctypes.c_void_p] * 9
                   + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                      ctypes.c_float, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def _check(name, x, shape, device):
    if x.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(x.shape)}")
    if x.device != device:
        raise ValueError(f"{name}: on {x.device}, expected {device}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


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
        rc = _library().expansion_accept_launch(
            halo.data_ptr(), props.data_ptr(), tox.data_ptr(),
            toy.data_ptr(), coeff8.data_ptr(), ccost.data_ptr(),
            pcost.data_ptr(), accept.data_ptr(), work.data_ptr(), n, s,
            float(lam), float(tau), int(max_global_rounds),
            int(sweeps_per_round or 16), stream)
    if rc != 0:
        raise RuntimeError(f"expansion_accept kernel launch failed: "
                           f"cudaError {rc}")
    expansion_accept.launches += 1
    return accept


#: Number of kernel launches (incremented only where the kernel launches).
expansion_accept.launches = 0
