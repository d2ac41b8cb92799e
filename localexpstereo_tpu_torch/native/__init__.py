"""Host-side C++ helpers (the port's copies of the JAX package's
``native/``), loaded with ctypes:

- the threaded ``.acrt`` cost-volume loader (``loader.cpp``): a parallel
  ``pread`` of the headerless float32 [D, H, W] volume fused with the
  out-of-view fill, and the L->R volume recovery with the right view's
  fill (``main.cpp:146-199``), where the reference runs one core;
- the exact min-cut oracle (``maxflow.cpp``): a from-scratch Dinic max
  flow on one grid region's graph, against which the capped push-relabel
  solves (``ops/mincut.py``, the CUDA kernels) are checked.

Each source is built at first use into a library of its own with ``g++
-O2 -shared -fPIC -std=c++17 -lpthread`` into ``build/torch_host/`` at the
checkout root, named by a hash of its source and flags, under a file lock
and published by an atomic rename (as :mod:`..ops.cuda_build` builds the
kernels). A missing ``g++`` or a failed build raises with the compiler's
message: there is no fallback to a numpy codec or solver.
"""
from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import pathlib
import subprocess

import numpy as np
import torch

_DIR = pathlib.Path(__file__).resolve().parent
BUILD_DIR = _DIR.parent.parent / "build" / "torch_host"
#: The loader's source (the default library), and the oracle's.
SOURCE = _DIR / "loader.cpp"
ORACLE_SOURCE = _DIR / "maxflow.cpp"
GXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")


def output(source: pathlib.Path = None) -> pathlib.Path:
    """The path of the library of ``source`` (default :data:`SOURCE`) for
    its current text and the flags."""
    source = SOURCE if source is None else source
    h = hashlib.sha256(source.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"{source.stem}_{h.hexdigest()[:16]}.so"


def build(source: pathlib.Path = None) -> pathlib.Path:
    """Compiles the library of ``source`` (default :data:`SOURCE`) unless
    it is built for the current text; returns its path. Raises
    RuntimeError with the compiler's output if ``g++`` is missing or
    fails."""
    source = SOURCE if source is None else source
    path = output(source)
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if path.exists():
            return path
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = ["g++", *GXX_FLAGS, str(source), "-o", str(tmp), "-lpthread"]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
        except FileNotFoundError as e:
            raise RuntimeError(f"{source.name} needs g++: {e}") from e
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"g++ failed ({proc.returncode}) building "
                               f"{source.name}:\n{proc.stderr}")
        os.replace(tmp, path)
    return path


@functools.lru_cache(maxsize=None)
def get_lib() -> ctypes.CDLL:
    """The loader's library, built first if needed."""
    lib = ctypes.CDLL(str(build()))
    f32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    lib.read_acrt_fill.restype = ctypes.c_int
    lib.read_acrt_fill.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                   ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                   ctypes.c_int, f32]
    lib.convert_l2r_fill.restype = None
    lib.convert_l2r_fill.argtypes = [f32, ctypes.c_int, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_int, f32]
    return lib


def _threads(threads: int) -> int:
    return threads if threads > 0 else (os.cpu_count() or 8)


def read_acrt_fill(path: str, ndisp: int, height: int, width: int,
                   fill_mode: int = -1, threads: int = 0) -> np.ndarray:
    """Reads a headerless [ndisp, H, W] float32 volume with the out-of-view
    fill of ``fill_mode`` (0 left, 1 right, -1 none; margin 0) in the same
    parallel pass: ``utils.acrt.read_acrt`` + ``fill_out_of_view``, on
    ``threads`` threads (default: the CPU count). Raises FileNotFoundError
    for a missing file and OSError for a short one."""
    out = np.empty((ndisp, height, width), np.float32)
    rc = get_lib().read_acrt_fill(os.fsencode(path), ndisp, height, width,
                                  fill_mode, _threads(threads), out)
    if rc == -1:
        raise FileNotFoundError(path)
    if rc != 0:
        raise OSError(f"{path}: short read (expected [{ndisp},{height},"
                      f"{width}] float32)")
    return out


def convert_l2r_fill(vol_l: np.ndarray, threads: int = 0) -> np.ndarray:
    """The right view's volume recovered from the left one with the right
    view's fill (margin 0), threaded: ``utils.acrt.convert_volume_l2r`` +
    ``fill_out_of_view(.., 1)``."""
    d, h, w = vol_l.shape
    vol_l = np.ascontiguousarray(vol_l, np.float32)
    out = np.empty_like(vol_l)
    get_lib().convert_l2r_fill(vol_l, d, h, w, _threads(threads), out)
    return out


@functools.lru_cache(maxsize=None)
def oracle_lib() -> ctypes.CDLL:
    """The min-cut oracle's library, built first if needed."""
    lib = ctypes.CDLL(str(build(ORACLE_SOURCE)))
    f32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    lib.grid_mincut.restype = ctypes.c_double
    lib.grid_mincut.argtypes = [
        ctypes.c_int, f32, f32, f32,
        np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")]
    return lib


def _host_f32(name: str, x, shape) -> np.ndarray:
    """A numpy array or CPU tensor as a C-contiguous float32 array of
    ``shape``; raises for a tensor on another device or another shape."""
    if isinstance(x, torch.Tensor):
        if x.device.type != "cpu":
            raise ValueError(f"grid_mincut_oracle: {name} is on {x.device}; "
                             f"the oracle runs on the host")
        x = x.detach().numpy()
    x = np.ascontiguousarray(x, np.float32)
    if x.shape != shape:
        raise ValueError(f"grid_mincut_oracle: {name} has shape {x.shape}, "
                         f"expected {shape}")
    return x


def grid_mincut_oracle(excess, cap_t, cap_fw):
    """Exact min-cut of one grid region by Dinic's max flow (the test
    oracle of the push-relabel solves).

    Args:
      excess: [S, S] source capacities (after terminal folding).
      cap_t: [S, S] sink capacities.
      cap_fw: [4, S, S] forward-edge capacities in ``ops.mincut.EDGE_DIRS``
        order (reverse capacities 0).
      Each as float32 numpy arrays or CPU tensors
      (``ops.mincut.build_graph``'s outputs for one region).
    Returns:
      (accept [S, S] bool numpy array, the max-flow value): accept is the
      source side, the nodes that cannot reach the sink in the final
      residual graph (free nodes included), as the push-relabel solves
      extract it.
    """
    s = excess.shape[0]
    e = _host_f32("excess", excess, (s, s))
    t = _host_f32("cap_t", cap_t, (s, s))
    fw = _host_f32("cap_fw", cap_fw, (4, s, s))
    accept = np.zeros(s * s, np.uint8)
    flow = oracle_lib().grid_mincut(s, e.reshape(-1), t.reshape(-1),
                                    fw.reshape(-1), accept)
    return accept.reshape(s, s).astype(bool), float(flow)
