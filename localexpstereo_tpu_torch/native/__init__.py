"""The threaded ``.acrt`` cost-volume loader (``loader.cpp``; the port's
copy of the JAX package's), loaded with ctypes.

It fuses a parallel ``pread`` of the headerless float32 [D, H, W] volume
with the out-of-view fill, and the L->R volume recovery with the right
view's fill (``main.cpp:146-199``), where the reference runs one core.

The library is built at first use with ``g++ -O2 -shared -fPIC -std=c++17
-lpthread`` into ``build/torch_host/`` at the checkout root, named by a
hash of its source and flags, under a file lock and published by an
atomic rename (as :mod:`..ops.cuda_build` builds the kernels). A missing
``g++`` or a failed build raises with the compiler's message: there is no
fallback to the numpy codec.
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

_DIR = pathlib.Path(__file__).resolve().parent
BUILD_DIR = _DIR.parent.parent / "build" / "torch_host"
SOURCE = _DIR / "loader.cpp"
GXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")


def output() -> pathlib.Path:
    """The library's path for the current source and flags."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"loader_{h.hexdigest()[:16]}.so"


def build() -> pathlib.Path:
    """Compiles the library unless it is built for the current source;
    returns its path. Raises RuntimeError with the compiler's output if
    ``g++`` is missing or fails."""
    path = output()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if path.exists():
            return path
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = ["g++", *GXX_FLAGS, str(SOURCE), "-o", str(tmp), "-lpthread"]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
        except FileNotFoundError as e:
            raise RuntimeError(f"the .acrt loader needs g++: {e}") from e
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"g++ failed ({proc.returncode}) building "
                               f"{SOURCE.name}:\n{proc.stderr}")
        os.replace(tmp, path)
    return path


@functools.lru_cache(maxsize=None)
def get_lib() -> ctypes.CDLL:
    """The loaded library, built first if needed."""
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
