"""Builds and loads the package's hand-written CUDA kernel libraries.

Every kernel source under ``csrc/`` is compiled by ``nvcc`` for ``sm_90a``
into a shared library with a plain ``extern "C"`` launcher (no PyTorch
headers, so a build takes seconds) and loaded with ``ctypes``. Libraries go
to ``build/torch_kernels/`` at the checkout root, named by a hash of their
sources and flags, and are built under a file lock at first use.
:func:`build` compiles several libraries at once, one ``nvcc`` process
each, all started together.
"""
from __future__ import annotations

import ctypes
import dataclasses
import fcntl
import functools
import hashlib
import os
import pathlib
import subprocess
import time
from typing import Callable, Dict, Sequence, Tuple

_PKG = pathlib.Path(__file__).resolve().parent.parent
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC")


@dataclasses.dataclass(frozen=True)
class Library:
    """One kernel library: its name, its ``csrc/`` sources, a function
    that declares the ``argtypes``/``restype`` of its launchers on the
    loaded ``ctypes.CDLL``, and the ``csrc/`` headers the sources include
    (hashed with them, not compiled on their own)."""

    name: str
    sources: Tuple[str, ...]
    declare: Callable[[ctypes.CDLL], None]
    headers: Tuple[str, ...] = ()

    def paths(self):
        return [_PKG / "csrc" / s for s in self.sources]

    def output(self) -> pathlib.Path:
        h = hashlib.sha256()
        for src in self.paths() + [_PKG / "csrc" / s for s in self.headers]:
            h.update(src.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        return BUILD_DIR / f"{self.name}_{h.hexdigest()[:16]}.so"


def nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME)")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def build(libs: Sequence[Library], verbose: bool = False
          ) -> Dict[str, Tuple[pathlib.Path, float, bool]]:
    """Compiles every library of ``libs`` that is not built yet for its
    current sources, all ``nvcc`` processes at once. Returns, by name,
    (path, seconds until that library was ready, whether it compiled).
    Raises if any compilation fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    out: Dict[str, Tuple[pathlib.Path, float, bool]] = {}
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        running = []
        for lib in libs:
            path = lib.output()
            if path.exists():
                out[lib.name] = (path, time.perf_counter() - t0, False)
                continue
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc(), *NVCC_FLAGS,
                   *(["-Xptxas", "-v"] if verbose else []),
                   "-o", str(tmp), *map(str, lib.paths())]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            running.append((lib, path, tmp, proc))
        failed = []
        for lib, path, tmp, proc in running:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{lib.name}: nvcc failed ({proc.returncode})"
                              f":\n{log}")
                continue
            if verbose:
                print(f"[{lib.name}]\n{log}", flush=True)
            os.replace(tmp, path)
            out[lib.name] = (path, time.perf_counter() - t0, True)
        if failed:
            raise RuntimeError("\n".join(failed))
    return out


@functools.lru_cache(maxsize=None)
def load(lib: Library) -> ctypes.CDLL:
    """The loaded library, built first if needed."""
    path, _, _ = build([lib])[lib.name]
    cdll = ctypes.CDLL(str(path))
    lib.declare(cdll)
    return cdll


def check(name: str, x, device, dtypes, shape) -> None:
    """Raises unless tensor ``x`` lies on ``device``, contiguous, with a
    dtype in ``dtypes`` and the ``shape`` (a None entry takes any size):
    what a launcher reads through a raw pointer."""
    if x.dtype not in dtypes:
        raise TypeError(f"{name}: expected {dtypes}, got {x.dtype}")
    if x.dim() != len(shape) or any(
            want is not None and got != want
            for got, want in zip(x.shape, shape)):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(x.shape)}")
    if x.device != device:
        raise ValueError(f"{name}: on {x.device}, expected {device}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def launch_error(name: str, rc: int) -> None:
    """Raises if a launcher returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")
