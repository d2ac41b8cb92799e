"""The proposals' random draws made on the card (``csrc/threefry.cu``).

:func:`.rng.uniform` and :func:`.plane.random_unit_vector` launch these for
a CUDA ``device``; for any other device they compute on the host, in the
plain PyTorch versions that these kernels equal bit for bit. A key's two
uint32 words are Python integers (:func:`.rng.key_words`) passed as launch
arguments, so a draw copies nothing to the card and never waits for it.
"""
from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from ..utils.profiling import span
from . import cuda_build


def _declare(lib: ctypes.CDLL) -> None:
    fn = lib.threefry_uniform_launch
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int64] + [ctypes.c_uint32] * 2
                   + [ctypes.c_float] * 2 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    fn = lib.threefry_unit_vector_launch
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int64] + [ctypes.c_uint32] * 4
                   + [ctypes.c_float] * 2 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int


LIBRARY = cuda_build.Library("threefry", ("threefry.cu",), _declare)


def _launch(wrapper, name: str, out: torch.Tensor, n: int, *args) -> None:
    """Launches ``name`` for ``n`` draws into ``out`` on its device's
    current stream, counted on ``wrapper``; nothing for ``n`` = 0."""
    if n == 0:
        return
    with torch.cuda.device(out.device):
        rc = getattr(cuda_build.load(LIBRARY), name)(
            out.data_ptr(), n, *args, torch.cuda.current_stream().cuda_stream)
    cuda_build.launch_error(name, rc)
    wrapper.launches += 1


def uniform(key: Tuple[int, int], shape: Sequence[int], lo: float,
            hi: float, device) -> torch.Tensor:
    """float32 ``rng.uniform(key, shape, lo, hi)`` drawn on the CUDA
    ``device``; ``lo`` and ``hi`` are float32 values."""
    with span("rng"):
        out = torch.empty(tuple(shape), dtype=torch.float32, device=device)
        _launch(uniform, "threefry_uniform_launch", out, out.numel(), *key,
                lo, hi)
        return out


def unit_vector(key_theta: Tuple[int, int], key_z: Tuple[int, int],
                shape: Sequence[int], theta_hi: float, z_lo: float,
                device) -> torch.Tensor:
    """[*shape, 3] ``plane.random_unit_vector`` drawn on the CUDA
    ``device``: theta ~ U(0, theta_hi) under ``key_theta``, z ~ U(z_lo, 1)
    under ``key_z`` (float32 bounds), in one launch."""
    with span("rng"):
        out = torch.empty(tuple(shape) + (3,), dtype=torch.float32,
                          device=device)
        _launch(unit_vector, "threefry_unit_vector_launch", out,
                out.numel() // 3, *key_theta, *key_z, theta_hi, z_lo)
        return out


#: Number of kernel launches, counted where the kernel launches.
uniform.launches = 0
unit_vector.launches = 0
