"""Counter-based random numbers, bit-exact with ``jax.random``'s threefry2x32.

The JAX package draws every proposal and every initial label from stateless
``jax.random`` keys. This module reproduces the four calls it makes —
``PRNGKey``, ``split``, ``fold_in`` and ``uniform`` — for the default
``jax_threefry_partitionable=True`` scheme, so the port's inits and
proposals equal the reference's bit for bit under the same seed.

A key is an int64 tensor of shape ``[2]`` holding two uint32 words. The
uint32 arithmetic runs in int64 with ``& 0xFFFFFFFF`` after every add and
shift (torch has no uint32 arithmetic). Keys stay on the CPU, like the host
loop that consumes them; :func:`uniform` moves its result to ``device``.
There is no global RNG state anywhere in the port.
"""
from __future__ import annotations

import math
from typing import Sequence, Union

import torch

_M = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M


def threefry2x32(k1, k2, x1: torch.Tensor, x2: torch.Tensor):
    """The threefry2x32 hash (20 rounds) of counter pairs (x1, x2) under the
    key (k1, k2); all values uint32 held in int64 tensors."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x0 = (x1 + ks[0]) & _M
    x1 = (x2 + ks[1]) & _M
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _M
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M
    return x0, x1


def PRNGKey(seed: int) -> torch.Tensor:  # noqa: N802 - mirrors jax.random
    """Key from a non-negative integer seed (``threefry_seed``)."""
    seed = int(seed)
    return torch.tensor([(seed >> 32) & _M, seed & _M], dtype=torch.int64)


def _counters(n: int):
    i = torch.arange(n, dtype=torch.int64)
    return i >> 32, i & _M


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """[num, 2] child keys (the partitionable, fold-like split)."""
    hi, lo = _counters(num)
    b1, b2 = threefry2x32(key[0], key[1], hi, lo)
    return torch.stack([b1, b2], dim=-1)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """Key mixed with the integer ``data`` (hash of the counter (0, data))."""
    d = int(data) & _M
    b1, b2 = threefry2x32(key[0], key[1], torch.zeros(1, dtype=torch.int64),
                          torch.tensor([d], dtype=torch.int64))
    return torch.cat([b1, b2])


def random_bits(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """uint32 random bits (in int64) of ``shape``."""
    shape = tuple(int(s) for s in shape)
    hi, lo = _counters(math.prod(shape))
    b1, b2 = threefry2x32(key[0], key[1], hi, lo)
    return (b1 ^ b2).reshape(shape)


Scalar = Union[float, torch.Tensor]


def uniform(key: torch.Tensor, shape: Sequence[int], minval: Scalar = 0.0,
            maxval: Scalar = 1.0, device=None) -> torch.Tensor:
    """float32 uniform draws in [minval, maxval), bit-exact with
    ``jax.random.uniform``: 23 random mantissa bits give a float in [1, 2),
    minus 1, scaled, then clamped below at ``minval``."""
    bits = random_bits(key, shape)
    fbits = ((bits >> 9) | 0x3F800000).to(torch.int32)
    floats = fbits.view(torch.float32) - 1.0
    lo = torch.as_tensor(minval, dtype=torch.float32)
    hi = torch.as_tensor(maxval, dtype=torch.float32)
    # XLA fuses the scale and shift into one fused multiply-add. The float64
    # product is exact, so the float64 sum cast to float32 matches it (bar
    # a double rounding, which the tests have not met).
    scaled = (floats.double() * (hi - lo).double() + lo.double()).float()
    out = torch.maximum(lo, scaled)
    return out if device is None else out.to(device)
