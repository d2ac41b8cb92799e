"""Counter-based random numbers, bit-exact with ``jax.random``'s threefry2x32.

The JAX package draws every proposal and every initial label from stateless
``jax.random`` keys. This module reproduces the calls it makes —
``PRNGKey``, ``split``, ``fold_in`` and ``uniform``, and the MC-CNN
trainer's ``randint``, ``bernoulli`` and ``normal`` — for the default
``jax_threefry_partitionable=True`` scheme, so the port's inits, proposals
and training batches equal the reference's bit for bit under the same seed
(``normal`` to within rounding: its ``erf_inv`` is XLA's polynomial).

A key is an int64 tensor of shape ``[2]`` holding two uint32 words. The
uint32 arithmetic runs in int64 with ``& 0xFFFFFFFF`` after every add and
shift (torch has no uint32 arithmetic). Keys stay on the CPU, like the host
loop that consumes them; a draw moves to ``device`` only at the end.
There is no global RNG state anywhere in the port.
"""
from __future__ import annotations

import math
from typing import Sequence, Union

import torch

from ..utils.profiling import span
from . import xla_math

_M = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M


def threefry2x32(k1, k2, x1: torch.Tensor, x2: torch.Tensor):
    """The threefry2x32 hash (20 rounds) of counter pairs (x1, x2) under the
    key (k1, k2); all values uint32 held in int64 tensors."""
    with span("rng"):
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
    # XLA fuses the scale and shift into one fused multiply-add.
    scaled = xla_math.fma(floats, hi - lo, lo)
    out = torch.maximum(lo, scaled)
    return out if device is None else out.to(device)


_I32_MIN, _I32_MAX = -2 ** 31, 2 ** 31 - 1


def _mul32(a: torch.Tensor, b: int) -> torch.Tensor:
    """``a * b`` modulo 2**32 for uint32 values, without leaving int64."""
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M


def randint(key: torch.Tensor, shape: Sequence[int], minval: int,
            maxval: int, device=None) -> torch.Tensor:
    """int32 draws in [minval, maxval), bit-exact with
    ``jax.random.randint`` (``_randint``) for int32 bounds: 64 random bits
    from the two halves of a split, reduced modulo the span with the
    multiplier ``(2**16 % span)**2 % span``, every product and sum
    wrapping as uint32. A span of ``maxval <= minval`` is 1, so ``minval``
    comes back."""
    lo, hi = int(minval), int(maxval)
    if not _I32_MIN <= min(lo, hi) <= max(lo, hi) <= _I32_MAX:
        raise ValueError(f"randint: bounds {lo}, {hi} are not int32")
    k1, k2 = split(key)
    higher, lower = random_bits(k1, shape), random_bits(k2, shape)
    span = 1 if hi <= lo else hi - lo
    mult = ((2 ** 16 % span) ** 2 & _M) % span
    offset = ((_mul32(higher % span, mult) + lower % span) & _M) % span
    out = (lo + offset).to(torch.int32)            # in [lo, hi)
    return out if device is None else out.to(device)


def bernoulli(key: torch.Tensor, p: float, shape: Sequence[int],
              device=None) -> torch.Tensor:
    """Boolean draws, ``uniform(key, shape) < p`` in float32 (the default
    mode of ``jax.random.bernoulli``)."""
    out = uniform(key, shape) < torch.tensor(p, dtype=torch.float32)
    return out if device is None else out.to(device)


#: XLA's float32 ``erf_inv`` (M. Giles, "Approximating the erfinv
#: function"): Horner coefficients for w < 5 and w >= 5.
_ERFINV_SMALL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                 -4.39150654e-06, 0.00021858087, -0.00125372503,
                 -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_LARGE = (-0.000200214257, 0.000100950558, 0.00134934322,
                 -0.00367342844, 0.00573950773, -0.0076224613,
                 0.00943887047, 1.00167406, 2.83297682)


def erfinv(x: torch.Tensor) -> torch.Tensor:
    """float32 inverse error function as XLA computes it on the CPU: the
    Giles polynomial in ``w = -log1p(-x^2)``, each Horner step one fused
    multiply-add (:func:`.xla_math.fma`), +-inf at +-1. ``torch.erfinv`` is
    more accurate, and so parts from XLA's by more: in 59 % of ``normal``'s
    draws, by up to 5.8e-6 relative. This parts by an ulp where torch's
    ``log1p`` rounds otherwise."""
    w = -torch.log1p(-(x * x))
    small = w < 5.0
    w = torch.where(small, w - 2.5, xla_math.sqrt(w) - 3.0)

    def coeff(i):
        return torch.where(small, _ERFINV_SMALL[i], _ERFINV_LARGE[i]).to(
            torch.float32)

    p = coeff(0)
    for i in range(1, len(_ERFINV_SMALL)):
        p = xla_math.fma(p, w, coeff(i))
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)


def normal(key: torch.Tensor, shape: Sequence[int],
           device=None) -> torch.Tensor:
    """float32 standard normal draws as ``jax.random.normal``:
    ``sqrt(2) * erf_inv(u)`` with u uniform in (-1, 1)."""
    lo = torch.nextafter(torch.tensor(-1.0), torch.tensor(0.0))
    u = uniform(key, shape, lo, 1.0)
    out = torch.tensor(math.sqrt(2), dtype=torch.float32) * erfinv(u)
    return out if device is None else out.to(device)
