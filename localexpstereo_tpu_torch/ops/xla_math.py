"""float32 math as XLA computes it on the CPU, the same on the CPU and on
the card.

The JAX package's proposals round their ``sin``, ``cos``, ``sqrt``, norms
and small products as XLA's CPU backend does. ``torch``'s own functions
round otherwise, and differently on the CPU and on a CUDA card, so on
near-tied moves the card's solve parts from its CPU twin (ROADMAP C8).
Each function here is built from elementwise float64 ``torch`` operations,
one multiply, add or conversion at a time, and rounded once to float32:
the same bits on either device, and XLA's on the CPU (``tests/
test_torch_xla_math.py`` holds them against ``jnp`` on millions of draws).

Eager mode only: nothing here may be compiled or fused, and a multiply and
an add stay two operations (no ``addcmul``, no ``alpha``), or the float64
roundings change.
"""
from __future__ import annotations

import struct

import torch

# glibc's ``__sincosf_table`` (``sysdeps/ieee754/flt-32/sincosf.h`` and
# ``sincosf_data.c``): the second table, for quadrants with n & 2, negates
# C0-C4 and keeps S1-S3. The bytes of HPI_INV are in ``libm.so.6``, followed
# by the rest of the table in the order HPI, C0, C1, S1, C2, S2, C3, S3, C4.
#: 2/pi scaled by 2^24, so that the quadrant lands in bits 24..31.
HPI_INV = float.fromhex("0x1.45f306dc9c883p+23")
#: pi/2, and its leading bits: n * _HPI_HI is exact for |n| < 2^7.
HPI = float.fromhex("0x1.921fb54442d18p+0")
_HPI_HI = float.fromhex("0x1.921fb54442dp+0")
_HPI_LO = HPI - _HPI_HI
#: cos(x) ~ C0 + C1 x^2 + ... + C4 x^8 and sin(x) ~ x + S1 x^3 + S2 x^5
#: + S3 x^7 on |x| <= pi/4.
C0, C1, C2, C3, C4 = (float.fromhex(h) for h in (
    "0x1p+0", "-0x1.ffffffd0c621cp-2", "0x1.55553e1068f19p-5",
    "-0x1.6c087e89a359dp-10", "0x1.99343027bf8c3p-16"))
S1, S2, S3 = (float.fromhex(h) for h in (
    "-0x1.555545995a603p-3", "0x1.1107605230bc4p-7",
    "-0x1.994eb3774cf24p-13"))


def _abstop12(x: torch.Tensor) -> torch.Tensor:
    """The exponent and first mantissa bit of float32 ``x`` (glibc's
    ``abstop12``)."""
    return (x.view(torch.int32) >> 20) & 0x7FF


def _top12(v: float) -> int:
    return int(_abstop12(torch.tensor([v], dtype=torch.float32))[0])


#: |x| below 2^-12: sin x = x, cos x = 1. |x| from 120 on: glibc's slow
#: reduction, which no solver path needs.
_TINY, _LIMIT = _top12(2.0 ** -12), _top12(120.0)


def as_f32(x):
    """A tensor as it is; a Python number rounded to float32 (XLA's
    constant), kept a Python float."""
    if torch.is_tensor(x):
        return x
    return struct.unpack("f", struct.pack("f", x))[0]


def fma(a, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once, as XLA's fused multiply-add: the
    float64 product of two float32 values is exact, the float64 sum is
    rounded to float32 (a double rounding, which no test has met). ``a``
    is a tensor; ``b`` and ``c`` join the float64 operations by type
    promotion, which is exact, unless the float64 operand is zero-dim
    (which would not promote them). Python numbers are float32 constants."""
    b, c = as_f32(b), as_f32(c)
    a = a.to(torch.float64)
    if a.dim() == 0 and torch.is_tensor(b):
        b = b.to(torch.float64)
    prod = a * b
    if prod.dim() == 0 and torch.is_tensor(c):
        c = c.to(torch.float64)
    return (prod + c).to(torch.float32)


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root (``jnp.sqrt``): the float64
    root rounded once, which is exact for float32 arguments. ``torch.sqrt``
    in float32 on the CPU misrounds 0.7 % of draws."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def rsqrt(x: torch.Tensor) -> torch.Tensor:
    """float32 ``1 / sqrt(x)``: the float64 quotient rounded once.

    XLA's CPU ``rsqrt`` is the processor's 12-bit estimate (``vrsqrtps``)
    refined by two Newton steps; the estimate's table is the processor's
    own, so no portable rule equals it. On 2,000,000 draws of 1 + a^2 + b^2
    (a, b uniform in [-3, 3]) this is within 1 ulp of ``lax.rsqrt`` and
    equal on 86.9 %. Rules nearer to it (one Newton step of XLA's form
    after this: 92.5 %) or further (float32 ``1 / sqrt``: 66.2 %) each move
    one of the port's solves off the JAX engine's beyond the trajectory
    tolerance in a parity test (ROADMAP C8)."""
    return (1.0 / torch.sqrt(x.to(torch.float64))).to(torch.float32)


def norm3(v: torch.Tensor) -> torch.Tensor:
    """Euclidean norm over the last axis of size 3, as
    ``jnp.linalg.norm``: ``sqrt(fma(x2, x2, fma(x1, x1, x0 * x0)))``."""
    x0, x1, x2 = v[..., 0], v[..., 1], v[..., 2]
    return sqrt(fma(x2, x2, fma(x1, x1, x0 * x0)))


def matvec3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``einsum("...ij,...j->...i", a, b)`` for 3 x 3 ``a`` as XLA's CPU dot:
    a fused multiply-add chain over j = 0, 1, 2."""
    acc = a[..., 0] * b[..., None, 0]
    for j in (1, 2):
        acc = fma(a[..., j], b[..., None, j], acc)
    return acc


def sincosf(x: torch.Tensor):
    """(sin x, cos x) of float32 ``x``, |x| < 120, as glibc's ``sinf`` and
    ``cosf`` (``sysdeps/ieee754/flt-32/s_sinf.c``, ``s_cosf.c``), which
    ``jnp.sin`` and ``jnp.cos`` call on the CPU.

    ``reduce_fast``: n = ((int32)(x * HPI_INV) + 2^23) >> 24, r = x - n pi/2
    with the product and difference fused, as glibc's FMA build has them
    (r is exact here: n * _HPI_HI and x - n * _HPI_HI are, so the last
    subtraction rounds once). Then glibc's float64 polynomials in r, each
    rounded once to float32, and the quadrant's sign. Below pi/4, n = 0
    and r = x: glibc's unreduced branch. The polynomials' multiply-adds are
    not fused here; that changes a float64 result by an ulp, which rounded
    the same in float32 on every draw measured.

    Raises ValueError for |x| >= 120 or NaN, on every device (on a card the
    check waits for ``x``; the solver calls this on the host only)."""
    top = _abstop12(x)
    if bool((top >= _LIMIT).any()):
        raise ValueError("sincosf: |x| >= 120 or NaN")
    xd = x.to(torch.float64)
    n = ((xd * HPI_INV).to(torch.int32) + 0x800000) >> 24
    nd = n.to(torch.float64)
    r = (xd - nd * _HPI_HI) - nd * _HPI_LO
    r2 = r * r
    r3 = r * r2
    sp = ((r + r3 * S1) + (r3 * r2) * (S2 + r2 * S3)).to(torch.float32)
    r4 = r2 * r2
    cp = (((C0 + r2 * C1) + r4 * C2)
          + (r4 * r2) * (C3 + r2 * C4)).to(torch.float32)
    # sin(r + q pi/2) = sp, cp, -sp, -cp; cos(r + q pi/2) = cp, -sp, -cp, sp
    # for q = n & 3.
    odd = (n & 1).to(torch.bool)
    sin = torch.where(odd, cp, sp)
    cos = torch.where(odd, sp, cp)
    sin = torch.where((n & 2).to(torch.bool), -sin, sin)
    cos = torch.where(((n + 1) & 2).to(torch.bool), -cos, cos)
    tiny = top < _TINY
    sin = torch.where(tiny, x, sin)
    cos = torch.where(tiny, 1.0, cos)
    return sin, cos


def cosf(x: torch.Tensor) -> torch.Tensor:
    """``jnp.cos`` of float32 ``x`` (:func:`sincosf`)."""
    return sincosf(x)[1]
