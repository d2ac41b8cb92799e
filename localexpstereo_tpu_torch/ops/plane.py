"""Plane-label operations on ``[..., 4]`` float32 tensors.

A label is ``(a, b, c, v)`` with disparity ``d(x, y) = a*x + b*y + c`` in
global pixel coordinates and ``v`` an optional vertical-disparity offset
(reference ``Plane.h:4-58``).
"""
from __future__ import annotations

import functools
import math

import torch

from . import rng, threefry_cuda, xla_math


def create_plane(normal: torch.Tensor, z: torch.Tensor, x: torch.Tensor,
                 y: torch.Tensor, v=0.0) -> torch.Tensor:
    """``a = -nx/nz, b = -ny/nz, c = z - a*x - b*y`` (``Plane.h:14-31``);
    ``normal`` is ``[..., 3]``, returns ``[..., 4]``. ``c`` is two fused
    multiply-adds, as XLA contracts it in the JAX package's jitted code."""
    nx, ny, nz = normal[..., 0], normal[..., 1], normal[..., 2]
    a = -nx / nz
    b = -ny / nz
    c = xla_math.fma(-b, y, xla_math.fma(-a, x, z))
    v = torch.as_tensor(v, dtype=a.dtype, device=a.device).expand(a.shape)
    return torch.stack([a, b, c, v], dim=-1)


def get_normal(labels: torch.Tensor) -> torch.Tensor:
    """Unit normal of a plane label (``Plane.h:42-50``); ``nz`` by
    :func:`.xla_math.rsqrt`, the same on either device. ``1 + a^2 + b^2``
    is rounded op by op, as eager JAX has it: the JAX engine's jitted code
    fuses it into two multiply-adds, which moves the port's solves off the
    JAX engine's in a parity test (ROADMAP C8)."""
    a, b = labels[..., 0], labels[..., 1]
    nz = xla_math.rsqrt(1.0 + a * a + b * b)
    return torch.stack([-a * nz, -b * nz, nz], dim=-1)


def disparity_at(labels: torch.Tensor, x, y) -> torch.Tensor:
    """``d = a*x + b*y + c`` (the v channel is excluded)."""
    return labels[..., 0] * x + labels[..., 1] * y + labels[..., 2]


def disparity_map(labeling: torch.Tensor, x0: int = 0,
                  y0: int = 0) -> torch.Tensor:
    """Per-pixel disparity of a ``[H, W, 4]`` labeling whose (0, 0) pixel
    sits at global coordinate ``(x0, y0)``."""
    h, w = labeling.shape[-3], labeling.shape[-2]
    dev = labeling.device
    ys = y0 + torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    xs = x0 + torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    return disparity_at(labeling, xs, ys)


def normal_map(labeling: torch.Tensor) -> torch.Tensor:
    """Visualization map of plane normals (``StereoEnergy.h:274-289``):
    channels ``(nz, (-b*nz+1)/2, (-a*nz+1)/2)``, the reference's BGR debug
    output."""
    a, b = labeling[..., 0], labeling[..., 1]
    nz = xla_math.rsqrt(1.0 + a * a + b * b)
    return torch.stack([nz, (-b * nz + 1.0) / 2.0, (-a * nz + 1.0) / 2.0],
                       dim=-1)


@functools.lru_cache(maxsize=None)
def _cosf(angle: float) -> float:
    """``jnp.cos`` of the float32 ``angle`` (a float32 value)."""
    return float(xla_math.cosf(torch.tensor(angle, dtype=torch.float32)))


def random_unit_vector(key: torch.Tensor, angle_range: float = math.pi,
                       shape: tuple = (), device=None) -> torch.Tensor:
    """Random unit vector within ``angle_range`` of +z (``Utilities.hpp:254-261``):
    theta ~ U(0, 2pi), z ~ U(cos(angle_range), 1), r = sqrt(1 - z^2), with
    1 - z^2 one fused multiply-add, as in the JAX package's jitted code.

    Computed by :mod:`.xla_math` as XLA computes it: on the host, and moved
    to ``device``, or for a CUDA ``device`` on the card in one launch
    (:func:`.threefry_cuda.unit_vector`). The same bits either way."""
    k1, k2 = rng.split(key)
    if rng.on_card(device):
        return threefry_cuda.unit_vector(
            rng.key_words(k1), rng.key_words(k2), shape,
            xla_math.as_f32(2.0 * math.pi), _cosf(angle_range), device)
    theta = rng.uniform(k1, shape, 0.0, 2.0 * math.pi)
    z = rng.uniform(k2, shape, _cosf(angle_range), 1.0)
    r = xla_math.sqrt(torch.clamp(xla_math.fma(-z, z, 1.0), min=0.0))
    sin, cos = xla_math.sincosf(theta)
    out = torch.stack([r * cos, r * sin, z], -1)
    return out if device is None else out.to(device)


def random_label(key: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                 min_disp: float, max_disp: float,
                 max_vdisp: float = 0.0) -> torch.Tensor:
    """Random label at pixels (x, y): z ~ U(min, max), normal within pi/3 of
    the optical axis (``StereoEnergy.h:120-129``)."""
    kz, kn, kv = rng.split(key, 3)
    shape = tuple(x.shape)
    dev = x.device
    z = rng.uniform(kz, shape, min_disp, max_disp, device=dev)
    n = random_unit_vector(kn, math.pi / 3, shape, device=dev)
    if max_vdisp != 0.0:
        v = rng.uniform(kv, shape, -max_vdisp, max_vdisp, device=dev)
    else:
        v = torch.zeros(shape, dtype=torch.float32, device=dev)
    return create_plane(n, z, x.to(torch.float32), y.to(torch.float32), v)
