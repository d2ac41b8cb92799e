"""Plane-label operations on ``[..., 4]`` float32 tensors.

A label is ``(a, b, c, v)`` with disparity ``d(x, y) = a*x + b*y + c`` in
global pixel coordinates and ``v`` an optional vertical-disparity offset
(reference ``Plane.h:4-58``).
"""
from __future__ import annotations

import math

import torch

from . import rng


def create_plane(normal: torch.Tensor, z: torch.Tensor, x: torch.Tensor,
                 y: torch.Tensor, v=0.0) -> torch.Tensor:
    """``a = -nx/nz, b = -ny/nz, c = z - a*x - b*y`` (``Plane.h:14-31``);
    ``normal`` is ``[..., 3]``, returns ``[..., 4]``."""
    nx, ny, nz = normal[..., 0], normal[..., 1], normal[..., 2]
    a = -nx / nz
    b = -ny / nz
    c = z - a * x - b * y
    v = torch.as_tensor(v, dtype=a.dtype, device=a.device).expand(a.shape)
    return torch.stack([a, b, c, v], dim=-1)


def get_normal(labels: torch.Tensor) -> torch.Tensor:
    """Unit normal of a plane label (``Plane.h:42-50``)."""
    a, b = labels[..., 0], labels[..., 1]
    nz = torch.rsqrt(1.0 + a * a + b * b)
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


def _f32(x: float) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def random_unit_vector(key: torch.Tensor, angle_range: float = math.pi,
                       shape: tuple = (), device=None) -> torch.Tensor:
    """Random unit vector within ``angle_range`` of +z (``Utilities.hpp:254-261``):
    theta ~ U(0, 2pi), z ~ U(cos(angle_range), 1), r = sqrt(1 - z^2)."""
    k1, k2 = rng.split(key)
    theta = rng.uniform(k1, shape, 0.0, 2.0 * math.pi, device=device)
    zmin = torch.cos(_f32(angle_range))
    z = rng.uniform(k2, shape, zmin, 1.0, device=device)
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    return torch.stack([r * torch.cos(theta), r * torch.sin(theta), z], -1)


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
