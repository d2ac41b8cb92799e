"""Multi-scale region grid with 16-color disjoint scheduling
(reference ``LayerManager.h``; counterpart of ``localexpstereo_tpu.models.grid``).

Every layer has fixed window sizes: unit ``s``, shared (move) window ``3s``
and filter window ``3s + 2R``. Cells are ``ceil(W/s) x ceil(H/s)``; the
regions of one color ``(i % 4, j % 4)`` form a regular grid at stride 4s
whose 3s windows are separated by s, so a color updates one dense canvas.
Unit sizes are taken as given (no tile-driven rounding).
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class Layer:
    """Static geometry of one expansion layer."""

    unit_size: int               # s
    width_blocks: int            # ceil(W / s)
    height_blocks: int           # ceil(H / s)
    nbx: int                     # max cells of one color along x
    nby: int                     # max cells of one color along y

    @property
    def num_regions(self) -> int:
        return self.nbx * self.nby

    @property
    def colors(self) -> List[Tuple[int, int]]:
        """(i0, j0) color offsets holding at least one cell, in the
        reference's order j = (i%4)*4 + (j%4)."""
        return [(i0, j0) for i0 in range(min(4, self.height_blocks))
                for j0 in range(min(4, self.width_blocks))]

    def color_regions(self, i0: int, j0: int):
        """Unit origins ``ox, oy`` ([N] int32) of color (i0, j0) padded to
        ``num_regions``, and the [N] bool mask of slots inside the image."""
        s = self.unit_size
        jj = j0 + 4 * np.arange(self.nbx)
        ii = i0 + 4 * np.arange(self.nby)
        ox = (jj[None, :] * s).repeat(self.nby, 0)
        oy = (ii[:, None] * s).repeat(self.nbx, 1)
        mask = ((jj[None, :] < self.width_blocks)
                & (ii[:, None] < self.height_blocks))
        return (ox.reshape(-1).astype(np.int32),
                oy.reshape(-1).astype(np.int32), mask.reshape(-1))

    def canvas_origin(self, i0: int, j0: int):
        """Unpadded coords (x, y) of the color's update-canvas top-left."""
        s = self.unit_size
        return (j0 - 1) * s, (i0 - 1) * s


def build_layer(width: int, height: int, unit_size: int) -> Layer:
    s = int(unit_size)
    if s < 1:
        raise ValueError(f"unit size must be >= 1, got {unit_size}")
    wb = -(-width // s)
    hb = -(-height // s)
    return Layer(unit_size=s, width_blocks=wb, height_blocks=hb,
                 nbx=-(-wb // 4), nby=-(-hb // 4))


def build_layers(width: int, height: int, unit_sizes) -> List[Layer]:
    return [build_layer(width, height, s) for s in unit_sizes]


def required_volume_padding(width: int, height: int, unit_sizes,
                            guided_radius: int) -> int:
    """Spatial zero padding of the cost volume so every color's filter
    windows lie inside it: they reach ``-s - r`` top-left and
    ``4s * nb + s + r`` bottom-right in image coordinates."""
    r = guided_radius
    vp = 0
    for s in unit_sizes:
        ly = build_layer(width, height, int(s))
        vp = max(vp, s + r,
                 4 * s * ly.nby + s + r - height,
                 4 * s * ly.nbx + s + r - width)
    return int(vp)


def required_padding(unit_sizes, window_radius: int) -> int:
    """Margin of the padded state/statistics arrays: the largest layer's
    update canvas reaches ~6s past the image, filter windows s + R + 1."""
    s_max = max(unit_sizes)
    return max(6 * s_max, 2 * s_max + window_radius + 2)
