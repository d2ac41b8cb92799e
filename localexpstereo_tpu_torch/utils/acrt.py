"""MC-CNN ``.acrt`` cost-volume codec and volume pre-processing (copy of
``localexpstereo_tpu.utils.acrt``).

``.acrt`` is a headerless row-major ``float32[ndisp][H][W]`` blob where
``vol[d, y, x]`` is the cost of matching im0(x, y) with im1(x - d, y)
(reference ``main.cpp:353-358``, ``README.md:85-91``). The reference loads it
via ``loadMatBinary(..., readHeader=false)`` (``Utilities.hpp:140-201``).

Also implements the out-of-view fill and the L->R volume recovery
(``main.cpp:146-199``).
"""
from __future__ import annotations

import numpy as np


def read_acrt(path: str, ndisp: int, height: int, width: int) -> np.ndarray:
    """Reads a headerless [ndisp, H, W] float32 volume."""
    vol = np.fromfile(path, dtype="<f4")
    expected = ndisp * height * width
    if vol.size != expected:
        raise ValueError(
            f"{path}: expected {expected} floats ([{ndisp},{height},{width}]), "
            f"got {vol.size}")
    return vol.reshape(ndisp, height, width)


def write_acrt(path: str, vol: np.ndarray) -> None:
    np.ascontiguousarray(vol, dtype="<f4").tofile(path)


def fill_out_of_view(vol: np.ndarray, mode: int, margin: int = 0) -> np.ndarray:
    """Replicates the first valid x into out-of-view entries.

    mode 0 (left volume): ``vol[d, y, x] = vol[d, y, d + margin]`` for
    ``x < d + margin`` (``main.cpp:152-163``). mode 1 (right volume): the last
    ``d + margin`` columns are set to ``vol[d, y, W - d - margin - 1]``
    (``main.cpp:164-175``).
    """
    vol = vol.copy()
    D, H, W = vol.shape
    for d in range(D):
        k = min(d + margin, W)
        if k <= 0:
            continue
        if mode == 0:
            src = vol[d, :, k] if k < W else vol[d, :, W - 1]
            vol[d, :, :k] = src[:, None]
        else:
            src = vol[d, :, W - k - 1] if W - k - 1 >= 0 else vol[d, :, 0]
            vol[d, :, W - k:] = src[:, None]
    return vol


def convert_volume_l2r(vol_l: np.ndarray, margin: int = 0) -> np.ndarray:
    """Recovers the right-view volume: ``volR[d, y, x] = volL[d, y, x + d]``
    with edge replication (``main.cpp:178-199``)."""
    D, H, W = vol_l.shape
    vol_r = vol_l.copy()
    for d in range(D):
        if d < W:
            vol_r[d, :, :W - d] = vol_l[d, :, d:]
        edge1 = vol_l[d, :, W - 1 - margin]
        x0 = max(W - 1 - d - margin, 0)
        vol_r[d, :, x0:] = edge1[:, None]
        if margin > 0:
            edge0 = vol_l[d, :, min(d + margin, W - 1)]
            vol_r[d, :, :margin] = edge0[:, None]
    return vol_r
