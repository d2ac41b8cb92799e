"""PFM codec, bit-compatible with the reference writer/reader (copy of
``localexpstereo_tpu.utils.pfm``).

Contract (reference ``Utilities.hpp:84-137``): header ``Pf\\n{w} {h}\\n{scale}\\n``
with scale ``-1/255`` printed as ``%lf`` (six decimals, ``-0.003922``); rows
stored bottom-up; float32 little-endian payload. The reader handles ``Pf``/
``PF``, positive-scale big-endian files, and bottom-up row order
(``Utilities.hpp:21-82``).
"""
from __future__ import annotations

import numpy as np

_WRITE_SCALE_STR = "%f" % (-1.0 / 255.0)  # "-0.003922", matches C's %lf


def read_pfm(path: str) -> np.ndarray:
    """Reads a PFM file into a float32 array [H, W] or [H, W, 3] (top-down)."""
    with open(path, "rb") as f:
        data = f.read()

    # Header: three whitespace-separated tokens.
    tokens = []
    pos = 0
    while len(tokens) < 4 and pos < len(data):
        end = pos
        while end < len(data) and not data[end:end + 1].isspace():
            end += 1
        if end > pos:
            tokens.append(data[pos:end].decode("ascii"))
        pos = end + 1

    magic = tokens[0]
    if magic == "Pf":
        channels = 1
    elif magic == "PF":
        channels = 3
    else:
        raise ValueError(f"{path}: not a 1/3 channel PFM file (magic {magic!r})")
    w, h = int(tokens[1]), int(tokens[2])
    scale = float(tokens[3])
    little_endian = scale < 0.0

    count = w * h * channels
    # Like the reference (Utilities.hpp:57), read the payload from the end of
    # the file: robust to header/payload separator ambiguity.
    payload = data[len(data) - count * 4:]
    dt = np.dtype("<f4") if little_endian else np.dtype(">f4")
    arr = np.frombuffer(payload, dtype=dt, count=count).astype(np.float32)
    if channels == 1:
        arr = arr.reshape(h, w)
    else:
        arr = arr.reshape(h, w, 3)
    return arr[::-1].copy()  # bottom-up -> top-down


def write_pfm(path: str, image: np.ndarray) -> None:
    """Writes float32 PFM with the reference's exact header and row order."""
    image = np.asarray(image, dtype=np.float32)
    if image.ndim == 2:
        magic = "Pf"
    elif image.ndim == 3 and image.shape[2] == 3:
        magic = "PF"
    else:
        raise ValueError(f"PFM image must be [H,W] or [H,W,3], got {image.shape}")
    h, w = image.shape[:2]
    with open(path, "wb") as f:
        f.write(f"{magic}\n{w} {h}\n{_WRITE_SCALE_STR}\n".encode("ascii"))
        f.write(np.ascontiguousarray(image[::-1], dtype="<f4").tobytes())
