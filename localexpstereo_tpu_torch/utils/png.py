"""PNG codec on the standard library (``zlib`` + ``struct``) and numpy.

The JAX package decodes its images with OpenCV (``cv2.imread``); the port
reads the same files without it:

- :func:`read_color` returns ``[H, W, 3]`` uint8 **BGR**, as
  ``cv2.IMREAD_COLOR`` does (gray is replicated, alpha is dropped);
- :func:`read_gray` returns ``[H, W]`` uint8, as ``cv2.IMREAD_GRAYSCALE``
  does (color is converted with libpng's integer weights);
- :func:`write` writes ``[H, W]`` gray or ``[H, W, 3]`` BGR uint8 images,
  as ``cv2.imwrite`` does (filter type 0).

Reads non-interlaced 8-bit gray, gray + alpha, RGB and RGBA images with
any of the five filter types; anything else raises ``ValueError``.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
#: Channels of each supported PNG color type.
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}
#: libpng's rgb-to-gray weights (png_set_rgb_to_gray with 0.299 / 0.587,
#: in 1/32768), the conversion OpenCV asks libpng for.
_GRAY_R = 29900 * 32768 // 100000
_GRAY_G = 58700 * 32768 // 100000
_GRAY_B = 32768 - _GRAY_R - _GRAY_G


def _chunks(data: bytes):
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos = 8
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        yield kind, data[pos + 8:pos + 8 + length]
        pos += 12 + length


def _unfilter_row(kind: int, row: np.ndarray, prior: np.ndarray,
                  bpp: int) -> np.ndarray:
    """One scanline of raw bytes -> its unfiltered bytes (PNG spec 9.2)."""
    if kind == 0:
        return row
    if kind == 1:       # Sub: cumulative sum per byte of the pixel, mod 256
        out = row.reshape(-1, bpp).cumsum(0, dtype=np.uint8)
        return out.reshape(-1)
    if kind == 2:       # Up
        return row + prior
    if kind not in (3, 4):
        raise ValueError(f"bad PNG filter type {kind}")
    out = bytearray(row.tobytes())
    up = prior.tobytes()
    for i in range(len(out)):
        left = out[i - bpp] if i >= bpp else 0
        if kind == 3:   # Average
            out[i] = (out[i] + ((left + up[i]) >> 1)) & 0xFF
            continue
        upleft = up[i - bpp] if i >= bpp else 0
        p = left + up[i] - upleft                   # Paeth
        pa, pb, pc = abs(p - left), abs(p - up[i]), abs(p - upleft)
        pred = left if pa <= pb and pa <= pc else (up[i] if pb <= pc
                                                   else upleft)
        out[i] = (out[i] + pred) & 0xFF
    return np.frombuffer(bytes(out), np.uint8)


def read(path: str) -> np.ndarray:
    """Decodes a PNG into ``[H, W, C]`` uint8 in its own channel order
    (gray, gray + alpha, RGB or RGBA)."""
    with open(path, "rb") as f:
        data = f.read()
    header = None
    idat = []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = header
    if depth != 8 or ctype not in _CHANNELS or interlace != 0:
        raise ValueError(f"{path}: only non-interlaced 8-bit gray, gray + "
                         f"alpha, RGB and RGBA PNGs are read (bit depth "
                         f"{depth}, color type {ctype}, interlace "
                         f"{interlace})")
    ch = _CHANNELS[ctype]
    stride = w * ch
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (stride + 1):
        raise ValueError(f"{path}: truncated image data")
    raw = raw.reshape(h, stride + 1)
    img = np.empty((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        prior = _unfilter_row(int(raw[y, 0]), raw[y, 1:], prior, ch)
        img[y] = prior
    return img.reshape(h, w, ch)


def read_color(path: str) -> np.ndarray:
    """``cv2.imread(path, cv2.IMREAD_COLOR)``: [H, W, 3] uint8 BGR."""
    img = read(path)
    if img.shape[2] <= 2:
        return np.repeat(img[..., :1], 3, axis=2)
    return np.ascontiguousarray(img[..., 2::-1])


def read_gray(path: str) -> np.ndarray:
    """``cv2.imread(path, cv2.IMREAD_GRAYSCALE)``: [H, W] uint8."""
    img = read(path)
    if img.shape[2] <= 2:
        return np.ascontiguousarray(img[..., 0])
    rgb = img[..., :3].astype(np.uint32)
    gray = (_GRAY_R * rgb[..., 0] + _GRAY_G * rgb[..., 1]
            + _GRAY_B * rgb[..., 2]) >> 15
    return gray.astype(np.uint8)


def _chunk(kind: bytes, body: bytes) -> bytes:
    crc = zlib.crc32(kind + body) & 0xFFFFFFFF
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", crc)


def write(path: str, image: np.ndarray) -> None:
    """``cv2.imwrite(path, image)`` for [H, W] gray or [H, W, 3] BGR uint8."""
    img = np.asarray(image)
    if img.dtype != np.uint8:
        raise ValueError(f"PNG images are written as uint8, got {img.dtype}")
    if img.ndim == 2:
        ctype, rows = 0, img
    elif img.ndim == 3 and img.shape[2] == 3:
        ctype, rows = 2, img[..., ::-1].reshape(img.shape[0], -1)
    else:
        raise ValueError(f"PNG image must be [H,W] or [H,W,3], got "
                         f"{img.shape}")
    h, w = img.shape[:2]
    scan = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    with open(path, "wb") as f:
        f.write(_SIGNATURE)
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0,
                                            0, 0)))
        f.write(_chunk(b"IDAT", zlib.compress(scan.tobytes(), 6)))
        f.write(_chunk(b"IEND", b""))
