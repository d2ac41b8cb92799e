"""Middlebury calibration / info parsers (reference
``main.cpp:76-144,201-214``; copy of ``localexpstereo_tpu.utils.calib``)."""
from __future__ import annotations

import dataclasses
import os
import re
from typing import Optional


@dataclasses.dataclass
class Calib:
    """Middlebury V3 ``calib.txt`` contents (reference ``main.cpp:76-144``)."""

    cam0: tuple = ()
    cam1: tuple = ()
    doffs: float = 0.0
    baseline: float = 0.0
    width: int = 0
    height: int = 0
    ndisp: int = 0
    isint: int = 0
    vmin: int = 0
    vmax: int = 0
    dyavg: float = 0.0
    dymax: float = 0.0
    gt_prec: float = -1.0  # V2 only (from info.txt)


def parse_calib(path: str) -> Calib:
    """Parses calib.txt. Tolerates missing lines like the reference (fields
    keep their defaults)."""
    calib = Calib()
    if not os.path.exists(path):
        return calib
    with open(path) as f:
        text = f.read()

    def fmat(name):
        m = re.search(rf"{name}\s*=\s*\[([^\]]*)\]", text)
        if not m:
            return ()
        return tuple(float(v) for v in re.split(r"[;\s]+", m.group(1).strip()) if v)

    def fval(name, cast):
        m = re.search(rf"^{name}\s*=\s*([-\d.eE+]+)", text, re.MULTILINE)
        return cast(m.group(1)) if m else None

    calib.cam0 = fmat("cam0")
    calib.cam1 = fmat("cam1")
    for name, cast in [("doffs", float), ("baseline", float), ("width", int),
                       ("height", int), ("ndisp", int), ("isint", int),
                       ("vmin", int), ("vmax", int), ("dyavg", float),
                       ("dymax", float)]:
        v = fval(name, cast)
        if v is not None:
            setattr(calib, name, v)
    return calib


def parse_info(path: str) -> Optional[tuple]:
    """Parses V2 ``info.txt``: two ints — GT intensity scale and ndisp
    (reference ``main.cpp:205-214``). Returns (gt_scale, ndisp) or None."""
    if not os.path.exists(path):
        return None
    with open(path) as f:
        vals = f.read().split()
    if len(vals) < 2:
        return None
    return int(vals[0]), int(vals[1])
