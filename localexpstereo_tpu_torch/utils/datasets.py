"""Dataset loading (reference ``main.cpp:201-268``; copy of
``localexpstereo_tpu.utils.datasets`` that decodes PNGs with
:mod:`.png` instead of OpenCV).

Resolves ndisp from ``info.txt`` (V2) or ``calib.txt`` (V3) with a CLI
override; loads the image pair from ``imL/imR.png`` else ``im0/im1.png``;
ground truth from ``groundtruth.png`` (scaled, 0 -> +inf) else
``disp0GT.pfm``; the non-occlusion mask from ``nonocc.png`` /
``mask0nocc.png`` (== 255), defaulting to all-valid.

Images are returned as float32 **BGR** in 0..255, matching the reference's
``cv::imread`` + ``convertTo`` pipeline (``StereoEnergy.h:90-97``) so that
grayscale/weight math is bit-comparable; :mod:`.png` decodes as
``cv2.IMREAD_COLOR`` / ``cv2.IMREAD_GRAYSCALE`` do.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np

from . import calib as calib_mod
from . import pfm, png


def _imread_color(path: str) -> Optional[np.ndarray]:
    return png.read_color(path) if os.path.exists(path) else None


def _imread_gray(path: str) -> Optional[np.ndarray]:
    return png.read_gray(path) if os.path.exists(path) else None


@dataclasses.dataclass
class StereoPair:
    im0: np.ndarray           # [H, W, 3] float32 BGR 0..255
    im1: np.ndarray
    disp_gt: np.ndarray       # [H, W] float32; +inf where unknown
    nonocc: np.ndarray        # [H, W] bool
    calib: calib_mod.Calib

    @property
    def ndisp(self) -> int:
        return self.calib.ndisp

    @property
    def max_disparity(self) -> float:
        return float(self.calib.ndisp - 1)


def load_data(input_dir: str, ndisp_override: int = 0) -> StereoPair:
    input_dir = input_dir.rstrip("/") + "/"
    info = calib_mod.parse_info(input_dir + "info.txt")
    if info is not None:
        gt_scale, ndisp = info
        calib = calib_mod.Calib()
        calib.gt_prec = 1.0 / gt_scale
        calib.ndisp = ndisp_override if ndisp_override > 0 else ndisp
    else:
        calib = calib_mod.parse_calib(input_dir + "calib.txt")
        if ndisp_override > 0:
            calib.ndisp = ndisp_override
    if calib.ndisp <= 0:
        raise ValueError(f"ndisp is not specified for {input_dir}")

    im0 = _imread_color(input_dir + "imL.png")
    im1 = _imread_color(input_dir + "imR.png")
    if im0 is None or im1 is None:
        im0 = _imread_color(input_dir + "im0.png")
        im1 = _imread_color(input_dir + "im1.png")
    if im0 is None or im1 is None:
        raise FileNotFoundError(
            f"image pairs (imL/imR.png or im0/im1.png) not found in {input_dir}")
    im0 = im0.astype(np.float32)
    im1 = im1.astype(np.float32)

    gt8 = _imread_gray(input_dir + "groundtruth.png")
    if gt8 is not None:
        disp_gt = gt8.astype(np.float32)
        if calib.gt_prec > 0:
            disp_gt = disp_gt * calib.gt_prec
        disp_gt[gt8 == 0] = np.inf
    elif os.path.exists(input_dir + "disp0GT.pfm"):
        disp_gt = pfm.read_pfm(input_dir + "disp0GT.pfm")
    else:
        disp_gt = np.zeros(im0.shape[:2], np.float32)

    nonocc8 = _imread_gray(input_dir + "nonocc.png")
    if nonocc8 is None:
        nonocc8 = _imread_gray(input_dir + "mask0nocc.png")
    if nonocc8 is not None:
        nonocc = nonocc8 == 255
    else:
        nonocc = np.ones(im0.shape[:2], bool)

    return StereoPair(im0=im0, im1=im1, disp_gt=disp_gt, nonocc=nonocc,
                      calib=calib)
