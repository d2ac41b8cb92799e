"""Evaluation / observability hook (reference ``Evaluator.h``; counterpart
of ``localexpstereo_tpu.models.evaluator``).

After every sweep it audits the energy (smoothness recomputed from scratch +
stored unary sum), computes bad-pixel rates against ground truth at the
configured threshold, appends a TSV row ``Time  Eng  Data  Smooth  all
nonocc`` to ``log_output.txt`` (``Evaluator.h:60-65,168-172``), saves
disparity / normal / error debug images through :mod:`..utils.png` (and a
dual run's consistency images, :meth:`Evaluator.save_consistency`), and
keeps the pausable optimization timer excluded from its own run time
(``Evaluator.h:113-116,185-186``). On a CUDA device it synchronizes the card
before stopping the timer, so the solve's queued work counts as solve time.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from ..ops import plane as plane_ops
from ..utils import png
from ..utils.timing import TimeStamper
from . import postprocess


class Evaluator:
    #: Prefix of the debug images, ``result{mode}{D|N|E}{index}.png``.
    HEADER = "result"

    def __init__(self, disp_gt: Optional[np.ndarray],
                 nonocc_mask: Optional[np.ndarray],
                 disparity_factor: float, save_dir: str = "./",
                 show: bool = False):
        self.timer = TimeStamper()
        self.disparity_factor = disparity_factor
        self.save_dir = save_dir
        #: Live progress display (``Evaluator.h:145-160``'s ``cv::imshow``
        #: windows) as two constantly-overwritten files, ``live_D.png`` /
        #: ``live_E.png`` in ``save_dir``, for an auto-refreshing viewer.
        self.show = show
        self.error_threshold = 0.5
        self.qprecision = 1.0 / disparity_factor if disparity_factor else -1.0

        self.disp_gt = (np.asarray(disp_gt, np.float32)
                        if disp_gt is not None else None)
        if self.disp_gt is not None:
            self.valid_mask = (self.disp_gt > 0) & np.isfinite(self.disp_gt)
            self.valid_pixels = int(self.valid_mask.sum())
            self.nonocc = (np.asarray(nonocc_mask, bool)
                           if nonocc_mask is not None
                           else np.ones_like(self.valid_mask))
            self.nonocc_pixels = int(self.nonocc.sum())
        else:
            self.valid_mask = None

        os.makedirs(save_dir, exist_ok=True)
        self._fp = open(os.path.join(save_dir, "log_output.txt"), "w")
        self._fp.write("Time\tEng\tData\tSmooth\tall\tnonocc\n")
        self._fp.flush()

    def __getstate__(self):
        """Picklable (a replica worker evaluates its pairs in its own
        process): the log file travels by name and is reopened to append."""
        state = self.__dict__.copy()
        state["_fp"] = self._fp is not None
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._fp = (open(os.path.join(self.save_dir, "log_output.txt"), "a")
                    if state["_fp"] else None)

    def set_precision(self, precision: float):
        """GT quantization precision; <= 0 disables (``main.cpp:292,381``)."""
        self.qprecision = precision

    def set_error_threshold(self, t: float):
        self.error_threshold = t

    # ------------------------------------------------------------------ --

    def evaluate(self, solver, labeling_m: torch.Tensor,
                 cost_m: torch.Tensor, mode: int, index: int):
        """cf. ``Evaluator::evaluate`` (``Evaluator.h:113-187``)."""
        was_ticking = self.timer.is_ticking()
        # Exclude evaluation from optimization time, but not the solve's
        # queued device work.
        if cost_m.is_cuda:
            torch.cuda.synchronize(cost_m.device)
        self.stop()

        from . import engine as engine_mod
        cfg = solver.cfg
        total, dc, sc = engine_mod.energy_audit(solver.data, cfg, labeling_m,
                                                cost_m, mode)
        total, dc, sc = float(total), float(dc), float(sc)

        p = cfg.pad
        lab = labeling_m[p:p + cfg.height, p:p + cfg.width]
        disp = plane_ops.disparity_map(lab).cpu().numpy()
        if self.qprecision > 0:
            # Reference quantize() uses convertTo(CV_32S) = cvRound =
            # round-half-to-even (Evaluator.h:106-111); np.rint matches.
            disp = np.rint(disp / self.qprecision) * self.qprecision

        all_pct = nonocc_pct = float("nan")
        if self.valid_mask is not None and self.valid_pixels > 0:
            err_ok = np.abs(disp - self.disp_gt) <= self.error_threshold
            all_pct = 100.0 * (1.0 - (err_ok & self.valid_mask).sum()
                               / max(self.valid_pixels, 1))
            nonocc_pct = 100.0 * (1.0 - (err_ok & self.nonocc).sum()
                                  / max(self.nonocc_pixels, 1))
        if self.show and mode == 0:
            self._show_live(disp)
        self._save_images(lab, disp, mode, index)
        if self._fp is not None and mode == 0:
            self._fp.write(f"{self.get_current_time():f}\t{total:f}\t"
                           f"{dc:f}\t{sc:f}\t{all_pct:f}\t{nonocc_pct:f}\n")
            self._fp.flush()

        if mode == 0:
            print(f"{index:2d} {self.get_current_time():5.1f}\t{total:.0f}\t"
                  f"{dc:.0f}\t{sc:.0f}\t{all_pct:4.2f}\t{nonocc_pct:4.2f}",
                  flush=True)

        if was_ticking:
            self.start()

    def _error_image(self, disp):
        err_ok = np.abs(disp - self.disp_gt) <= self.error_threshold
        return np.where(err_ok | (~self.valid_mask), 255, 0)

    def _show_live(self, disp):
        """Headless ``cv::imshow``: overwrite the live preview files
        (atomic rename, so a watching viewer never reads a torn frame)."""
        os.makedirs(self.save_dir, exist_ok=True)
        vis = np.clip(disp * self.disparity_factor, 0, 255).astype(np.uint8)
        frames = {"live_D.png": vis}
        if self.valid_mask is not None:
            frames["live_E.png"] = self._error_image(disp).astype(np.uint8)
        for name, img in frames.items():
            tmp = os.path.join(self.save_dir, "." + name + ".tmp.png")
            png.write(tmp, img)
            os.replace(tmp, os.path.join(self.save_dir, name))

    def _save_images(self, lab, disp, mode, index):
        vis = np.clip(disp * self.disparity_factor, 0, 255).astype(np.uint8)
        png.write(os.path.join(
            self.save_dir, f"{self.HEADER}{mode}D{index:02d}.png"), vis)
        nmap = plane_ops.normal_map(lab).cpu().numpy()
        png.write(os.path.join(
            self.save_dir, f"{self.HEADER}{mode}N{index:02d}.png"),
            np.clip(nmap * 255, 0, 255).astype(np.uint8))
        if self.valid_mask is not None:
            err_vis = self._error_image(disp)
            occ = self.valid_mask & (~self.nonocc)
            err_vis = np.where(occ & (err_vis == 0), 200, err_vis)
            png.write(os.path.join(
                self.save_dir, f"{self.HEADER}{mode}E{index:02d}.png"),
                err_vis.astype(np.uint8))

    def save_consistency(self, solver, state, index: int):
        """The left-right consistency images of a dual run
        (``viewConsistencyCheck``, ``PMStereoBase.h:87-108``; saved after
        each sweep pair, ``FastGCStereo.h:160-168``):
        ``result{mode}C{index}.png``, the view's disparity in gray with
        channel 0 (blue) at 255 where the lookup left the image (fail 128)
        and channel 2 (red) at 255 where the views disagree (fail 255), at
        the post-process's threshold 1.5. Outside the optimization time."""
        was_ticking = self.timer.is_ticking()
        if state[0][1].is_cuda:
            torch.cuda.synchronize(state[0][1].device)
        self.stop()
        cfg = solver.cfg
        p = cfg.pad
        disps = [plane_ops.disparity_map(
            state[mode][0][p:p + cfg.height, p:p + cfg.width])
            for mode in (0, 1)]
        fails = postprocess.consistency_check(disps[0], disps[1], 1.5)
        for mode, (disp, fail) in enumerate(zip(disps, fails)):
            vis = np.clip(disp.cpu().numpy() * self.disparity_factor, 0,
                          255).astype(np.uint8)
            img = np.stack([vis] * 3, -1)
            f = fail.cpu().numpy()
            img[f == 128, 0] = 255
            img[f == 255, 2] = 255
            png.write(os.path.join(
                self.save_dir, f"{self.HEADER}{mode}C{index:02d}.png"), img)
        if was_ticking:
            self.start()

    # ------------------------------------------------------------- timer --

    def start(self):
        self.timer.start()

    def stop(self):
        self.timer.stop()

    def get_current_time(self) -> float:
        return self.timer.get_current_time()

    def close(self):
        if self._fp is not None:
            self._fp.close()
            self._fp = None
