"""Cold frames, back to back (closed loop): each frame hands one pair's
images and float cost volume, held on the card, to a solver built as the
command line's MiddV3 mode builds it (``cli.main.parse_args`` and
``_make_solver``, the configuration's flags, the inputs in memory), runs
its schedule (the energy build, the random init, the greedy and the
graph-cut sweeps of one view) and copies the disparity map to the host.

Traffic keys: ``pairs`` (how many pairs the frames cycle over, each drawn
from the seed and the pair's index); ``moves_checked``: the expansion
moves a frame keeps for the check, on average (``common.MoveCapture``).
"""
from __future__ import annotations

import importlib
import math
import time

import torch

from .. import check
from ..reference import energy as ref
from .common import Evaluator, Samples, install_capture, remove_capture


class Client:
    kind = "cold"

    def __init__(self, config: dict, traffic: dict, seed: int, device: str,
                 trace: bool):
        from localexpstereo_tpu_torch.cli import main as cli
        self.cli = cli
        self.config = config
        self.traffic = traffic
        self.seed = seed
        self.device = torch.device(device)
        self.opt = cli.parse_args(list(config["argv"]) + ["-device", device])
        self.scene = importlib.import_module(
            f"benchmark.scenes.{config['scene']}")
        self.pairs = []
        self.frames = []
        self._refs = {}

    def setup(self) -> None:
        from localexpstereo_tpu_torch.utils import calib, datasets
        cfg = self.config
        layers = self.cli.v3_layers(cfg["width"])
        if layers != list(cfg["unit_sizes"]):
            raise RuntimeError(f"the command line sizes the layers {layers}, "
                               f"the configuration {cfg['unit_sizes']}")
        self.layers = layers
        cal = calib.Calib(ndisp=cfg["ndisp"])
        for i in range(self.traffic["pairs"]):
            sc = self.scene.make(cfg, self.seed, i)
            im = torch.as_tensor(sc["im0"], device=self.device)
            vol = torch.as_tensor(sc["vol"], device=self.device)
            self.pairs.append({
                "pair": datasets.StereoPair(im0=im, im1=im, disp_gt=None,
                                            nonocc=None, calib=cal),
                "vol": vol, "labels": sc["labels"]})
        self.samples = Samples(cfg, self.seed, self.device)
        self.capture = install_capture(cfg, self.kind, self.seed,
                                       self.traffic["moves_checked"])
        # The command line's warm-up: one sweep of each kind on a solver of
        # the first pair, through the same evaluator.
        solver = self._solver(self.pairs[0])
        solver.set_evaluator(Evaluator(self.samples, math.inf, False,
                                       self.pairs[0]["vol"]))
        solver.run(1, view_modes=(0,), pm_iterations=1)
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def _solver(self, pair):
        return self.cli._make_solver(pair["pair"], self.opt, self.layers,
                                     (pair["vol"], pair["vol"]))

    def frame(self, k: int, deadline: float, sync: bool) -> dict:
        """Frame ``k``; raises ``WindowClosed`` once ``deadline`` passes."""
        from localexpstereo_tpu_torch.ops import plane
        pair = self.pairs[k % len(self.pairs)]
        opt = self.opt
        start = time.perf_counter()
        solver = self._solver(pair)
        ev = Evaluator(self.samples, deadline, sync, pair["vol"])
        solver.set_evaluator(ev)
        self.capture.begin(k)
        labeling, _ = solver.run(opt.iterations, view_modes=(0,),
                                 pm_iterations=opt.pm_iterations)
        disp = plane.disparity_map(labeling).cpu().numpy()
        end = time.perf_counter()
        rec = {"k": k, "pair": k % len(self.pairs), "start": start,
               "end": end, "marks": ev.marks, "kept": ev.kept,
               "moves": self.capture.end(),
               "labeling": labeling.clone(), "disp": disp}
        return rec

    def keep(self, rec: dict) -> None:
        """A frame completed inside the window: every one is checked."""
        self.frames.append(rec)

    def release(self) -> None:
        """Nothing of the program's state outlives a frame; the engine gets
        its module back."""
        remove_capture(self.capture)

    def check(self, control: bool = False):
        """Per completed frame, the numbers of :mod:`..check`."""
        rows = []
        for rec in self.frames:
            pair = self.pairs[rec["pair"]]
            pr = self.pair_reference(rec)
            kept = rec["kept"]
            if not check.complete(kept, rec["disp"]):
                rows.append(check.missing())
                continue
            row = check.build_numbers(kept, self.samples, pr,
                                      self.samples.volume_points(pair["vol"]),
                                      control)
            row["unary_gap"] = check.unary_number(kept, self.samples, pr,
                                                  control)
            row["map_gap"] = check.map_number(rec["labeling"], rec["disp"],
                                              control)
            row["cut_gap"] = check.cut_number(rec["moves"], pr, control)
            row["energy_ratio"] = None if control else self.ratio(rec)
            rows.append(row)
        return rows

    def ratio(self, rec: dict) -> float:
        """The reference's ``energy_ratio`` of a frame's final labeling."""
        pr, codes, scale, e_truth = self.reference(rec["pair"])
        return check.energy_ratio(rec["labeling"], e_truth, pr, codes, scale)

    def pair_reference(self, rec: dict) -> check.PairReference:
        return self.reference(rec["pair"])[0]

    def reference(self, i: int):
        """The reference's build of pair ``i``: (PairReference, the
        quantized volume and its scale, the planted truth's energy)."""
        if i not in self._refs:
            p = ref.params_of(self.config)
            pair = self.pairs[i]
            pr = check.PairReference(pair["pair"].im0, p)
            codes, scale = ref.quantize(pair["vol"], p.th_col)
            self._refs[i] = (pr, codes, scale,
                             pr.truth_energy(pair["labels"], codes, scale))
        return self._refs[i]
