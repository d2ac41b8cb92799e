"""A camera stream's warm frames, back to back (closed loop): each frame
computes the MC-CNN cost volume of the frame's grayscale pair on the card
(``models.mccnn.cost_volume``, the configuration's widths, weights drawn
from the seed) and hands it with the colour images to
``serving.StereoStream`` (pipelined, the static uint8 range), which builds
the frame's energy, warm-starts from the last labeling ("cell") and runs
its warm schedule. Set-up gives the stream its cold frame and one warm
frame.

Traffic keys: ``pan_positions`` and ``pan_step``: the frames are cut from
one wide scene drawn from the seed, ``pan_step`` px apart, the pan running
back and forth over ``pan_positions`` positions; ``checked``: how many of
the window's frames the check re-computes, drawn from the seed;
``moves_checked``: the expansion moves a frame keeps for the check, on
average (``common.MoveCapture``).
"""
from __future__ import annotations

import importlib
import math
import time

import torch

from .. import check, window
from ..reference import energy as ref
from ..reference import mccnn as ref_mccnn
from .common import (Evaluator, Reservoir, Samples, install_capture,
                     remove_capture)

#: The luma weights of the grayscale image the network reads (ITU-R BT.601).
LUMA = (0.299, 0.587, 0.114)


def mccnn_weights(spec: dict, device) -> list:
    """[(weight [c_out, c_in, k, k], bias [c_out]), ...] float32 of the
    feature tower ``spec`` (the configuration's ``mccnn``), drawn from its
    ``weights_seed`` on ``device`` in one call, as Torch7's
    SpatialConvolution initializes a layer: uniform in +-1/sqrt(k k c_in).
    One network for every run, as a deployment serves one: the run's seed
    draws the scene."""
    k, c_in = spec["kernel"], spec["in_channels"]
    shapes = []
    for c_out in spec["channels"]:
        shapes.append(((c_out, c_in, k, k), (c_out,), (k * k * c_in) ** -0.5))
        c_in = c_out
    sizes = [math.prod(w) + b[0] for w, b, _ in shapes]
    gen = torch.Generator(device=device)
    gen.manual_seed(spec["weights_seed"])
    flat = torch.rand(sum(sizes), generator=gen, device=device) * 2.0 - 1.0
    out = []
    for (ws, bs, bound), part in zip(shapes, torch.split(flat, sizes)):
        n = math.prod(ws)
        out.append(((part[:n] * bound).reshape(ws).contiguous(),
                    (part[n:] * bound).contiguous()))
    return out


def grayscale(image: torch.Tensor) -> torch.Tensor:
    """[H, W, 1] float32 luma of an [H, W, 3] image."""
    luma = torch.tensor(LUMA, dtype=torch.float32, device=image.device)
    return (image.to(torch.float32) * luma).sum(-1, keepdim=True)


class Client:
    kind = "warm"

    def __init__(self, config: dict, traffic: dict, seed: int, device: str,
                 trace: bool):
        self.config = config
        self.traffic = traffic
        self.seed = seed
        self.device = torch.device(device)
        self.trace = trace
        self.scene = importlib.import_module(
            f"benchmark.scenes.{config['scene']}")
        self.kept = Reservoir(traffic["checked"], seed)
        self._pending = None

    def setup(self) -> None:
        from localexpstereo_tpu_torch.config import PARAMS_GF
        from localexpstereo_tpu_torch.models import mccnn
        from localexpstereo_tpu_torch.serving import StereoStream
        cfg, tr = self.config, self.traffic
        e = cfg["energy"]
        sc = self.scene.make(cfg, self.seed, 0, tr["pan_positions"],
                             tr["pan_step"])
        self.labels = sc["labels"]
        self.ims = [torch.as_tensor(sc[k], dtype=torch.float32,
                                    device=self.device)
                    for k in ("im0", "im1")]
        self.grays = [grayscale(im) for im in self.ims]
        spec = cfg["mccnn"]
        self.weights = mccnn_weights(spec, self.device)
        self.net = mccnn.MCCNN(spec["channels"],
                               in_channels=spec["in_channels"]).to(self.device)
        with torch.no_grad():
            for conv, (w, b) in zip(self.net.convs, self.weights):
                conv.weight.copy_(w)
                conv.bias.copy_(b)
        self.net.requires_grad_(False)
        self.mccnn = mccnn
        sched = cfg["schedule"]
        self.stream = StereoStream(
            PARAMS_GF.replace(windR=e["windR"], lambda_=e["lambda"],
                              th_col=e["th_col"]),
            max_disp=float(cfg["ndisp"] - 1), unit_sizes=cfg["unit_sizes"],
            cold_iterations=sched["cold"]["graph_cut"],
            cold_pm_iterations=sched["cold"]["greedy"],
            warm_iterations=sched["warm"]["graph_cut"],
            warm_pm_iterations=sched["warm"]["greedy"],
            pipelined=True, profile=self.trace, device=self.device)
        self.samples = Samples(cfg, self.seed, self.device)
        self.capture = install_capture(cfg, self.kind, self.seed,
                                       tr["moves_checked"])
        self.k0 = 0
        for _ in range(2):                       # the cold frame, one warm
            self._frame(self.k0, float("inf"), False)
            self.k0 += 1
        self._pending = None
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def _cols(self, k: int) -> slice:
        off = window.pan_offset(k, self.traffic["pan_positions"],
                                self.traffic["pan_step"])
        return slice(off, off + self.config["width"])

    def _frame(self, k: int, deadline: float, sync: bool) -> dict:
        cols = self._cols(k)
        im0, im1 = self.ims[0][:, cols], self.ims[1][:, cols]
        start = time.perf_counter()
        if self.device.type == "cuda":
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
        vol = self.mccnn.cost_volume(self.net, self.grays[0][:, cols],
                                     self.grays[1][:, cols],
                                     self.config["ndisp"])
        if self.device.type == "cuda":
            ev[1].record()
        else:
            ev = None
        evaluator = Evaluator(self.samples, deadline, sync, vol)
        if self.stream.solver is not None:
            self.stream.solver.set_evaluator(evaluator)
        self.capture.begin(k)
        out = self.stream.process(im0, im1, vol, vol)
        end = time.perf_counter()
        rec = {"k": k, "cols": cols, "start": start, "end": end,
               "marks": evaluator.marks, "kept": evaluator.kept,
               "moves": self.capture.end(),
               "mccnn_events": ev, "timings": self.stream.last_timings,
               "labeling": self.stream._prev_labeling, "disp": None}
        # The pipelined stream hands back the frame before this one.
        if self._pending is not None:
            self._pending["disp"] = out
        self._pending = rec
        return rec

    def frame(self, k: int, deadline: float, sync: bool) -> dict:
        return self._frame(self.k0 + k, deadline, sync)

    def keep(self, rec: dict) -> None:
        """A frame completed inside the window: the reservoir keeps a few
        for the check, each with a copy of its labeling."""
        self.kept.offer(rec)
        if rec["labeling"] is not None and any(r is rec
                                               for r in self.kept.items):
            rec["labeling"] = rec["labeling"].clone()

    def release(self) -> None:
        """Takes the last frame's map from the pipeline, then drops the
        stream's state."""
        if self._pending is not None:
            self._pending["disp"] = self.stream.flush()
        remove_capture(self.capture)
        self.stream = None
        self.net = None

    def check(self, control: bool = False):
        """Per kept frame, the numbers of :mod:`..check` and the MC-CNN
        volume's."""
        rows = []
        for rec in self.kept.items:
            kept = rec["kept"]
            if not check.complete(kept, rec["disp"]):
                rows.append(check.missing())
                continue
            cols = rec["cols"]
            pr = self.pair_reference(rec)
            row = check.build_numbers(kept, self.samples, pr,
                                      kept["vol_points"], control)
            row["unary_gap"] = check.unary_number(kept, self.samples, pr,
                                                  control)
            row["map_gap"] = check.map_number(rec["labeling"], rec["disp"],
                                              control)
            row["cut_gap"] = check.cut_number(rec["moves"], pr, control)
            g0, g1 = (g[:, cols] for g in self.grays)
            f0 = ref_mccnn.features(self.weights, g0)
            f1 = ref_mccnn.features(self.weights, g1)
            s = self.samples
            want = ref_mccnn.cost_at(f0, f1, s.pd, s.py, s.px)
            if control:
                got = ref_mccnn.cost_at(
                    ref_mccnn.features(self.weights, g0, allow_tf32=True),
                    ref_mccnn.features(self.weights, g1, allow_tf32=True),
                    s.pd, s.py, s.px)
            else:
                got = kept["vol_points"]
            row["volume_gap"] = float((got - want).abs().max())
            if not control:
                row["energy_ratio"] = self.ratio(rec, pr, (f0, f1))
            rows.append(row)
        return rows

    def pair_reference(self, rec: dict) -> check.PairReference:
        return check.PairReference(
            self.ims[0][:, rec["cols"]].contiguous(),
            ref.params_of(self.config))

    def ratio(self, rec: dict, pr=None, feats=None) -> float:
        """The reference's ``energy_ratio`` of a frame's final labeling,
        on the reference network's volume of the frame."""
        cols = rec["cols"]
        if pr is None:
            pr = self.pair_reference(rec)
        p = pr.p
        if feats is None:
            feats = [ref_mccnn.features(self.weights, g[:, cols])
                     for g in self.grays]
        codes, scale = ref.quantize(
            ref_mccnn.volume(*feats, self.config["ndisp"]), p.th_col)
        truth = self.scene.frame_labels(self.labels, cols.start,
                                        self.config["width"])
        return check.energy_ratio(rec["labeling"],
                                  pr.truth_energy(truth, codes, scale), pr,
                                  codes, scale)
