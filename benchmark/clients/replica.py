"""Cold frames from a standing pool of replicas, one worker process a card
(``parallel.replica.ReplicaPool``), in a closed loop: one pair in flight a
card, and a card's next pair handed over as soon as its map has been
collected.

The pool is built as the batch command line builds a shape group's
``ReplicaSolver`` (``cli/batch.group_solver``: the configuration's flags,
the batch's warm-up) and started in set-up: the workers' spawn, their
cards' start-up and their warm-ups land there. Frame ``k`` is pair ``k mod
pairs`` with solver seed ``seed0 + k`` (``seed0`` drawn from the run's
seed), so the frames of a run are all different solves. A frame runs from
its hand-over (``submit``) to its disparity map as numpy in this process;
the frames come back in the order they complete. Frames still in flight
when the window closes are dropped at their next sweep boundary. As each
completed frame lands, after its stamps, this process holds its map
against its labeling on its own card (``map_gap``, :meth:`Client.keep`):
the one device work of this process in the window, so the harness's
device trace, which reads this process alone, sees the frames land.

The check (:meth:`Client.check`): every completed frame's map (its
``map_gap``, read as it landed) and energy (``energy_ratio`` against
:mod:`..reference.energy`), and one
frame drawn from the seed solved again in this process, alone on one
device (no pool, no worker, nothing pickled), as the cold client solves a
frame: the command line's solver (``cli.main._make_solver``, the frame's
seed) with the cold client's evaluator and move capture. That twin is held
bit for bit against the pool's frame (``twin_gap``: the pixels whose label
differs), and its energy build, init unaries, expansion moves, map and
energy against the plain reference (:mod:`..reference.energy`,
:mod:`..reference.cut`: ``build_gap``, ``vol_codes``, ``unary_gap``,
``cut_gap``, ``map_gap``, ``energy_ratio``), under the limits of the cold
cell. ``check.verdict`` reads only ``check.ORDER``, which has no
``twin_gap``: the twin's row carries it into ``map_gap`` (infinite where
``twin_gap`` passes its limit), and its reading is printed beside its limit
on standard error.

A traced run gives each worker a profiler window over its card; at
:meth:`Client.release` the workers' spans, card ops and peaks, the pool's
counters and this process's ``replica.*`` spans go into every kept frame's
``timings`` (``benchmark/replica_trace.py`` reads them).

Traffic keys: ``pairs`` (how many pairs the frames cycle over, each drawn
from the seed and the pair's index); ``moves_checked``: the expansion moves
the twin keeps for the check, on average (``common.MoveCapture``).
Configuration key: ``replicas`` (the
cards, ``cuda:0`` on; worker processes on the CPU for the harness's tests).
"""
from __future__ import annotations

import importlib
import math
import sys
import time

import numpy as np
import torch

from .. import check
from ..reference import energy as ref
from .common import (Evaluator, Samples, WindowClosed, install_capture,
                     remove_capture)


class Client:
    kind = "cold"

    def __init__(self, config: dict, traffic: dict, seed: int, device: str,
                 trace: bool):
        from localexpstereo_tpu_torch.parallel import replica
        if not hasattr(replica, "ReplicaPool"):
            raise RuntimeError("this program has no standing replica pool "
                               "(parallel.replica.ReplicaPool)")
        from localexpstereo_tpu_torch.cli import batch
        self.batch = batch
        self.config = config
        self.traffic = traffic
        self.seed = seed
        self.trace = trace
        self.seed0 = int(np.random.SeedSequence([seed % 2 ** 63, 17])
                         .generate_state(1)[0]) % 2 ** 30
        self.ns = batch.parse_args(list(config["argv"]) + [
            "-seed", str(self.seed0), "-device", device])
        n = config["replicas"]
        self.devices = ([f"cuda:{i}" for i in range(n)] if device == "cuda"
                        else ["cpu"] * n)
        self.ref_device = torch.device("cuda:0" if device == "cuda"
                                       else "cpu")
        self.pairs = []
        self.frames = []
        self.pool = None
        self._next = 0
        self._refs = {}
        self._twin = None

    def setup(self) -> None:
        from localexpstereo_tpu_torch.cli import main as cli
        from localexpstereo_tpu_torch.utils import calib, datasets
        cfg = self.config
        layers = cli.v3_layers(cfg["width"])
        if layers != list(cfg["unit_sizes"]):
            raise RuntimeError(f"the command line sizes the layers {layers}, "
                               f"the configuration {cfg['unit_sizes']}")
        scene = importlib.import_module(f"benchmark.scenes.{cfg['scene']}")
        cal = calib.Calib(ndisp=cfg["ndisp"])
        for i in range(self.traffic["pairs"]):
            sc = scene.make(cfg, self.seed, i)
            self.pairs.append({
                "pair": datasets.StereoPair(im0=sc["im0"], im1=sc["im0"],
                                            disp_gt=None, nonocc=None,
                                            calib=cal),
                "vol": sc["vol"], "labels": sc["labels"]})
        solver = self.batch.group_solver(
            self.ns, [p["pair"] for p in self.pairs], self.devices,
            [(p["vol"], p["vol"]) for p in self.pairs])
        self.pool = solver.pool(self.ns.iterations, (0,),
                                self.ns.pmIterations, trace=self.trace)
        first = self.pairs[0]
        self.pool.start((first["pair"].im0, (first["vol"], first["vol"])))
        # The map check of keep(), at the frames' shape, on the planted truth.
        truth = torch.as_tensor(first["labels"], device=self.ref_device)
        check.map_number(truth, ref.disparity(truth).cpu().numpy(), False)

    def _submit(self) -> None:
        """The next frame, to the card with none in flight."""
        b = self._next
        self._next += 1
        p = self.pairs[b % len(self.pairs)]
        self.pool.submit(b, p["pair"].im0, p["pair"].im1,
                         (p["vol"], p["vol"]))

    def frame(self, k: int, deadline: float, sync: bool) -> dict:
        """The next frame to complete (the first call hands one to every
        card); raises ``WindowClosed`` once ``deadline`` passes first."""
        if self._next == 0:
            for _ in self.devices:
                self._submit()
        got = self.pool.next_result(
            timeout=max(deadline - time.perf_counter(), 0.0))
        if got is None:
            raise WindowClosed()
        if time.perf_counter() < deadline:
            self._submit()
        b, st, res = got["b"], got["stamps"], got["result"]
        return {"k": b, "pair": b % len(self.pairs), "start": st["submit"][0],
                "end": st["collect"][1], "marks": st["marks"],
                "timings": {"b": b, "worker": got["worker"], "stamps": st},
                "labeling": res["labelings"][0], "disp": res["disparity"]}

    def keep(self, rec: dict) -> None:
        """A frame completed inside the window: every one is checked, its
        map here and now, on this process's card."""
        lab = torch.as_tensor(rec["labeling"], device=self.ref_device)
        rec["map_gap"] = check.map_number(lab, rec["disp"], False)
        self.frames.append(rec)

    def release(self) -> None:
        """Closes the pool (the frames in flight are dropped); a traced
        run's traces go into the kept frames' ``timings``."""
        if self.pool is None:
            return
        workers = self.pool.close(timeout=300.0 if self.trace else 30.0)
        shared = {"workers": workers, "counts": self.pool.counts()}
        for rec in self.frames:
            rec["timings"].update(shared)
        self.pool = None

    def check(self, control: bool = False):
        """Per completed frame, ``map_gap`` (the control's made now) and
        ``energy_ratio``; then the twin's row."""
        rows = []
        for rec in self.frames:
            pr, codes, scale, e_truth = self.reference(rec["pair"])
            lab = torch.as_tensor(rec["labeling"], device=self.ref_device)
            rows.append({
                "map_gap": (check.map_number(lab, rec["disp"], True)
                            if control else rec["map_gap"]),
                "energy_ratio": None if control else check.energy_ratio(
                    lab, e_truth, pr, codes, scale)})
        if self.frames:
            rows.append(self.twin_row(control))
        return rows

    def solve_twin(self) -> dict:
        """One completed frame drawn from the seed, solved again alone in
        this process as the cold client solves a frame (once a run)."""
        if self._twin is not None:
            return self._twin
        from localexpstereo_tpu_torch.cli import main as cli
        from localexpstereo_tpu_torch.ops import plane
        from localexpstereo_tpu_torch.utils import datasets
        rng = np.random.default_rng([self.seed % 2 ** 63, 19])
        rec = self.frames[int(rng.integers(len(self.frames)))]
        k, cfg, dev = rec["k"], self.config, self.ref_device
        p = self.pairs[rec["pair"]]
        im = torch.as_tensor(p["pair"].im0, device=dev)
        vol = torch.as_tensor(p["vol"], device=dev)
        pair = datasets.StereoPair(im0=im, im1=im, disp_gt=None, nonocc=None,
                                   calib=p["pair"].calib)
        opt = cli.parse_args(list(cfg["argv"]) + [
            "-seed", str(self.seed0 + k), "-device", dev.type])
        samples = Samples(cfg, self.seed, dev)
        ev = Evaluator(samples, math.inf, False, vol)
        capture = install_capture(cfg, self.kind, self.seed,
                                  self.traffic["moves_checked"])
        try:
            solver = cli._make_solver(pair, opt, cli.v3_layers(cfg["width"]),
                                      (vol, vol))
            solver.set_evaluator(ev)
            capture.begin(k)
            labeling, _ = solver.run(opt.iterations, view_modes=(0,),
                                     pm_iterations=opt.pm_iterations)
            moves = capture.end()
        finally:
            remove_capture(capture)
        self._twin = {"rec": rec, "labeling": labeling.clone(),
                      "disp": plane.disparity_map(labeling).cpu().numpy(),
                      "kept": ev.kept, "moves": moves, "samples": samples,
                      "vol": vol}
        return self._twin

    def twin_row(self, control: bool) -> dict:
        """The twin's numbers against the reference (the control's with
        ``control``) and, but in the control, ``twin_gap``: the pixels
        whose label (all four floats, bit for bit) differs from the pool's
        frame; ``map_gap`` also holds the pool's host map against the
        twin's labeling, and is infinite where ``twin_gap`` passes its
        limit."""
        tw = self.solve_twin()
        rec, lab, kept = tw["rec"], tw["labeling"], tw["kept"]
        if not check.complete(kept, tw["disp"]):
            return check.missing()
        pr, codes, scale, e_truth = self.reference(rec["pair"])
        samples = tw["samples"]
        row = check.build_numbers(kept, samples, pr,
                                  samples.volume_points(tw["vol"]), control)
        row["unary_gap"] = check.unary_number(kept, samples, pr, control)
        row["cut_gap"] = check.cut_number(tw["moves"], pr, control)
        row["map_gap"] = max(check.map_number(lab, tw["disp"], control),
                             check.map_number(lab, rec["disp"], control))
        row["energy_ratio"] = None if control else check.energy_ratio(
            lab, e_truth, pr, codes, scale)
        if control:
            return row
        want = lab.cpu().numpy()
        gap = int(np.any(want.view(np.uint32)
                         != rec["labeling"].view(np.uint32), axis=-1).sum())
        lim = check.limits(self.config["name"])["twin_gap"]
        print(f"check twin_gap {gap!r} limit {lim!r} (frame {rec['k']})",
              file=sys.stderr, flush=True)
        row["twin_gap"] = gap
        if gap > lim:
            row["map_gap"] = float("inf")
        return row

    def reference(self, i: int):
        """The reference's build of pair ``i``: (PairReference, the
        quantized volume and its scale, the planted truth's energy)."""
        if i not in self._refs:
            p = ref.params_of(self.config)
            pair = self.pairs[i]
            pr = check.PairReference(
                torch.as_tensor(pair["pair"].im0, device=self.ref_device), p)
            codes, scale = ref.quantize(
                torch.as_tensor(pair["vol"], device=self.ref_device),
                p.th_col)
            self._refs[i] = (pr, codes, scale,
                             pr.truth_energy(pair["labels"], codes, scale))
        return self._refs[i]
