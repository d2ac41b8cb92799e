"""The multi-pair batch command line (counterpart of
``localexpstereo_tpu.cli.batch``; the README's "BASELINE config 3", the
Middlebury trainingH set of 15 pairs).

    python -m localexpstereo_tpu_torch.cli.batch -mode MiddV3 \\
        -targetDirs DIR [DIR ...] | -targetParent PARENT \\
        -outputDir OUT [-doDual 1] [-iterations 5 -pmIterations 2 ...] \\
        [-volume acrt|mccnn] [-volPrecision uint8|bfloat16|float32] \\
        [-device cuda|cpu]

Flags are the JAX package's, with ``-device`` in place of ``-platform``.
``-targetParent DIR`` adds every subdirectory of DIR that holds an
``im0.png`` or ``imL.png``. Datasets are grouped by (H, W, ndisp), read
from their images and calibration; each group runs as one
:class:`..parallel.replica.ReplicaSolver`, one pair at a time on each
visible card (``-device cpu``: one, on the CPU), pair ``b`` of a group
with seed ``seed + b``. The MiddV3 volumes stream through a
:class:`..utils.prefetch.PairPrefetcher`, one pair ahead of the solve, so
two pairs' volumes are in memory at a time (the JAX package reads them all
first); ``-volume mccnn`` computes each pair's when it is solved.

Per dataset (a name repeated across parents is disambiguated):
``disp0.pfm``, ``disp0raw.pfm`` with ``-doDual 1``, ``time.txt`` and
``debug/`` (``log_output.txt`` and the images). ``time.txt`` keeps the JAX
package's meaning: a group's evaluators start and stop together, so on one
card every pair of a group writes the group's optimization time (energy
builds and volume reads excluded, measured to device completion). The
output root gets ``batch_summary.json``: ``groups`` (``shape``,
``datasets``, ``batch``, ``waves``, ``wall_s``, ``amortized_s_per_frame``;
the port's ``warmup_s``, the longest warm-up solve, which ``wall_s`` leaves
out; and by pair ``load_s``, ``prefetch_wait_s``, ``solve_s`` and the
kernels' ``launches``, its warm-up's included) and ``n_devices``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import List, Optional

import torch

from ..config import PARAMS_GF, Options
from ..models.evaluator import Evaluator
from ..parallel.mesh import make_devices
from ..parallel.replica import ReplicaSolver
from ..utils import datasets, pfm
from ..utils.prefetch import PairPrefetcher
from . import main as cli_main


def parse_args(argv: Optional[List[str]] = None):
    ap = argparse.ArgumentParser(
        prog="localexpstereo_tpu_torch-batch",
        description="Local Expansion Stereo on PyTorch + CUDA: the "
                    "multi-pair batch command line (one pair at a time on "
                    "each card)")
    ap.add_argument("--mode", default="MiddV3", choices=["MiddV2", "MiddV3"])
    ap.add_argument("--targetDirs", nargs="+", default=[])
    ap.add_argument("--targetParent", default="")
    ap.add_argument("--outputDir", default="out")
    ap.add_argument("--doDual", type=int, default=0)
    ap.add_argument("--iterations", type=int, default=5)
    ap.add_argument("--pmIterations", type=int, default=2)
    ap.add_argument("--ndisp", type=int, default=0)
    ap.add_argument("--smooth_weight", type=float, default=None)
    ap.add_argument("--filterRadious", "--filterRadius", type=int,
                    dest="filterRadious", default=20)
    ap.add_argument("--mc_threshold", type=float, default=0.5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--volume", default="acrt", choices=["acrt", "mccnn"])
    ap.add_argument("--volPrecision", default="uint8",
                    choices=["uint8", "bfloat16", "float32"])
    ap.add_argument("--warmup", type=int, default=1)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap.parse_args(cli_main.normalize_argv(argv))


def _dedupe_names(entries: List[dict]) -> None:
    """Disambiguates duplicate leaf names (e.g. trainingH/X and
    trainingQ/X) in place so per-dataset outputs never overwrite each
    other: first by prefixing the parent directory, then by an index."""
    leaf_counts: dict = {}
    for e in entries:
        leaf_counts[e["name"]] = leaf_counts.get(e["name"], 0) + 1
    for e in entries:
        if leaf_counts[e["name"]] > 1:
            parent = os.path.basename(os.path.dirname(e["dir"].rstrip("/")))
            if parent:
                e["name"] = f"{parent}_{e['name']}"
    seen: dict = {}
    for e in entries:
        n = seen.get(e["name"], 0)
        seen[e["name"]] = n + 1
        if n:
            e["name"] = f"{e['name']}_{n}"


def _expand_parent(parent: str) -> List[str]:
    out = []
    for name in sorted(os.listdir(parent)):
        d = os.path.join(parent, name)
        if os.path.isdir(d) and any(
                os.path.exists(os.path.join(d, f))
                for f in ("im0.png", "imL.png")):
            out.append(d)
    return out


def _options_for(ns, target_dir: str) -> Options:
    return Options(
        mode=ns.mode, output_dir="", target_dir=target_dir,
        iterations=ns.iterations, pm_iterations=ns.pmIterations,
        do_dual=bool(ns.doDual), ndisp=ns.ndisp,
        smooth_weight=ns.smooth_weight, mc_threshold=ns.mc_threshold,
        filter_radius=ns.filterRadious, seed=ns.seed, volume=ns.volume,
        warmup=ns.warmup, vol_precision=ns.volPrecision, device=ns.device)


def _volume_stream(ns, entries):
    """The MiddV3 volumes of ``entries`` in order (None in MiddV2 mode),
    and the prefetcher that reads them (None unless ``-volume acrt``)."""
    if ns.mode != "MiddV3":
        return None, None
    if ns.volume == "mccnn":
        return (cli_main.load_v3_volumes(e["dir"], e["pair"], "mccnn",
                                         ns.device) for e in entries), None
    prefetcher = PairPrefetcher([e["dir"] for e in entries], ns.ndisp,
                                load_volumes=True)
    return prefetcher.volumes(), prefetcher


def _evaluator(ns, e, out_dir: str, max_disp: float) -> Evaluator:
    ev = Evaluator(e["pair"].disp_gt, e["pair"].nonocc,
                   255.0 / max(max_disp, 1e-6),
                   save_dir=os.path.join(out_dir, "debug"))
    if ns.mode == "MiddV2":
        ev.set_precision(e["pair"].calib.gt_prec)
        ev.set_error_threshold(0.5)
    else:
        ev.set_precision(-1.0)
        ev.set_error_threshold(cli_main.v3_error_threshold(e["dir"]))
    return ev


def group_solver(ns, pairs: List[datasets.StereoPair], devices,
                 volumes) -> ReplicaSolver:
    """The :class:`ReplicaSolver` of one shape group (``pairs`` of one
    shape), as :func:`run_batch` runs it: the mode's parameters and layers,
    pair ``b`` with seed ``-seed`` + b, and the warm-up unless ``-warmup
    0``. ``volumes``: (vol0, vol1) of each pair in order, or None (V2)."""
    w = pairs[0].im0.shape[1]
    params = PARAMS_GF.replace(
        windR=ns.filterRadious,
        lambda_=_options_for(ns, "").resolve_smooth_weight())
    if ns.mode == "MiddV3":
        params = params.replace(th_col=ns.mc_threshold)
        layers = cli_main.v3_layers(w)
    else:
        layers = cli_main.V2_LAYERS
    solver = ReplicaSolver(
        [p.im0 for p in pairs], [p.im1 for p in pairs], params,
        float(pairs[0].max_disparity), layers, devices=devices,
        volumes=volumes, seed=ns.seed, vol_dtype=ns.volPrecision)
    if ns.warmup:
        solver.precompile(view_modes=(0, 1) if ns.doDual else (0,),
                          pm_iterations=ns.pmIterations,
                          iterations=ns.iterations)
    return solver


def run_batch(ns) -> dict:
    dirs = list(ns.targetDirs)
    if ns.targetParent:
        dirs += _expand_parent(ns.targetParent)
    if not dirs:
        raise SystemExit("no target directories (use -targetDirs/-targetParent)")

    # Images and calibration only; the volumes stream in later.
    entries = []
    for d in dirs:
        pair = datasets.load_data(d, ns.ndisp)
        h, w = pair.im0.shape[:2]
        entries.append({"dir": d, "name": os.path.basename(d.rstrip("/")),
                        "pair": pair, "shape": (h, w, pair.ndisp)})
    _dedupe_names(entries)
    groups: dict = {}
    for e in entries:
        groups.setdefault(e["shape"], []).append(e)
    print(f"{len(entries)} datasets in {len(groups)} shape group(s):")
    for shape, es in groups.items():
        print(f"  (H={shape[0]}, W={shape[1]}, ndisp={shape[2]}): "
              + ", ".join(x["name"] for x in es))

    devices = make_devices(kind=ns.device)
    modes = (0, 1) if ns.doDual else (0,)
    summary = {"groups": [], "n_devices": len(devices)}
    ordered = [e for es in groups.values() for e in es]
    volumes, prefetcher = _volume_stream(ns, ordered)

    for shape, es in groups.items():
        max_disp = float(es[0]["pair"].max_disparity)
        solver = group_solver(ns, [e["pair"] for e in es], devices, volumes)
        evs = [_evaluator(ns, e, os.path.join(ns.outputDir, e["name"]),
                          max_disp) for e in es]
        solver.set_evaluators(evs)
        waits0 = len(prefetcher.wait_s) if prefetcher else 0
        t0 = time.perf_counter()
        try:
            solver.run(ns.iterations, modes, ns.pmIterations)
            stats = [solver.pair_stats(b) for b in range(len(es))]
            # The warm-ups run inside run() (on one card on the first pair,
            # on several in each worker at its start);
            # the wall leaves out the longest, as the JAX package's leaves
            # out its precompile.
            warmup_s = max(st["warmup_s"] for st in stats)
            wall = time.perf_counter() - t0 - warmup_s
            disps = solver.disparities()
            raws = solver.disparities(raw=True) if ns.doDual else None
            for b, e in enumerate(es):
                out_dir = os.path.join(ns.outputDir, e["name"])
                pfm.write_pfm(os.path.join(out_dir, "disp0.pfm"), disps[b])
                if ns.doDual:
                    pfm.write_pfm(os.path.join(out_dir, "disp0raw.pfm"),
                                  raws[b])
                with open(os.path.join(out_dir, "time.txt"), "w") as f:
                    f.write(f"{evs[b].get_current_time():f}\n")
        finally:
            for ev in evs:
                ev.close()
        summary["groups"].append({
            "shape": list(shape), "datasets": [e["name"] for e in es],
            "batch": len(es), "waves": solver.waves, "wall_s": wall,
            "amortized_s_per_frame": wall / len(es),
            "load_s": ([prefetcher.load_s[e["dir"]] for e in es]
                       if prefetcher else None),
            "prefetch_wait_s": (prefetcher.wait_s[waits0:]
                                if prefetcher else None),
            "warmup_s": warmup_s,
            "solve_s": [st["solve_s"] for st in stats],
            "launches": [st["launches"] for st in stats]})
        print(f"group {shape}: {len(es)} pairs, {solver.waves} wave(s), "
              f"{wall:.1f} s wall, {wall / len(es):.2f} s/frame amortized")

    os.makedirs(ns.outputDir, exist_ok=True)
    with open(os.path.join(ns.outputDir, "batch_summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    return summary


def main(argv: Optional[List[str]] = None) -> int:
    ns = parse_args(argv)
    if ns.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("-device cuda: no CUDA device is available "
                           "(use -device cpu to run on the CPU)")
    os.makedirs(ns.outputDir, exist_ok=True)
    run_batch(ns)
    return 0


if __name__ == "__main__":
    sys.exit(main())
