"""The port's command line (counterpart of
``localexpstereo_tpu.cli.main``; reference ``main.cpp:425-480``).

    python -m localexpstereo_tpu_torch.cli.main -mode MiddV2|MiddV3 \\
        -targetDir DIR -outputDir OUT [-unaryBackend dma] [-fuseSeeds N] \\
        [-doDual 1] [-volume acrt|mccnn] \\
        [-volPrecision uint8|bfloat16|float32] [-device cpu]

Flags are the JAX CLI's (``main.cpp:33-50`` plus its own), in both ``-name
value`` and ``--name value`` form, with ``-device cuda|cpu`` in place of
``-platform``. ``-unaryBackend auto|xla|blk`` all run the plain sampler
(on the TPU they were layouts of one function); ``dma`` runs the fused
sampling + guided-filter kernel (its plain version with ``-device cpu``).

MiddV2 mode: images ``imL/imR.png`` (else ``im0/im1.png``), ``info.txt``
(ground-truth scale and ndisp), ground truth ``groundtruth.png`` and
``nonocc.png``; the image-warp (V2) energy, layers {5, 15, 25} px, error
threshold 0.5, the ground truth's precision (``main.cpp:270-329``); the
smooth weight defaults to 1.0 and ``-mc_threshold`` / ``-volPrecision`` do
not apply.

MiddV3 mode: images ``im0/im1.png``, ``calib.txt``, the cost volume
``im0.acrt`` (``im1.acrt``, or the L->R recovery, for the right view;
read by the threaded loader of :mod:`..native`, built at first use),
ground truth ``disp0GT.pfm``; layers {1%, 3%, 9%} of the width, error
threshold 1.0 (x0.5 Q, x2 F) (``main.cpp:331-421``). With ``-volume
mccnn`` the left volume is computed from the images on the run's device
by the bundled MC-CNN weights (:mod:`..models.mccnn`) instead, and the
right one recovered from it; no ``.acrt`` is read.

Either mode: init, ``-pmIterations`` greedy sweeps and ``-iterations``
graph-cut sweeps of view 0, or with ``-doDual 1`` of both views (each sweep
on view 0, then view 1) followed by the left-right post-process at
threshold 1.5 and one more log row.

``-fuseSeeds N`` (N > 1) first solves seeds ``seed + 1 .. seed + N - 1``
with the same schedule and views, untimed: on one card one after the
other, on the primary's energy; with more than one card (``-device cuda``)
as one :class:`..parallel.replica.ReplicaSolver` batch over as many cards
as seeds, one worker process a card, each building its energy. The timed
solve then fuses each of their labelings into
its result (each view into its own) at every layer, coarsest first (the
fusion move), and, with one view, logs one more row.
With ``-warmup 1`` a throwaway fusion on the warm-up solve's state comes
first, so ``time.txt`` holds no first-use costs of the fusion path.

Outputs: ``disp0.pfm``, ``time.txt`` and ``debug/`` with the per-sweep
images and ``log_output.txt``; with ``-doDual 1`` also ``disp0raw.pfm``
(view 0 before the post-process) and the consistency images
``debug/result{0,1}C{index}.png`` after each sweep pair.

Refused: ``-laneFriendly 1``, which is TPU sizing.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time
from typing import List, Optional

import torch

from ..config import PARAMS_GF, Options
from .. import native
from ..models import mccnn
from ..models.engine import (COARSE_PROPOSERS, LAYER0_PROPOSERS,
                             LocalExpansionSolver, init_from_labeling)
from ..models.evaluator import Evaluator
from ..ops import plane as plane_ops
from ..parallel.mesh import make_devices
from ..parallel.replica import ReplicaSolver
from ..utils import datasets, pfm, prefetch, profiling


def normalize_argv(argv: Optional[List[str]]) -> List[str]:
    """Accepts the reference's single-dash long flags by normalizing to --."""
    argv = list(sys.argv[1:] if argv is None else argv)
    norm = []
    for a in argv:
        if a.startswith("-") and not a.startswith("--") and len(a) > 2 \
                and not a[1].isdigit():
            norm.append("-" + a)
        else:
            norm.append(a)
    return norm


def _refuse_unported(ns) -> None:
    """Raises for the settings the port does not take yet."""
    refused = [
        (ns.laneFriendly != 0, "-laneFriendly sizes layers for the TPU's "
                               "VMEM tiles; the port takes the reference "
                               "sizing only"),
    ]
    for hit, why in refused:
        if hit:
            raise NotImplementedError(why)


def parse_args(argv: Optional[List[str]] = None) -> Options:
    norm = normalize_argv(argv)

    ap = argparse.ArgumentParser(
        prog="localexpstereo_tpu_torch",
        description="Local Expansion Stereo on PyTorch + CUDA")
    ap.add_argument("--mode", default="", choices=["", "MiddV2", "MiddV3"])
    ap.add_argument("--targetDir", default="")
    ap.add_argument("--outputDir", default="")
    ap.add_argument("--doDual", type=int, default=0)
    ap.add_argument("--iterations", type=int, default=5)
    ap.add_argument("--pmIterations", type=int, default=2)
    ap.add_argument("--ndisp", type=int, default=0)
    ap.add_argument("--smooth_weight", type=float, default=None)
    ap.add_argument("--filterRadious", "--filterRadius", type=int,
                    dest="filterRadious", default=20)
    ap.add_argument("--mc_threshold", type=float, default=0.5)
    ap.add_argument("--threadNum", type=int, default=-1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--volume", default="acrt", choices=["acrt", "mccnn"])
    ap.add_argument("--volPrecision", default="uint8",
                    choices=["uint8", "bfloat16", "float32"])
    ap.add_argument("--unaryBackend", default="auto",
                    choices=["auto", "xla", "blk", "dma"])
    ap.add_argument("--warmup", type=int, default=1)
    ap.add_argument("--fuseSeeds", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--show", type=int, default=0)
    ap.add_argument("--laneFriendly", type=int, default=0)
    ns = ap.parse_args(norm)
    _refuse_unported(ns)

    # -threadNum is accepted for parity with the JAX CLI and does nothing.
    return Options(
        mode=ns.mode, output_dir=ns.outputDir, target_dir=ns.targetDir,
        do_dual=ns.doDual != 0,
        iterations=ns.iterations, pm_iterations=ns.pmIterations,
        ndisp=ns.ndisp, smooth_weight=ns.smooth_weight,
        mc_threshold=ns.mc_threshold, filter_radius=ns.filterRadious,
        seed=ns.seed, fuse_seeds=ns.fuseSeeds, warmup=ns.warmup,
        volume=ns.volume, vol_precision=ns.volPrecision,
        unary_backend="dma" if ns.unaryBackend == "dma" else "auto",
        device=ns.device, show=bool(ns.show))


def print_options(opt: Options):
    print("----------- parameter settings -----------")
    for name, val in [("mode", opt.mode), ("outputDir", opt.output_dir),
                      ("targetDir", opt.target_dir),
                      ("doDual", int(opt.do_dual)),
                      ("pmIterations", opt.pm_iterations),
                      ("iterations", opt.iterations), ("ndisp", opt.ndisp),
                      ("filterRadious", opt.filter_radius),
                      ("smooth_weight", opt.resolve_smooth_weight()),
                      ("mc_threshold", opt.mc_threshold),
                      ("seed", opt.seed), ("fuseSeeds", opt.fuse_seeds),
                      ("volume", opt.volume),
                      ("unaryBackend", opt.unary_backend),
                      ("volPrecision", opt.vol_precision),
                      ("device", opt.device)]:
        print(f"{name:<15}: {val}")


def _solver_params(opt: Options, have_vols: bool):
    """PARAMS_GF with the run's window radius and smooth weight; with cost
    volumes ``th_col`` is the CNN threshold (``-mc_threshold``), without
    them the V2 color truncation keeps its preset."""
    params = PARAMS_GF.replace(windR=opt.filter_radius,
                               lambda_=opt.resolve_smooth_weight())
    if have_vols:
        params = params.replace(th_col=opt.mc_threshold)
    return params


def _make_solver(pair: datasets.StereoPair, opt: Options, layers,
                 vols=(None, None)):
    """The run's solver: on the V3 energy with ``vols``, else on the V2
    image-warp energy (where the unary route is the warp sampler's and the
    volume precision does not apply)."""
    solver = LocalExpansionSolver(
        pair.im0, pair.im1, _solver_params(opt, vols[0] is not None),
        pair.max_disparity, vol0=vols[0], vol1=vols[1], seed=opt.seed,
        device=opt.device, unary_backend=opt.unary_backend,
        vol_dtype=opt.vol_precision)
    solver.add_layer(layers[0], LAYER0_PROPOSERS)
    for sz in layers[1:]:
        solver.add_layer(sz, COARSE_PROPOSERS)
    return solver


def _make_batch_aux(pair: datasets.StereoPair, opt: Options, layers,
                    vols=(None, None)):
    """The factory of -fuseSeeds' auxiliary solves on several cards: k
    seeds from ``first_seed`` as one ReplicaSolver batch over at most k
    cards (pair b equals the serial solve of seed first_seed + b)."""
    def make(first_seed: int, k: int) -> ReplicaSolver:
        return ReplicaSolver(
            [pair.im0] * k, [pair.im1] * k,
            _solver_params(opt, vols[0] is not None), pair.max_disparity,
            layers, devices=make_devices(min(k, torch.cuda.device_count())),
            volumes=None if vols[0] is None else [vols] * k,
            seed=first_seed, vol_dtype=opt.vol_precision,
            unary_backend=opt.unary_backend)
    return make


def _synchronize(solver: LocalExpansionSolver) -> None:
    if solver.device.type == "cuda":
        torch.cuda.synchronize(solver.device)
        profiling.count_sync()


def view_modes(opt: Options):
    return (0, 1) if opt.do_dual else (0,)


def warm_up(solver: LocalExpansionSolver, opt: Options) -> None:
    """The counterpart of the JAX solver's ``precompile``: a throwaway
    solve of the same problem and views with at most one sweep of each
    kind (and, with two views, the post-process), before the evaluator is
    set. It builds the kernel libraries and pays the device's first-use
    costs, so ``time.txt`` measures the solve alone."""
    t0 = time.perf_counter()
    solver.run(iterations=min(opt.iterations, 1), view_modes=view_modes(opt),
               pm_iterations=min(opt.pm_iterations, 1))
    _synchronize(solver)
    print(f"warm-up solve in {time.perf_counter() - t0:.1f} s")


def solve_aux_seeds(solver: LocalExpansionSolver, opt: Options, make_aux,
                    make_batch_aux=None):
    """-fuseSeeds N: solves seeds seed + 1 .. seed + N - 1 with the run's
    schedule on the run's views. Returns their ``{mode: [H, W, 4]
    labeling}`` dicts (with two views, the post-processed labelings).

    With more than one card (the solver on CUDA) and ``make_batch_aux``,
    as one ReplicaSolver batch (the JAX CLI's multi-device route); else
    one after the other, each on the primary solver's energy (the same
    energy; building it again would cost the set-up once per seed)."""
    solver.finalize()
    modes = view_modes(opt)
    k = opt.fuse_seeds - 1
    if (make_batch_aux is not None and solver.device.type == "cuda"
            and torch.cuda.device_count() > 1):
        t0 = time.perf_counter()
        rs = make_batch_aux(opt.seed + 1, k)
        rs.run(opt.iterations, view_modes=modes,
               pm_iterations=opt.pm_iterations)
        print(f"fuseSeeds: solved {k} auxiliary seed(s) on "
              f"{len(rs.devices)} devices in "
              f"{time.perf_counter() - t0:.1f} s")
        return [{m: rs.labeling(b, m) for m in modes} for b in range(k)]
    labelings = []
    for i in range(1, opt.fuse_seeds):
        t0 = time.perf_counter()
        aux = make_aux(opt.seed + i)
        aux.data, aux.cfg = solver.data, solver.cfg
        aux.run(opt.iterations, view_modes=modes,
                pm_iterations=opt.pm_iterations)
        labelings.append({m: aux._unpadded_labeling(m).clone()
                          for m in modes})
        _synchronize(solver)
        print(f"fuseSeeds: solved auxiliary seed {opt.seed + i} in "
              f"{time.perf_counter() - t0:.1f} s")
    return labelings


def warm_up_fusion(solver: LocalExpansionSolver, labelings) -> None:
    """A throwaway fusion of each view's labeling of ``labelings`` (a
    ``{mode: labeling}`` dict) into the warm-up solve's state at every
    layer: the first-use costs of the fusion path (the min-cut kernel's
    build among them) before the timer, as the JAX CLI does."""
    t0 = time.perf_counter()
    for mode, labeling in labelings.items():
        solver._fuse_layers(*init_from_labeling(solver.data, solver.cfg,
                                                labeling, mode),
                            mode, tuple(reversed(range(len(solver.layers)))))
    _synchronize(solver)
    print(f"warm-up fusion in {time.perf_counter() - t0:.1f} s")


def _run(solver: LocalExpansionSolver, pair, opt: Options,
         error_thresh: float, gt_precision: float, make_aux,
         make_batch_aux=None):
    out_dir = opt.output_dir or "."
    debug_dir = os.path.join(out_dir, "debug")
    os.makedirs(debug_dir, exist_ok=True)

    ev = Evaluator(pair.disp_gt, pair.nonocc,
                   255.0 / max(pair.max_disparity, 1e-6),
                   save_dir=debug_dir, show=opt.show)
    ev.set_precision(gt_precision)
    ev.set_error_threshold(error_thresh)
    if opt.warmup:
        warm_up(solver, opt)
    fuse_with = None
    if opt.fuse_seeds > 1:
        fuse_with = solve_aux_seeds(solver, opt, make_aux, make_batch_aux)
        if opt.warmup:
            warm_up_fusion(solver, fuse_with[0])
    solver.set_evaluator(ev)
    try:
        labeling, raw = solver.run(opt.iterations, view_modes=view_modes(opt),
                                   pm_iterations=opt.pm_iterations,
                                   fuse_with=fuse_with)
        disp = plane_ops.disparity_map(labeling).cpu().numpy()
        pfm.write_pfm(os.path.join(out_dir, "disp0.pfm"), disp)
        if opt.do_dual:
            pfm.write_pfm(os.path.join(out_dir, "disp0raw.pfm"),
                          plane_ops.disparity_map(raw).cpu().numpy())
        with open(os.path.join(out_dir, "time.txt"), "w") as f:
            f.write(f"{ev.get_current_time():f}\n")
    finally:
        ev.close()
    return disp


def load_v3_volumes(target_dir: str, pair: datasets.StereoPair,
                    volume: str = "acrt", device="cuda"):
    """Left/right cost volumes of a V3 dataset, as host arrays: from
    ``im0.acrt`` / ``im1.acrt`` with the out-of-view fills, R recovered
    from L when absent (``main.cpp:363-367``), by the threaded loader
    (:func:`..utils.prefetch.load_v3_volumes`); or with ``volume``
    "mccnn" the MC-CNN volume of the pair computed on ``device`` with the
    bundled weights (its own out-of-view fill) and R recovered from it by
    the loader's fused recovery and fill (the JAX CLI's volumes)."""
    h, w = pair.im0.shape[:2]
    if volume == "mccnn":
        net = mccnn.params_from_jax(mccnn.load_default_params()).to(device)
        print("Computing MC-CNN cost volumes on device.")
        vol_l = mccnn.cost_volume(net, pair.im0, pair.im1,
                                  pair.ndisp).cpu().numpy()
        return vol_l, native.convert_l2r_fill(vol_l)
    return prefetch.load_v3_volumes(target_dir, pair.ndisp, h, w,
                                    announce=True)


def v3_error_threshold(target_dir: str) -> float:
    """1.0, halved for quarter-size datasets, doubled for full-size
    (``main.cpp:342-346``)."""
    err = 1.0
    if "trainingQ" in target_dir or "testQ" in target_dir:
        err /= 2.0
    elif "trainingF" in target_dir or "testF" in target_dir:
        err *= 2.0
    return err


def v3_layers(w: int) -> List[int]:
    """Reference heuristic {1%, 3%, 9%} of width (``main.cpp:395-397``)."""
    return [max(1, int(w * 0.01)), max(1, int(w * 0.03)),
            max(1, int(w * 0.09))]


#: Unit sizes of the MiddV2 mode's layers (``main.cpp:273-284``).
V2_LAYERS = [5, 15, 25]


def run_midv2(opt: Options):
    """The MiddV2 mode (``main.cpp:270-329``)."""
    pair = datasets.load_data(opt.target_dir, opt.ndisp)
    print(f"ndisp = {pair.ndisp}")
    solver = _make_solver(pair, opt, V2_LAYERS)
    return _run(solver, pair, opt, error_thresh=0.5,
                gt_precision=pair.calib.gt_prec,
                make_aux=lambda seed: _make_solver(
                    pair, dataclasses.replace(opt, seed=seed), V2_LAYERS),
                make_batch_aux=_make_batch_aux(pair, opt, V2_LAYERS))


def run_midv3(opt: Options):
    """The MiddV3 mode (``main.cpp:331-421``)."""
    pair = datasets.load_data(opt.target_dir, opt.ndisp)
    print(f"ndisp = {pair.ndisp}")
    w = pair.im0.shape[1]
    vol_l, vol_r = load_v3_volumes(opt.target_dir, pair, opt.volume,
                                   opt.device)
    layers = v3_layers(w)
    solver = _make_solver(pair, opt, layers, (vol_l, vol_r))
    return _run(solver, pair, opt,
                error_thresh=v3_error_threshold(opt.target_dir),
                gt_precision=-1.0,
                make_aux=lambda seed: _make_solver(
                    pair, dataclasses.replace(opt, seed=seed), layers,
                    (vol_l, vol_r)),
                make_batch_aux=_make_batch_aux(pair, opt, layers,
                                               (vol_l, vol_r)))


def main(argv: Optional[List[str]] = None) -> int:
    opt = parse_args(argv)
    print_options(opt)
    if opt.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("-device cuda: no CUDA device is available "
                           "(use -device cpu to run on the CPU)")
    if opt.output_dir:
        os.makedirs(opt.output_dir, exist_ok=True)
    if opt.mode == "MiddV2":
        print("Running by Middlebury V2 mode.")
        run_midv2(opt)
        return 0
    if opt.mode == "MiddV3":
        print("Running by Middlebury V3 mode.")
        run_midv3(opt)
        return 0
    print("Specify the following arguments:")
    print("  -mode [MiddV2, MiddV3]")
    print("  -targetDir [PATH_TO_IMAGE_DIR]")
    print("  -outputDir [PATH_TO_OUTPUT_DIR]")
    return 1


if __name__ == "__main__":
    sys.exit(main())
