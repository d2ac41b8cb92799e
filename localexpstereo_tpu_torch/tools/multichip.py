"""Multi-rank checks of the port's sharded engines (the port's counterpart
of the JAX package's ``__graft_entry__.dryrun_multichip`` and
``tools/sharded_volume_scale.py``).

    python -m localexpstereo_tpu_torch.tools.multichip --ranks N \\
        [--device cuda|cpu] [--scale] [--height H --width W --ndisp D]

Rank ``i`` runs on ``cuda:{i % cards}`` (with ``--device cuda``; ranks
share a card when there are fewer cards than ranks) or on the CPU; the
backend follows (:func:`..parallel.collectives.choose_backend`). Prints
one JSON line a check:

1. ``data``: :class:`..parallel.batch.BatchedSolver`, N pairs of 24 x 32
   over the N ranks: the init, a greedy and a graph-cut sweep, the
   energies and their mean over the ranks; pair b equal to
   ``LocalExpansionSolver(seed + b)`` bit for bit;
2. ``spatial``: :func:`..parallel.spatial.sharded_cost_aggregation` of a
   16N x 40 image against :func:`..ops.guided.filter_image`;
3. ``volume``: :class:`..parallel.volume.ShardedVolumeSolver` (1 + 1) on
   an 8N x 36 x 6 problem, equal to the single-device solve bit for bit,
   the shard at most ``hq + 2 halo`` rows high;
4. ``replica``: :class:`..parallel.replica.ReplicaSolver`, one pair a
   rank's device, pairs 0 and N-1 equal to the single-pair solves;
5. ``dvolume``: :class:`..parallel.dvolume.ShardedDVolumeSolver` on the
   problem of 3, within the JAX check's tolerance of the single-device
   solve (and whether it is bitwise), ``dq + 2`` planes a rank.

With ``--solve SCALE``, then the single-device, height- and
disparity-sharded solves of ``utils.synthetic.build_problem(SCALE)`` (the
main path's problem at 1.0) at 2 + 5 with the main path's parameters:
seconds, the collectives' seconds and bytes, whether each equals the
single-device solve bit for bit.

With ``--scale``, then the at-scale slice of ``tools/sharded_volume_scale.py``
(default 2880 x 1988 x 400, uint8, disparity-sharded over the N ranks): a
chunked init, then one greedy color step of the fine layer; each rank's
resident volume bytes against the whole padded pair's, its peak device
memory and the state's checksum (equal on every rank).
"""
from __future__ import annotations

import argparse
import hashlib
import json
import sys
import time
from typing import List

import numpy as np
import torch

from ..config import PARAMS_GF
from ..models import engine
from ..ops import guided, kernels, rng
from ..parallel import collectives
from ..parallel.batch import BatchedSolver
from ..parallel.dvolume import ShardedDVolumeSolver
from ..parallel.replica import ReplicaSolver
from ..parallel.spatial import sharded_cost_aggregation
from ..parallel.volume import ShardedVolumeSolver

#: The JAX check's tolerance of the disparity-sharded labels against the
#: single-device ones (``__graft_entry__.py:233-235``).
DSHARD_ATOL, DSHARD_RTOL = 5e-4, 1e-3
#: The spatial aggregation against the whole-image filter.
SPATIAL_ATOL = 1e-5
PARAMS = PARAMS_GF.replace(windR=4, lambda_=0.5, th_col=0.5)


def devices_for(ranks: int, kind: str) -> List[str]:
    """Rank i's device: ``cuda:{i % cards}``, or the CPU."""
    if kind == "cpu":
        return ["cpu"] * ranks
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards == 0:
        raise RuntimeError("no CUDA device (pass --device cpu)")
    return [f"cuda:{i % cards}" for i in range(ranks)]


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class EnergyLog:
    """Evaluator hook: view 0's total energy after the init and each
    sweep."""

    def __init__(self):
        self.energies: List[float] = []

    def start(self):
        pass

    def stop(self):
        pass

    def evaluate(self, solver, labeling_m, cost_m, mode, index):
        if mode == 0:
            self.energies.append(float(engine.energy_audit(
                solver.data, solver.cfg, labeling_m, cost_m, mode)[0]))


def digest(*tensors) -> str:
    """A hash of the tensors' bytes: equal states give equal digests."""
    h = hashlib.sha1()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def small_problem(h: int, w: int, nd: int, seed: int):
    """(image, volume) of the JAX dry run's solver checks."""
    r = np.random.default_rng(seed)
    img = (r.random((h, w, 3)) * 255).astype(np.float32)
    dd = np.arange(nd, dtype=np.float32)[:, None, None]
    d_true = r.random((h, w), np.float32) * (nd - 1)
    vol = np.minimum(np.abs(dd - d_true[None]) * 0.4, 1.0).astype(np.float32)
    return img, vol


def make_solver(cls, img, vol, max_disp: float, unit_sizes, device, seed,
                params=PARAMS, im1=None, **kw):
    """``cls`` on (img, ``im1`` or img) with ``vol`` as both views'
    volume, the reference's layer proposers."""
    s = cls(img, img if im1 is None else im1, params, max_disp=max_disp,
            vol0=vol, vol1=vol, seed=seed, device=device, **kw)
    for i, size in enumerate(unit_sizes):
        s.add_layer(size, engine.LAYER0_PROPOSERS if i == 0
                    else engine.COARSE_PROPOSERS)
    return s


def solve(rank, device, kind: str, img, vol, max_disp: float, unit_sizes,
          seed: int, schedule=(1, 1), params=PARAMS, **kw):
    """One solve on this rank: ``kind`` "single" (the engine), "volume"
    (height-sharded) or "dvolume" (disparity-sharded). Returns the labels,
    view 0's cost state, the energies after the init and each sweep (rank
    0 of a sharded solve; every rank of a single one), seconds, the
    collectives' traffic, the kernels' launches in the run (the counts
    set to 0 just before it), the resident volume and the peak memory."""
    cls = {"single": engine.LocalExpansionSolver,
           "volume": ShardedVolumeSolver,
           "dvolume": ShardedDVolumeSolver}[kind]
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    s = make_solver(cls, img, vol, max_disp, unit_sizes, dev, seed, params,
                    **kw)
    log = EnergyLog()
    s.set_evaluator(log)
    t0 = time.perf_counter()
    s.finalize()
    _sync(dev)
    build_s = time.perf_counter() - t0
    before = dict(collectives.traffic)
    kernels.zero_launch_counts()
    t0 = time.perf_counter()
    lab, _ = s.run(schedule[1], pm_iterations=schedule[0])
    _sync(dev)
    out = {"labels": lab, "cost": s._state[0][1], "energies": log.energies,
           "build_s": build_s, "solve_s": time.perf_counter() - t0,
           "launches": kernels.launch_counts(),
           "vol_shape": list(s.data.vol.shape),
           "vol_bytes": s.data.vol.numel() * s.data.vol.element_size(),
           "peak_gib": (torch.cuda.max_memory_allocated(dev) / 2 ** 30
                        if dev.type == "cuda" else None)}
    out.update({f"collective_{k}": collectives.traffic[k] - before[k]
                for k in before})
    if kind == "volume":
        out.update(hq=s.hq, halo=s.halo)
    if kind == "dvolume":
        out.update(dq=s.dq)
    return out


def solve_single(img, vol, max_disp, unit_sizes, seed, device, **kw):
    """The single-device solve of :func:`solve` in this process."""
    return collectives.to_host(solve(0, device, "single", img, vol,
                                      max_disp, unit_sizes, seed, **kw))


# ------------------------------------------------------------ the checks --

def _data_rank(rank, device, ims0, ims1, vols, max_disp):
    bs = BatchedSolver(ims0, ims1, PARAMS, max_disp, [4], device=device,
                       vols0=vols, vols1=vols, seed=0, vol_dtype="float32")
    state = bs.init()
    (_, _, _), mean0 = bs.energies(state)
    state = bs.sweep(state, 0, do_gc=False)
    state = bs.sweep(state, 0, do_gc=True)
    (tot, _, _), mean1 = bs.energies(state)
    final, _ = bs.run(1, pm_iterations=1)
    return {"tot": tot, "mean0": mean0, "mean1": mean1, "final": final,
            "disp": bs.disparities()}


def check_data(devices):
    n = len(devices)
    r = np.random.default_rng(0)
    h, w, nd = 24, 32, 6
    ims = (r.random((n, h, w + 8, 3)) * 255).astype(np.float32)
    vols = np.stack([small_problem(h, w, nd, 10 + b)[1] for b in range(n)])
    outs = collectives.launch(_data_rank, devices, ims[:, :, :w],
                              ims[:, :, 3:3 + w], vols, float(nd - 1),
                              timeout_s=600)
    for o in outs[1:]:
        assert np.array_equal(o["final"], outs[0]["final"]), "ranks differ"
    o = outs[0]
    assert o["disp"].shape == (n, h, w) and np.isfinite(o["disp"]).all()
    assert abs(o["mean1"] - float(np.mean(o["tot"].astype(np.float64)))) \
        <= 1e-9 * abs(o["mean1"])
    assert o["mean1"] < o["mean0"], (o["mean0"], o["mean1"])
    for b in (0, n - 1):
        single = make_solver(engine.LocalExpansionSolver, ims[b, :, :w],
                             vols[b], float(nd - 1), [4], devices[0], b,
                             im1=ims[b, :, 3:3 + w], vol_dtype="float32")
        lab, _ = single.run(1, pm_iterations=1)
        assert np.array_equal(o["final"][b], lab.cpu().numpy()), b
    return {"check": "data", "pairs": n, "mean_energy": [o["mean0"],
                                                          o["mean1"]],
            "pairs_equal_single": True}


def _spatial_rank(rank, device, img, p, radius):
    """The rank's rows of the aggregation (the image's statistics computed
    on every rank, as the energy's are), and its seconds."""
    n = collectives.world()
    stats = guided.compute_stats(torch.as_tensor(img, device=device), radius,
                                 1e-4)

    def block(a):
        return collectives.row_block(torch.as_tensor(a, device=device), rank,
                                     n)
    _sync(device)
    t0 = time.perf_counter()
    q = sharded_cost_aggregation(block(p), block(stats.guide),
                                 block(stats.mean), block(stats.inv), radius)
    _sync(device)
    return {"q": q, "seconds": time.perf_counter() - t0}


def spatial_case(devices, h: int, w: int, radius: int, seed: int = 1):
    """The sharded aggregation of an [h, w] cost over ``devices`` against
    the whole-image filter on ``devices[0]``: the max abs error, the
    ranks' seconds in the aggregation and the whole filter's."""
    r = np.random.default_rng(seed)
    img = (r.random((h, w, 3)) * 255).astype(np.float32)
    p = r.random((h, w)).astype(np.float32)
    dev = torch.device(devices[0])
    stats = guided.compute_stats(torch.as_tensor(img, device=dev), radius,
                                 1e-4)
    pd = torch.as_tensor(p, device=dev)
    guided.filter_image(pd, stats, radius)
    _sync(dev)
    t0 = time.perf_counter()
    want = guided.filter_image(pd, stats, radius)
    _sync(dev)
    whole_s = time.perf_counter() - t0
    outs = collectives.launch(_spatial_rank, devices, img, p, radius,
                              timeout_s=600)
    got = np.concatenate([o["q"] for o in outs])
    return {"max_abs_err": float(np.abs(got - want.cpu().numpy()).max()),
            "ranks_s": [o["seconds"] for o in outs], "whole_s": whole_s}


def check_spatial(devices):
    row = spatial_case(devices, 16 * len(devices), 40, 3)
    assert row["max_abs_err"] <= SPATIAL_ATOL, row
    return {"check": "spatial", **row}


def _solver_problem(n):
    img, vol = small_problem(8 * n, 36, 6, 3)
    return img, vol, 5.0


def check_volume(devices):
    img, vol, md = _solver_problem(len(devices))
    ref = collectives.launch(solve, devices[:1], "single", img, vol, md,
                             [3], 3, timeout_s=600)[0]
    outs = collectives.launch(solve, devices, "volume", img, vol, md, [3],
                              3, timeout_s=600)
    for o in outs:
        assert np.array_equal(o["labels"], ref["labels"])
        assert np.array_equal(o["cost"], ref["cost"])
        assert o["vol_shape"][2] <= o["hq"] + 2 * o["halo"]
    return {"check": "volume", "bitwise": True,
            "shard_rows": outs[0]["vol_shape"][2]}


def check_replica(devices):
    n = len(devices)
    r = np.random.default_rng(5)
    h, w, nd = 20, 28, 5
    ims = (r.random((n, h, w, 3)) * 255).astype(np.float32)
    vols = np.stack([small_problem(h, w, nd, 20 + b)[1] for b in range(n)])
    rs = ReplicaSolver(ims, ims, PARAMS, float(nd - 1), [3], devices=devices,
                       vols0=vols, vols1=vols, seed=5, vol_dtype="float32")
    final, _ = rs.run(1, pm_iterations=1)
    for b in (0, n - 1):
        s = make_solver(engine.LocalExpansionSolver, ims[b], vols[b],
                        float(nd - 1), [3], devices[b], 5 + b,
                        vol_dtype="float32")
        lab, _ = s.run(1, pm_iterations=1)
        assert np.array_equal(final[b], lab.cpu().numpy()), b
    return {"check": "replica", "pairs": n, "pairs_equal_single": True}


def check_dvolume(devices):
    img, vol, md = _solver_problem(len(devices))
    ref = collectives.launch(solve, devices[:1], "single", img, vol, md,
                             [3], 3, timeout_s=600)[0]
    outs = collectives.launch(solve, devices, "dvolume", img, vol, md, [3],
                              3, timeout_s=600)
    for o in outs:
        assert np.array_equal(o["labels"], outs[0]["labels"])
        assert o["vol_shape"][1] == o["dq"] + 2
    np.testing.assert_allclose(outs[0]["labels"], ref["labels"],
                               atol=DSHARD_ATOL, rtol=DSHARD_RTOL)
    return {"check": "dvolume", "planes": outs[0]["vol_shape"][1],
            "bitwise": bool(np.array_equal(outs[0]["labels"],
                                           ref["labels"]))}


CHECKS = (check_data, check_spatial, check_volume, check_replica,
          check_dvolume)


def _synthetic_solve(rank, device, kind, scale, schedule):
    from ..utils import synthetic
    img, vol, _, w, nd, _ = synthetic.build_problem(scale)
    sizes = [max(1, int(w * f)) for f in (0.01, 0.03, 0.09)]
    params = PARAMS_GF.replace(windR=20, lambda_=0.5, th_col=0.5)
    return solve(rank, device, kind, img, vol, float(nd - 1), sizes, 0,
                 schedule, params)


def check_solves(devices, scale: float, schedule=(2, 5)):
    """The main path's solve at ``scale``, single-device on
    ``devices[0]``, then height- and disparity-sharded over ``devices``:
    one row each (rank 0's numbers, every rank's state equal)."""
    rows = []
    ref = collectives.launch(_synthetic_solve, devices[:1], "single", scale,
                             schedule, timeout_s=1200)[0]
    for kind in ("single", "volume", "dvolume"):
        outs = [ref] if kind == "single" else collectives.launch(
            _synthetic_solve, devices, kind, scale, schedule,
            timeout_s=1200)
        for o in outs:
            assert np.array_equal(o["labels"], outs[0]["labels"])
        o = outs[0]
        rows.append({
            "check": "solve", "kind": kind, "ranks": len(outs),
            "bitwise": bool(np.array_equal(o["labels"], ref["labels"])),
            **{k: o[k] for k in ("solve_s", "build_s", "energies",
                                 "vol_bytes", "peak_gib", "launches",
                                 "collective_calls", "collective_bytes",
                                 "collective_seconds")}})
    return rows


# -------------------------------------------------------- the at-scale slice --

class PlaneSource:
    """The at-scale volume, made a plane at a time on a device, only where
    it is read (``build_energy`` slices its leading axes): the JAX tool's
    basin around ``d = 0.08 x + 0.01 y`` plus noise, each plane's noise
    from its own seed, so that every rank makes the same planes."""

    def __init__(self, h: int, w: int, nd: int, device, seed: int = 0):
        self.shape = (nd, h, w)
        self.device = torch.device(device)
        self.seed = seed

    def plane(self, d: int) -> torch.Tensor:
        h, w = self.shape[1:]
        ys = torch.arange(h, dtype=torch.float32, device=self.device)
        xs = torch.arange(w, dtype=torch.float32, device=self.device)
        d_true = torch.clamp(0.08 * xs[None] + 0.01 * ys[:, None], 0,
                             self.shape[0] - 1)
        gen = torch.Generator(self.device).manual_seed(
            self.seed * 1_000_003 + d)
        noise = torch.rand((h, w), generator=gen, device=self.device)
        return torch.clamp(torch.abs(d - d_true) * 0.15, max=1.0) \
            + noise * 0.05

    def __getitem__(self, key):
        key = key if isinstance(key, tuple) else (key,)
        planes = range(self.shape[0])[key[0]]
        out = torch.stack([self.plane(d) for d in planes]) if len(planes) \
            else torch.empty((0,) + self.shape[1:], device=self.device)
        return out[(slice(None),) + key[1:]]


def _scale_rank(rank, device, h, w, nd, init_chunk, colors):
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    img = (np.random.default_rng(0).random((h, w, 3)) * 255).astype(
        np.float32)
    vol = PlaneSource(h, w, nd, dev)
    params = PARAMS_GF.replace(windR=20, lambda_=0.5, th_col=0.5)
    sizes = [max(1, int(w * f)) for f in (0.01, 0.03, 0.09)]
    s = make_solver(ShardedDVolumeSolver, img, vol, float(nd - 1), sizes,
                    dev, 0, params, init_row_chunk=init_chunk)
    t0 = time.perf_counter()
    s.finalize()
    _sync(dev)
    build_s = time.perf_counter() - t0
    root = rng.PRNGKey(0)
    t0 = time.perf_counter()
    lab, cost = s._init_state(rng.fold_in(root, 1000), 0)
    _sync(dev)
    init_s = time.perf_counter() - t0
    layer = s.layers[0]
    plan, dzs, nrs = s._layer_inputs(0, 0)
    launches = []
    t0 = time.perf_counter()
    for ci, (i0, j0) in enumerate(layer.colors[:colors]):
        ox, oy, rmask = layer.color_regions(i0, j0)
        cox, coy = layer.canvas_origin(i0, j0)
        engine._color_body(
            s.data, s.cfg, lab, cost,
            torch.as_tensor(ox, dtype=torch.int64, device=dev),
            torch.as_tensor(oy, dtype=torch.int64, device=dev),
            torch.as_tensor(rmask, device=dev), cox, coy, dzs, nrs,
            rng.fold_in(root, ci), unit_size=layer.unit_size, nbx=layer.nbx,
            nby=layer.nby, plan=plan, do_gc=False, mode=0, dshard=s.dshard)
        launches.append(len(plan))
    _sync(dev)
    step_s = time.perf_counter() - t0
    hp, wp = s.data.vol.shape[2:]
    return {"rank": rank, "device": str(dev), "backend": collectives.backend(),
            "unit_sizes": sizes, "dq": s.dq, "planes": s.data.vol.shape[1],
            "vol_bytes": s.data.vol.numel() * s.data.vol.element_size(),
            "whole_vol_bytes": 2 * nd * hp * wp, "build_s": build_s,
            "init_s": init_s, "color_steps": colors, "step_s": step_s,
            "proposals": sum(launches),
            "mean_cost": float(cost.double().mean()),
            "digest": digest(lab, cost),
            "peak_gib": (torch.cuda.max_memory_allocated(dev) / 2 ** 30
                         if dev.type == "cuda" else None)}


def scale_slice(devices, h: int = 1988, w: int = 2880, nd: int = 400,
                init_chunk: int = 16, colors: int = 1):
    """The at-scale slice over ``devices``: each rank's row; the ranks'
    states must be equal."""
    rows = collectives.launch(_scale_rank, devices, h, w, nd, init_chunk,
                              colors, timeout_s=1200)
    if len({r["digest"] for r in rows}) != 1:
        raise AssertionError(f"ranks' states differ: {rows}")
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--scale", action="store_true",
                    help="also run the at-scale slice")
    ap.add_argument("--solve", type=float, default=0.0,
                    help="also solve the main path's problem at this scale")
    ap.add_argument("--height", type=int, default=1988)
    ap.add_argument("--width", type=int, default=2880)
    ap.add_argument("--ndisp", type=int, default=400)
    ap.add_argument("--init-chunk", type=int, default=16)
    ap.add_argument("--colors", type=int, default=1)
    ns = ap.parse_args(argv)
    devices = devices_for(ns.ranks, ns.device)
    print(json.dumps({"devices": devices,
                      "backend": collectives.choose_backend(devices)}),
          flush=True)
    for check in CHECKS:
        t0 = time.perf_counter()
        row = check(devices)
        row["seconds"] = time.perf_counter() - t0
        print(json.dumps(row), flush=True)
    if ns.solve:
        for row in check_solves(devices, ns.solve):
            print(json.dumps(row), flush=True)
    if ns.scale:
        for row in scale_slice(devices, ns.height, ns.width, ns.ndisp,
                               ns.init_chunk, ns.colors):
            print(json.dumps({"check": "scale", **row}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
