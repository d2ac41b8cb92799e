"""Times the fused unary kernel (``ops/unary_cuda.sample_windows``) of this
checkout, or of another checkout of the port, on one CUDA card::

    python -m localexpstereo_tpu_torch.tools.unary_times [--tree DIR]

Inputs are those of ``chip_smoke.py``'s ``unary_kernel`` phase, made by this
checkout (:func:`..utils.synthetic.unary_windows` on the 1436 x 992 x 145
problem): one color of each layer, (F, N) = (62, 468), (149, 54), (407, 6),
raw and guided-filtered (r 10). With ``--tree DIR`` the calls go to the
package of the checkout at DIR, loaded under another name, with its own
sources and build directory: two versions of the kernel compared in one
process on one card.

Prints the card's name and power limit, then one JSON line per (F, r):
``ms``, the median of 5 single calls between two CUDA events (what
``chip_smoke.py`` reports, host work of the wrapper included); ``ms_x20``,
the median of 3 runs of 20 calls back to back, over 20; and ``device_ms``,
each device kernel's time per call by name and their sum, from
torch.profiler over 5 calls (a call of an older kernel made several
launches: this splits its time by pass).
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import pathlib
import statistics
import subprocess
import sys

import numpy as np
import torch

from ..utils import synthetic

PKG = "localexpstereo_tpu_torch"


def unary_module(tree: str | None):
    """``ops.unary_cuda`` of this checkout, or of the checkout at ``tree``
    (its package loaded as ``other_localexpstereo_tpu_torch``)."""
    if tree is None:
        return importlib.import_module(f"{PKG}.ops.unary_cuda")
    root = pathlib.Path(tree).resolve() / PKG
    name = f"other_{PKG}"
    spec = importlib.util.spec_from_file_location(
        name, root / "__init__.py", submodule_search_locations=[str(root)])
    pkg = importlib.util.module_from_spec(spec)
    sys.modules[name] = pkg
    spec.loader.exec_module(pkg)
    return importlib.import_module(f"{name}.ops.unary_cuda")


def events_ms(fn, calls: int = 1, reps: int = 5) -> float:
    """Median milliseconds a call of ``fn`` over ``reps`` runs of ``calls``
    calls back to back between two CUDA events (one warm-up call first)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return statistics.median(times)


def device_ms(fn, calls: int = 5) -> dict:
    """Each device kernel's milliseconds a call of ``fn`` by name, and their
    sum ("total"), from torch.profiler over ``calls`` calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            key = e.name[:60]
            by_name[key] = by_name.get(key, 0.0) + e.device_time_total / 1e3
    out = {k: v / calls for k, v in sorted(by_name.items())}
    out["total"] = sum(out.values())
    return out


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--tree", help="a checkout of the port to time "
                                       "in place of this one")
    args = parser.parse_args(argv)
    unary = unary_module(args.tree)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    solver, truth, _ = synthetic.bench_solver(1.0, "cuda")
    solver.finalize()
    data, cfg = solver.data, solver.cfg
    rng = np.random.default_rng(0)
    for layer in solver.layers:
        props, fox, foy, f = synthetic.unary_windows(solver, truth, layer,
                                                     rng)
        for r in (0, cfg.params.guided_radius):
            kw = dict(min_disp=cfg.min_disp, th_col=cfg.params.th_col,
                      scale=cfg.vol_scale, zero=cfg.vol_zero,
                      stats=(data.guide[0], data.gf_mean[0], data.gf_inv[0]),
                      pad=cfg.pad, r_gf=r)

            def call():
                return unary.sample_windows(
                    data.vol[0], cfg.vol_pad, props, fox, foy, f,
                    cfg.height, cfg.width, **kw)
            print(json.dumps({
                "tree": args.tree or ".", "F": f, "N": props.shape[0],
                "r_gf": r, "ms": events_ms(call, 1, 5),
                "ms_x20": events_ms(call, 20, 3),
                "device_ms": device_ms(call)}), flush=True)


if __name__ == "__main__":
    main()
