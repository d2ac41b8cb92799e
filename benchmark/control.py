"""The correctness check's control and planted faults, read on the card at
a cell's own size (the benchmark's own runs never run this).

    python3 benchmark/control.py --workload adirondack_h.cold_pairs2 \\
        --seeds 11 12 13 --frames 2

For each seed it sets the cell's client up as a run does, solves
``--frames`` frames (no window: every frame completes), and prints one JSON
line:

- ``sound``: each number of the check for the program's frames (the lower
  readings);
- ``control``: each number with the reference, one precision lower, in the
  program's place (``check``'s ``control``): float32 guide statistics and
  bfloat16 weights for float64 / float32, 4-bit volume codes for 8-bit,
  a bfloat16 unary, map and expansion move (its terms computed in
  bfloat16 and cut by the reference's max-flow) for float32, the MC-CNN
  with TF32 for float32 without; ``correct`` must come out false;
- ``faults``: ``energy_ratio`` and ``cut_gap`` of one more frame solved
  with a fault planted in the program: ``unchanged`` (every sweep returns
  the state it was given) and ``half`` (the accept kernels reject the
  moves of the second half of each colour's regions).
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import importlib
import json
import math
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def _half(accept_fn):
    """``accept_fn`` with the moves of the second half of the regions
    rejected (its attributes, such as a launch counter, carried over)."""
    @functools.wraps(accept_fn)
    def half(*args, **kwargs):
        accept = accept_fn(*args, **kwargs).clone()
        accept[accept.shape[0] // 2:] = False
        return accept
    return half


@contextlib.contextmanager
def planted(fault: str):
    """The program with ``fault`` planted, for the block: in the solver's
    sweep, or where the accept masks are produced (the kernels' modules)."""
    from localexpstereo_tpu_torch.models import engine
    from localexpstereo_tpu_torch.ops import mincut, mincut_cuda
    saved = (engine.LocalExpansionSolver._sweep, mincut_cuda.expansion_accept,
             mincut.greedy_accept)
    if fault == "unchanged":
        engine.LocalExpansionSolver._sweep = lambda self, *a, **k: None
    elif fault == "half":
        mincut_cuda.expansion_accept = _half(saved[1])
        mincut.greedy_accept = _half(saved[2])
    else:
        raise ValueError(fault)
    try:
        yield
    finally:
        (engine.LocalExpansionSolver._sweep, mincut_cuda.expansion_accept,
         mincut.greedy_accept) = saved


def read_seed(workload: str, seed: int, frames: int, device: str = "cuda",
              config_overrides=None, faults=("unchanged", "half")) -> dict:
    """The sound, control and fault readings of one seed."""
    import torch

    from benchmark import check, run

    _, cell, config, traffic = run.load_cell(workload)
    config = dict(config, **(config_overrides or {}))
    client = importlib.import_module(
        f"benchmark.clients.{traffic['client']}").Client(
            config, traffic, seed, device, False)
    client.setup()
    for k in range(frames):
        client.keep(client.frame(k, math.inf, False))
    faulty = {}
    for i, fault in enumerate(faults):
        with planted(fault):
            rec = client.frame(frames + i, math.inf, False)
        rec["labeling"] = rec["labeling"].clone()
        faulty[fault] = rec
    client.release()
    if device == "cuda":
        torch.cuda.empty_cache()
    lims = check.limits(cell["config"])
    out = {"workload": workload, "seed": seed, "frames": frames}
    for name, control in (("sound", False), ("control", True)):
        readings = check.worst(client.check(control))
        ok, _ = check.verdict(readings, {k: v for k, v in lims.items()
                                         if k in readings})
        out[name] = dict(readings, correct=ok)
    out["faults"] = {
        f: {"energy_ratio": client.ratio(rec),
            "cut_gap": check.cut_number(rec["moves"],
                                        client.pair_reference(rec), False)}
        for f, rec in faulty.items()}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--frames", type=int, default=1)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("the control runs on a CUDA card", file=sys.stderr)
        return 2
    for seed in args.seeds:
        print(json.dumps(read_seed(args.workload, seed, args.frames)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
