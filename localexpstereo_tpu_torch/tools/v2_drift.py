"""How far the port's V2 (image-warp) solve on one CUDA card drifts from
the same solve on the CPU::

    python -m localexpstereo_tpu_torch.tools.v2_drift

1. ``sizes``: the small V2 solve of :func:`..utils.synthetic.v2_solver`
   (layers [4, 8, 16], windR 20, 1 greedy + 1 graph-cut sweep) on the card
   and on the CPU, at a few sizes, views and ``max_vdisp``: one JSON line
   each, with every view's energies and their relative gap after each
   sweep (the small phase of ``chip_smoke.py`` holds the gap to 0.002).
2. ``shared``: from one init state (the CPU's, copied to the card), one
   greedy sweep on each device, every proposal, unary and accept mask of
   its color steps recorded: the first steps that differ and by how much,
   the labelings' and energies' gap after the sweep. Then the random draws
   alone on the same inputs (``same_inputs``): the init's random labels
   drawn on the card against the CPU's, and each of the CPU sweep's random
   perturbation calls run again on the card with the CPU's inputs, each
   with its largest gap (0.0 when the two devices round alike). With the
   proposals computed as ``ops/xla_math`` and ``csrc/refit_sums.cu`` do,
   no step differs (``chip_smoke.py``'s ``proposals`` phase requires it).

Prints the card's name and power limit first. Exits 2 without a card.
"""
from __future__ import annotations

import json
import subprocess
import sys

import torch

from ..models import energy, engine, proposals
from ..ops import mincut, rng
from ..utils import synthetic

#: (height, width, disparities, views, max_vdisp) of the size sweep.
CASES = ((48, 72, 16, (0,), 0.0), (64, 96, 24, (0,), 0.0),
         (64, 96, 24, (0, 1), 0.0), (96, 144, 24, (0,), 0.0),
         (96, 144, 24, (0, 1), 0.0), (96, 144, 24, (0,), 1.0))
LAYERS = [4, 8, 16]


class _Energies:
    """Evaluator hook: every view's total energy after the init and each
    sweep."""

    def __init__(self, modes):
        self.rows = {m: [] for m in modes}

    def start(self):
        pass

    def stop(self):
        pass

    def evaluate(self, solver, labeling_m, cost_m, mode, index):
        self.rows[mode].append(float(engine.energy_audit(
            solver.data, solver.cfg, labeling_m, cost_m, mode)[0]))


def sizes():
    for h, w, nd, modes, max_vdisp in CASES:
        out = {}
        for device in ("cuda", "cpu"):
            solver, _, _, _ = synthetic.v2_solver(h, w, nd, device,
                                                  sizes=LAYERS,
                                                  max_vdisp=max_vdisp)
            rec = _Energies(modes)
            solver.set_evaluator(rec)
            solver.run(iterations=1, view_modes=modes, pm_iterations=1)
            out[device] = rec.rows
        gap = {m: [abs(a - b) / abs(b) for a, b in
                   zip(out["cuda"][m][1:], out["cpu"][m][1:])]
               for m in modes}
        print(json.dumps({"part": "sizes", "shape": [h, w, nd],
                          "view_modes": list(modes), "max_vdisp": max_vdisp,
                          "energies_cuda": out["cuda"],
                          "energies_cpu": out["cpu"], "relative_gap": gap}),
              flush=True)


def shared(h: int = 48, w: int = 72, nd: int = 16, steps: int = 6) -> dict:
    """One greedy sweep from one shared state on each device; prints and
    returns the row."""
    solvers = {}
    for device in ("cuda", "cpu"):
        solvers[device], _, _, _ = synthetic.v2_solver(h, w, nd, device,
                                                       sizes=LAYERS)
        solvers[device].finalize()
    cpu = solvers["cpu"]
    state = engine.init_step(cpu.data, cpu.cfg,
                             rng.fold_in(rng.PRNGKey(0), 1000),
                             unit_size=LAYERS[0], mode=0)
    init_labeling = state[0].clone()        # the sweep writes the state
    states = {"cpu": state, "cuda": tuple(x.cuda() for x in state)}
    trace = {"cpu": [], "cuda": []}
    saved = {name: getattr(proposals, name)
             for name in ("expansion", "ransac", "random_perturbation")}
    saved_unary, saved_greedy = energy.unary_windows, mincut.greedy_accept

    perturbations = []      # the CPU's calls: (args, kwargs, output)

    def recorded(name, fn):
        def wrapper(*args, **kwargs):
            out = fn(*args, **kwargs)
            trace[out.device.type].append((name, out.to("cpu", copy=True)))
            if name == "random_perturbation" and out.device.type == "cpu":
                perturbations.append((args, kwargs, out))
            return out
        return wrapper

    for name, fn in saved.items():
        setattr(proposals, name, recorded(name, fn))
    energy.unary_windows = recorded("unary", saved_unary)
    mincut.greedy_accept = recorded("accept", saved_greedy)
    try:
        key = rng.fold_in(rng.PRNGKey(0), 2000)
        for device, solver in solvers.items():
            solver._sweep(states[device], 0, 0, False, key)
    finally:
        for name, fn in saved.items():
            setattr(proposals, name, fn)
        energy.unary_windows, mincut.greedy_accept = saved_unary, saved_greedy
    differ = []
    for i, ((name, a), (_, b)) in enumerate(zip(trace["cuda"],
                                                trace["cpu"])):
        if a.dtype == torch.bool:
            gap = float((a != b).double().mean())      # share flipped
        else:
            gap = float((a.double() - b.double()).abs().nan_to_num().max())
        if gap > 0 and len(differ) < steps:
            differ.append([i, name, gap])
    energies = {d: float(engine.energy_audit(s.data, s.cfg, *states[d],
                                             0)[0])
                for d, s in solvers.items()}
    lab_gap = float((states["cuda"][0].cpu() - states["cpu"][0]).abs().max())

    def on_card(x):
        return x.cuda() if torch.is_tensor(x) else x

    card = solvers["cuda"]
    init_gap = float((engine.init_step(
        card.data, card.cfg, rng.fold_in(rng.PRNGKey(0), 1000),
        unit_size=LAYERS[0], mode=0)[0].cpu() - init_labeling).abs().max())
    perturb_gaps = [
        float((saved["random_perturbation"](
            args[0], *map(on_card, args[1:]),
            **{k: on_card(v) for k, v in kwargs.items()}).cpu()
            - out).abs().max())
        for args, kwargs, out in perturbations]
    row = {"part": "shared", "shape": [h, w, nd],
           "steps": len(trace["cpu"]), "first_differing": differ,
           "labeling_max_gap": lab_gap, "energies": energies,
           "same_inputs": {
               "init_labeling_max_gap": init_gap,
               "random_perturbation_calls": len(perturb_gaps),
               "random_perturbation_max_gap": max(perturb_gaps),
               "random_perturbation_differing": sum(
                   g > 0 for g in perturb_gaps)}}
    print(json.dumps(row), flush=True)
    return row


def main() -> int:
    if not torch.cuda.is_available():
        print("v2_drift: needs a CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    shared()
    sizes()
    return 0


if __name__ == "__main__":
    sys.exit(main())
