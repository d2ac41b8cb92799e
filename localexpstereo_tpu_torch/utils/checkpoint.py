"""Checkpoint / resume of the optimization state (copy of
``localexpstereo_tpu.utils.checkpoint``; numpy only).

The reference has no checkpointing; its optimizer can only warm-start from
a labeling (``FastGCStereo.h:117-130``). Here the full mutable state — each
view's padded labeling and unary cost (``currentLabeling_m_`` /
``currentCost_``, ``PMStereoBase.h:44-49``), the RNG seed and the sweep
counters — round-trips through one ``.npz``. The keys are the JAX
package's (``labeling_{mode}``, ``cost_{mode}``, ``seed``, ``pm_done``,
``gc_done``, ``pad``, ``modes``), so a checkpoint written by either
package resumes in the other.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np


@dataclasses.dataclass
class Checkpoint:
    labeling: Dict[int, np.ndarray]   # mode -> [Hp, Wp, 4]
    cost: Dict[int, np.ndarray]       # mode -> [Hp, Wp]
    seed: int
    pm_iterations_done: int
    iterations_done: int
    pad: int


def save_checkpoint(path: str, state: Dict[int, Tuple], seed: int,
                    pm_done: int, gc_done: int, pad: int) -> None:
    """``state``: mode -> (labeling_m, cost_m) as host arrays."""
    arrays = {}
    for mode, (labeling_m, cost_m) in state.items():
        arrays[f"labeling_{mode}"] = np.asarray(labeling_m)
        arrays[f"cost_{mode}"] = np.asarray(cost_m)
    np.savez_compressed(
        path, seed=seed, pm_done=pm_done, gc_done=gc_done, pad=pad,
        modes=np.asarray(sorted(state.keys()), np.int32), **arrays)


def load_checkpoint(path: str) -> Checkpoint:
    with np.load(path) as z:
        modes = [int(m) for m in z["modes"]]
        return Checkpoint(
            labeling={m: z[f"labeling_{m}"] for m in modes},
            cost={m: z[f"cost_{m}"] for m in modes},
            seed=int(z["seed"]),
            pm_iterations_done=int(z["pm_done"]),
            iterations_done=int(z["gc_done"]),
            pad=int(z["pad"]),
        )
