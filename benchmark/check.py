"""How ``correct`` is decided: what the timed path produced, held against
the plain reference (:mod:`.reference`), number by number, each against a
limit of its own (``limits/<config>.json``).

The numbers, each taken as the worst over the frames checked:

- ``build_gap``: the energy build's guide means, inverse covariances and
  pairwise weights at sampled pixels, against the reference's (largest
  gap over the largest value, per array);
- ``vol_codes``: the stored volume's uint8 codes at sampled positions,
  against the reference's quantization of the float volume the frame was
  handed (largest difference in codes; exact);
- ``unary_gap``: the init's unary at sampled layer-0 cells (the first
  costs the solve computes, under its own labels), against the
  reference's evaluation of the same label over the same cell window
  (largest gap over ``th_col``);
- ``map_gap``: the disparity map that reached the host, against ``a x + b
  y + c`` of the final labeling, in pixels;
- ``cut_gap``: at expansion moves captured inside the window (a few a
  frame, drawn from the seed: :class:`.clients.common.MoveCapture`), how
  far the energy of the kernel's accept mask lies above the reference's
  least energy of the same move (:mod:`.reference.cut`), the move's terms
  worked out again from the labels, the proposal, the image's weights and
  the window's unaries, in energy units;
- ``energy_ratio``: the reference's energy of the final labeling over the
  reference's energy of the planted truth (each truth label valid where it
  lies: :func:`..reference.energy.valid_or_flat`): how far the solve's
  result lies above the truth;
- ``volume_gap`` (a configuration that computes its volume): the MC-CNN
  volume at sampled positions against the reference network's.

The control (``control=True``) puts the reference, computed one precision
lower, in the program's place for every number that it can compute.

``unary_gap`` and ``cut_gap`` follow the program from its own state: the
labels a cell or a move starts from, and for ``cut_gap`` the unaries the
move weighs (the state's costs and the proposal's, computed as the init's
are, which ``unary_gap`` checks).
"""
from __future__ import annotations

import json
import pathlib
import sys
from typing import Dict, List

import numpy as np
import torch

from .reference import cut
from .reference import energy as ref

ORDER = ("build_gap", "vol_codes", "unary_gap", "map_gap", "cut_gap",
         "energy_ratio", "volume_gap")
LIMITS_DIR = pathlib.Path(__file__).resolve().parent / "limits"


def limits(config_name: str) -> Dict[str, float]:
    with open(LIMITS_DIR / f"{config_name}.json") as f:
        return json.load(f)["limits"]


class PairReference:
    """The reference's build of one image pair: guide statistics and
    pairwise weights of the left view, and the quantized volume for the
    energy (built on first use)."""

    def __init__(self, im0: torch.Tensor, p: ref.Params):
        self.im0 = im0
        self.p = p
        self.stats = ref.guide_stats(im0, p.radius, p.gf_eps)
        self.weights = ref.weights(im0, p.omega, p.epsilon)

    def energy(self, labeling: torch.Tensor, codes, scale) -> float:
        data = ref.pixel_data_cost(codes, scale, labeling, self.stats, self.p)
        return float(data + ref.smoothness(labeling, self.weights, self.p))

    def truth_energy(self, labels, codes, scale) -> float:
        """The energy of a planted truth's labels [H, W, 4] (host)."""
        lab = torch.as_tensor(labels, device=self.im0.device)
        return self.energy(ref.valid_or_flat(lab, self.p), codes, scale)


def build_numbers(kept: dict, samples, pr: PairReference,
                  code_floats: torch.Tensor, control: bool
                  ) -> Dict[str, float]:
    """``build_gap`` and ``vol_codes`` of one frame; ``code_floats`` are
    the float volume's values at the sampled positions."""
    p = pr.p
    b = kept["built"]
    smp_y, smp_x = samples.py, samples.px
    want_mean = pr.stats.mean[smp_y, smp_x]
    want_inv = pr.stats.inv[smp_y, smp_x]
    want_w = pr.weights[:, smp_y, smp_x]
    if control:
        low = ref.guide_stats(pr.im0, p.radius, p.gf_eps, torch.float32)
        got_mean, got_inv = low.mean[smp_y, smp_x], low.inv[smp_y, smp_x]
        got_w = ref.weights(pr.im0, p.omega, p.epsilon,
                            torch.bfloat16)[:, smp_y, smp_x]
    else:
        got_mean, got_inv, got_w = b["mean"], b["inv"], b["weights"]
    build = max(ref.relative_gap(got_mean, want_mean),
                ref.relative_gap(got_inv, want_inv),
                ref.relative_gap(got_w, want_w))
    codes, _ = ref.quantize(code_floats, p.th_col)
    if control:
        hi = 2.0 * p.th_col
        got = torch.round(code_floats.clamp(0.0, hi) / (hi / 15.0)) * 17.0
    else:
        got = b["codes"].to(torch.float32)
    vol_codes = float((got - codes.to(torch.float32)).abs().max())
    return {"build_gap": build, "vol_codes": vol_codes}


def unary_number(kept: dict, samples, pr: PairReference,
                 control: bool) -> float:
    """``unary_gap`` of one frame."""
    p = pr.p
    args = (kept["vol_windows"], kept["init_labels"], samples.cell_x,
            samples.cell_y, samples.s, pr.stats, p, samples.shape)
    want = ref.cell_unary(*args)
    got = (ref.cell_unary(*args, dtype=torch.bfloat16) if control
           else kept["init_costs"])
    return float((got.to(torch.float64) - want).abs().max()) / p.th_col


def map_number(labeling: torch.Tensor, disp: np.ndarray,
               control: bool) -> float:
    """``map_gap`` of one frame."""
    want = ref.disparity(labeling)
    got = (ref.disparity(labeling, torch.bfloat16) if control
           else torch.as_tensor(disp, device=labeling.device))
    return float((got.to(torch.float64) - want).abs().max())


def _weights_at(wts: torch.Tensor, tox: int, toy: int, g: int) -> np.ndarray:
    """[8, g, g] of the image's weights [8, H, W] from (tox - 1, toy - 1),
    0 outside the image."""
    h, w = wts.shape[1:]
    ys = torch.arange(g, device=wts.device) + toy - 1
    xs = torch.arange(g, device=wts.device) + tox - 1
    inside = ((ys >= 0) & (ys < h))[:, None] & ((xs >= 0) & (xs < w))[None]
    win = wts[:, ys.clamp(0, h - 1)][:, :, xs.clamp(0, w - 1)]
    return (win * inside).cpu().numpy()


def cut_number(moves, pr: PairReference, control: bool):
    """``cut_gap`` of one frame's captured moves (None where it has none);
    the control judges the reference's own cut of the move's terms
    computed in bfloat16."""
    if not moves:
        return None
    p = pr.p
    out = -np.inf
    for m in moves:
        halo = m["halo"].cpu().numpy()
        tox, toy = (int(v) for v in m["origin"].cpu().tolist())
        args = (halo, m["alpha"].cpu().numpy(), tox, toy,
                m["u0"].cpu().numpy(), m["u1"].cpu().numpy(),
                _weights_at(pr.weights, tox, toy, halo.shape[0]),
                p.lambda_, p.th_smooth)
        x = (cut.min_cut(cut.move_terms(*args, dtype=torch.bfloat16))
             if control else m["accept"].cpu().numpy())
        out = max(out, cut.gap(cut.move_terms(*args), x))
    return float(out)


def energy_ratio(labeling: torch.Tensor, e_truth: float,
                 pr: PairReference, codes, scale) -> float:
    """The reference's energy of ``labeling`` over ``e_truth`` (the
    planted truth's)."""
    return pr.energy(labeling, codes, scale) / e_truth


def complete(kept: dict, disp) -> bool:
    """Whether a frame left what the check reads: the init's samples and a
    map on the host. A frame that solved nothing leaves none of it, and
    fails every number."""
    return all(k in kept for k in ("built", "init_costs")) \
        and disp is not None


def missing() -> Dict[str, float]:
    return {name: float("inf") for name in ORDER}


def worst(rows: List[Dict[str, float]]) -> Dict[str, float]:
    """Each number's worst reading over the frames."""
    out: Dict[str, float] = {}
    for row in rows:
        for k, v in row.items():
            if v is not None:
                out[k] = max(out.get(k, -np.inf), v)
    return out


def verdict(readings: Dict[str, float], lims: Dict[str, float]):
    """(correct, {name: [reading, limit]}) in :data:`ORDER`. A reading
    that is not finite, or a number of the limits that no frame read,
    fails."""
    table = {}
    ok = True
    for name in ORDER:
        if name not in lims:
            continue
        got = readings.get(name)
        table[name] = [got, lims[name]]
        if got is None or not np.isfinite(got) or got > lims[name]:
            ok = False
    return ok, table


def report(table: Dict[str, list]) -> None:
    """Each number beside its limit, as the last lines on standard
    error."""
    for name, (got, lim) in table.items():
        print(f"check {name} {got!r} limit {lim!r}", file=sys.stderr,
              flush=True)
