"""The yardstick's arithmetic: the H100's published peaks, the least time a
piece of work can take on them, and the work of the expansion moves and of
the MC-CNN volume counted from the configuration alone (never from
launches, plans or rounds that the program happens to run).

Peaks: NVIDIA's H100 SXM data sheet, dense rates: 3.35 TB/s of HBM3 and
67 TFLOP/s of float32 outside the tensor cores, at the full 700 W power
limit (the run reports the card's limit beside every share).
"""
from __future__ import annotations

HBM_BYTES_S = 3.35e12
F32_OPS_S = 67e12
#: float32 operations of the expansion move's graph construction a
#: forward edge of its 8-neighbour grid: its tables, t-links, graph build
#: and energy guard, 320 a pixel over the 4 forward edges a pixel.
OPS_PER_EDGE = 80


def bound_s(nbytes: float, nops: float) -> float:
    """The least seconds the card needs to move ``nbytes`` and do
    ``nops`` float32 operations."""
    return max(nbytes / HBM_BYTES_S, nops / F32_OPS_S)


def random_count(k_max: int, outer_iter: int, min_disp: float,
                 max_disp: float) -> int:
    """Perturbation proposals of a sweep: they stop once the step
    ``(max - min) 0.5^(iter + k + 1)`` falls under 0.1 (the reference
    C++'s ``Proposer.h:149-152``)."""
    count = 0
    for k in range(k_max):
        if (max_disp - min_disp) * 0.5 ** (outer_iter + k + 1) < 0.1:
            break
        count += 1
    return count


def plan_length(proposers, outer_iter: int, min_disp: float,
                max_disp: float) -> int:
    """Proposals a region of a layer evaluates in one sweep."""
    n = 0
    for name in proposers:
        if name.startswith("random"):
            n += random_count(int(name[len("random"):]), outer_iter,
                              min_disp, max_disp)
        else:
            n += 1
    return n


def cells(config: dict, s: int) -> int:
    """Cells of unit size ``s`` on the frame: every region of a layer is one
    cell's 3s x 3s move window, and its 16 colours cover each cell once."""
    return -(-config["width"] // s) * -(-config["height"] // s)


def forward_edges(n: int) -> int:
    """Forward 8-neighbour edges inside an n x n window."""
    return 2 * n * (n - 1) + 2 * (n - 1) ** 2


def expansion_region(s: int):
    """(bytes, operations) of one region's expansion move, window S = 3s:
    its inputs read once (labels with a 1-px halo, the proposal, the
    window's origin, 8 pairwise weights, current and proposed costs a
    pixel) and its accept mask written once; the graph's construction a
    forward edge. No push-relabel work: that depends on the inputs and on
    the implementation."""
    S = 3 * s
    nbytes = ((S + 2) ** 2 * 4 * 4 + 4 * 4 + 2 * 4
              + 8 * S * S * 4 + 2 * S * S * 4 + S * S)
    return nbytes, OPS_PER_EDGE * forward_edges(S)


def sweeps(config: dict, kind: str):
    """[(outer_iter, graph-cut?)] of one frame of ``kind`` ("cold" or
    "warm"), as the configuration's schedule states."""
    sched = config["schedule"][kind]
    return ([(it, False) for it in range(sched["greedy"])]
            + [(it, True) for it in range(sched["graph_cut"])])


def expansion_bound_s(config: dict, kind: str) -> float:
    """The least seconds of every expansion move of one frame."""
    lo, hi = 0.0, float(config["ndisp"] - 1)
    total = 0.0
    for it, gc in sweeps(config, kind):
        if not gc:
            continue
        for s, props in zip(config["unit_sizes"], config["proposers"]):
            nbytes, nops = expansion_region(s)
            moves = plan_length(props, it, lo, hi) * cells(config, s)
            total += moves * bound_s(nbytes, nops)
    return total


def mccnn_work(config: dict):
    """(bytes, operations) of one pair's MC-CNN volume: both towers'
    multiply-adds over both images and the correlation's, the images read
    and the volume written once."""
    h, w, nd = config["height"], config["width"], config["ndisp"]
    spec = config["mccnn"]
    taps = spec["kernel"] ** 2
    c_in = c0 = spec["in_channels"]
    ops = 0
    for c_out in spec["channels"]:
        ops += 2 * taps * c_in * c_out
        c_in = c_out
    return 2 * h * w * c0 * 4 + nd * h * w * 4, h * w * (2 * ops
                                                         + 2 * nd * c_in)


def mccnn_bound_s(config: dict) -> float:
    return bound_s(*mccnn_work(config))
