"""The roofline's work is counted from the configuration alone."""
import json
import pathlib

import pytest

from benchmark import roofline

ROOT = pathlib.Path(__file__).resolve().parents[2]
CONFIG = json.loads((ROOT / "benchmark/configs/adirondack_h.json")
                    .read_text())


def test_plan_lengths_follow_the_perturbation_schedule():
    layer0 = CONFIG["proposers"][0]
    # 144 * 0.5^(it + k + 1) >= 0.1 keeps k <= 9 - it, at most 7.
    assert [roofline.plan_length(layer0, it, 0.0, 144.0)
            for it in range(5)] == [9, 9, 9, 9, 8]
    assert roofline.plan_length(CONFIG["proposers"][1], 0, 0.0, 144.0) == 3


def test_plan_lengths_equal_the_programs_plans():
    from localexpstereo_tpu_torch.models import engine
    for props in CONFIG["proposers"]:
        for it in range(5):
            assert roofline.plan_length(props, it, 0.0, 144.0) == len(
                engine.make_plan(props, it, 0.0, 144.0))


def test_moves_of_a_cold_frame_are_one_per_cell_and_plan_step():
    cells = [roofline.cells(CONFIG, s) for s in CONFIG["unit_sizes"]]
    assert cells == [103 * 71, 34 * 24, 12 * 8]
    # 5 graph-cut sweeps: 9 + 9 + 9 + 9 + 8 proposals at layer 0, 3 a sweep
    # at the others; every proposal moves every cell's region once.
    by_hand = 0.0
    for s, steps in zip(CONFIG["unit_sizes"], (44, 15, 15)):
        nbytes, nops = roofline.expansion_region(s)
        by_hand += steps * roofline.cells(CONFIG, s) * roofline.bound_s(
            nbytes, nops)
    assert roofline.expansion_bound_s(CONFIG, "cold") == pytest.approx(
        by_hand)


def test_a_region_reads_its_inputs_once():
    nbytes, nops = roofline.expansion_region(14)
    S = 42
    assert nbytes == 44 * 44 * 16 + 24 + 8 * S * S * 4 + 2 * S * S * 4 \
        + S * S
    assert nops == roofline.OPS_PER_EDGE * (2 * S * (S - 1)
                                            + 2 * (S - 1) ** 2)


def test_bounds_do_not_depend_on_what_the_program_launches():
    from localexpstereo_tpu_torch.models import engine
    before = roofline.expansion_bound_s(CONFIG, "cold")
    knobs = engine.mincut_knobs
    engine.mincut_knobs = lambda ss: (1, 1)
    try:
        assert roofline.expansion_bound_s(CONFIG, "cold") == before
    finally:
        engine.mincut_knobs = knobs


def test_mccnn_work():
    cfg = {"height": 10, "width": 20, "ndisp": 8,
           "mccnn": {"in_channels": 1, "channels": [64, 64, 64, 64, 64],
                     "kernel": 3}}
    nbytes, nops = roofline.mccnn_work(cfg)
    tower = 2 * 9 * (1 * 64 + 4 * 64 * 64)
    assert nops == 200 * (2 * tower + 2 * 8 * 64)
    assert nbytes == 2 * 200 * 4 + 8 * 200 * 4
