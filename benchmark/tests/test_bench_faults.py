"""The harness's run on the CPU at a tiny size, the look for a card
skipped: sound, it comes out correct; with the timed path broken
underneath, or with the control in the program's place, it does not.

Each case is one run of about half a minute (a frame of the tiny problem
takes some seconds on one CPU thread); the sound one goes first, so that a
false result below is the fault's and not the size's."""
import pytest
import torch

from benchmark import control, run

ENERGY = {"windR": 6, "lambda": 0.5, "th_col": 0.5, "th_smooth": 1.0,
          "omega": 10.0, "epsilon": 0.01, "gf_eps": 0.0001}
COLD = ("adirondack_h.cold_pairs2", {
    "height": 48, "width": 200, "ndisp": 16, "unit_sizes": [2, 6, 18],
    "energy": ENERGY,
    "argv": ["-mode", "MiddV3", "-smooth_weight", "0.5", "-iterations", "1",
             "-pmIterations", "1", "-filterRadius", "6"],
    "schedule": {"cold": {"greedy": 1, "graph_cut": 1}}})
WARM = ("video_h.warm_pan", {
    "height": 48, "width": 96, "ndisp": 16, "unit_sizes": [2, 4, 8],
    "energy": ENERGY,
    "schedule": {"cold": {"greedy": 1, "graph_cut": 1},
                 "warm": {"greedy": 0, "graph_cut": 1}}})
SEED = 2 ** 33 + 17


def _run(cell, seconds=25.0):
    torch.set_num_threads(2)
    result, _ = run.run_cell(cell[0], SEED, seconds, False, device="cpu",
                             config_overrides=cell[1])
    return result


@pytest.mark.parametrize("cell", [COLD, WARM], ids=["cold", "warm"])
def test_sound_run_is_correct(cell):
    result = _run(cell)
    assert result["attempted"] >= 1
    assert result["correct"], result["checks"]


def test_sweeps_that_return_their_state_fail():
    with control.planted("unchanged"):
        result = _run(COLD)
    assert not result["correct"]
    assert result["checks"]["energy_ratio"][0] > \
        result["checks"]["energy_ratio"][1]


@pytest.mark.parametrize("cell", [COLD, WARM], ids=["cold", "warm"])
def test_half_the_regions_left_out_fail(cell):
    with control.planted("half"):
        result = _run(cell, seconds=60.0)
    assert result["attempted"] >= 1
    assert not result["correct"]
    assert result["checks"]["cut_gap"][0] > result["checks"]["cut_gap"][1]


def test_an_altered_map_fails(monkeypatch):
    from localexpstereo_tpu_torch.ops import plane
    real = plane.disparity_map

    def altered(labeling, *a, **k):
        disp = real(labeling, *a, **k).clone()
        disp[3, 5] += 0.25
        return disp
    monkeypatch.setattr(plane, "disparity_map", altered)
    result = _run(COLD)
    assert not result["correct"]
    assert result["checks"]["map_gap"][0] >= 0.2


def test_an_altered_volume_fails(monkeypatch):
    from localexpstereo_tpu_torch.models import mccnn
    real = mccnn.cost_volume

    def altered(*a, **k):
        vol = real(*a, **k)
        vol[3] += 0.05
        return vol
    monkeypatch.setattr(mccnn, "cost_volume", altered)
    result = _run(WARM)
    assert not result["correct"]
    assert result["checks"]["volume_gap"][0] >= 0.04


def test_a_stream_that_returns_its_state_fails(monkeypatch):
    from localexpstereo_tpu_torch import serving
    real = serving.StereoStream.process
    calls = []

    def stale(self, *a, **k):
        calls.append(1)
        if len(calls) <= 2:                 # the set-up's frames
            return real(self, *a, **k)
        return None
    monkeypatch.setattr(serving.StereoStream, "process", stale)
    result = _run(WARM, seconds=5.0)
    assert not result["correct"]


@pytest.mark.parametrize("cell", [COLD, WARM], ids=["cold", "warm"])
def test_the_control_fails(cell):
    torch.set_num_threads(2)
    out = control.read_seed(cell[0], SEED, 1, device="cpu",
                            config_overrides=cell[1], faults=())
    assert out["sound"]["correct"]
    assert not out["control"]["correct"]
