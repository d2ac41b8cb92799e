"""The replica cell on the CPU: its client through the harness's run on two
CPU worker processes at a tiny size, the readers of the workers' traces on
a synthetic two-card trace, and the twin check against planted faults of
the router (another frame's map; a frame solved with the next seed) and
against the control."""
import json
import math
import pathlib

import numpy as np
import pytest
import torch

from benchmark import check, readers, run, replica_trace
from benchmark.clients import replica as client_mod

ROOT = pathlib.Path(__file__).resolve().parents[2]
CELL = "adirondack_h_replica4.cold_stream4"
ENERGY = {"windR": 6, "lambda": 0.5, "th_col": 0.5, "th_smooth": 1.0,
          "omega": 10.0, "epsilon": 0.01, "gf_eps": 0.0001}
TINY = {"height": 48, "width": 200, "ndisp": 16, "unit_sizes": [2, 6, 18],
        "energy": ENERGY, "replicas": 2,
        "argv": ["-mode", "MiddV3", "-smooth_weight", "0.5", "-iterations",
                 "1", "-pmIterations", "1", "-filterRadius", "6"],
        "schedule": {"cold": {"greedy": 1, "graph_cut": 1}}}
SEED = 2 ** 33 + 29
PHASES = ("color", "rng", "proposal", "unary", "accept", "write")
R4 = ("device_idle.r4", "peak_gib.r4", "handover_s.r4", "return_s.r4",
      "solve_s.r4", "handover_gib.r4", "device_ops.r4", "sweep_syncs.r4") \
    + tuple(f"idle_{p}_s.r4" for p in PHASES)
#: The readers that read the frames' stamps, which every run has.
STAMPED = ("handover_s.r4", "return_s.r4", "solve_s.r4")


def test_a_run_on_two_cpu_workers():
    torch.set_num_threads(1)
    result, _ = run.run_cell(CELL, SEED, 25.0, False, device="cpu",
                             config_overrides=TINY)
    assert result["attempted"] >= 2
    assert result["correct"], result["checks"]
    assert set(result["checks"]) == {"build_gap", "vol_codes", "unary_gap",
                                     "map_gap", "cut_gap", "energy_ratio"}
    assert set(result["metrics"]) == {"setup_s", "frame_s"}


def test_the_cell_declares_its_metrics():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = {w["name"]: w for w in bench["workloads"]}[CELL]
    assert cell["chips"] == 4
    names = [m["name"] for m in run.cell_metrics(bench, CELL, "per_layer")]
    assert names == list(R4)
    assert [m["name"] for m in run.cell_metrics(bench, CELL, "end_to_end")] \
        == ["setup_s", "frame_s"]


def test_a_program_without_the_pool_is_refused(monkeypatch):
    from localexpstereo_tpu_torch.parallel import replica
    monkeypatch.delattr(replica, "ReplicaPool")
    _, _, config, traffic = run.load_cell(CELL)
    with pytest.raises(RuntimeError, match="no standing replica pool"):
        client_mod.Client(dict(config, **TINY), traffic, SEED, "cpu", False)


def _row(name, start, end, parent=-1, syncs=0, b=None):
    return (name, {} if b is None else {"b": b}, start, end, parent, 1,
            syncs)


def _synthetic(with_ops=True):
    """Two cards over the window [0, 10]: card 0 busy [1, 4] and [6, 7]
    (idle 0.6), card 1 busy [0, 5] (idle 0.5; an op after the close);
    frame 0 on card 0 ([0.5, 8.5]: build at 1.6, solve [2, 7]), frame 1 on
    card 1 ([0.7, 9.2]: build at 2.0, solve [2.5, 8]); card 0's warm-up
    sweep comes before any pair. Inside the frames, card 0 idles [4, 6]
    under ``unary`` (a sweep with 3 syncs, of which 2 in the ``unary``
    span) and [7, 8.5] outside any phase; card 1 idles [5, 6] under
    ``color`` and [6, 9.2] under ``rng`` (a sweep with 1 sync)."""
    workers = [
        {"worker": 0, "peak_bytes": 2 * 2 ** 30,
         "ops": (["k"], np.zeros(3, np.int32), np.array([1.0, 2.0, 6.0]),
                 np.array([3.0, 4.0, 7.0])),
         "spans": [_row("sweep", 0.1, 0.2, syncs=5),
                   _row("replica.receive", 0.9, 1.5, b=0),
                   _row("solve", 2.0, 7.0),
                   _row("sweep", 3.0, 6.5, parent=2, syncs=1),
                   _row("unary", 3.5, 6.2, parent=3, syncs=2),
                   _row("replica.return", 7.1, 7.3, b=0)]},
        {"worker": 1, "peak_bytes": 3 * 2 ** 30,
         "ops": (["k"], np.zeros(2, np.int32), np.array([0.0, 11.0]),
                 np.array([5.0, 12.0])),
         "spans": [_row("replica.receive", 1.0, 1.8, b=1),
                   _row("sweep", 2.5, 9.5, syncs=1),
                   _row("color", 4.0, 6.0, parent=1),
                   _row("rng", 6.0, 9.5, parent=1)]}]
    if not with_ops:
        for w in workers:
            del w["ops"], w["spans"]
    stamps = [{"submit": (0.5, 0.6), "build": (1.6, 2.0),
               "solve": (2.0, 7.0), "collect": (8.0, 8.5)},
              {"submit": (0.7, 0.8), "build": (2.0, 2.5),
               "solve": (2.5, 8.0), "collect": (9.0, 9.2)}]
    shared = {"workers": workers,
              "counts": {"submitted": 2, "bytes_in": 3 * 2 ** 30}}
    frames = [{"start": s, "end": e, "marks": [],
               "timings": dict(shared, b=b, worker=b, stamps=stamps[b])}
              for b, (s, e) in enumerate(((0.5, 8.5), (0.7, 9.2)))]
    return readers.Run(config={}, kind="cold", frames=frames, t0=0.0,
                       t1=10.0, device=None, peak_bytes=0)


@pytest.mark.parametrize("name,want", [
    ("device_idle.r4", 55.0), ("peak_gib.r4", 3.0), ("handover_s.r4", 1.2),
    ("return_s.r4", 1.35), ("solve_s.r4", 5.25), ("handover_gib.r4", 1.5),
    ("device_ops.r4", 1.5), ("sweep_syncs.r4", 2.0),
    ("idle_unary_s.r4", 1.0), ("idle_color_s.r4", 0.5),
    ("idle_rng_s.r4", 1.6), ("idle_proposal_s.r4", 0.0),
    ("idle_accept_s.r4", 0.0), ("idle_write_s.r4", 0.0)])
def test_readers_on_a_synthetic_two_card_trace(name, want):
    assert run.reader(name)(_synthetic()) == pytest.approx(want)


@pytest.mark.parametrize("name", R4)
def test_readers_find_nothing_without_the_workers(name):
    bare = _synthetic()
    for f in bare.frames:
        f["timings"] = {"b": 0, "worker": 0}
    assert run.reader(name)(bare) is None
    untraced = run.reader(name)(_synthetic(with_ops=False))
    assert (untraced is None) is (name not in ("peak_gib.r4",
                                               "handover_gib.r4") + STAMPED)


def test_a_worker_whose_spans_were_dropped_is_not_read():
    r = _synthetic()
    r.frames[0]["timings"]["workers"][1]["dropped"] = 4
    assert replica_trace.idle_by_phase(r) is None
    assert replica_trace.sweep_syncs(r) is None


@pytest.fixture(scope="module")
def frames():
    """A client of the tiny cell on two CPU workers: four sound frames,
    then frames until one comes from a router that solves frame k with the
    next seed (handed over as k + 1, its result handed back as k)."""
    torch.set_num_threads(1)
    _, _, config, traffic = run.load_cell(CELL)
    c = client_mod.Client(dict(config, **TINY), traffic, SEED, "cpu", False)
    c.setup()

    def landed(k):
        rec = c.frame(k, math.inf, False)
        c.keep(rec)
        return rec
    try:
        sound = [landed(k) for k in range(4)]
        submit, next_result = c.pool.submit, c.pool.next_result
        moved = set()

        def shifted(b, *args, **kwargs):
            moved.add(b + 1)
            return submit(b + 1, *args, **kwargs)

        def back(timeout=None):
            got = next_result(timeout)
            if got is not None and got["b"] in moved:
                got["b"] -= 1
            return got
        c.pool.submit, c.pool.next_result = shifted, back
        faulty = []
        while not any(r["k"] + 1 in moved for r in faulty):
            faulty.append(landed(len(sound) + len(faulty)))
        faulty = [r for r in faulty if r["k"] + 1 in moved]
    finally:
        c.release()
    return c, sound, faulty


@pytest.mark.parametrize("fault", ["sound", "other_map", "next_seed"])
def test_twin_gap_fails_for_a_planted_fault(frames, fault):
    c, sound, faulty = frames
    if fault == "sound":
        rec = sound[0]
    elif fault == "other_map":
        other = next(r for r in sound if r["pair"] != sound[0]["pair"])
        rec = dict(sound[0], labeling=other["labeling"], disp=other["disp"])
    else:
        rec = faulty[0]
    c.frames, c._twin = [rec], None
    rows = c.check()
    twin = rows[-1]
    ok, table = check.verdict(check.worst(rows), check.limits(c.config[
        "name"]))
    assert (twin["twin_gap"] == 0) is (fault == "sound")
    assert ok is (fault == "sound"), table


def test_the_control_fails_the_twins_numbers(frames):
    c, sound, _ = frames
    c.frames, c._twin = [sound[0]], None
    readings = check.worst(c.check(control=True))
    lims = check.limits(c.config["name"])
    ok, table = check.verdict(readings, lims)
    assert not ok
    failed = {k for k, (got, lim) in table.items()
              if got is not None and got > lim}
    assert {"build_gap", "unary_gap", "map_gap"} <= failed, table
