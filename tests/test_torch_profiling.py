"""The port's tracing (``utils/profiling.py``): the span recorder, its sync
counter, its on/off rule, the Chrome trace of a profiled block, and the
spans of a tiny solve and of a stream's frame."""
import contextlib
import json
import time
import warnings

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from localexpstereo_tpu_torch.config import PARAMS_GF
from localexpstereo_tpu_torch.models import engine
from localexpstereo_tpu_torch.serving import StereoStream
from localexpstereo_tpu_torch.utils import profiling, synthetic

PARAMS = PARAMS_GF.replace(windR=6, lambda_=0.5, th_col=0.5)
#: The tiny solve: 16 x 24 px, 4 disparities, layers of 8 and 16 px cells
#: with the reference's proposer sets, 1 greedy + 1 graph-cut sweep.
H, W, ND = 16, 24, 4
SIZES = (8, 16)
PHASES = ("proposal", "unary", "accept", "write")


@contextlib.contextmanager
def _profiled():
    """A profiler window, closed for the recorder by a span after it."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        yield prof
    with profiling.span("off"):
        pass


def _by_name(recs):
    out = {}
    for r in recs:
        out.setdefault(r.name, []).append(r)
    return out


def test_spans_nest_with_parents_and_attributes():
    with _profiled():
        for i in range(3):
            with profiling.span("solve", index=i):
                with profiling.span("sweep", kind="greedy"):
                    time.sleep(0.002)
    recs = profiling.records()
    assert [r.name for r in recs] == ["solve", "sweep"] * 3
    for i in range(3):
        outer, inner = recs[2 * i], recs[2 * i + 1]
        assert outer.parent == -1 and outer.attrs == {"index": i}
        assert inner.parent == 2 * i and inner.attrs == {"kind": "greedy"}
        assert outer.start <= inner.start < inner.end <= outer.end
        assert inner.end - inner.start >= 0.002
        assert not outer.raised and outer.syncs == 0
    assert len({r.thread for r in recs}) == 1
    assert profiling.counts() == {"dropped": 0, "syncs_outside": 0}


def test_a_raising_span_is_closed_and_marked():
    with _profiled():
        with pytest.raises(ValueError):
            with profiling.span("outer"):
                with profiling.span("fails"):
                    raise ValueError
        with profiling.span("after"):
            pass
    outer, fails, after = profiling.records()
    assert fails.raised and outer.raised and not after.raised
    assert fails.end >= fails.start and outer.end >= fails.end
    # The raising spans left the stack: the next one is at the top.
    assert after.parent == -1


def test_recorder_off_records_nothing():
    with _profiled():
        with profiling.span("kept"):
            pass
    kept = profiling.records()
    off = profiling.span("off", a=1)
    assert off is profiling.span("other")
    with off:
        pass
    assert profiling.records() == kept
    assert [r.name for r in kept] == ["kept"]


def test_the_first_span_after_a_window_restores_the_warnings():
    show = warnings.showwarning
    filters = list(warnings.filters)
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("on"):
            assert warnings.showwarning is not show
            assert warnings.filters[0][1].pattern == profiling.SYNC_MESSAGE
    with profiling.span("off"):
        pass
    assert warnings.showwarning is show
    assert warnings.filters == filters


def test_sync_warnings_are_counted_in_their_span_and_not_shown():
    with warnings.catch_warnings(record=True) as shown:
        warnings.simplefilter("default")
        with _profiled():
            with profiling.span("outer"):
                for _ in range(2):
                    warnings.warn(profiling.SYNC_MESSAGE
                                  + " (from a test)")
                with profiling.span("inner"):
                    warnings.warn(profiling.SYNC_MESSAGE)
                warnings.warn("another warning")
            warnings.warn(profiling.SYNC_MESSAGE)
    outer, inner = profiling.records()
    assert (outer.syncs, inner.syncs) == (2, 1)
    assert profiling.counts()["syncs_outside"] == 1
    assert [str(w.message) for w in shown] == ["another warning"]


def test_sync_warnings_after_the_window_are_neither_counted_nor_shown():
    with warnings.catch_warnings(record=True) as shown:
        warnings.simplefilter("default")
        with profile(activities=[ProfilerActivity.CPU]):
            with profiling.span("inside"):
                warnings.warn(profiling.SYNC_MESSAGE)
        # The window has ended; no span has run since to restore the mode.
        warnings.warn(profiling.SYNC_MESSAGE)
        with profiling.span("off"):
            pass
    (inside,) = profiling.records()
    assert inside.syncs == 1
    assert profiling.counts()["syncs_outside"] == 0
    assert shown == []


def test_the_cap_counts_drops(monkeypatch):
    monkeypatch.setattr(profiling, "CAP", 3)
    with _profiled():
        with profiling.span("top"):
            for _ in range(4):
                with profiling.span("child"):
                    pass
    assert [r.name for r in profiling.records()] == ["top", "child",
                                                     "child"]
    assert profiling.counts()["dropped"] == 2


def test_trace_writes_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "t")) as prof:
        with profiling.span("phase"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    events = json.loads((tmp_path / "t" / "trace.json").read_text())
    names = [e.get("name", "") for e in events["traceEvents"]]
    assert any("mm" in n for n in names)
    assert "phase" in names
    assert any("mm" in a.key for a in prof.key_averages())
    assert [r.name for r in profiling.records()] == ["phase"]


def _solve():
    img, vol, _, _, _, _ = synthetic.planted_problem(H, W, ND)
    solver = engine.LocalExpansionSolver(img, img, PARAMS, ND - 1, vol0=vol,
                                         vol1=vol, device="cpu")
    for li, size in enumerate(SIZES):
        solver.add_layer(size, engine.LAYER0_PROPOSERS if li == 0
                         else engine.COARSE_PROPOSERS)
    labeling, _ = solver.run(1, pm_iterations=1)
    return solver, labeling


@pytest.fixture(scope="module")
def solves():
    torch.set_num_threads(1)
    before = profiling.records()
    show = warnings.showwarning
    _, off = _solve()
    untouched = (profiling.records() == before
                 and warnings.showwarning is show)
    with _profiled():
        solver, on = _solve()
    recs = profiling.records()
    return solver, off, on, recs, untouched


def test_solve_without_a_profiler_records_nothing(solves):
    assert solves[4]


def test_solve_with_the_recorder_on_is_bitwise_equal(solves):
    _, off, on, _, _ = solves
    assert torch.equal(off, on)


def test_solve_spans_follow_the_plan(solves):
    solver, _, _, recs, _ = solves
    by = _by_name(recs)
    assert [len(by[n]) for n in ("solve", "build", "init")] == [1, 1, 1]
    sweeps = by["sweep"]
    assert [(s.attrs["kind"], s.attrs["index"], s.attrs["view"])
            for s in sweeps] == [("greedy", 1, 0), ("graph_cut", 2, 0)]
    for it, sweep in enumerate(sweeps):
        inside = [r for r in recs if sweep.start <= r.start < sweep.end]
        kinds = _by_name(inside)
        plans = [solver._layer_inputs(li, 0)[0]
                 for li in range(len(SIZES))]
        colors = sum(len(layer.colors) for layer in solver.layers)
        steps = [p[0] for li, layer in enumerate(solver.layers)
                 for _ in layer.colors for p in plans[li]]
        assert len(kinds["color"]) == colors
        for phase in PHASES:
            assert len(kinds[phase]) == len(steps), phase
        assert [r.attrs["kind"] for r in kinds["proposal"]] == steps
        kernel = "greedy" if it == 0 else "expansion"
        assert {r.attrs["kernel"] for r in kinds["accept"]} == {kernel}
        assert ({(r.attrs["S"], r.attrs["N"]) for r in kinds["accept"]}
                == {(3 * layer.unit_size, layer.nby * layer.nbx)
                    for layer in solver.layers})
        assert len(kinds["rng"]) >= len(steps) + colors


def test_solve_spans_lie_inside_their_parents(solves):
    _, _, _, recs, _ = solves
    parents = {"solve": None, "build": "solve", "init": "solve",
               "sweep": "solve", "color": "sweep", "proposal": "color",
               "unary": "color", "accept": "color", "write": "color"}
    for r in recs:
        p = recs[r.parent] if r.parent >= 0 else None
        if r.name == "rng":
            assert p.name in ("solve", "init", "sweep", "color", "proposal")
        else:
            assert (p.name if p else None) == parents[r.name], r.name
        if p is not None:
            assert p.start <= r.start <= r.end <= p.end
        assert not r.raised and r.syncs == 0


def test_stream_records_its_phases_without_profile():
    img, vol, _, _, _, _ = synthetic.planted_problem(H, W, ND)
    stream = StereoStream(PARAMS, max_disp=float(ND - 1), unit_sizes=[8],
                          layer_proposers=[("expansion",)],
                          cold_iterations=1, cold_pm_iterations=0,
                          device="cpu")
    with _profiled():
        disp = stream.process(img, img, vol, vol)
    recs = profiling.records()
    top = [r.name for r in recs if r.parent == -1]
    assert top == ["stream.build", "stream.solve", "stream.output"]
    solve, = (r for r in recs if r.name == "solve")
    assert recs[solve.parent].name == "stream.solve"
    assert stream.last_timings is None
    assert disp.shape == (H, W) and np.isfinite(disp).all()
