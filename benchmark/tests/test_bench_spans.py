"""The card's idle time charged to the program's spans, and the syncs of
its sweeps, on a synthetic device trace with hand-placed spans."""
import json
import pathlib

import numpy as np
import pytest

from benchmark import readers, run, spans

ROOT = pathlib.Path(__file__).resolve().parents[2]
SOLVER, OTHER = 1, 2

#: (name, start, end, parent, thread, syncs), in the order they opened:
#: one completed frame [1, 9] and, from 10, a frame the window's close
#: (20) dropped, whose spans are still open at the close.
RECORDS = [
    ("solve", 1.0, 9.0, -1, SOLVER, 0),        # 0
    ("sweep", 2.0, 8.5, 0, SOLVER, 1),         # 1
    ("color", 2.0, 8.0, 1, SOLVER, 2),         # 2
    ("rng", 2.5, 3.0, 2, SOLVER, 0),           # 3
    ("proposal", 3.0, 5.0, 2, SOLVER, 3),      # 4
    ("rng", 3.5, 4.0, 4, SOLVER, 0),           # 5
    ("accept", 5.0, 7.0, 2, SOLVER, 4),        # 6
    ("write", 7.0, 7.5, 2, SOLVER, 0),         # 7
    ("proposal", 1.0, 9.0, -1, OTHER, 7),      # 8: another thread
    ("solve", 10.0, 20.0, -1, SOLVER, 0),      # 9: the dropped frame
    ("sweep", 11.0, 20.0, 9, SOLVER, 5),       # 10
    ("color", 11.0, 20.0, 10, SOLVER, 6),      # 11
]
#: The card's ops: busy [1, 2.2], [2.8, 3.6], [4.5, 6], [7.2, 7.8],
#: [8.4, 9.5] and, in the dropped frame, [12, 13].
OPS = [(1.0, 2.2), (2.8, 3.6), (4.5, 6.0), (7.2, 7.8), (8.4, 9.5),
       (12.0, 13.0)]
#: Idle seconds of the completed frame by innermost span: the gap
#: [2.2, 2.8] crosses the edge of color and rng (0.3 each), [3.6, 4.5]
#: the edges rng / proposal (0.4, 0.5), [6, 7.2] accept / write (1.0,
#: 0.2), [7.8, 8.4] color / sweep (0.2, 0.4).
IDLE = {"color": 0.5, "rng": 0.7, "proposal": 0.5, "unary": 0.0,
        "accept": 1.0, "write": 0.2}


class _Trace:
    def __init__(self, ops):
        self.names, self.name_id = ["op"], np.zeros(len(ops), np.int32)
        self.start_s = np.array([s for s, _ in ops])
        self.end_s = np.array([e for _, e in ops])


def _spans(records=RECORDS):
    cols = list(zip(*records))
    return spans.Spans(name=np.array(cols[0]), start=np.array(cols[1]),
                       end=np.array(cols[2]), parent=np.array(cols[3]),
                       thread=np.array(cols[4]), syncs=np.array(cols[5]))


def _run(kind="cold", device=True, frames=((1.0, 9.0),)):
    return readers.Run(config={}, kind=kind,
                       frames=[{"start": s, "end": e} for s, e in frames],
                       t0=0.0, t1=20.0,
                       device=_Trace(OPS) if device else None, peak_bytes=0)


@pytest.fixture
def recorded(monkeypatch):
    monkeypatch.setattr(spans, "recorded", _spans)


def test_the_flat_timeline_is_the_innermost_span():
    times, label = spans.flat_timeline(_spans(), SOLVER)
    at = {float(t): int(lab) for t, lab in zip(times, label)}
    assert at[2.0] == 2 and at[2.5] == 3 and at[3.0] == 4
    assert at[4.0] == 4 and at[8.0] == 1 and at[8.5] == 0 and at[9.0] == -1
    assert 8 not in label


def test_idle_is_charged_to_the_innermost_span(recorded):
    by = spans.idle_by_phase(_run(), "cold")
    assert by == pytest.approx(dict(IDLE, sweep=sum(IDLE.values()) + 0.4))
    for phase, want in IDLE.items():
        got = run.reader(f"idle_{phase}_s.frame")(_run())
        assert got == pytest.approx(want)


def test_idle_is_per_completed_frame(recorded):
    # A second completed frame without spans halves each share; the
    # dropped frame's idle seconds never count.
    two = _run(frames=((1.0, 9.0), (9.5, 9.9)))
    by = spans.idle_by_phase(two, "cold")
    assert by["accept"] == pytest.approx(0.5)
    assert by["sweep"] == pytest.approx((sum(IDLE.values()) + 0.4) / 2)


def test_sweep_syncs_count_the_completed_frames_sweeps(recorded):
    # 1 + 2 + 3 + 4 in the frame; not the other thread's 7, nor the
    # dropped frame's 5 + 6.
    assert spans.sweep_syncs(_run(), "cold") == 10.0
    assert run.reader("sweep_syncs.frame")(_run()) == 10.0
    assert spans.sweep_syncs(_run("warm"), "cold") is None


def _new_metrics():
    with open(ROOT / "BENCHMARK.json") as f:
        bench = json.load(f)
    return [m["name"] for m in bench["per_layer"]
            if m["name"].startswith(("sweep_syncs.", "idle_"))]


def test_fourteen_metrics_are_declared():
    names = _new_metrics()
    assert len(names) == 14
    assert {n.split(".")[1] for n in names} == {"frame", "warm"}


@pytest.mark.parametrize("name", _new_metrics())
def test_readers_find_nothing_without_a_trace(name, recorded):
    kind = "cold" if name.endswith(".frame") else "warm"
    assert run.reader(name)(_run(kind, device=False)) is None


def test_nothing_is_read_without_the_recorder(monkeypatch):
    from localexpstereo_tpu_torch.utils import profiling
    monkeypatch.delattr(profiling, "records")
    assert spans.recorded() is None
    assert spans.idle_by_phase(_run(), "cold") is None
    assert spans.sweep_syncs(_run(), "cold") is None


def test_nothing_is_read_after_the_recorder_dropped_spans(monkeypatch):
    from localexpstereo_tpu_torch.utils import profiling
    from torch.profiler import ProfilerActivity, profile
    for cap, kept in ((3, True), (2, False)):
        monkeypatch.setattr(profiling, "CAP", cap)
        with profile(activities=[ProfilerActivity.CPU]):
            with profiling.span("sweep"):
                for _ in range(2):
                    with profiling.span("color"):
                        pass
        with profiling.span("off"):
            pass
        assert (spans.recorded() is not None) is kept
