"""The window's arithmetic on synthetic frame logs, and the trace's on
synthetic traces."""
import numpy as np
import pytest

from benchmark import readers, trace, window


def test_partial_frames_are_dropped():
    frames = [(0, 0.0, 10.0), (0, 10.0, 21.0), (0, 21.0, 33.0)]
    assert window.completed(frames, 0.0, 30.0) == frames[:2]
    assert window.frame_s(window.completed(frames, 0.0, 30.0), 1) == 10.5


@pytest.mark.parametrize("clients", [1, 2, 4])
def test_frame_s_amortizes_over_clients(clients):
    frames = [(c, 0.0, 20.0) for c in range(clients)] + \
        [(c, 20.0, 44.0) for c in range(clients)]
    assert window.frame_s(frames, clients) == pytest.approx(22.0 / clients)


def test_warm_frame_s_is_the_mean_over_streams():
    frames = [(0, 0.0, 2.0), (0, 2.0, 5.0), (1, 0.0, 4.0)]
    assert window.warm_frame_s(frames) == pytest.approx(3.0)


def test_no_frame_is_an_error():
    with pytest.raises(ValueError):
        window.frame_s([], 1)


def test_pan_runs_back_and_forth():
    offs = [window.pan_offset(k, 4, 2) for k in range(9)]
    assert offs == [0, 2, 4, 6, 4, 2, 0, 2, 4]
    assert all(abs(a - b) == 2 for a, b in zip(offs, offs[1:]))


def test_busy_is_the_union_of_ops_in_the_window():
    start = np.array([0.5, 1.0, 1.5, 4.0, 9.5])
    end = np.array([2.0, 1.2, 3.0, 5.0, 11.0])
    assert trace.busy_s(start, end, 0.0, 10.0) == pytest.approx(
        2.5 + 1.0 + 0.5)
    gs, gl = trace.idle_gaps(start, end, 0.0, 10.0)
    assert gl.tolist() == pytest.approx([4.5, 1.0, 0.5])
    assert gs.tolist() == pytest.approx([5.0, 3.0, 0.0])


def test_top_ops_sum_by_name():
    names = ["a", "b"]
    nid = np.array([0, 1, 0])
    start = np.array([0.0, 1.0, 2.0])
    end = np.array([0.5, 3.0, 2.25])
    assert trace.top_ops(names, nid, start, end, 0.0, 10.0) == [
        ["b", 2.0], ["a", 0.75]]


def test_gaps_are_named_by_the_innermost_span():
    spans = [(0.0, 10.0, "cold_frame"), (2.0, 4.0, "gc_sweep")]
    assert trace.span_at(spans, 3.0) == "gc_sweep"
    assert trace.span_at(spans, 5.0) == "cold_frame"
    assert trace.span_at(spans, 11.0) == "outside"


class _Trace:
    def __init__(self, names, nid, start, end):
        self.names, self.name_id = names, np.asarray(nid)
        self.start_s, self.end_s = np.asarray(start), np.asarray(end)


def _run(kind="cold"):
    config = {"width": 64, "height": 32, "ndisp": 16,
              "unit_sizes": [2, 4, 8],
              "proposers": [["expansion", "ransac", "random7"]] + [
                  ["expansion", "expansion", "ransac"]] * 2,
              "energy": {"windR": 6},
              "schedule": {"cold": {"greedy": 1, "graph_cut": 1}}}
    dev = _Trace(["expansion_accept_kernel(float*)", "elementwise"],
                 [0, 1, 0, 1], [0.5, 1.0, 6.0, 8.0], [1.0, 2.0, 6.5, 9.0])
    frames = [{"start": 0.0, "end": 5.0, "marks": [(0, 0.2), (1, 2.0),
                                                   (2, 4.5)]}]
    return readers.Run(config=config, kind=kind, frames=frames,
                       t0=0.0, t1=10.0, device=dev, peak_bytes=2 ** 31)


def test_readers_on_a_synthetic_trace():
    run = _run()
    assert readers.device_idle(run, "cold") == pytest.approx(
        100 * (1 - 3.0 / 10.0))
    assert readers.device_idle(run, "warm") is None
    assert readers.device_ops(run, "cold") == 2.0
    assert readers.peak_gib(run, "cold") == 2.0
    assert readers.sweep_s(run, False) == pytest.approx(1.8)
    assert readers.sweep_s(run, True) == pytest.approx(2.5)
    assert readers.build_init_s(run, "cold") == pytest.approx(0.2)
    from benchmark import roofline
    bound = roofline.expansion_bound_s(run.config, "cold")
    # Only the kernel that ran inside the frame counts.
    assert readers.expansion_roofline(run, "cold") == pytest.approx(
        100 * bound / 0.5)
