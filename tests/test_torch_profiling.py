"""The port's profiling helpers (``utils/profiling.py``): PhaseTimer's
counts and totals, and the Chrome trace of a profiled block."""
import json
import time

import torch

from localexpstereo_tpu_torch.utils import profiling


def test_phase_timer_counts_and_totals():
    timer = profiling.PhaseTimer()
    x = torch.ones(4)
    for _ in range(3):
        with timer.phase("solve", x):
            time.sleep(0.01)
    with timer.phase("init"):
        pass
    assert dict(timer.counts) == {"solve": 3, "init": 1}
    assert timer.totals["solve"] >= 0.03
    assert timer.totals["init"] < timer.totals["solve"]
    report = timer.report().splitlines()
    assert report[0].startswith("solve") and "(3 calls)" in report[0]
    assert report[1].startswith("init") and "(1 calls)" in report[1]


def test_phase_timer_counts_a_raising_phase():
    timer = profiling.PhaseTimer(block=False)
    try:
        with timer.phase("fails"):
            raise ValueError
    except ValueError:
        pass
    assert timer.counts["fails"] == 1


def test_trace_writes_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "t")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    events = json.loads((tmp_path / "t" / "trace.json").read_text())
    assert any("mm" in e.get("name", "") for e in events["traceEvents"])
    assert any("mm" in a.key for a in prof.key_averages())
