"""The command line's refusals, and a run of each cell on the card."""
import json
import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
CELLS = [w["name"] for w in BENCH["workloads"]]


def _run(cwd, *args, timeout=600):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", *args], cwd=cwd,
        capture_output=True, text=True, timeout=timeout)


def _has_card():
    import torch
    return torch.cuda.is_available()


def test_no_card_no_result():
    if _has_card():
        pytest.skip("this host has a card")
    out = _run(ROOT, "--workload", CELLS[0], "--seed", "1", "--seconds", "1")
    assert out.returncode == 2
    assert out.stdout.strip() == ""


def test_benchmark_alone_gives_no_result(tmp_path):
    """A directory that holds only BENCHMARK.json and the benchmark's
    folder: no program to measure, no result."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path, "--workload", CELLS[0], "--seed", "1",
               "--seconds", "1")
    assert out.returncode != 0
    assert not out.stdout.strip().endswith("}")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_a_run_on_the_card(workload):
    if not _has_card():
        pytest.skip("needs a CUDA card")
    out = _run(ROOT, "--workload", workload, "--seed", "2147483659",
               "--seconds", str(BENCH["run_seconds"]), timeout=1500)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu"
    assert list(result)[-1] == "checks"
