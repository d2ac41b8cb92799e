"""Every cell of BENCHMARK.json resolves by name to its files, and the file
keeps to the benchmark contract's shape."""
import importlib
import json
import pathlib
import re

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def _cells():
    return [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("workload", _cells())
def test_cell_files_resolve(workload):
    from benchmark import check, run
    _, cell, config, traffic = run.load_cell(workload)
    client = importlib.import_module(f"benchmark.clients.{traffic['client']}")
    assert hasattr(client.Client, "frame")
    scene = importlib.import_module(f"benchmark.scenes.{config['scene']}")
    assert hasattr(scene, "make")
    assert config["name"] == cell["config"]
    assert check.limits(cell["config"])
    for group in ("end_to_end", "per_layer"):
        for m in run.cell_metrics(BENCH, workload, group):
            assert callable(run.reader(m["name"]))


@pytest.mark.parametrize("workload", _cells())
def test_cell_reports_what_the_contract_asks(workload):
    from benchmark import run
    e2e = [m["name"] for m in run.cell_metrics(BENCH, workload,
                                                "end_to_end")]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert run.cell_metrics(BENCH, workload, "per_layer")


def test_shape_of_the_benchmark_file():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file()
        assert c["file"].startswith("benchmark/")
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["name"] not in names
        names.add(m["name"])
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
    assert len(json.dumps(BENCH)) < 64 * 1024
