"""The benchmark of the PyTorch and CUDA port (``localexpstereo_tpu_torch``)
on one card: one run of one cell of ``BENCHMARK.json``.

    python3 benchmark/run.py --workload adirondack_h.cold_pairs2 \\
        --seed 123456789012 --seconds 51 --trace 0

From the root of a checkout. The cell names a configuration
(``benchmark/configs/<name>.json``: the sizes, the command line's flags,
the scene generator in ``benchmark/scenes/``) and a traffic mix
(``benchmark/traffic/<name>.json``: the client in ``benchmark/clients/``
and its parameters); every metric is a reader in
``benchmark/metrics/<name>.py``, found by the metric's name.

A run makes its inputs from ``--seed`` and uploads them (set-up), warms up
every shape the traffic uses, then drives the client's frames back to back
in this one process for ``--seconds``; a frame still running when the
window closes is dropped. With ``--trace 1`` the card's ops are traced
over the window and the per-layer metrics are reported instead of the
end-to-end ones. Once the window has closed and the peak memory is read,
the frames are held against the plain reference (``benchmark/check.py``).
The last line of standard output is the result, a JSON object; the last
lines of standard error are each number compared, beside its limit.

Exits 2, printing no result, without a CUDA card (or with fewer than the
cell asks for), and 3 if JAX or the JAX package was imported.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

#: Top-level module names that the process may not hold once the window
#: has closed: JAX and the JAX package the port was made from.
FORBIDDEN = ("jax", "jaxlib", "flax", "localexpstereo_tpu")
BENCH = ROOT / "benchmark"
#: Intra-op threads of the run's one process: a steady load, and the host
#: work of a color step is many small ops that more threads do not speed.
HOST_THREADS = 2


def load_cell(workload: str):
    """(benchmark, cell, config, traffic) of ``workload``."""
    with open(ROOT / "BENCHMARK.json") as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}: {sorted(cells)}")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    with open(ROOT / configs[cell["config"]]["file"]) as f:
        config = json.load(f)
    with open(BENCH / "traffic" / f"{cell['traffic']}.json") as f:
        traffic = json.load(f)
    return bench, cell, config, traffic


def cell_metrics(bench: dict, workload: str, group: str):
    """The metrics of ``group`` ("end_to_end" or "per_layer") that the cell
    reports: those that list it, and those without a list that move an
    end-to-end metric it reports."""
    e2e = [m["name"] for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    out = []
    for m in bench[group]:
        if "workloads" in m:
            if workload in m["workloads"]:
                out.append(m)
        elif group == "end_to_end" or m["moves"] in e2e:
            out.append(m)
    return out


def reader(name: str):
    """The ``read(run)`` of ``benchmark/metrics/<name>.py``."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark.metrics." + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def run_cell(workload: str, seed: int, seconds: float, traced: bool,
             device: str = "cuda", config_overrides=None):
    """One run of ``workload``. Returns (result dict, checks table). The
    device is the card; the CPU (``device="cpu"``, with
    ``config_overrides`` that shrink the configuration) is for the tests of
    the harness alone, which skip its look for a card."""
    import torch

    from benchmark import check, readers
    from benchmark.clients.common import WindowClosed
    from benchmark.trace import (DeviceTrace, busy_s, idle_gaps, span_at,
                                 top_ops)

    bench, cell, config, traffic = load_cell(workload)
    config = dict(config, **(config_overrides or {}))
    cuda = device == "cuda"
    torch.set_num_threads(HOST_THREADS)
    client = importlib.import_module(
        f"benchmark.clients.{traffic['client']}").Client(
            config, traffic, seed, device, traced)
    client.setup()
    card = power_limit() if cuda else "cpu"
    if cuda:
        torch.cuda.synchronize()
    dev_trace = DeviceTrace() if traced and cuda else None
    if dev_trace is not None:
        dev_trace.start()
    t0 = time.perf_counter()
    setup_s = t0 - T_START
    t1 = t0 + seconds
    frames = []
    k = 0
    while time.perf_counter() < t1:
        try:
            rec = client.frame(k, t1, traced)
        except WindowClosed:
            break
        if rec["end"] > t1:
            break
        client.keep(rec)
        frames.append({key: rec.get(key) for key in
                       ("start", "end", "marks", "timings", "mccnn_events")})
        k += 1
    if cuda:
        torch.cuda.synchronize()
    if dev_trace is not None:
        dev_trace.stop()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    mccnn_ms = [f["mccnn_events"][0].elapsed_time(f["mccnn_events"][1])
                for f in frames if f.get("mccnn_events")]
    client.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    rows = client.check()
    check_s = time.perf_counter() - t_check
    lims = check.limits(cell["config"])
    ok, table = check.verdict(check.worst(rows), lims)
    failed = sum(1 for row in rows if not check.verdict(row, {
        name: lim for name, lim in lims.items()
        if row.get(name) is not None})[0])

    run = readers.Run(config=config, kind=client.kind,
                      frames=frames, t0=t0, t1=t1, device=dev_trace,
                      peak_bytes=peak, mccnn_ms=mccnn_ms, setup_s=setup_s)
    metrics = {}
    group = "per_layer" if traced else "end_to_end"
    for m in cell_metrics(bench, workload, group):
        value = reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": ok, "attempted": len(frames), "failed": failed,
              "metrics": metrics,
              "device": {"platform": "gpu" if cuda else "cpu",
                         "kind": (torch.cuda.get_device_name(0) if cuda
                                  else "cpu"),
                         "count": cell["chips"], "memory_peak_bytes": peak,
                         "power_limit": card},
              "frames": len(frames), "check_s": check_s,
              "frame_walls": [f["end"] - f["start"] for f in frames]}
    if dev_trace is not None:
        d = dev_trace
        result["device"]["busy_s"] = busy_s(d.start_s, d.end_s, t0, t1)
        result["device"]["window_s"] = t1 - t0
        starts, lengths = idle_gaps(d.start_s, d.end_s, t0, t1)
        sp = readers.spans(run)
        result["breakdown"] = {
            "device_ops": top_ops(d.names, d.name_id, d.start_s, d.end_s,
                                  t0, t1),
            "idle_gaps": [[span_at(sp, float(s)), float(g)]
                          for s, g in zip(starts[:10], lengths[:10])]}
    result["checks"] = table
    return result, table


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _, cell, _, _ = load_cell(args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); this "
              f"host has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    from benchmark import check
    result, table = run_cell(args.workload, args.seed, args.seconds,
                             bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    check.report(table)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
