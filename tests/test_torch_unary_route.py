"""The sweeps' unary route (``energy.fused_unary``, ``energy.kernel_filters``):
which inputs send a color step's unary to the fused sampling + guided-filter
kernel, the ``route`` of the ``unary`` span that records it, and the
benchmark's readers of that attribute (``unary_kernel_share.*``).

Nothing here allocates on a card: the route is decided from the device's
type and the window's shape alone."""
import contextlib
import dataclasses
import time
import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import readers, run
from localexpstereo_tpu_torch.config import PARAMS_BF, PARAMS_GF
from localexpstereo_tpu_torch.models import energy, engine
from localexpstereo_tpu_torch.ops import unary_cuda
from localexpstereo_tpu_torch.utils import profiling, synthetic

#: The cells' filter windows at r = 10 (windR 20): F = 3 s + 2 r for the
#: unit sizes 14, 43 and 129 of a 1436 px wide image.
CELL_WINDOWS = (62, 149, 407)
CFG = energy.EnergyConfig(width=1436, height=992, pad=150,
                          params=PARAMS_GF.replace(windR=20, lambda_=0.5),
                          min_disp=0.0, max_disp=144.0, vol_pad=140)

#: (case, configuration changes, parameter changes, device, F, fused,
#: filtered in the kernel).
ROUTES = [
    *[(f"auto-cuda-F{f}", {}, {}, "cuda", f, True, True)
      for f in CELL_WINDOWS],
    ("dma-cuda", {"unary_backend": "dma"}, {}, "cuda", 62, True, True),
    ("dma-cpu", {"unary_backend": "dma"}, {}, "cpu", 62, True, True),
    ("auto-cpu", {}, {}, "cpu", 62, False, False),
    ("auto-sharded", {"sharded": True}, {}, "cuda", 62, False, False),
    ("dma-sharded", {"unary_backend": "dma", "sharded": True}, {}, "cuda",
     62, False, False),
    ("auto-interp0", {"interp": 0}, {}, "cuda", 62, False, False),
    ("auto-interp2", {"interp": 2}, {}, "cuda", 62, False, False),
    ("auto-naive", {"kind": "naive"}, {}, "cuda", 62, False, False),
    ("dma-naive", {"kind": "naive", "unary_backend": "dma"}, {}, "cuda", 62,
     False, False),
    # r = 40: no tile of a 149 px window fits the shared memory.
    ("auto-no-plan", {}, {"windR": 80}, "cuda", 149, False, False),
    # The bilateral filter: the kernel samples, the filter runs after it.
    ("auto-bf-cuda", {}, {"filter_name": PARAMS_BF.filter_name}, "cuda", 62,
     True, False),
    ("auto-bf-cpu", {}, {"filter_name": PARAMS_BF.filter_name}, "cpu", 62,
     False, False),
]


@pytest.mark.parametrize("case,changes,params,device,f,fused,filtered",
                         ROUTES, ids=[r[0] for r in ROUTES])
def test_the_unary_route(case, changes, params, device, f, fused, filtered):
    initialized = torch.cuda.is_initialized()
    cfg = dataclasses.replace(CFG, params=CFG.params.replace(**params),
                              **changes)
    assert energy.fused_unary(cfg, torch.device(device), f) is fused
    assert energy.kernel_filters(cfg, device, f) is filtered
    assert torch.cuda.is_initialized() == initialized


def test_the_cells_windows_have_a_plan_and_wide_radii_not():
    for f in CELL_WINDOWS:
        assert unary_cuda.has_plan(f, 10) and unary_cuda.has_plan(f, 0)
    assert not unary_cuda.has_plan(149, 40)
    with pytest.raises(ValueError):
        unary_cuda.launch_plan(149, 6, 40)


# ----------------------------------------------- the span and its readers --

PARAMS = PARAMS_GF.replace(windR=6, lambda_=0.5, th_col=0.5)
H, W, ND = 16, 24, 4
SIZES = (8, 16)


@contextlib.contextmanager
def _profiled():
    """A profiler window, closed for the recorder by a span after it."""
    with profile(activities=[ProfilerActivity.CPU]):
        yield
    with profiling.span("off"):
        pass


def _solve(route: str):
    """A tiny CPU solve (1 greedy + 1 graph-cut sweep) on ``route`` in a
    profiler window: (its unary spans, a run of one cold frame around it
    as the readers see it)."""
    img, vol, _, _, _, _ = synthetic.planted_problem(H, W, ND)
    solver = engine.LocalExpansionSolver(img, img, PARAMS, ND - 1, vol0=vol,
                                         vol1=vol, device="cpu",
                                         unary_backend=route)
    for li, size in enumerate(SIZES):
        solver.add_layer(size, engine.LAYER0_PROPOSERS if li == 0
                         else engine.COARSE_PROPOSERS)
    with _profiled():
        t0 = time.perf_counter()
        solver.run(1, pm_iterations=1)
        t1 = time.perf_counter()
    frames = [{"start": t0, "end": t1}]
    fake = readers.Run(config={}, kind="cold", frames=frames, t0=t0, t1=t1,
                       device=object(), peak_bytes=0)
    return [r for r in profiling.records() if r.name == "unary"], fake


@pytest.mark.parametrize("route,label,share", [("auto", "plain", 0.0),
                                               ("dma", "kernel", 100.0)])
def test_the_unary_span_records_its_route(route, label, share):
    unary, fake = _solve(route)
    assert unary and {r.attrs["route"] for r in unary} == {label}
    assert run.reader("unary_kernel_share.frame")(fake) == share
    assert run.reader("unary_kernel_share.warm")(fake) is None


def _record(i, name, start, end, parent, **attrs):
    return types.SimpleNamespace(name=name, start=start, end=end,
                                 parent=parent, thread=1, syncs=0,
                                 attrs=attrs, index=i)


#: One completed frame [1, 9] and, from 10, one the window's close dropped:
#: three unary spans in the frame's sweep (two on the kernel), one outside
#: any sweep, one in the dropped frame.
RECORDS = [
    ("solve", 1.0, 9.0, -1, {}),
    ("sweep", 2.0, 8.0, 0, {"kind": "greedy"}),
    ("color", 2.0, 8.0, 1, {}),
    ("unary", 3.0, 4.0, 2, {"route": "kernel"}),
    ("unary", 4.0, 5.0, 2, {"route": "plain"}),
    ("unary", 5.0, 6.0, 2, {"route": "kernel"}),
    ("unary", 8.2, 8.4, 0, {"route": "plain"}),
    ("solve", 10.0, 20.0, -1, {}),
    ("sweep", 11.0, 20.0, 7, {}),
    ("unary", 12.0, 13.0, 8, {"route": "plain"}),
]


def _recorded(monkeypatch, records):
    recs = [_record(i, *r[:4], **r[4]) for i, r in enumerate(records)]
    monkeypatch.setattr(profiling, "records", lambda: list(recs))
    monkeypatch.setattr(profiling, "counts",
                        lambda: {"dropped": 0, "syncs_outside": 0})


def _run(kind="cold", device=True, frames=((1.0, 9.0),)):
    return readers.Run(config={}, kind=kind,
                       frames=[{"start": s, "end": e} for s, e in frames],
                       t0=0.0, t1=20.0, device=object() if device else None,
                       peak_bytes=0)


@pytest.mark.parametrize("name,kind", [("unary_kernel_share.frame", "cold"),
                                       ("unary_kernel_share.warm", "warm")])
def test_the_share_counts_the_completed_frames_sweeps(monkeypatch, name,
                                                      kind):
    _recorded(monkeypatch, RECORDS)
    read = run.reader(name)
    assert read(_run(kind)) == pytest.approx(200.0 / 3.0)
    assert read(_run("warm" if kind == "cold" else "cold")) is None
    assert read(_run(kind, device=False)) is None
    assert read(_run(kind, frames=())) is None


def test_the_share_is_none_without_the_route(monkeypatch):
    # A checkout whose unary spans carry no route: the parent's reading.
    _recorded(monkeypatch, [r[:4] + ({},) for r in RECORDS])
    assert run.reader("unary_kernel_share.frame")(_run()) is None
