"""Tracing for the port: the recorder of the program's spans and of the
host's waits on the card, and a Chrome trace of a profiled block
(counterpart of ``localexpstereo_tpu.utils.profiling``).

The reference's only tracing facility is the pausable ``TimeStamper`` wall
clock (``TimeStamper.h``, :mod:`.timing`). Here:

- :func:`span`: a named interval of the program's host work (the solve,
  each sweep, each color step and its phases), nested per thread and
  stamped on ``time.perf_counter``, the clock that a device trace of the
  same process is mapped onto (``benchmark/trace.py``), so that the card's
  idle time can be charged to the host work that ran meanwhile;
- the ``syncs`` counter of each span: the host's waits on the card while
  the span was the innermost open one on its thread, counted through
  PyTorch's sync debug mode (pageable copies to and from the card,
  ``.item()``, ``bool()`` of a card tensor, ``nonzero``, boolean-mask
  indexing, a stream's ``synchronize``) and, for the waits the mode does
  not report (``torch.cuda.synchronize``, an event's ``synchronize``), by
  :func:`count_sync` where the program makes them;
- :func:`trace`: a ``torch.profiler`` window over the CPU and, where there
  is one, the card, written as a Chrome trace, each span a
  ``record_function`` range above the ops it launched;
- :class:`DeviceWindow`: a window over the card alone that hands back its
  spans and the card's ops as plain arrays, as a worker process sends them
  to its parent (``parallel/replica.ReplicaPool(trace=True)``).

The recorder records only while a ``torch.profiler`` window records in
the process (:func:`trace`, or any other profiler window). Off, a span is
one flag read and a shared no-op context. The first span of a window
empties the records, sets the sync debug mode to "warn" and routes its
warnings into the counter, so that none is shown; the end of
:func:`trace`, or the first span after another window, puts both back
as they were (two windows with no span between them record as one). No
span waits for the card.
"""
from __future__ import annotations

import contextlib
import os
import threading
import time
import warnings
from typing import Dict, Iterator, List

import numpy as np
import torch

#: Spans kept a window; those beyond it are counted as dropped.
CAP = 1 << 20
#: The warning PyTorch's sync debug mode raises at each wait on the card.
SYNC_MESSAGE = "called a synchronizing CUDA operation"

_profiling = torch._C._autograd._profiler_enabled
_OFF = contextlib.nullcontext()
_lock = threading.Lock()
_local = threading.local()
_on = False
_chrome = 0
_records: List["Span"] = []
_dropped = 0
_syncs_outside = 0
_saved = None


class Span:
    """One recorded span: ``name``, ``attrs``, ``start`` and ``end``
    (``time.perf_counter`` seconds), ``parent`` (the index in
    :func:`records` of the span it opened in, -1 at the top of its
    thread), ``thread`` (``threading.get_ident``), ``raised`` (the block
    raised) and ``syncs`` (the host's waits on the card while it was the
    innermost open span)."""

    __slots__ = ("name", "attrs", "start", "end", "parent", "thread",
                 "raised", "syncs", "index", "_fn")

    def __init__(self, name: str, attrs: dict):
        self.name = name
        self.attrs = attrs
        self.syncs = 0
        self.raised = False
        self._fn = None

    def __enter__(self) -> "Span":
        global _dropped
        stack = _stack()
        self.parent = stack[-1].index if stack else -1
        self.thread = threading.get_ident()
        records = _records
        if len(records) < CAP:
            self.index = len(records)
            records.append(self)
        else:
            self.index = -1
            _dropped += 1
        stack.append(self)
        if _chrome:
            self._fn = torch.profiler.record_function(self.name)
            self._fn.__enter__()
        self.start = time.perf_counter()
        return self

    def __exit__(self, kind, value, tb) -> bool:
        self.end = time.perf_counter()
        self.raised = kind is not None
        if self._fn is not None:
            self._fn.__exit__(kind, value, tb)
            self._fn = None
        _stack().pop()
        return False


def span(name: str, **attrs):
    """``with span(name, **attrs):`` records the block while a profiler
    window records; otherwise does nothing."""
    if _profiling():
        if not _on:
            _start()
        return Span(name, attrs)
    if _on:
        _stop()
    return _OFF


def count_sync() -> None:
    """Charges one wait on the card to the innermost open span while the
    recorder is on: the program calls it beside each wait that the sync
    debug mode does not report."""
    if _on and _profiling():
        _charge()


def records() -> List[Span]:
    """The spans recorded in the latest window, in the order they
    opened."""
    return list(_records)


def counts() -> Dict[str, int]:
    """``dropped``: spans of the latest window beyond :data:`CAP`;
    ``syncs_outside``: its waits on the card while no span was open, such
    as a caller's copies between two solves."""
    return {"dropped": _dropped, "syncs_outside": _syncs_outside}


def _stack() -> List[Span]:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


def _charge() -> None:
    global _syncs_outside
    stack = _stack()
    if stack:
        stack[-1].syncs += 1
    else:
        _syncs_outside += 1


def _count_sync(message, category, filename, lineno, file=None, line=None):
    """``warnings.showwarning`` while the recorder is on: charges each sync
    warning to the innermost open span of the thread, shows the others.
    Between the window's end and the next span the mode still warns: those
    warnings are neither counted nor shown."""
    if str(message).startswith(SYNC_MESSAGE):
        if _profiling():
            _charge()
        return
    _saved[1](message, category, filename, lineno, file, line)


def _set_sync_debug_mode(mode) -> None:
    # Setting the mode warns that it is a prototype: nothing is shown.
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        torch.cuda.set_sync_debug_mode(mode)


def _start() -> None:
    global _on, _records, _dropped, _syncs_outside, _saved
    with _lock:
        if _on:
            return
        _records, _dropped, _syncs_outside = [], 0, 0
        mode = None
        if torch.cuda.is_available():
            mode = torch.cuda.get_sync_debug_mode()
            _set_sync_debug_mode("warn")
        warnings.filterwarnings("always", message=SYNC_MESSAGE)
        _saved = (warnings.filters[0], warnings.showwarning, mode)
        warnings.showwarning = _count_sync
        _on = True


def _stop() -> None:
    global _on
    with _lock:
        if not _on:
            return
        entry, show, mode = _saved
        if mode is not None:
            _set_sync_debug_mode(mode)
        if warnings.showwarning is _count_sync:
            warnings.showwarning = show
        with contextlib.suppress(ValueError):
            warnings.filters.remove(entry)
        _on = False


def span_rows(records: List[Span]) -> List[tuple]:
    """``records`` as plain tuples (name, attrs, start, end, parent,
    thread, syncs), ``end`` None for a span still open: what another
    process can be sent."""
    return [(r.name, dict(r.attrs), r.start, getattr(r, "end", None),
             r.parent, r.thread, r.syncs) for r in records]


class DeviceWindow:
    """A ``torch.profiler`` window over ``device``'s activity alone (over
    the host's ops on a process without a card: the spans need a window),
    inside which the spans record. :meth:`stop` returns the window's spans
    (:func:`span_rows`), ``dropped`` (:func:`counts`) and the device's ops
    as ``ops``: (names, each op's index into them, starts, ends), on
    ``time.perf_counter``, the clock of every process of one host
    (``CLOCK_MONOTONIC``)."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._prof = None

    def start(self) -> None:
        act = torch.profiler.ProfilerActivity
        self._prof = torch.profiler.profile(activities=[
            act.CUDA if self.device.type == "cuda" else act.CPU])
        self._prof.__enter__()

    def stop(self) -> dict:
        from torch.autograd import DeviceType
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        # The profiler stamps events in ns of the system clock.
        offset = time.time_ns() * 1e-9 - time.perf_counter()
        self._prof.__exit__(None, None, None)
        _stop()
        ids: Dict[str, int] = {}
        rows = []
        for e in self._prof.profiler.kineto_results.events():
            if e.device_type() != DeviceType.CUDA or e.is_user_annotation():
                continue
            rows.append((ids.setdefault(e.name(), len(ids)), e.start_ns(),
                         e.duration_ns()))
        self._prof = None
        arr = np.asarray(rows, np.float64).reshape(-1, 3)
        start = arr[:, 1] * 1e-9 - offset
        return {"spans": span_rows(_records), "dropped": _dropped,
                "ops": (list(ids), arr[:, 0].astype(np.int32), start,
                        start + arr[:, 2] * 1e-9)}


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """``with trace(dir) as prof:`` profiles the block and writes
    ``dir/trace.json``, the program's spans as ranges above the ops;
    ``prof.key_averages()`` sums it by op, and :func:`records` holds the
    spans."""
    global _chrome
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    try:
        with torch.profiler.profile(activities=acts) as prof:
            _chrome += 1
            try:
                yield prof
            finally:
                _chrome -= 1
    finally:
        _stop()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
