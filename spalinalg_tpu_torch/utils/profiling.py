"""Tracing and profiling hooks (counterpart of
``spalinalg_tpu/utils/profiling.py``).

:func:`annotate` is the port's span: a named stretch of host work, inert
unless tracing is on. Tracing is on while a torch profiler runs or inside
:func:`tracing`. A span then records a profiler event named as the span
where the profiler runs (a host op on the trace's clock, beside the
device's activity, so an idle gap can be put down to the span the host was
in; under ``torch.autograd.profiler.emit_nvtx()`` an NVTX range), and adds
into an in-memory registry its count, host seconds and self host seconds
(less its child spans); with ``device=`` it also records a pair of CUDA
events, whose elapsed time is read only when :func:`span_totals` reads the
registry. :func:`reset` clears it.

The port's spans, each named ``spal.<...>``:

- ``spal.spmv`` / ``spal.spmm``: a CSR or CSC product, from
  ``ops/matvec.py`` to the kernel launch's return;
- ``spal.spmv.plan``: the vector SpMV's work plan, looked up (and built on
  a miss);
- ``spal.launch``: a kernel launch (``ops/kernels/_build.py::launch``, the
  funnel of every kernel of the port);
- ``spal.precond``: a solver's preconditioner set-up (the Jacobi diagonal
  of ``linalg.cg``), with device time.

:func:`trace_to` writes a Chrome trace of a block over the CPU and, where
there is a card, CUDA activities, and :func:`device_sync` waits for every
card that holds a tensor of a nested structure (timing hygiene).

Examples
--------
>>> import torch
>>> from spalinalg_tpu_torch import CsrMatrix
>>> from spalinalg_tpu_torch.utils import profiling
>>> a = CsrMatrix.eye(4, device="cpu")
>>> with profiling.tracing():
...     _ = a @ torch.ones(4, dtype=torch.float64)
>>> profiling.span_totals()["spal.spmv"]["count"]
1
>>> profiling.reset()
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Dict, Iterator, Optional

import torch
from torch.autograd import _profiler_enabled

__all__ = ["annotate", "tracing", "span_totals", "reset", "trace_to",
           "device_sync"]

# The profiler's C++ RecordFunction as a context manager: one event on the
# trace, as ``torch.profiler.record_function`` gives, without its two
# dispatcher ops and TorchScript object a span.
_record_function = torch._C._profiler._RecordFunctionFast
_NULL = contextlib.nullcontext()
_LOCK = threading.Lock()
_LOCAL = threading.local()       # each thread's stack of open spans
_FORCED = 0                      # depth of open ``tracing()`` scopes
_TOTALS: Dict[str, "_Total"] = {}


class _Total:
    __slots__ = ("count", "host_s", "self_s", "device_s", "pending")

    def __init__(self):
        self.count = 0
        self.host_s = 0.0
        self.self_s = 0.0
        self.device_s: Optional[float] = None
        self.pending = []        # (start, end) CUDA events not yet read


class _Span:
    """One open span; see :func:`annotate`."""

    __slots__ = ("name", "device", "rf", "events", "t0", "child")

    def __init__(self, name: str, device):
        self.name = name
        self.device = device

    def __enter__(self):
        self.rf = None
        if _profiler_enabled():
            self.rf = _record_function(self.name)
            self.rf.__enter__()
        stack = getattr(_LOCAL, "stack", None)
        if stack is None:
            stack = _LOCAL.stack = []
        stack.append(self)
        self.child = 0.0
        self.events = _start_event(self.device)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        host = time.perf_counter() - self.t0
        pair = None
        if self.events is not None:
            stream, start = self.events
            end = torch.cuda.Event(enable_timing=True)
            end.record(stream)
            pair = (start, end)
        stack = _LOCAL.stack
        stack.pop()
        if stack:
            stack[-1].child += host
        with _LOCK:
            t = _TOTALS.get(self.name)
            if t is None:
                t = _TOTALS[self.name] = _Total()
            t.count += 1
            t.host_s += host
            t.self_s += host - self.child
            if pair is not None:
                t.pending.append(pair)
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


def _start_event(device):
    """``(stream, recorded start event)`` on the card ``device`` names
    (``True``: the current one), or None where there is no card to time."""
    if not device or not (torch.cuda.is_available()
                          and torch.cuda.is_initialized()):
        return None
    if isinstance(device, torch.device):
        if device.type != "cuda":
            return None
        stream = torch.cuda.current_stream(device)
    else:
        stream = torch.cuda.current_stream()
    start = torch.cuda.Event(enable_timing=True)
    start.record(stream)
    return stream, start


def annotate(name: str, *, device=False):
    """The port's span ``name`` over a ``with`` block (see the module's
    docstring). Off (no profiler running, no :func:`tracing` scope) it is
    one shared null context: no profiler event, no clock, no CUDA event.
    ``device``: ``True`` (the current card) or a ``torch.device`` whose
    current stream gets a pair of CUDA events around the block; a CPU
    device records none."""
    if not (_FORCED or _profiler_enabled()):
        return _NULL
    return _Span(name, device)


@contextlib.contextmanager
def tracing() -> Iterator[None]:
    """Turn the port's spans on for a block without a profiler: the
    registry fills, and no profiler event is recorded unless a profiler
    runs as well. Scopes nest."""
    global _FORCED
    with _LOCK:
        _FORCED += 1
    try:
        yield
    finally:
        with _LOCK:
            _FORCED -= 1


def span_totals() -> Dict[str, Dict[str, Optional[float]]]:
    """``{name: {"count", "host_s", "self_s", "device_s"}}`` of every span
    recorded since the last :func:`reset`; ``device_s`` is None for a span
    that recorded no CUDA events. Reading waits for the events' work."""
    with _LOCK:
        totals = list(_TOTALS.items())
    out = {}
    for name, t in totals:
        with _LOCK:
            pending, t.pending = t.pending, []
        if pending:
            device_s = 0.0
            for start, end in pending:
                end.synchronize()
                device_s += start.elapsed_time(end) / 1e3
            with _LOCK:
                t.device_s = (t.device_s or 0.0) + device_s
        out[name] = {"count": t.count, "host_s": t.host_s,
                     "self_s": t.self_s, "device_s": t.device_s}
    return out


def reset() -> None:
    """Clear the registry of :func:`span_totals`."""
    with _LOCK:
        _TOTALS.clear()


@contextlib.contextmanager
def trace_to(logdir: str) -> Iterator[torch.profiler.profile]:
    """Profile a block (CPU, and CUDA where there is a card) and write its
    Chrome trace into ``logdir`` as ``trace_<pid>_<ns>.json``; yields the
    profiler, whose ``key_averages()`` stay readable afterwards."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def _devices(tree, out: set, seen: set) -> None:
    if id(tree) in seen:
        return
    seen.add(id(tree))
    if isinstance(tree, torch.Tensor):
        if tree.device.type == "cuda":
            out.add(tree.device)
    elif isinstance(tree, dict):
        for v in tree.values():
            _devices(v, out, seen)
    elif isinstance(tree, (list, tuple, set, frozenset)):
        for v in tree:
            _devices(v, out, seen)
    elif isinstance(getattr(tree, "device", None), torch.device):
        if tree.device.type == "cuda":            # a matrix of the port
            out.add(tree.device)


def device_sync(tree) -> None:
    """Block until every card that holds a tensor (or a matrix of the
    port) in the nested structure ``tree`` has finished its work."""
    devices: set = set()
    _devices(tree, devices, set())
    for dev in devices:
        torch.cuda.synchronize(dev)
