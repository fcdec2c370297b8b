"""Tracing and profiling hooks (counterpart of
``spalinalg_tpu/utils/profiling.py``).

Thin wrappers over ``torch.profiler``: :func:`annotate` names a region in
a trace (and, while the card is in use, in an NVTX range as well),
:func:`trace_to` writes a Chrome trace of a block over the CPU and, where
there is a card, CUDA activities, and :func:`device_sync` waits for every
card that holds a tensor of a nested structure (timing hygiene).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator

import torch

__all__ = ["annotate", "trace_to", "device_sync"]


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """A named region: a ``torch.profiler.record_function`` span, plus an
    NVTX range where the process has used the card."""
    nvtx = torch.cuda.is_available() and torch.cuda.is_initialized()
    with torch.profiler.record_function(name):
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()


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
