"""Metrics tier (counterpart of ``spalinalg_tpu/utils/metrics.py``).

Per-op structured metrics (nnz, flops, achieved rate) through a host-side
recorder with optional JSON-lines output. Each record also
names the dispatch path that ran, for example ``csr_spmv:cuda`` (the
hand-written kernel) or ``csr_spmv:plain`` (the plain torch version on
CPU tensors), so a reader of the records can tell the two apart. The
paths: ``csr_spmv``, ``csc_spmv``, ``csr_spmm``, ``csc_spmm``, ``spgemm``
and ``dia_spmv``, each ``:cuda`` or ``:plain``; ``bsr_spmv`` and
``bsr_spmm``, each ``:plain`` or ``:cuda:`` and the kernel's variant
(``bsr_spmv:cuda:vector`` / ``:scalar``, ``bsr_spmm:cuda:tiled`` /
``:register``);
``dia_spmm:torch`` (plain torch on any device: the JAX package has no
kernel for a 2-D operand either); ``spgemm_symbolic:native|numpy``; the
supernodal Cholesky's host phases (``chol_ordering:host``,
``chol_symbolic:host``, ``chol_plan:host``, or ``chol_plan:disk`` where
the plan came from the on-disk cache).

Examples
--------
>>> import torch
>>> from spalinalg_tpu_torch import CsrMatrix
>>> from spalinalg_tpu_torch.utils import metrics
>>> rec = metrics.enable()
>>> _ = CsrMatrix.eye(4, device="cpu") @ torch.ones(4, dtype=torch.float64)
>>> rec.records[-1].op, rec.records[-1].path, rec.records[-1].nnz
('csr_spmv', 'csr_spmv:plain', 4)
>>> metrics.disable()
"""

from __future__ import annotations

import json
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Union

import torch

__all__ = ["OpMetrics", "MetricsRecorder", "recorder", "enable", "disable",
           "instrument"]


@dataclass
class OpMetrics:
    op: str
    seconds: float
    path: str = ""
    nnz: int = 0
    flops: int = 0

    @property
    def nnz_per_s(self) -> float:
        return self.nnz / self.seconds if self.seconds else 0.0

    def to_dict(self) -> Dict:
        return {
            "op": self.op, "path": self.path, "seconds": self.seconds,
            "nnz": self.nnz, "flops": self.flops,
            "nnz_per_s": self.nnz_per_s,
        }


@dataclass
class MetricsRecorder:
    """Collects :class:`OpMetrics`; optionally streams JSON lines.

    Disabled by default (no cost on the hot path); enable with
    :func:`enable`."""

    jsonl_stream: Optional[object] = None
    records: List[OpMetrics] = field(default_factory=list)
    enabled: bool = False

    def record(self, m: OpMetrics) -> None:
        self.records.append(m)
        if self.jsonl_stream is not None:
            self.jsonl_stream.write(json.dumps(m.to_dict()) + "\n")

    @contextmanager
    def measure(self, op: str, *, nnz: int = 0, flops: int = 0, sync=None):
        """Time a block and record it as ``op``. ``sync``, if given, runs
        before the clock stops; where the process has used the card, the
        clock stops only after ``torch.cuda.synchronize()`` too, so the
        block's launches are counted to their end."""
        t0 = time.perf_counter()
        yield
        if sync is not None:
            sync()
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        self.record(OpMetrics(op=op, seconds=time.perf_counter() - t0,
                              nnz=nnz, flops=flops))

    def summary(self) -> Dict[str, Dict]:
        out: Dict[str, Dict] = {}
        for m in self.records:
            s = out.setdefault(m.path or m.op,
                               {"count": 0, "seconds": 0.0, "nnz": 0})
            s["count"] += 1
            s["seconds"] += m.seconds
            s["nnz"] += m.nnz
        return out


_GLOBAL = MetricsRecorder()


def recorder() -> MetricsRecorder:
    return _GLOBAL


def enable(jsonl_stream=None) -> MetricsRecorder:
    """Turn on per-op recording (optionally streaming JSON lines)."""
    _GLOBAL.enabled = True
    if jsonl_stream is not None:
        _GLOBAL.jsonl_stream = jsonl_stream
    return _GLOBAL


def disable() -> None:
    _GLOBAL.enabled = False
    _GLOBAL.jsonl_stream = None


def instrument(op: str, fn, *, path: Union[str, Callable[[], str]],
               device: torch.device, nnz: int = 0, flops: int = 0):
    """Run ``fn()``; when the recorder is enabled, time it to completion
    (synchronising ``device`` if it is a GPU) and record an
    :class:`OpMetrics` whose ``path`` is ``f"{op}:{path}"``. ``path`` may
    be a function, called only when recording."""
    rec = _GLOBAL
    if not rec.enabled:
        return fn()
    if callable(path):
        path = path()
    t0 = time.perf_counter()
    out = fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    rec.record(OpMetrics(op=op, seconds=time.perf_counter() - t0,
                         path=f"{op}:{path}", nnz=nnz, flops=flops))
    return out

