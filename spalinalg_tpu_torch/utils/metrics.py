"""Metrics tier (counterpart of ``spalinalg_tpu/utils/metrics.py``).

Per-op structured metrics (nnz, flops, bytes moved, achieved rate) through
a host-side recorder with optional JSON-lines output. Each record also
names the dispatch path that ran, for example ``csr_spmv:cuda`` (the
hand-written kernel) or ``csr_spmv:plain`` (the plain torch version on
CPU tensors), so a reader of the records can tell the two apart.

Examples
--------
>>> import torch
>>> from spalinalg_tpu_torch import CsrMatrix
>>> from spalinalg_tpu_torch.utils import metrics
>>> rec = metrics.enable()
>>> _ = CsrMatrix.eye(4) @ torch.ones(4, dtype=torch.float64)
>>> rec.records[-1].op, rec.records[-1].path, rec.records[-1].nnz
('csr_spmv', 'csr_spmv:plain', 4)
>>> metrics.disable()
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

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
    bytes: int = 0

    @property
    def nnz_per_s(self) -> float:
        return self.nnz / self.seconds if self.seconds else 0.0

    @property
    def gbytes_per_s(self) -> float:
        return self.bytes / self.seconds / 1e9 if self.seconds else 0.0

    def to_dict(self) -> Dict:
        return {
            "op": self.op, "path": self.path, "seconds": self.seconds,
            "nnz": self.nnz, "flops": self.flops, "bytes": self.bytes,
            "nnz_per_s": self.nnz_per_s, "gbytes_per_s": self.gbytes_per_s,
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


def instrument(op: str, fn, *, path: str, device: torch.device,
               nnz: int = 0, flops: int = 0, bytes: int = 0):
    """Run ``fn()``; when the recorder is enabled, time it to completion
    (synchronising ``device`` if it is a GPU) and record an
    :class:`OpMetrics` whose ``path`` is ``f"{op}:{path}"``."""
    rec = _GLOBAL
    if not rec.enabled:
        return fn()
    t0 = time.perf_counter()
    out = fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    rec.record(OpMetrics(op=op, seconds=time.perf_counter() - t0,
                         path=f"{op}:{path}", nnz=nnz, flops=flops,
                         bytes=bytes))
    return out
