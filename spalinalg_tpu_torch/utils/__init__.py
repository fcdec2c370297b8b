"""Aux subsystems: metrics, the port's spans and profiling hooks, structure
checks, and the plan caches (in memory and on disk)."""

from .checks import checked_call, checked_structure, determinism_audit
from .metrics import MetricsRecorder, OpMetrics, recorder
from .plancache import StructureCache
from .profiling import annotate, device_sync, trace_to

__all__ = [
    "checked_structure", "checked_call", "determinism_audit",
    "MetricsRecorder", "OpMetrics", "recorder", "annotate", "trace_to",
    "device_sync", "StructureCache",
]
