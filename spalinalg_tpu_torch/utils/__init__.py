"""Aux subsystems: the metrics recorder and the structure plan cache."""

from .metrics import MetricsRecorder, OpMetrics, recorder
from .plancache import StructureCache

__all__ = ["MetricsRecorder", "OpMetrics", "recorder", "StructureCache"]
