"""What the port's own spans give a per-layer metric.

The port keeps a registry of its spans (``spal.spmv``, ``spal.precond``,
...; ``spalinalg_tpu_torch.utils.profiling.span_totals()``) that fills only
while tracing is on: in a traced run, only while the profiler runs, so it
holds the profiled units alone, the window that ``Record.trace``
describes. Those spans also lie on the profiler's timeline, so
``tracing.reduce_profile`` labels an idle gap with the port span the host
was in (``<benchmark span>/spal.spmv``). A program without the registry,
or a run in which a span never opened, gives None.
"""

from __future__ import annotations


def totals(name: str):
    """``{"count", "host_s", "self_s", "device_s"}`` of the port's span
    ``name`` in this process, or None where the port keeps no registry or
    the span never opened."""
    from spalinalg_tpu_torch.utils import profiling

    span_totals = getattr(profiling, "span_totals", None)
    if span_totals is None:
        return None
    t = span_totals().get(name)
    return t if t and t["count"] else None


def per_call(name: str, field: str, scale: float):
    """``scale`` times the span's ``field`` (``host_s``, ``self_s`` or
    ``device_s``) over its count, or None."""
    t = totals(name)
    if t is None or t[field] is None:
        return None
    return scale * t[field] / t["count"]


def idle_share_under(rec, name: str):
    """Per cent of the profiled window in idle gaps whose label ends in
    ``/<name>``: the device idle while the port's span ``name`` was the
    outermost host op. None without a trace or without the span."""
    if rec.trace is None or not rec.trace["window_s"] or totals(name) is None:
        return None
    suffix = "/" + name
    idle = sum(s for label, s in rec.trace["idle_gaps"]
               if label.endswith(suffix))
    return 100.0 * idle / rec.trace["window_s"]
