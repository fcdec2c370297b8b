"""What a traced run reads: the benchmark's own host spans, CUDA-event
timings of the port's public calls, and the reduction of a
``torch.profiler`` trace to busy time, idle gaps and the device's busiest
operations.

Everything here is recorded from the benchmark's files, around calls into
the port; nothing reads a span or a timer inside the port.
"""

from __future__ import annotations

import bisect
import contextlib
from collections import defaultdict

import torch

WINDOW_SPAN = "bench.window"


class Tracer:
    """Host spans and event timers of one run, each inert until switched
    on.

    ``span(name)`` marks a stretch of host work in the profiler's trace
    (the labels of idle gaps) while ``spans`` is on; spans do not nest.
    ``start(key)`` / ``stop(key)`` bracket device work with two CUDA events
    on the current stream while ``events`` is on; ``brackets(key)`` gives
    their elapsed times once the work is done.
    """

    def __init__(self):
        self.spans = False
        self.events = False
        self._pairs = defaultdict(list)

    def span(self, name: str):
        if not self.spans:
            return contextlib.nullcontext()
        return torch.profiler.record_function(name)

    def start(self, key: str, work=None) -> None:
        """Open a bracket under ``key``; ``work`` is what its call must do,
        ``(bytes, flops, itemsize)`` from ``roofline``."""
        if not self.events:
            return
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self._pairs[key].append([ev, None, work])

    def stop(self, key: str) -> None:
        """Close the bracket opened last under ``key``."""
        if not self.events:
            return
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self._pairs[key][-1][1] = ev

    @contextlib.contextmanager
    def timed(self, key: str, work=None):
        self.start(key, work)
        try:
            yield
        finally:
            self.stop(key)

    def brackets(self, key: str) -> list:
        """``(device seconds, work)`` of every closed bracket under
        ``key``."""
        out = []
        for a, b, work in self._pairs.get(key, ()):
            if b is not None:
                b.synchronize()
                out.append((a.elapsed_time(b) / 1e3, work))
        return out


def _union(intervals):
    """Merged, sorted ``[start, end]`` intervals."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _outermost(events):
    """``(starts, list of (start, end, name))`` of the events not inside an
    earlier one, sorted by start."""
    out = []
    for s, e, name in sorted(events, key=lambda t: (t[0], -t[1])):
        if out and s < out[-1][1]:
            continue
        out.append((s, e, name))
    return [t[0] for t in out], out


def _covering(index, t):
    starts, evs = index
    i = bisect.bisect_right(starts, t) - 1
    if i >= 0 and evs[i][1] >= t:
        return evs[i][2]
    return None


def reduce_profile(events, span_prefixes=()):
    """Reduce a profiler's events (``prof.events()``) to a dict:

    - ``window_s``: the duration of the ``bench.window`` span;
    - ``busy_s``: the union of device operations' intervals inside it;
    - ``device_ops``: ``(name, seconds, count)`` by name, busiest first;
    - ``idle_gaps``: ``(label, seconds)`` summed by label, longest first,
      each label ``<benchmark span>/<outermost host op>`` over the gap's
      middle (``python`` where no op runs there);
    - ``device_count``: the device operations inside the window.
    """
    window = None
    dev, host, spans = [], [], []
    ours = (WINDOW_SPAN, *span_prefixes)
    for e in events:
        s, t = float(e.time_range.start), float(e.time_range.end)
        if e.device_type == torch.autograd.DeviceType.CUDA:
            # the benchmark's spans are mirrored on the device's timeline
            # as annotations: no device work
            if not (getattr(e, "is_user_annotation", False)
                    or e.name.startswith(ours)):
                dev.append((s, t, e.name))
        elif e.name == WINDOW_SPAN:
            window = (s, t)
        elif e.name.startswith(tuple(span_prefixes)):
            spans.append((s, t, e.name))
        else:
            host.append((s, t, e.name))
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW_SPAN!r} span")
    w0, w1 = window
    inside = [(max(s, w0), min(t, w1), n) for s, t, n in dev
              if t > w0 and s < w1]
    busy = _union([(s, t) for s, t, _ in inside])
    per_name = defaultdict(lambda: [0.0, 0])
    for s, t, n in inside:
        per_name[n][0] += t - s
        per_name[n][1] += 1
    ops = sorted(((n, v[0] / 1e6, v[1]) for n, v in per_name.items()),
                 key=lambda r: -r[1])
    host_idx = _outermost(host)
    span_idx = _outermost(spans)
    gaps = defaultdict(float)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = 0.5 * (a + b)
        label = (f"{_covering(span_idx, mid) or 'bench'}/"
                 f"{_covering(host_idx, mid) or 'python'}")
        gaps[label] += (b - a) / 1e6
    return {
        "window_s": (w1 - w0) / 1e6,
        "busy_s": sum(t - s for s, t in busy) / 1e6,
        "device_ops": ops,
        "idle_gaps": sorted(gaps.items(), key=lambda kv: -kv[1]),
        "device_count": len(inside),
    }
