"""The benchmark's driver: one cell, one seed, one run.

Everything particular to a cell is found by name from ``BENCHMARK.json``:
its configuration (``configs/<config>.json``: a structure generator and
its sizes), its traffic (``traffic/<traffic>.json``: a loop kind and its
parameters), the limits of its output check (``limits/<cell>.json``), the
loop (``loops/<loop>.py``, with its plain reference beside it as
``loops/<loop>_ref.py``) and one reader a per-layer metric
(``metrics/<metric>.py``).

A run: set-up (inputs from ``--seed`` on the card, the matrix built by the
port's device path, the cell's shapes warmed), then either the measured
window (``--trace 0``: whole units until ``--seconds`` have passed, the
cell's end-to-end metrics over all of them) or the traced run (``--trace
1``: units under ``torch.profiler``, units bracketed by CUDA events, one
unit with the port's metrics recorder on; the cell's per-layer metrics),
then the output check against the plain reference once the program's
state is freed, then one JSON line.

A cell on several cards runs this in every rank of a gang (``gang.py``):
one window that rank 0 opens and closes and every rank runs the same
units of, every rank traced and checked, and rank 0 gathering their
readings.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import random
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch

from . import tracing

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "spalinalg_tpu")
RESULT_KEYS = ("correct", "attempted", "failed", "metrics", "device")


class BenchError(RuntimeError):
    """A run that cannot report: no card, a forbidden import, a missing
    file."""


def forbidden_modules(modules=None):
    """Top-level names in ``sys.modules`` that the run may not hold,
    compared whole (``spalinalg_tpu_torch`` is not ``spalinalg_tpu``)."""
    modules = sys.modules if modules is None else modules
    tops = {name.partition(".")[0] for name in list(modules)}
    return sorted(t for t in tops if t in FORBIDDEN)


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    """A cell's entries and files, read from ``BENCHMARK.json``."""

    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list          # metric entries this cell reports
    per_layer: list


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise BenchError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]

    def mine(entry):
        return name in entry.get("workloads", [name])

    return Cell(
        name=name, chips=int(w["chips"]),
        config=load_json(root / conf["file"]),
        traffic=load_json(HERE / "traffic" / f"{w['traffic']}.json"),
        limits=load_json(HERE / "limits" / f"{name}.json"),
        end_to_end=[m for m in bench["end_to_end"] if mine(m)],
        per_layer=[m for m in bench["per_layer"] if mine(m)])


def loop_module(kind: str):
    return importlib.import_module(f"spbench.loops.{kind}")


def metric_reader(name: str):
    """The ``read(record)`` function of ``metrics/<name>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"spbench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Reservoir:
    """A uniform sample of at most ``k`` of the answers offered, drawn from
    the seed (reservoir sampling): references kept, nothing copied."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = random.Random(int(seed) ^ 0x5EED)
        self.items = []
        self.seen = 0

    def offer(self, make):
        """Offer the ``seen``-th answer; ``make()`` gives it where kept."""
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(make())
        else:
            j = self.rng.randrange(self.seen)
            if j < self.k:
                self.items[j] = make()


@dataclass
class Context:
    """What a loop's set-up gets. ``rank``, ``world`` and ``group`` (the
    harness's gloo group; None on one card) are what a loop's multi-rank
    branch reads; the port's collectives run on the default group."""

    cell: Cell
    seed: int
    device: torch.device
    tracer: tracing.Tracer
    timings: dict = field(default_factory=dict)   # host seconds by name
    notes: dict = field(default_factory=dict)     # printed, not compared
    rank: int = 0
    world: int = 1
    group: object = None


@dataclass
class Record:
    """What a per-layer metric's reader reads."""

    cell: str
    trace: dict               # tracing.reduce_profile of the traced units
    tracer: tracing.Tracer    # CUDA-event brackets of the timed units
    iterations: int           # solver iterations in the traced units
    busy_s: float             # device busy seconds
    peak_bytes: int           # device memory peak
    timings: dict
    # every rank's readings in rank order (one entry on one card):
    # ``rank``, ``units``, ``peak_bytes``, ``trace``, ``busy_s`` and, traced,
    # ``window_s`` (else ``agree_us``); the fields above are rank 0's
    ranks: list = field(default_factory=list)


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "power limit not read"


CLOCK_QUERIES = ("clocks.sm,power.draw,clocks_event_reasons.active",
                 # the same, as nvidia-smi named it before the rename
                 "clocks.sm,power.draw,clocks_throttle_reasons.active")


def card_clocks(device) -> str:
    """The card's SM clock, power draw and active throttle reasons, as
    ``nvidia-smi`` reads them (None off the card)."""
    if device.type != "cuda":
        return None
    # by UUID: nvidia-smi's indices need not follow CUDA's order
    card = f"GPU-{torch.cuda.get_device_properties(device).uuid}"
    for query in CLOCK_QUERIES:
        try:
            out = subprocess.run(
                ["nvidia-smi", f"--query-gpu={query}", "-i", card,
                 "--format=csv,noheader"], capture_output=True, text=True,
                timeout=30)
        except (OSError, subprocess.SubprocessError):
            break
        if out.returncode == 0 and out.stdout.strip():
            return f"{query}: {out.stdout.strip()}"
    return "clocks not read"


def peak_bytes(device) -> int:
    """The device's memory peak since the run reset it (0 off the card)."""
    return torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0


def _window(loop, state, seconds: float, gang=None) -> tuple:
    """Whole units until ``seconds`` have passed; ``(units, seconds,
    agreeing seconds)`` to the end of the last one's device work. In a gang
    the window opens after a barrier, rank 0's clock decides after each
    unit whether it has passed, every rank gets that decision, and the
    window closes after a barrier once every rank's work is done."""
    units = 0
    agree_s = 0.0
    if gang is not None:
        gang.barrier()
    t0 = time.perf_counter()
    deadline = t0 + seconds
    while True:
        loop.unit(state)
        units += 1
        if gang is None:
            if time.perf_counter() >= deadline:
                break
        else:
            t = time.perf_counter()
            stop = gang.agree(t >= deadline)
            agree_s += time.perf_counter() - t
            if stop:
                break
    loop.sync(state)
    if gang is not None:
        gang.barrier()
    return units, time.perf_counter() - t0, agree_s


def _traced(loop, state, ctx: Context, gang=None):
    """The traced run's three phases: ``trace_units`` units under the
    profiler with the benchmark's spans on, ``timed_units`` units with
    CUDA-event brackets on, and one unit with the port's metrics recorder
    on. Returns the reduced trace, the units run, the solver iterations of
    the profiled units and the variant paths the recorder saw."""
    from torch.profiler import ProfilerActivity, profile

    traffic = ctx.cell.traffic
    tracer = ctx.tracer
    loop.sync(state)
    units = 0
    it0 = state.iterations
    tracer.spans = True
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        if gang is not None:
            gang.barrier()         # every rank's profiler is on: one window
        with torch.profiler.record_function(tracing.WINDOW_SPAN):
            for _ in range(int(traffic["trace_units"])):
                loop.unit(state)
                units += 1
            loop.sync(state)
    tracer.spans = False
    iterations = state.iterations - it0
    reduced = tracing.reduce_profile(prof.events(),
                                     span_prefixes=(traffic["loop"] + ".",))
    del prof
    tracer.events = True
    for _ in range(int(traffic["timed_units"])):
        loop.unit(state)
        units += 1
    loop.sync(state)
    tracer.events = False
    from spalinalg_tpu_torch.utils import metrics as port_metrics

    rec = port_metrics.enable()
    rec.records.clear()
    loop.unit(state)
    units += 1
    loop.sync(state)
    paths = sorted({r.path for r in rec.records})
    port_metrics.disable()
    rec.records.clear()
    return reduced, units, iterations, paths


def _check_modules(where: str) -> None:
    found = forbidden_modules()
    if found:
        raise BenchError(f"{where}: sys.modules holds {', '.join(found)}; "
                         "the benchmark measures the port alone")


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             t_start: float, device, print_fn=print,
             imported_s: float = None, gang=None):
    """One run of ``cell`` on ``device``: set-up, window or trace, check.
    ``t_start`` is the wall-clock time the run started. Returns the result
    dict with the compared numbers under ``checks``. In a gang (``gang``,
    this rank's :class:`gang.Gang`) every rank runs this; rank 0 gets the
    result, from every rank's readings, and every other rank None."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tracer = tracing.Tracer()
    ctx = Context(cell=cell, seed=int(seed), device=device, tracer=tracer)
    if gang is not None:
        ctx.rank, ctx.world, ctx.group = gang.rank, gang.world, gang.group
    if imported_s is not None:
        ctx.timings["imports_s"] = imported_s
    loop = loop_module(cell.traffic["loop"])
    is_cuda = device.type == "cuda"
    if is_cuda:
        torch.cuda.set_device(device)
        torch.cuda.reset_peak_memory_stats(device)
    state = loop.setup(ctx)
    loop.sync(state)
    setup_s = time.time() - t_start
    metrics = {}
    reduced, paths, iterations, agree_s = None, [], 0, 0.0
    clocks_before = card_clocks(device)
    if not trace:
        units, window_s, agree_s = _window(loop, state, seconds, gang)
        if ctx.rank == 0:
            values = loop.end_to_end(state, units, window_s)
            values["setup_s"] = setup_s
            for m in cell.end_to_end:
                if m["name"] in values:
                    metrics[m["name"]] = {"value": values[m["name"]],
                                          "unit": m["unit"]}
    else:
        reduced, units, iterations, paths = _traced(loop, state, ctx, gang)
    if is_cuda:
        ctx.notes["clocks"] = {"before": clocks_before,
                               "after": card_clocks(device)}
    peak = peak_bytes(device)
    _check_modules("after the window")
    busy = reduced["busy_s"] if reduced else 0.0
    checks = loop.check(state, cell.limits)        # frees the program first
    state = None
    mine = {"rank": ctx.rank, "units": units, "peak_bytes": int(peak),
            "trace": reduced, "busy_s": busy}
    if trace:
        mine["window_s"] = reduced["window_s"]
    else:
        mine["agree_us"] = 1e6 * agree_s / units
    # every rank past its check, or rank 0 waits here until the launcher
    # ends the gang
    ranks = [mine] if gang is None else gang.gather(mine)
    if trace:
        print_fn("variant paths: " + json.dumps(paths))
        print_fn("device ops: " + json.dumps(
            [[n, s, c] for n, s, c in reduced["device_ops"][:20]]))
    if ranks is None:                              # not rank 0
        print_fn("timings: " + json.dumps(ctx.timings))
        if ctx.notes:
            print_fn("notes: " + json.dumps(ctx.notes))
        return None
    if gang is not None:
        ctx.notes["ranks"] = [
            {k: v for k, v in r.items() if k not in ("trace", "busy_s")}
            | ({"busy_share": r["busy_s"] / r["window_s"]} if trace else {})
            for r in ranks]
    record = Record(cell=cell.name, trace=reduced, tracer=tracer,
                    iterations=iterations, busy_s=busy, peak_bytes=peak,
                    timings=ctx.timings, ranks=ranks)
    if trace:
        for m in cell.per_layer:
            value = metric_reader(m["name"])(record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    failed = sum(1 for c in checks.values() if not c["value"] <= c["limit"])
    dev = {"platform": "gpu",
           "kind": torch.cuda.get_device_name(device) if is_cuda else "cpu",
           "count": cell.chips,
           "memory_peak_bytes": max(r["peak_bytes"] for r in ranks)}
    out = {"correct": failed == 0 and bool(checks), "attempted": units,
           "failed": failed, "metrics": metrics, "device": dev}
    if trace:
        # the idlest card: it waits longest on the others
        idle = min(ranks, key=lambda r: r["busy_s"] / r["window_s"])
        dev["busy_s"] = idle["busy_s"]
        dev["window_s"] = idle["window_s"]
        out["breakdown"] = {
            "device_ops": [[n, s] for n, s, _ in
                           idle["trace"]["device_ops"][:10]],
            "idle_gaps": [[n, s] for n, s in idle["trace"]["idle_gaps"][:10]]}
    print_fn("timings: " + json.dumps(ctx.timings))
    if ctx.notes:
        print_fn("notes: " + json.dumps(ctx.notes))
    out["notes"] = ctx.notes
    out["checks"] = checks
    return out


def emit(out: dict) -> None:
    """The compared numbers as the last lines on stderr, and the result as
    the last line on stdout (``checks`` its last key)."""
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    keys = list(RESULT_KEYS) + (["breakdown"] if "breakdown" in out else [])
    line = {k: out[k] for k in keys}
    line["checks"] = out["checks"]
    print(json.dumps(line), flush=True)
