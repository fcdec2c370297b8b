"""The port's spans (``spalinalg_tpu_torch/utils/profiling.py``): off, a
span is one shared null context (no ``record_function``, no clock, no
event); on (a profiler running, or inside ``profiling.tracing()``), each
``spal.*`` span is counted once per call in the registry and, under the
profiler, appears in its events; self time is host time less the child
spans'; ``linalg.cg`` names its Jacobi set-up ``spal.precond`` and each
product ``spal.spmv``, which no other port span encloses; no port span
takes a name the benchmark reads as its own.
"""

import re
import sys
import threading
import time
import types
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import spalinalg_tpu_torch as tsp
from spalinalg_tpu_torch.linalg import cg
from spalinalg_tpu_torch.utils import profiling

PACKAGE = Path(tsp.__file__).resolve().parent
BENCH_PREFIXES = ("bench.", "cg.", "gcn.", "pagerank.")


@pytest.fixture(autouse=True)
def _cpu_scope():
    """CPU tensors, and an empty registry before and after each test."""
    profiling.reset()
    with tsp.default_device("cpu"):
        yield
    profiling.reset()


def _tridiag(n=64, dtype=torch.float64, fmt="csr"):
    d = (np.diag(np.full(n, 4.0)) + np.diag(np.full(n - 1, -1.0), 1)
         + np.diag(np.full(n - 1, -1.0), -1))
    cls = tsp.CsrMatrix if fmt == "csr" else tsp.CscMatrix
    return cls.from_dense(torch.from_numpy(d).to(dtype))


def _operand(op, n, dtype):
    return (torch.ones(n, dtype=dtype) if op == "spmv"
            else torch.ones(n, 3, dtype=dtype))


def _boom(*args, **kwargs):
    raise AssertionError("called while tracing is off")


def _forbid_recording(monkeypatch):
    """Make every recording primitive a span could touch raise."""
    monkeypatch.setattr(torch.profiler, "record_function", _boom)
    monkeypatch.setattr(profiling, "_record_function", _boom)
    monkeypatch.setattr(profiling, "time",
                        types.SimpleNamespace(perf_counter=_boom))
    monkeypatch.setattr(torch.cuda, "Event", _boom)


def test_off_is_the_shared_null_context():
    assert not torch.autograd._profiler_enabled()
    a = profiling.annotate("spal.a")
    b = profiling.annotate("spal.b", device=True)
    assert a is b
    with a:
        pass
    assert profiling.span_totals() == {}


def test_off_builds_no_record_function_and_reads_no_clock(monkeypatch):
    A = _tridiag()
    _forbid_recording(monkeypatch)
    with profiling.annotate("spal.test", device=True):
        y = A @ torch.ones(64, dtype=torch.float64)
    assert float(y.sum()) == pytest.approx(2 * 64 + 2)
    assert profiling.span_totals() == {}


@pytest.mark.parametrize("fmt", ["csr", "csc"])
@pytest.mark.parametrize("op", ["spmv", "spmm"])
def test_off_product_leaves_registry_empty(fmt, op):
    A = _tridiag(fmt=fmt)
    A @ _operand(op, 64, torch.float64)
    assert profiling.span_totals() == {}


@pytest.mark.parametrize("fmt", ["csr", "csc"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("op", ["spmv", "spmm"])
def test_profiler_counts_each_product(fmt, dtype, op):
    A = _tridiag(dtype=dtype, fmt=fmt)
    x = _operand(op, 64, dtype)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            A @ x
    totals = profiling.span_totals()
    name = f"spal.{op}"
    other = "spal.spmm" if op == "spmv" else "spal.spmv"
    assert totals[name]["count"] == 3
    assert other not in totals
    assert totals[name]["host_s"] > 0
    assert totals[name]["device_s"] is None
    names = [e.name for e in prof.events()]
    assert names.count(name) == 3


def test_tracing_records_without_a_profiler(monkeypatch):
    A = _tridiag()
    monkeypatch.setattr(profiling, "_record_function", _boom)
    with profiling.tracing():
        assert not torch.autograd._profiler_enabled()
        A @ torch.ones(64, dtype=torch.float64)
        A @ torch.ones(64, 2, dtype=torch.float64)
    A @ torch.ones(64, dtype=torch.float64)          # off again: not counted
    totals = profiling.span_totals()
    assert totals["spal.spmv"]["count"] == 1
    assert totals["spal.spmm"]["count"] == 1


def test_tracing_scopes_nest():
    with profiling.tracing():
        with profiling.tracing():
            pass
        with profiling.annotate("spal.inner"):
            pass
    with profiling.annotate("spal.after"):
        pass
    assert set(profiling.span_totals()) == {"spal.inner"}


def test_self_time_is_host_time_less_the_children():
    with profiling.tracing():
        with profiling.annotate("spal.outer"):
            time.sleep(0.002)
            for _ in range(2):
                with profiling.annotate("spal.mid"):
                    time.sleep(0.001)
                    with profiling.annotate("spal.leaf"):
                        time.sleep(0.001)
    t = profiling.span_totals()
    assert t["spal.outer"]["count"] == 1
    assert t["spal.mid"]["count"] == t["spal.leaf"]["count"] == 2
    assert t["spal.outer"]["self_s"] == pytest.approx(
        t["spal.outer"]["host_s"] - t["spal.mid"]["host_s"], rel=1e-9)
    assert t["spal.mid"]["self_s"] == pytest.approx(
        t["spal.mid"]["host_s"] - t["spal.leaf"]["host_s"], rel=1e-9)
    assert t["spal.leaf"]["self_s"] == t["spal.leaf"]["host_s"]
    assert t["spal.outer"]["self_s"] >= 0.002
    assert t["spal.mid"]["self_s"] >= 0.002


def test_span_closes_on_an_exception():
    with profiling.tracing():
        with pytest.raises(ValueError):
            with profiling.annotate("spal.fails"):
                raise ValueError("inside")
        with profiling.annotate("spal.next"):
            pass
    t = profiling.span_totals()
    assert t["spal.fails"]["count"] == 1
    # the failed span was popped: the next one is no child of it
    assert t["spal.fails"]["self_s"] == t["spal.fails"]["host_s"]


@pytest.mark.parametrize("device", [True, torch.device("cpu")])
def test_device_span_on_the_cpu_times_nothing(device):
    with profiling.tracing():
        with profiling.annotate("spal.dev", device=device):
            torch.ones(8).sum()
    t = profiling.span_totals()["spal.dev"]
    assert t["count"] == 1 and t["device_s"] in (None, 0.0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cg_counts_precond_once_and_each_spmv(dtype):
    A = _tridiag(n=80, dtype=dtype)
    b = torch.ones(80, dtype=dtype)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = cg(A, b, tol=0.0, maxiter=12, precondition="jacobi")
    assert res.iterations == 12
    t = profiling.span_totals()
    assert t["spal.precond"]["count"] == 1
    assert t["spal.spmv"]["count"] == res.iterations + 1
    names = [e.name for e in prof.events()]
    assert names.count("spal.precond") == 1
    assert names.count("spal.spmv") == res.iterations + 1


def test_no_port_span_encloses_an_spmv_on_the_cg_path():
    A = _tridiag(n=80)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        cg(A, torch.ones(80, dtype=torch.float64), tol=0.0, maxiter=6,
           precondition="jacobi")
    spans = [e for e in prof.events() if e.name.startswith("spal.")]
    spmvs = [e for e in spans if e.name == "spal.spmv"]
    assert len(spmvs) == 7
    for s in spmvs:
        a, b = s.time_range.start, s.time_range.end
        assert not [o.name for o in spans if o is not s
                    and o.time_range.start <= a and o.time_range.end >= b]


def test_reset_clears():
    with profiling.tracing():
        _tridiag() @ torch.ones(64, dtype=torch.float64)
    assert profiling.span_totals()["spal.spmv"]["count"] == 1
    profiling.reset()
    assert profiling.span_totals() == {}
    with profiling.tracing():
        _tridiag() @ torch.ones(64, dtype=torch.float64)
    assert profiling.span_totals()["spal.spmv"]["count"] == 1


def _source_span_names():
    pattern = re.compile(r"""annotate\(\s*["']([^"']+)["']""")
    names = set()
    for path in PACKAGE.rglob("*.py"):
        names.update(pattern.findall(path.read_text()))
    return names


def test_port_span_names_are_not_the_benchmarks():
    with profile(activities=[ProfilerActivity.CPU]):
        cg(_tridiag(), torch.ones(64, dtype=torch.float64), tol=0.0,
           maxiter=3, precondition="jacobi")
        _tridiag(fmt="csc") @ torch.ones(64, 2, dtype=torch.float64)
    seen = set(profiling.span_totals())
    in_source = _source_span_names()
    assert {"spal.spmv", "spal.spmm", "spal.precond"} <= seen
    assert {"spal.spmv", "spal.spmv.plan", "spal.spmm", "spal.launch",
            "spal.precond"} <= in_source
    for name in seen | in_source:
        assert name.startswith("spal."), name
        assert not name.startswith(BENCH_PREFIXES), name


def test_registry_keeps_every_span_across_threads():
    """Spans opened by many threads at once (autograd's backward runs on
    its own thread) lose no count and nest only within their thread."""
    per_thread, threads = 400, 12
    errors = []

    def work():
        try:
            for _ in range(per_thread):
                with profiling.annotate("spal.t_outer"):
                    with profiling.annotate("spal.t_inner"):
                        pass
        except Exception as exc:                 # reported below
            errors.append(exc)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with profiling.tracing():
            pool = [threading.Thread(target=work) for _ in range(threads)]
            for th in pool:
                th.start()
            for th in pool:
                th.join(timeout=60)
            assert not any(th.is_alive() for th in pool)
    finally:
        sys.setswitchinterval(old)
    assert not errors
    t = profiling.span_totals()
    assert t["spal.t_outer"]["count"] == per_thread * threads
    assert t["spal.t_inner"]["count"] == per_thread * threads
    assert t["spal.t_inner"]["self_s"] == t["spal.t_inner"]["host_s"]
    assert t["spal.t_outer"]["self_s"] == pytest.approx(
        t["spal.t_outer"]["host_s"] - t["spal.t_inner"]["host_s"],
        rel=1e-6, abs=1e-9)
