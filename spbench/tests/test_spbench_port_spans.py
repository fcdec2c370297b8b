"""The readers of the port's spans (``metrics/spmv_host_us.*``,
``spmv_idle_share.*``, ``jacobi_ms.cg``): each value from a fake record and
a filled registry, None with no span, and the idle shares summing only the
gaps labelled ``*/spal.spmv``."""

import types

import pytest
import torch

from spbench import harness, port_spans
from spalinalg_tpu_torch.utils import profiling

HOST = ["spmv_host_us.cg", "spmv_host_us.pagerank"]
IDLE = ["spmv_idle_share.cg", "spmv_idle_share.pagerank"]
ALL = HOST + IDLE + ["jacobi_ms.cg"]

TOTALS = {
    "spal.spmv": {"count": 4, "host_s": 8e-4, "self_s": 6e-4,
                  "device_s": None},
    "spal.precond": {"count": 2, "host_s": 1e-3, "self_s": 1e-3,
                     "device_s": 0.05},
}
TRACE = {
    "window_s": 0.5, "busy_s": 0.4, "device_ops": [], "device_count": 0,
    "idle_gaps": [["cg.solve/spal.spmv", 0.03],
                  ["pagerank.spmv/spal.spmv", 0.02],
                  ["cg.solve/spal.spmv.plan", 0.5],       # not the span
                  ["cg.solve/CsrSpmv", 0.25],
                  ["pagerank.readback/aten::item", 0.01],
                  ["bench/python", 0.004]],
}


def _record(trace=TRACE):
    return types.SimpleNamespace(cell="toy", trace=trace, tracer=None,
                                 iterations=0, busy_s=0.4, peak_bytes=0,
                                 timings={})


@pytest.fixture
def filled(monkeypatch):
    monkeypatch.setattr(profiling, "span_totals", lambda: TOTALS)


@pytest.fixture
def empty(monkeypatch):
    monkeypatch.setattr(profiling, "span_totals", lambda: {})


@pytest.mark.parametrize("name", HOST)
def test_host_us_per_call(name, filled):
    assert harness.metric_reader(name)(_record()) == pytest.approx(200.0)


@pytest.mark.parametrize("name", IDLE)
def test_idle_share_sums_only_spal_spmv(name, filled):
    # 0.03 + 0.02 of 0.5 s; "/spal.spmv.plan" and "/CsrSpmv" do not count
    assert harness.metric_reader(name)(_record()) == pytest.approx(10.0)


def test_jacobi_ms_per_call(filled):
    assert harness.metric_reader("jacobi_ms.cg")(_record()) == \
        pytest.approx(25.0)


@pytest.mark.parametrize("name", ALL)
def test_none_without_the_span(name, empty):
    assert harness.metric_reader(name)(_record()) is None


@pytest.mark.parametrize("name", ALL)
def test_none_without_the_registry(name, monkeypatch):
    """A port that keeps no registry (the program before its spans) gives
    None and raises nothing."""
    monkeypatch.delattr(profiling, "span_totals")
    assert harness.metric_reader(name)(_record()) is None


def test_none_without_device_time(monkeypatch):
    totals = {"spal.precond": dict(TOTALS["spal.precond"], device_s=None)}
    monkeypatch.setattr(profiling, "span_totals", lambda: totals)
    assert harness.metric_reader("jacobi_ms.cg")(_record()) is None


@pytest.mark.parametrize("name", IDLE)
def test_idle_share_none_without_a_trace(name, filled):
    assert harness.metric_reader(name)(_record(trace=None)) is None


def test_idle_share_zero_when_no_gap_is_the_spans(filled):
    trace = dict(TRACE, idle_gaps=[["bench/python", 0.1]])
    assert port_spans.idle_share_under(_record(trace), "spal.spmv") == 0.0


def test_reads_the_real_registry(cpu):
    """The port's own registry, filled by products inside ``tracing()``."""
    from spalinalg_tpu_torch import CsrMatrix

    profiling.reset()
    try:
        a = CsrMatrix.eye(8)
        with profiling.tracing():
            for _ in range(3):
                a @ torch.ones(8, dtype=torch.float64)
        t = profiling.span_totals()["spal.spmv"]
        got = harness.metric_reader("spmv_host_us.cg")(_record())
        assert t["count"] == 3
        assert got == pytest.approx(1e6 * t["host_s"] / 3)
        assert harness.metric_reader("jacobi_ms.cg")(_record()) is None
    finally:
        profiling.reset()


def test_entries_name_their_cells():
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    entries = {m["name"]: m for m in bench["per_layer"]}
    cells = {"cg": "hpcg-256.cg50", "pagerank": "graph500-s22.pagerank20"}
    for name in ALL:
        assert entries[name]["workloads"] == [cells[name.rsplit(".")[-1]]]
        assert name in [m["name"] for m in
                        harness.load_cell(cells[name.rsplit(".")[-1]])
                        .per_layer]
