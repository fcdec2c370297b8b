"""The result line: its exact keys, the compared numbers last, on a toy
cell run on the CPU (the look for a card skipped); the reduction of a
trace; the file layout that BENCHMARK.json names."""

import json
import time
import types

import pytest
import torch

from spbench import harness, tracing
from toy import cell


@pytest.mark.parametrize("kind", ["cg", "gcn", "pagerank"])
def test_last_line_keys(kind, cpu, capsys):
    out = harness.run_cell(cell(kind), 2 ** 31 + 77, 0.05, False,
                           time.time(), cpu)
    harness.emit(out)
    captured = capsys.readouterr()
    line = json.loads(captured.out.strip().splitlines()[-1])
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    assert "setup_s" in line["metrics"]
    assert all(set(m) == {"value", "unit"} for m in line["metrics"].values())
    err = captured.err.strip().splitlines()
    checks = line["checks"]
    assert err[-len(checks):] == [
        f"check {k} {c['value']!r} limit {c['limit']!r}"
        for k, c in checks.items()]


def _event(name, start, end, device=False):
    return types.SimpleNamespace(
        name=name, time_range=types.SimpleNamespace(start=start, end=end),
        device_type=(torch.autograd.DeviceType.CUDA if device
                     else torch.autograd.DeviceType.CPU))


def test_reduce_profile_takes_the_union():
    events = [
        _event(tracing.WINDOW_SPAN, 0, 100),
        _event("cg.solve", 0, 100),
        _event("aten::item", 40, 60),
        _event("k1", 10, 30, True),
        _event("k2", 20, 40, True),          # overlaps k1: counted once
        _event("k3", 60, 70, True),
        _event("k1", 90, 110, True),         # clipped at the window's end
        _event("cg.solve", 0, 100, True),    # an annotation: no work
        _event(tracing.WINDOW_SPAN, 0, 100, True),
    ]
    r = tracing.reduce_profile(events, ("cg.",))
    assert r["window_s"] == pytest.approx(100e-6)
    assert r["busy_s"] == pytest.approx(50e-6)
    assert r["device_count"] == 4
    assert [n for n, _, _ in r["device_ops"]][0] == "k1"
    gaps = dict(r["idle_gaps"])
    assert gaps["cg.solve/aten::item"] == pytest.approx(20e-6)
    assert gaps["cg.solve/python"] == pytest.approx(30e-6)


def test_benchmark_files_exist():
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    for w in bench["workloads"]:
        c = harness.load_cell(w["name"])
        harness.loop_module(c.traffic["loop"])
        assert c.end_to_end and c.per_layer
        for m in c.per_layer:
            assert callable(harness.metric_reader(m["name"]))
    for c in bench["configs"]:
        assert (harness.ROOT / c["file"]).is_file()
