"""The output check fails its control (the plain reference one precision
down, in the program's place) and every planted fault of the cell, at a
toy size. On the chip the same readings are taken at the cells' own
sizes with ``spbench/tools/readings.py``."""

import time

import pytest
import torch

from spbench import faults, harness
from toy import cell


def _fails(numbers: dict, limits: dict) -> bool:
    return any(not v <= limits[k] for k, v in numbers.items())


@pytest.mark.parametrize("kind", ["cg", "pagerank"])
def test_control_fails(kind, cpu):
    c = cell(kind)
    loop = harness.loop_module(kind)
    for seed in (1, 2, 2 ** 31 + 5):
        ctx = harness.Context(cell=c, seed=seed, device=cpu, tracer=None)
        assert _fails(loop.control(ctx), c.limits)


@pytest.mark.card
def test_gcn_control_fails_on_the_card(card):
    """TF32 exists only on the card."""
    from spalinalg_tpu_torch import default_device

    c = cell("gcn")
    c.config = dict(c.config, scale=14, edgefactor=12, nodes=16384,
                    features=100, train_nodes=2000, classes=47)
    loop = harness.loop_module("gcn")
    with default_device(card):
        for seed in (1, 2, 3):
            ctx = harness.Context(cell=c, seed=seed, device=card, tracer=None)
            assert _fails(loop.control(ctx), c.limits)


FAULT_CASES = [(kind, name) for kind, table in faults.FAULTS.items()
               for name in table]


@pytest.mark.parametrize("kind,name", FAULT_CASES)
def test_fault_makes_correct_false(kind, name, cpu):
    with faults.FAULTS[kind][name]():
        out = harness.run_cell(cell(kind), 7, 0.05, False, time.time(), cpu,
                               print_fn=lambda s: None)
    assert out["correct"] is False


@pytest.mark.card
@pytest.mark.parametrize("kind", ["cg", "gcn", "pagerank"])
def test_traced_toy_run_on_the_card(kind, card):
    """A traced run reads a busy device and every metric of the cell that
    has something to read."""
    from spalinalg_tpu_torch import default_device

    with default_device(card):
        out = harness.run_cell(cell(kind), 7, 0.05, True, time.time(), card,
                               print_fn=lambda s: None)
    assert out["correct"] is True
    assert out["device"]["busy_s"] > 0
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert out["metrics"]
