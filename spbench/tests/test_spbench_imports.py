"""Nothing the benchmark runs imports JAX or the JAX package (top-level
names compared whole), and a run without a card fails with no result."""

import ast
import json
import subprocess
import sys
from pathlib import Path

from spbench import harness

SPBENCH = Path(harness.__file__).resolve().parent


def test_whole_name_comparison():
    assert harness.forbidden_modules({"spalinalg_tpu_torch.ops": 1,
                                      "spalinalg_tpu_torchx": 1}) == []
    assert harness.forbidden_modules({"spalinalg_tpu.ops": 1}) == [
        "spalinalg_tpu"]
    assert harness.forbidden_modules({"jax": 1, "jaxlib.xla": 1,
                                      "flax": 1}) == ["flax", "jax", "jaxlib"]


def test_no_source_imports_jax():
    for path in SPBENCH.rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            for name in names:
                assert name.partition(".")[0] not in harness.FORBIDDEN, \
                    f"{path}: imports {name}"


def test_a_toy_run_loads_no_jax():
    """Every module of the benchmark and a toy run of each loop, in a
    fresh process."""
    code = f"""
import sys, time, json, importlib
sys.path.insert(0, {str(SPBENCH.parent)!r})
sys.path.insert(0, {str(SPBENCH / 'tests')!r})
import torch
from spbench import harness, faults, roofline, tracing
from spbench.tools import readings
from spalinalg_tpu_torch import default_device
import toy
with default_device("cpu"):
    for kind in ("cg", "gcn", "pagerank"):
        harness.run_cell(toy.cell(kind), 3, 0.02, False, time.time(),
                         torch.device("cpu"), print_fn=lambda s: None)
print(json.dumps(harness.forbidden_modules()))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_run_without_a_card_fails_with_no_result(card_absent):
    out = subprocess.run(
        [sys.executable, str(SPBENCH / "run.py"), "--workload",
         "hpcg-256.cg50", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
