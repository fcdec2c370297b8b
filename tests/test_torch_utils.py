"""The port's utils tier against the JAX package's: the structure checks
(the JAX ``tests/test_checks.py`` cases, on corrupted port structures, with
the JAX messages), ``determinism_audit``, ``trace_to`` and ``annotate``,
``device_sync``, ``MetricsRecorder.measure``, ``StructureCache.clear``; and ``heartbeat()``
in a fresh process with no process group.
"""

import glob
import io
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import spalinalg_tpu as jsp
import spalinalg_tpu_torch as tsp
from spalinalg_tpu.utils import checks as jchecks
from spalinalg_tpu_torch.errors import StructureError
from spalinalg_tpu_torch.utils import checks, metrics, profiling
from spalinalg_tpu_torch.utils.plancache import StructureCache


@pytest.fixture(autouse=True)
def _cpu_scope():
    """The port's entry points place data on the card unless told
    otherwise; these tests run on the CPU."""
    with tsp.default_device("cpu"):
        yield


def _i32(a):
    return torch.tensor(a, dtype=torch.int32)


def corrupt(what, pkg):
    """The 2 x 2 identity-like CSR with one fault, in ``pkg``."""
    m = pkg.CsrMatrix(2, 2, [0, 1, 2], [0, 1], [1.0, 2.0])
    ptr, minor = {"ok": ([0, 1, 2], [0, 1]),
                  "minor": ([0, 1, 2], [0, 7]),
                  "negative": ([0, 1, 2], [-1, 1]),
                  "monotone": ([0, 2, 1], [0, 1]),
                  "ptr0": ([1, 1, 2], [0, 1]),
                  "capacity": ([0, 1, 3], [0, 1])}[what]
    if pkg is jsp:
        return type(m)._from_parts(2, 2, jnp.asarray(ptr, dtype=jnp.int32),
                                   jnp.asarray(minor, dtype=jnp.int32),
                                   m.values)
    return type(m)._from_parts(2, 2, _i32(ptr), _i32(minor), m.values)


def test_valid_passes():
    err = checks.checked_structure(corrupt("ok", tsp))()
    assert err.get() is None
    err.throw()  # no exception


@pytest.mark.parametrize("what,message", [
    ("minor", "minor index out of range"),
    ("negative", "minor index out of range"),
    ("monotone", "monotone"),
    ("ptr0", "ptr\\[0\\] must be 0"),
    ("capacity", "nnz exceeds stored-element capacity"),
])
def test_corruption_detected_as_in_jax(what, message):
    """The port's check raises the JAX checkify message for each fault."""
    err = checks.checked_structure(corrupt(what, tsp))()
    with pytest.raises(StructureError, match=message):
        err.throw()
    jerr = jchecks.checked_structure(corrupt(what, jsp))()
    assert err.get() in jerr.get()


def test_ptr_length_mismatch():
    m = corrupt("ok", tsp)
    bad = type(m)._from_parts(2, 2, _i32([0, 1, 1, 2]), m.colind, m.values)
    assert checks.checked_structure(bad)().get() == "ptr length mismatch"


def test_padding_slots_are_not_checked():
    """Slots past ``ptr[-1]`` are padding: their indices are not read."""
    m = corrupt("ok", tsp)
    padded = type(m)._from_parts(2, 2, _i32([0, 1, 1]), _i32([0, 9]),
                                 m.values)
    assert checks.checked_structure(padded)().get() is None


def test_checked_call_runs_nothing_on_a_bad_structure():
    calls = []

    def fn(a, x):
        calls.append(1)
        return a @ x

    x = torch.ones(2, dtype=torch.float64)
    err, out = checks.checked_call(fn, corrupt("minor", tsp), x)
    assert calls == [] and out is None
    assert err.get() == "minor index out of range"
    err, out = checks.checked_call(fn, corrupt("ok", tsp), x)
    assert err.get() is None and calls == [1]
    assert torch.equal(out, torch.tensor([1.0, 2.0], dtype=torch.float64))
    bsr = tsp.BsrMatrix.eye(4, 2)
    bad = tsp.BsrMatrix._from_parts(4, 4, 2, 2, bsr.indptr,
                                    bsr.indices + 5, bsr.data)
    err, out = checks.checked_call(fn, bsr.to_csr(), bad)
    assert err.get() == "minor index out of range" and out is None
    with pytest.raises(TypeError):
        checks.checked_structure(torch.ones(2))


def test_determinism_audit():
    rng = np.random.default_rng(1234)
    d = np.where(rng.random((40, 40)) < 0.2, rng.normal(size=(40, 40)), 0)
    a = tsp.CsrMatrix.from_dense(d)
    x = torch.from_numpy(rng.normal(size=40))
    assert checks.determinism_audit(lambda v: a @ v, x)
    ja = jsp.CsrMatrix.from_dense(d)
    assert jchecks.determinism_audit(lambda v: ja @ v, jnp.asarray(x.numpy()))
    counter = iter(range(10))
    assert not checks.determinism_audit(lambda: torch.tensor(next(counter)))
    assert checks.determinism_audit(lambda: np.arange(3))


def test_trace_names_the_annotated_region(tmp_path):
    a = tsp.CsrMatrix.eye(64)
    x = torch.ones(64, dtype=torch.float64)
    with profiling.trace_to(str(tmp_path / "trace")) as prof:
        with profiling.annotate("spalinalg_region"):
            for _ in range(3):
                a @ x
    (path,) = glob.glob(str(tmp_path / "trace" / "*.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "spalinalg_region" for e in events)
    assert any(e.key == "spalinalg_region" for e in prof.key_averages())


def test_device_sync_walks_nested_structures():
    tree = {"a": [torch.ones(2), (tsp.CsrMatrix.eye(3), np.ones(2))],
            "b": None}
    tree["self"] = tree                       # cycles are walked once
    profiling.device_sync(tree)               # CPU only: nothing to wait on
    found = set()
    profiling._devices(tree, found, set())
    assert found == set()


def test_measure_records_one_op():
    buf = io.StringIO()
    rec = metrics.MetricsRecorder(jsonl_stream=buf)
    synced = []
    with rec.measure("spmv", nnz=1000, flops=2000,
                     sync=lambda: synced.append(1)):
        pass
    assert len(rec.records) == 1 and synced == [1]
    r = rec.records[0]
    assert (r.op, r.nnz, r.flops) == ("spmv", 1000, 2000)
    assert r.seconds >= 0
    assert rec.summary()["spmv"]["count"] == 1
    assert '"op": "spmv"' in buf.getvalue()


def test_structure_cache_clear():
    cache = StructureCache()
    a, b = torch.arange(3), torch.arange(4)
    built = []
    cache.get((a,), lambda: built.append(1) or "pa")
    cache.get((b,), lambda: built.append(1) or "pb")
    assert len(cache) == 2
    cache.clear()
    assert len(cache) == 0
    assert cache.get((a,), lambda: built.append(1) or "pa") == "pa"
    assert len(built) == 3 and len(cache) == 1
    del a                              # a cleared entry's finaliser is a no-op
    assert len(cache) == 0


def test_heartbeat_without_a_process_group():
    """In a fresh process with no process group, ``heartbeat()`` is the
    one-rank case: it returns a latency (as the JAX ``heartbeat`` does
    with no setup)."""
    code = ("import torch.distributed as dist\n"
            "import spalinalg_tpu_torch as tsp\n"
            "from spalinalg_tpu_torch.parallel import multihost\n"
            "assert not dist.is_initialized()\n"
            "with tsp.default_device('cpu'):\n"
            "    beat = multihost.heartbeat()\n"
            "assert not dist.is_initialized()\n"
            "assert 0 <= beat < 60, beat\n"
            "print(beat)\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert float(proc.stdout.strip()) >= 0
