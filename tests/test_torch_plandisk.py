"""The port's on-disk plan cache (``spalinalg_tpu_torch/utils/plandisk.py``)
and its use by the supernodal Cholesky.

- The plan (``perm``, the value gather, the ``SupernodalPlan`` with its
  ``SupernodalSymbolic``) round-trips through a non-executable ``npz``:
  every field equal, runtime caches empty.
- A second ``cholesky()`` after ``_SYMBOLIC.clear()`` loads the plan from
  disk: one ``chol_plan`` record with path ``disk``, and a factor and a
  solve bitwise equal to those of the built plan, whose records were the
  three host phases.
- Eviction under a tiny cap (oldest first), a corrupt file and a stale
  layout (both rebuild), a class outside the allowlist (refused, rebuilt),
  ``SPALINALG_PLAN_CACHE=off`` (nothing written, host phases every time),
  and the directory: a ``torch/`` subdirectory of the variable, else
  ``~/.cache/spalinalg_tpu_torch/plans``.
"""

import json
import os
import sys
import zipfile

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import spalinalg_tpu_torch as tsp
import spalinalg_tpu_torch.linalg as tla
from spalinalg_tpu_torch.linalg.supernodal import SupernodalPlan
from spalinalg_tpu_torch.utils import metrics, plandisk

cholesky_mod = sys.modules["spalinalg_tpu_torch.linalg.cholesky"]


@pytest.fixture(autouse=True)
def _cpu_scope_and_cache(tmp_path, monkeypatch):
    """CPU tensors, and a fresh plan cache a test."""
    monkeypatch.setenv("SPALINALG_PLAN_CACHE", str(tmp_path / "plans"))
    monkeypatch.delenv("SPALINALG_PLAN_CACHE_MAX_MB", raising=False)
    cholesky_mod._SYMBOLIC.clear()
    with tsp.default_device("cpu"):
        yield
    cholesky_mod._SYMBOLIC.clear()


def lap2d(k):
    T = sps.diags([-1.0, 4.0, -1.0], [-1, 0, 1], shape=(k, k))
    D = sps.diags([-1.0, -1.0], [-1, 1], shape=(k, k))
    S = (sps.kron(sps.eye(k), T) + sps.kron(D, sps.eye(k))).tocsr()
    S.sort_indices()
    return tsp.CsrMatrix(S.shape[0], S.shape[1], S.indptr, S.indices, S.data)


def plan_files(tmp_path):
    d = tmp_path / "plans" / "torch"
    return sorted(d.glob("*.npz")) if d.exists() else []


def factor_recorded(A):
    rec = metrics.enable()
    rec.records.clear()
    try:
        fac = tla.cholesky(A, method="supernodal")
        return fac, [(r.op, r.path) for r in rec.records]
    finally:
        metrics.disable()
        rec.records.clear()


HOST_PHASES = [("chol_ordering", "chol_ordering:host"),
               ("chol_symbolic", "chol_symbolic:host"),
               ("chol_plan", "chol_plan:host")]


def assert_equal_trees(a, b, where="plan"):
    if isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype, where
        np.testing.assert_array_equal(a, b)
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_equal_trees(x, y, f"{where}.{i}")
    elif isinstance(a, dict):
        assert list(a) == list(b), where
        for k in a:
            assert_equal_trees(a[k], b[k], f"{where}[{k}]")
    elif hasattr(a, "__dataclass_fields__"):
        assert type(a) is type(b), where
        for name in a.__dataclass_fields__:
            if name != "_tables":
                assert_equal_trees(getattr(a, name), getattr(b, name),
                                   f"{where}/{name}")
    else:
        assert a == b, where


def test_plan_round_trip(tmp_path):
    A = lap2d(14)
    sym = cholesky_mod._supernodal_symbolic(A, True)
    sym.plan.tables("cpu")                    # a runtime cache, filled
    path = str(tmp_path / "plan.npz")
    plandisk._save(path, (sym.perm, sym.value_src.numpy(), sym.plan))
    assert zipfile.is_zipfile(path)
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
    assert {m.get("cls") for m in meta.values()} >= {
        "SupernodalPlan", "SupernodalSymbolic", "_Bucket"}
    perm, src, plan = plandisk._load(path)
    assert isinstance(plan, SupernodalPlan) and plan._tables == {}
    np.testing.assert_array_equal(perm, sym.perm)
    np.testing.assert_array_equal(src, sym.value_src.numpy())
    assert_equal_trees(plan, sym.plan)
    assert plan.last_reads == sym.plan.last_reads and plan.last_reads


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_second_factor_loads_from_disk(dtype, tmp_path):
    A = lap2d(16).astype(dtype)
    b = torch.from_numpy(np.random.default_rng(5).normal(size=A.nrows)).to(
        dtype)
    fac1, rec1 = factor_recorded(A)
    assert rec1 == HOST_PHASES
    assert len(plan_files(tmp_path)) == 1
    cholesky_mod._SYMBOLIC.clear()            # a new process, as it were
    fac2, rec2 = factor_recorded(A)
    assert rec2 == [("chol_plan", "chol_plan:disk")]
    np.testing.assert_array_equal(fac2.perm, fac1.perm)
    assert fac1.snf.panels.keys() == fac2.snf.panels.keys()
    for k, p in fac1.snf.panels.items():
        assert torch.equal(fac2.snf.panels[k], p)
    assert torch.equal(tla.cholesky_solve(fac2, b),
                       tla.cholesky_solve(fac1, b))
    _, rec3 = factor_recorded(A)              # in memory now: no record
    assert rec3 == []


def test_eviction_caps_the_directory(tmp_path, monkeypatch):
    cdir = tmp_path / "evict"
    cdir.mkdir()
    for i in range(5):
        p = cdir / f"f{i}.npz"
        p.write_bytes(bytes(400_000))
        os.utime(p, (1_000_000 + i, 1_000_000 + i))
    monkeypatch.setenv("SPALINALG_PLAN_CACHE_MAX_MB", "1")
    plandisk._evict(str(cdir))
    left = sorted(f.name for f in cdir.iterdir())
    assert sum(f.stat().st_size for f in cdir.iterdir()) <= 1_000_000
    assert left == ["f3.npz", "f4.npz"]       # the oldest went first
    # a cap below one plan keeps none of them
    monkeypatch.setenv("SPALINALG_PLAN_CACHE_MAX_MB", "0.0001")
    tla.cholesky(lap2d(10), method="supernodal")
    assert plan_files(tmp_path) == []


def test_corrupt_file_rebuilds(tmp_path):
    A = lap2d(12)
    fac1, _ = factor_recorded(A)
    (path,) = plan_files(tmp_path)
    path.write_bytes(b"not an npz")
    cholesky_mod._SYMBOLIC.clear()
    fac2, rec = factor_recorded(A)
    assert rec == HOST_PHASES                 # rebuilt, silently
    for k, p in fac1.snf.panels.items():
        assert torch.equal(fac2.snf.panels[k], p)
    (path,) = plan_files(tmp_path)            # and stored again
    assert zipfile.is_zipfile(path)


def test_stale_layout_and_unknown_class_rebuild(tmp_path, monkeypatch):
    A = lap2d(12)
    factor_recorded(A)
    (path,) = plan_files(tmp_path)
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        arrays = {k: z[k] for k in z.files if k != "__meta__"}
    stale = {k: v for k, v in meta.items() if not k.endswith("/l_nnz")}
    for what, manifest in (("stale", stale), ("class", {
            **meta, "plan.2": {**meta["plan.2"], "cls": "Popen"}})):
        np.savez(path, __meta__=np.frombuffer(json.dumps(manifest).encode(),
                                              dtype=np.uint8), **arrays)
        cholesky_mod._SYMBOLIC.clear()
        _, rec = factor_recorded(A)
        assert rec == HOST_PHASES, what


def test_off_disables_the_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("SPALINALG_PLAN_CACHE", "off")
    assert plandisk.plan_cache_dir() is None
    A = lap2d(12)
    _, rec1 = factor_recorded(A)
    cholesky_mod._SYMBOLIC.clear()
    _, rec2 = factor_recorded(A)
    assert rec1 == rec2 == HOST_PHASES
    assert not (tmp_path / "plans").exists()


def test_cache_directory(tmp_path, monkeypatch):
    assert plandisk.plan_cache_dir() == str(tmp_path / "plans" / "torch")
    monkeypatch.delenv("SPALINALG_PLAN_CACHE")
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    assert plandisk.plan_cache_dir() == str(
        tmp_path / "home" / ".cache" / "spalinalg_tpu_torch" / "plans")
    for off in ("0", "none", "OFF"):
        monkeypatch.setenv("SPALINALG_PLAN_CACHE", off)
        assert plandisk.plan_cache_dir() is None


def test_key_separates_structures_and_options(tmp_path):
    A, B = lap2d(10), lap2d(11)
    tla.cholesky(A, method="supernodal")
    tla.cholesky(A, method="supernodal", reorder=False)
    tla.cholesky(B, method="supernodal")
    assert len(plan_files(tmp_path)) == 3
