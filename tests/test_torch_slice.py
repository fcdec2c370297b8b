"""The whole ported slice against the JAX package, and checks of the port
itself.

COO (or DOK) build -> ``CsrMatrix.from_coo`` -> ``csr @ x`` -> backward to
``x`` and ``values``, run through both packages on the same NumPy inputs
in float64 and float32. Then: the port imports no JAX, runs on CPU tensors
without ever calling ``nvcc``, records the path that ran, refuses to run
plain torch on a non-CPU device, and its docstring examples hold.
"""

import doctest
import importlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import spalinalg_tpu as jsp
import spalinalg_tpu_torch as tsp
from spalinalg_tpu_torch.ops.kernels import _build
from spalinalg_tpu_torch.ops.kernels.csr_spmv import csr_spmv

TOL = {np.float32: 1e-5, np.float64: 1e-12}


def _triplets(dtype, n=300, m=280, k=3000):
    rng = np.random.default_rng(5)
    rows = rng.integers(0, n, size=k)
    cols = rng.integers(0, m, size=k)
    vals = rng.normal(size=k).astype(dtype)
    vals[rng.random(k) < 0.05] = 0                      # explicit zeros
    rows = np.concatenate([rows, rows[:300]])           # duplicates, some
    cols = np.concatenate([cols, cols[:300]])           # of them cancelling
    vals = np.concatenate([vals, -vals[:100],
                           rng.normal(size=200).astype(dtype)])
    x = rng.normal(size=m).astype(dtype)
    g = rng.normal(size=n).astype(dtype)
    return (n, m, rows, cols, vals), x, g


def _jax_slice(csr, x, g):
    def f(values, xv):
        return jnp.vdot(jnp.asarray(g), csr.with_values(values) @ xv)

    y = np.asarray(csr @ x)
    dv, dx = jax.grad(f, argnums=(0, 1))(csr.values, jnp.asarray(x))
    return y, np.asarray(dv), np.asarray(dx)


def _port_slice(csr, x, g):
    values = csr.values.clone().requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = csr.with_values(values) @ xt
    y.backward(torch.from_numpy(g))
    return y.detach().numpy(), values.grad.numpy(), xt.grad.numpy()


@pytest.mark.parametrize("builder", ["coo", "dok"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_slice_matches_jax(dtype, builder):
    args, x, g = _triplets(dtype)
    mats = []
    for pkg in (jsp, tsp):
        if builder == "coo":
            mats.append(pkg.CsrMatrix.from_coo(pkg.CooMatrix.with_triplets(
                *args)))
        else:
            mats.append(pkg.CsrMatrix.from_dok(pkg.DokMatrix.with_triplets(
                *args)))
    jcsr, tcsr = mats
    np.testing.assert_array_equal(tcsr.rowptr.numpy(), np.asarray(jcsr.rowptr))
    np.testing.assert_array_equal(tcsr.colind.numpy(), np.asarray(jcsr.colind))
    np.testing.assert_array_equal(tcsr.values.numpy(), np.asarray(jcsr.values))
    tol = TOL[dtype]
    for got, want in zip(_port_slice(tcsr, x, g), _jax_slice(jcsr, x, g)):
        assert got.dtype == want.dtype
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def test_port_never_imports_jax():
    code = ("import sys, spalinalg_tpu_torch, "
            "spalinalg_tpu_torch.ops.kernels.csr_spmv, chip_smoke; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'spalinalg_tpu' or "
            "m.startswith('spalinalg_tpu.')]; "
            "assert not bad, bad")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_port_sources_import_no_jax():
    """No import statement of the port or of chip_smoke.py names JAX or the
    JAX package, wherever it sits (also inside functions)."""
    import ast
    from pathlib import Path

    root = Path(tsp.__file__).parent
    files = sorted(root.rglob("*.py")) + [root.parent / "chip_smoke.py"]
    bad = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            bad += [(path.name, n) for n in names
                    if n.split(".")[0] in ("jax", "jaxlib", "spalinalg_tpu")]
    assert len(files) > 10 and bad == []


def test_no_build_on_cpu(monkeypatch):
    """Running the slice on CPU tensors never reaches the kernel build."""
    calls = []
    monkeypatch.setattr(_build, "find_nvcc", lambda: calls.append(1))
    monkeypatch.setattr(_build, "_build", lambda out: calls.append(1))
    _build.load_library.cache_clear()
    args, x, g = _triplets(np.float64)
    csr = tsp.CsrMatrix.from_coo(tsp.CooMatrix.with_triplets(*args))
    _port_slice(csr, x, g)
    _port_slice(csr.to_csc(), x, g)
    assert calls == []
    assert _build.load_library.cache_info().currsize == 0


def test_metrics_record_the_path():
    from spalinalg_tpu_torch.utils import metrics

    rec = metrics.enable()
    try:
        rec.records.clear()
        tsp.CsrMatrix.eye(5) @ torch.ones(5, dtype=torch.float64)
        tsp.CscMatrix.eye(5) @ torch.ones(5, dtype=torch.float64)
        assert [(r.op, r.path, r.nnz) for r in rec.records] == [
            ("csr_spmv", "csr_spmv:plain", 5), ("csc_spmv", "csc_spmv:plain", 5)]
    finally:
        metrics.disable()
        rec.records.clear()


def test_no_plain_torch_off_the_cpu():
    """Off the CPU the wrapper launches a kernel or raises; it never runs
    the plain version. SpMM has no kernel yet and raises there."""
    ptr = torch.tensor([0, 1, 2], dtype=torch.int32, device="meta")
    ind = torch.tensor([0, 1], dtype=torch.int32, device="meta")
    val = torch.ones(2, dtype=torch.float64, device="meta")
    x = torch.ones(2, dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="no csr_spmv kernel"):
        csr_spmv(ptr, ind, val, x, 2)
    mat = tsp.CsrMatrix._from_parts(2, 2, ptr, ind, val)
    with pytest.raises(NotImplementedError, match="B2"):
        mat @ torch.ones(2, 3, dtype=torch.float64, device="meta")


@pytest.mark.parametrize("module", [
    "spalinalg_tpu_torch.dtypes",
    "spalinalg_tpu_torch.formats.coo",
    "spalinalg_tpu_torch.formats.dok",
    "spalinalg_tpu_torch.formats.compressed",
    "spalinalg_tpu_torch.utils.metrics",
    "spalinalg_tpu_torch.utils.plancache",
])
def test_port_doctests(module):
    result = doctest.testmod(importlib.import_module(module))
    assert result.attempted > 0 and result.failed == 0
