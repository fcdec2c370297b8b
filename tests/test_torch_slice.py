"""The whole ported slice against the JAX package, and checks of the port
itself.

COO (or DOK) build -> ``CsrMatrix.from_coo`` -> ``csr @ x`` -> backward to
``x`` and ``values``, and the stencil slice ``diags`` + ``kron`` Laplacian
-> ``DiaMatrix.from_csr`` -> ``dia @ x`` -> backward, run through both
packages on the same NumPy inputs in float64 and float32. Then: the port
imports no JAX, runs on CPU tensors without ever calling ``nvcc``, records
the path that ran, refuses to run plain torch on a non-CPU device, places
data on the card unless a device or a ``default_device`` scope says
otherwise, and its docstring examples hold.
"""

import contextvars
import doctest
import importlib
import io
import subprocess
import sys

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import jax
import jax.numpy as jnp

import spalinalg_tpu as jsp
import spalinalg_tpu_torch as tsp
from spalinalg_tpu_torch.device import resolve_device
from spalinalg_tpu_torch.ops.kernels import _build
from spalinalg_tpu_torch.ops.kernels.csr_spmm import csr_spmm
from spalinalg_tpu_torch.ops.kernels.csr_spmv import csr_spmv
from spalinalg_tpu_torch.ops.kernels.spgemm_numeric import spgemm_numeric
from spalinalg_tpu_torch.ops.kernels.bsr_spmm import bsr_spmm
from spalinalg_tpu_torch.ops.kernels.bsr_spmv import bsr_spmv
from spalinalg_tpu_torch.ops.kernels.dia_spmv import dia_spmv
from spalinalg_tpu_torch.tools.probe_widegather import wide_gather_mac


@pytest.fixture(autouse=True)
def _cpu_scope():
    """The port's entry points place data on the card unless told
    otherwise; these tests run on the CPU."""
    with tsp.default_device("cpu"):
        yield


@pytest.fixture(autouse=True)
def _plan_cache(tmp_path, monkeypatch):
    """A fresh on-disk plan cache a test: a plan written by an earlier
    test or process would turn a cold factor warm and take its
    ``chol_*`` host phases off the metrics recorder."""
    monkeypatch.setenv("SPALINALG_PLAN_CACHE", str(tmp_path / "plans"))


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
            "spalinalg_tpu_torch.ops.kernels.csr_spmv, "
            "spalinalg_tpu_torch.ops.kernels.csr_spmm, "
            "spalinalg_tpu_torch.ops.kernels.csr_sddmm, "
            "spalinalg_tpu_torch.tools.bench_csr, "
            "spalinalg_tpu_torch.ops.kernels.spgemm_numeric, "
            "spalinalg_tpu_torch.ops.spgemm, "
            "spalinalg_tpu_torch.ops.elementwise, "
            "spalinalg_tpu_torch.formats.bsr, "
            "spalinalg_tpu_torch.ops.bsr_ops, "
            "spalinalg_tpu_torch.ops.kernels.bsr_spmv, "
            "spalinalg_tpu_torch.ops.kernels.bsr_spmm, "
            "spalinalg_tpu_torch.native.lib, "
            "spalinalg_tpu_torch.device, "
            "spalinalg_tpu_torch.formats.dia, "
            "spalinalg_tpu_torch.formats.device, "
            "spalinalg_tpu_torch.ops.structure, "
            "spalinalg_tpu_torch.ops.construct, "
            "spalinalg_tpu_torch.ops.kernels.dia_spmv, "
            "spalinalg_tpu_torch.tools.probe_widegather, "
            "spalinalg_tpu_torch.linalg, spalinalg_tpu_torch.linalg.cg, "
            "spalinalg_tpu_torch.linalg.iterative, "
            "spalinalg_tpu_torch.linalg.precond, "
            "spalinalg_tpu_torch.linalg.triangular, "
            "spalinalg_tpu_torch.linalg.ordering, "
            "spalinalg_tpu_torch.linalg.symbolic, "
            "spalinalg_tpu_torch.linalg.banded, "
            "spalinalg_tpu_torch.linalg.supernodal, "
            "spalinalg_tpu_torch.linalg.cholesky, "
            "spalinalg_tpu_torch.linalg.supernodal_lu, "
            "spalinalg_tpu_torch.linalg.lu, "
            "spalinalg_tpu_torch.linalg.solve, "
            "spalinalg_tpu_torch.linalg.qr, "
            "spalinalg_tpu_torch.linalg.funm, "
            "spalinalg_tpu_torch.linalg.eigen, "
            "spalinalg_tpu_torch.ops.reduce_api, "
            "spalinalg_tpu_torch.ops.indexing, "
            "spalinalg_tpu_torch.ops.reduction, "
            "spalinalg_tpu_torch.config, spalinalg_tpu_torch.parallel, "
            "spalinalg_tpu_torch.parallel.multihost, "
            "spalinalg_tpu_torch.parallel.partition, "
            "spalinalg_tpu_torch.parallel.spmv, "
            "spalinalg_tpu_torch.parallel.bsr, spalinalg_tpu_torch.io, "
            "spalinalg_tpu_torch.io.matrix_market, "
            "spalinalg_tpu_torch.io.checkpoint, "
            "spalinalg_tpu_torch.io.scipy_interop, "
            "spalinalg_tpu_torch.io.torch_interop, "
            "spalinalg_tpu_torch.utils, spalinalg_tpu_torch.utils.checks, "
            "spalinalg_tpu_torch.utils.profiling, "
            "spalinalg_tpu_torch.utils.plandisk, chip_smoke; "
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
    """Running the slices on CPU tensors (SpMV, SpMM, SpGEMM and BSR, with
    their gradients) never reaches the kernel build or ``nvcc``."""
    calls = []
    monkeypatch.setattr(_build, "find_nvcc", lambda: calls.append(1))
    monkeypatch.setattr(_build, "_build", lambda out: calls.append(1))
    monkeypatch.setattr(_build, "_run_all", lambda cmds: calls.append(cmds))
    _build.load_library.cache_clear()
    args, x, g = _triplets(np.float64)
    csr = tsp.CsrMatrix.from_coo(tsp.CooMatrix.with_triplets(*args))
    _port_slice(csr, x, g)
    _port_slice(csr.to_csc(), x, g)
    for mat in (csr, csr.to_csc()):
        values = mat.values.clone().requires_grad_(True)
        X = torch.from_numpy(np.stack([x, -x], 1)).requires_grad_(True)
        (mat.with_values(values) @ X).sum().backward()
    rng = np.random.default_rng(6)
    sq = tsp.CsrMatrix.from_coo(tsp.CooMatrix.with_triplets(
        300, 300, rng.integers(0, 300, 6000), rng.integers(0, 300, 6000),
        rng.normal(size=6000)))
    assert sq.nnz > 4096   # the native symbolic phase: g++, not nvcc
    values = sq.values.clone().requires_grad_(True)
    (sq.with_values(values) * sq).values.sum().backward()
    ((sq ** 3) + sq - sq.to_csc().to_csr()).to_dense()
    assert values.grad is not None
    for bsr in (sq.to_bsr(4), sq.to_bsr(4).astype(torch.float32)):
        for rhs in (torch.ones(300), torch.ones(300, 3)):
            data = bsr.data.clone().requires_grad_(True)
            xg = rhs.to(torch.float64).requires_grad_(True)
            (bsr.with_data(data) @ xg).sum().backward()
            assert data.grad is not None and xg.grad is not None
    (sq.to_bsr(4).astype(torch.bfloat16) @ torch.ones(300)).sum()
    dia = tsp.DiaMatrix.from_csr(tsp.kron(
        tsp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(20, 20)),
        tsp.diags([1.0], [0], shape=(15, 15))))
    data = dia.data.clone().requires_grad_(True)
    xg = torch.ones(300, dtype=torch.float64, requires_grad=True)
    (tsp.DiaMatrix(300, 300, dia.offsets, data) @ xg).sum().backward()
    assert data.grad is not None and xg.grad is not None
    dia @ torch.ones(300, 2, dtype=torch.float64)
    coo = sq.to_coo().to_device()
    coo.to_csr_device() @ torch.ones(300, dtype=torch.float64)
    wide_gather_mac(torch.ones(4, 9), torch.zeros(3, 5, dtype=torch.int32),
                    torch.ones(3, 5))
    assert calls == []
    assert _build.load_library.cache_info().currsize == 0


def test_metrics_record_the_path():
    from spalinalg_tpu_torch.utils import metrics

    rec = metrics.enable()
    try:
        rec.records.clear()
        tsp.CsrMatrix.eye(5) @ torch.ones(5, dtype=torch.float64)
        tsp.CscMatrix.eye(5) @ torch.ones(5, dtype=torch.float64)
        dia = tsp.DiaMatrix.from_diagonals([1.0, 2.0], [0, 1], 5)
        dia @ torch.ones(5, dtype=torch.float64)
        dia @ torch.ones(5, 2, dtype=torch.float64)
        assert [(r.op, r.path, r.nnz) for r in rec.records] == [
            ("csr_spmv", "csr_spmv:plain", 5), ("csc_spmv", "csc_spmv:plain", 5),
            ("dia_spmv", "dia_spmv:plain", 9), ("dia_spmm", "dia_spmm:torch", 9)]
    finally:
        metrics.disable()
        rec.records.clear()


def test_no_plain_torch_off_the_cpu():
    """Off the CPU each wrapper launches its kernel or raises; it never
    runs the plain version. The meta device has no kernel."""
    ptr = torch.tensor([0, 1, 2], dtype=torch.int32, device="meta")
    ind = torch.tensor([0, 1], dtype=torch.int32, device="meta")
    val = torch.ones(2, dtype=torch.float64, device="meta")
    x = torch.ones(2, dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="no csr_spmv kernel"):
        csr_spmv(ptr, ind, val, x, 2)
    mat = tsp.CsrMatrix._from_parts(2, 2, ptr, ind, val)
    with pytest.raises(ValueError, match="no csr_spmm kernel for device"):
        mat @ torch.ones(2, 3, dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="no csr_spmm kernel for device"):
        csr_spmm(ptr, ind, val, torch.ones(2, 3, dtype=torch.float64,
                                           device="meta"), 2)
    plan = tsp.SpgemmPlan(nrows=2, ncols=2, a_idx=ind, b_idx=ind, gid=ind,
                          rowptr=ptr, colind=ind, n_out=2, tptr=ptr,
                          nnz_a=2, nnz_b=2)
    with pytest.raises(ValueError, match="no spgemm_numeric kernel for device"):
        spgemm_numeric(plan, val, val)
    blocks = torch.ones(2, 1, 1, dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="no bsr_spmv kernel for device"):
        bsr_spmv(ptr, ind, blocks, x)
    with pytest.raises(ValueError, match="no bsr_spmm kernel for device"):
        bsr_spmm(ptr, ind, blocks, torch.ones(2, 3, dtype=torch.float64,
                                              device="meta"))
    bsr = tsp.BsrMatrix._from_parts(2, 2, 1, 1, ptr, ind, blocks)
    with pytest.raises(ValueError, match="no bsr_spmv kernel for device"):
        bsr @ x
    with pytest.raises(ValueError, match="no bsr_spmm kernel for device"):
        bsr.astype(torch.bfloat16) @ torch.ones(2, 3, device="meta")
    with pytest.raises(ValueError, match="no dia_spmv kernel for device"):
        dia_spmv([0, 1], torch.ones(2, 2, device="meta"), x.float(), 2, 2)
    with pytest.raises(ValueError, match="no dia_spmv kernel for device"):
        dia_spmv([0], torch.ones(1, 2, device="meta"), x, 2, 2,
                 transposed=True)
    dia = tsp.DiaMatrix(2, 2, [0, 1], torch.ones(2, 2, dtype=torch.float64),
                        device="meta")
    with pytest.raises(ValueError, match="no dia_spmv kernel for device"):
        dia @ x
    with pytest.raises(ValueError, match="no wide_gather kernel"):
        wide_gather_mac(torch.ones(2, 3, device="meta"),
                        torch.zeros(1, 2, dtype=torch.int32, device="meta"),
                        torch.ones(1, 2, device="meta"))


@pytest.mark.parametrize("module", [
    "spalinalg_tpu_torch.dtypes",
    "spalinalg_tpu_torch.formats.coo",
    "spalinalg_tpu_torch.formats.dok",
    "spalinalg_tpu_torch.formats.compressed",
    "spalinalg_tpu_torch.ops.elementwise",
    "spalinalg_tpu_torch.ops.spgemm",
    "spalinalg_tpu_torch.formats.bsr",
    "spalinalg_tpu_torch.ops.bsr_ops",
    "spalinalg_tpu_torch.ops.kernels.bsr_spmv",
    "spalinalg_tpu_torch.ops.kernels.bsr_spmm",
    "spalinalg_tpu_torch.ops.kernels.csr_spmv",
    "spalinalg_tpu_torch.ops.kernels.csr_spmm",
    "spalinalg_tpu_torch.ops.kernels.csr_sddmm",
    "spalinalg_tpu_torch.utils.metrics",
    "spalinalg_tpu_torch.utils.plancache",
    "spalinalg_tpu_torch.utils.profiling",
    "spalinalg_tpu_torch.device",
    "spalinalg_tpu_torch.formats.dia",
    "spalinalg_tpu_torch.formats.device",
    "spalinalg_tpu_torch.ops.structure",
    "spalinalg_tpu_torch.ops.construct",
    "spalinalg_tpu_torch.ops.kernels.dia_spmv",
    "spalinalg_tpu_torch.tools.probe_widegather",
    "spalinalg_tpu_torch.ops.reduce_api",
    "spalinalg_tpu_torch.ops.indexing",
    "spalinalg_tpu_torch.ops.reduction",
    "spalinalg_tpu_torch.linalg.cg",
    "spalinalg_tpu_torch.linalg.iterative",
    "spalinalg_tpu_torch.linalg.precond",
    "spalinalg_tpu_torch.linalg.triangular",
    "spalinalg_tpu_torch.linalg.ordering",
    "spalinalg_tpu_torch.linalg.banded",
    "spalinalg_tpu_torch.linalg.cholesky",
    "spalinalg_tpu_torch.linalg.lu",
    "spalinalg_tpu_torch.linalg.solve",
    "spalinalg_tpu_torch.linalg.qr",
    "spalinalg_tpu_torch.linalg.funm",
    "spalinalg_tpu_torch.linalg.eigen",
    "spalinalg_tpu_torch.config",
    "spalinalg_tpu_torch.parallel.partition",
    "spalinalg_tpu_torch.io.matrix_market",
    "spalinalg_tpu_torch.io.checkpoint",
    "spalinalg_tpu_torch.io.scipy_interop",
    "spalinalg_tpu_torch.io.torch_interop",
    "spalinalg_tpu_torch.utils.checks",
])
def test_port_doctests(module):
    result = doctest.testmod(importlib.import_module(module))
    assert result.attempted > 0 and result.failed == 0


def _laplacian(pkg, k):
    """The 7-point Laplacian of a k x k x k grid through ``diags`` +
    ``kron`` + ``+``: CSR."""
    t = pkg.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(k, k))
    eye = pkg.diags([1.0], [0], shape=(k, k))
    return (pkg.kron(pkg.kron(t, eye), eye) + pkg.kron(pkg.kron(eye, t), eye)
            + pkg.kron(pkg.kron(eye, eye), t))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_stencil_slice_matches_jax(dtype):
    """``diags`` + ``kron`` Laplacian -> ``DiaMatrix.from_csr`` ->
    ``dia @ x`` -> backward to ``data`` and ``x``, through both packages."""
    k = 6
    n = k ** 3
    jdia = jsp.DiaMatrix.from_csr(_laplacian(jsp, k))
    tdia = tsp.DiaMatrix.from_csr(_laplacian(tsp, k))
    np.testing.assert_array_equal(tdia.offsets, jdia.offsets)
    np.testing.assert_array_equal(tdia.offsets, [-36, -6, -1, 0, 1, 6, 36])
    np.testing.assert_array_equal(tdia.data.numpy(), np.asarray(jdia.data))
    rng = np.random.default_rng(7)
    data = np.asarray(jdia.data).astype(dtype)
    x = rng.normal(size=n).astype(dtype)
    g = rng.normal(size=n).astype(dtype)

    def f(d, xv):
        return jnp.vdot(jnp.asarray(g), jsp.DiaMatrix(n, n, jdia.offsets, d)
                        @ xv)

    y = np.asarray(jsp.DiaMatrix(n, n, jdia.offsets, jnp.asarray(data))
                   @ jnp.asarray(x))
    jd, jx = jax.grad(f, argnums=(0, 1))(jnp.asarray(data), jnp.asarray(x))
    td = torch.from_numpy(data).requires_grad_(True)
    tx = torch.from_numpy(x).requires_grad_(True)
    ty = tsp.DiaMatrix(n, n, tdia.offsets, td) @ tx
    ty.backward(torch.from_numpy(g))
    tol = TOL[dtype]
    for got, want in ((ty, y), (td.grad, jd), (tx.grad, jx)):
        assert got.dtype == getattr(torch, np.dtype(dtype).name)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=tol, atol=tol * 12)
    csr = _laplacian(tsp, k).astype(getattr(torch, np.dtype(dtype).name))
    np.testing.assert_allclose(ty.detach().numpy(),
                               (csr @ torch.from_numpy(x)).numpy(),
                               rtol=tol, atol=tol * 12)


ENTRY_POINTS = {
    "CsrMatrix": lambda: tsp.CsrMatrix(2, 2, [0, 1, 2], [0, 1], [1.0, 2.0]),
    "CscMatrix": lambda: tsp.CscMatrix(2, 2, [0, 1, 2], [0, 1], [1.0, 2.0]),
    "CsrMatrix.eye": lambda: tsp.CsrMatrix.eye(3),
    "CscMatrix.eye": lambda: tsp.CscMatrix.eye(3),
    "CsrMatrix.from_coo": lambda: tsp.CsrMatrix.from_coo(
        tsp.CooMatrix.with_entries(2, 2, [(0, 1, 1.0)])),
    "CscMatrix.from_coo": lambda: tsp.CscMatrix.from_coo(
        tsp.CooMatrix.with_entries(2, 2, [(0, 1, 1.0)])),
    "CsrMatrix.from_dok": lambda: tsp.CsrMatrix.from_dok(
        tsp.DokMatrix.with_triplets(2, 2, [0], [1], [1.0])),
    "CscMatrix.from_dok": lambda: tsp.CscMatrix.from_dok(
        tsp.DokMatrix.with_triplets(2, 2, [0], [1], [1.0])),
    "BsrMatrix": lambda: tsp.BsrMatrix(2, 2, 1, [0, 1, 2], [0, 1],
                                       np.ones((2, 1, 1))),
    "BsrMatrix.eye": lambda: tsp.BsrMatrix.eye(4, 2),
    "csr_from_arrays": lambda: tsp.io.csr_from_arrays(
        2, 2, [0, 1, 2], [0, 1], [1.0, 2.0]),
    "csc_from_arrays": lambda: tsp.io.csc_from_arrays(
        2, 2, [0, 1, 2], [0, 1], [1.0, 2.0]),
    "bsr_from_arrays": lambda: tsp.io.bsr_from_arrays(
        2, 2, 1, [0, 1, 2], [0, 1], np.ones((2, 1, 1))),
    "dia_from_arrays": lambda: tsp.io.dia_from_arrays(2, 2, [0],
                                                      np.ones((1, 2))),
    "device_coo_from_arrays": lambda: tsp.io.device_coo_from_arrays(
        2, 2, [0], [1], [1.0]),
    "DiaMatrix": lambda: tsp.DiaMatrix(2, 2, [0], np.ones((1, 2))),
    "DiaMatrix.from_diagonals": lambda: tsp.DiaMatrix.from_diagonals(
        [1.0], [0], 3),
    "DeviceCoo": lambda: tsp.DeviceCoo(2, 2, [0], [1], [1.0]),
    "CooMatrix.to_device": lambda: tsp.CooMatrix.with_entries(
        2, 2, [(0, 1, 1.0)]).to_device(),
    "diags": lambda: tsp.diags([1.0], [0], shape=(3, 3)),
    "sprandom": lambda: tsp.sprandom(4, 4, 0.5, seed=0),
    "kron": lambda: tsp.kron(tsp.CooMatrix.with_entries(1, 1, [(0, 0, 2.0)]),
                             tsp.CooMatrix.with_entries(1, 1, [(0, 0, 3.0)])),
    "load_npz": lambda: tsp.io.load_npz(_checkpoint()),
    "from_scipy": lambda: tsp.io.from_scipy(sps.eye(3, format="csr")),
    # results stay on the sparse tensor's device: made on the default one
    "from_sparse_coo": lambda: tsp.io.from_sparse_coo(torch.sparse_coo_tensor(
        torch.tensor([[0], [1]]), torch.tensor([1.0]), (2, 2),
        device=resolve_device())),
    "to_sparse_coo": lambda: tsp.io.to_sparse_coo(
        tsp.CooMatrix.with_entries(2, 2, [(0, 1, 1.0)])),
}


def _checkpoint():
    """A CSR checkpoint, in memory (``np.load`` reads a file object)."""
    buf = io.BytesIO()
    tsp.io.save_npz(buf, tsp.CsrMatrix.eye(3, device="cpu"))
    buf.seek(0)
    return buf


@pytest.mark.parametrize("entry", list(ENTRY_POINTS))
def test_entry_points_follow_the_default_device(entry):
    """With no ``device``, each entry point places its data on the scope's
    device; an explicit ``device`` wins over the scope."""
    with tsp.default_device("meta"):
        assert ENTRY_POINTS[entry]().device.type == "meta"
    assert ENTRY_POINTS[entry]().device.type == "cpu"


def test_unscoped_entry_points_go_to_the_card():
    """Outside any scope, no ``device`` means the card: on this CPU-only
    machine ``CsrMatrix.from_coo`` raises rather than building on the CPU.
    An explicit device still wins, and scopes nest."""
    from spalinalg_tpu_torch.device import resolve_device

    coo = tsp.CooMatrix.with_entries(2, 2, [(0, 1, 1.0)])
    empty = contextvars.Context()
    assert empty.run(resolve_device) == torch.device("cuda")
    if torch.cuda.is_available():
        pytest.skip("a card is present: the unscoped build would succeed")
    with pytest.raises((AssertionError, RuntimeError)):
        empty.run(tsp.CsrMatrix.from_coo, coo)
    with pytest.raises((AssertionError, RuntimeError)):
        empty.run(tsp.DiaMatrix.from_diagonals, [1.0], [0], 3)

    class Op:                           # an operand with no device
        ncols = 2

        def __matmul__(self, v):
            return v

    with pytest.raises((AssertionError, RuntimeError)):
        empty.run(tsp.linalg.cg, Op(), np.ones(2))
    assert empty.run(lambda: tsp.CsrMatrix.from_coo(
        coo, device="cpu").device) == torch.device("cpu")
    with tsp.default_device("meta"):
        with tsp.default_device("cpu"):
            assert resolve_device() == torch.device("cpu")
        assert resolve_device() == torch.device("meta")
        assert resolve_device("cpu") == torch.device("cpu")


def test_linalg_imports_with_jax_blocked():
    """``import spalinalg_tpu_torch.linalg`` in a process where importing
    jax (or the JAX package) fails."""
    code = ("import sys\n"
            "class Block:\n"
            "    def find_spec(self, name, path=None, target=None):\n"
            "        if name.split('.')[0] in ('jax', 'jaxlib', "
            "'spalinalg_tpu'):\n"
            "            raise ImportError('blocked: ' + name)\n"
            "sys.meta_path.insert(0, Block())\n"
            "for m in [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib')]:\n"
            "    del sys.modules[m]\n"
            "import spalinalg_tpu_torch.linalg as la\n"
            "import spalinalg_tpu_torch.linalg.supernodal_lu\n"
            "for name in ('cholesky', 'lu', 'lu_solve', 'spsolve', "
            "'factorized', 'is_symmetric', 'qr', 'qr_solve', 'lstsq', "
            "'eigsh', 'lanczos', 'block_lanczos', 'lobpcg', 'svds', "
            "'arnoldi', 'expm_multiply'):\n"
            "    assert name in la.__all__ and callable(getattr(la, name))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def _solver_matrix(pkg, k):
    """The 5-point Laplacian of a k x k grid, as COO triplets (with
    duplicates that sum to the stencil) -> CSR."""
    rows, cols, vals = [], [], []
    for i in range(k):
        for j in range(k):
            r = i * k + j
            rows += [r, r]
            cols += [r, r]
            vals += [3.0, 1.0]
            for ii, jj in ((i - 1, j), (i + 1, j), (i, j - 1), (i, j + 1)):
                if 0 <= ii < k and 0 <= jj < k:
                    rows.append(r)
                    cols.append(ii * k + jj)
                    vals.append(-1.0)
    return pkg.CsrMatrix.from_coo(pkg.CooMatrix.with_triplets(
        k * k, k * k, rows, cols, vals))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_solver_slice_matches_jax(dtype):
    """COO -> CSR -> ``cg`` (Jacobi) and ``cholesky`` -> ``cholesky_solve``
    through both packages: the same iterations and solutions (float64:
    atol 1e-8 for CG, rtol 1e-9 for Cholesky; float32: rtol 1e-4 / 1e-5)."""
    import spalinalg_tpu.linalg as jla
    import spalinalg_tpu_torch.linalg as tla

    jA = _solver_matrix(jsp, 12).astype(dtype)
    tA = _solver_matrix(tsp, 12).astype(dtype)
    np.testing.assert_array_equal(tA.colind.numpy(), np.asarray(jA.colind))
    b = np.random.default_rng(11).normal(size=144).astype(dtype)
    tol = 1e-9 if dtype == np.float64 else 1e-4
    jres = jla.cg(jA, b, tol=tol, precondition="jacobi")
    tres = tla.cg(tA, b, tol=tol, precondition="jacobi")
    jx = np.asarray(jres.x)
    if dtype == np.float64:
        assert tres.iterations == int(jres.iterations)
        np.testing.assert_allclose(tres.x.numpy(), jx, atol=1e-8)
    else:
        np.testing.assert_allclose(tres.x.numpy(), jx, rtol=1e-4,
                                   atol=1e-4 * np.abs(jx).max())
    for method in ("auto", "supernodal"):
        jx = np.asarray(jla.cholesky_solve(jla.cholesky(jA, method=method),
                                           b))
        tx = tla.cholesky_solve(tla.cholesky(tA, method=method), b).numpy()
        rtol = 1e-9 if dtype == np.float64 else 1e-5
        np.testing.assert_allclose(tx, jx, rtol=rtol,
                                   atol=rtol * np.abs(jx).max())


def test_solver_slice_no_build_on_cpu(monkeypatch):
    """The solvers and factorizations on CPU tensors never reach the
    kernel build or ``nvcc`` (the native host library is g++'s)."""
    import spalinalg_tpu_torch.linalg as tla

    calls = []
    monkeypatch.setattr(_build, "find_nvcc", lambda: calls.append(1))
    monkeypatch.setattr(_build, "_build", lambda out: calls.append(1))
    monkeypatch.setattr(_build, "_run_all", lambda cmds: calls.append(cmds))
    _build.load_library.cache_clear()
    A = _solver_matrix(tsp, 8)
    b = np.ones(64)
    for M in (None, "jacobi", tla.ic0(A), tla.chebyshev(A)):
        assert float(tla.cg(A, b, tol=1e-8, precondition=M).residual) <= 1e-8
    tla.cg(A.to_bsr(4), b, tol=1e-8)
    tla.gmres(A, b, M=tla.ilu0(A))
    tla.bicgstab(A, b, M=tla.ilu0(A))
    for method in ("auto", "supernodal", "dense"):
        tla.cholesky_solve(tla.cholesky(A, method=method), b)
    assert calls == []
    assert _build.load_library.cache_info().currsize == 0


def test_linalg_all_matches_jax():
    """The port's linalg tier exports every name of the JAX package's."""
    import spalinalg_tpu.linalg as jla
    import spalinalg_tpu_torch.linalg as tla

    assert sorted(tla.__all__) == sorted(jla.__all__)


def test_parallel_all_matches_jax():
    """The port's distributed tier exports the JAX package's 13 names."""
    import spalinalg_tpu.parallel as jpar
    import spalinalg_tpu_torch.parallel as tpar

    assert sorted(tpar.__all__) == sorted(jpar.__all__)
    assert len(tpar.__all__) == 13
    assert all(callable(getattr(tpar, name)) for name in tpar.__all__)


def test_io_and_utils_all_match_jax():
    """The port's io and utils tiers export every name of the JAX
    package's, but the utils tier's per-entry byte model
    (``roofline_model``, ``HBM_GBPS``), which the port left out; the three
    BCOO/BCSR bridges map to their torch.sparse counterparts, and the io
    tier keeps its carry functions."""
    import spalinalg_tpu.io as jio
    import spalinalg_tpu.utils as jutils
    import spalinalg_tpu_torch.io as tio
    import spalinalg_tpu_torch.utils as tutils

    torch_names = {"from_bcoo": "from_sparse_coo", "to_bcoo": "to_sparse_coo",
                   "to_bcsr": "to_sparse_csr"}
    carry = {"csr_from_arrays", "csc_from_arrays", "bsr_from_arrays",
             "dia_from_arrays", "device_coo_from_arrays", "to_arrays"}
    assert sorted(tio.__all__) == sorted(
        {torch_names.get(n, n) for n in jio.__all__} | carry)
    assert set(jutils.__all__) - set(tutils.__all__) == {
        "roofline_model", "HBM_GBPS"}
    assert sorted(set(tutils.__all__) - set(jutils.__all__)) == [
        "StructureCache"]
    for mod in (tio, tutils):
        assert all(getattr(mod, name) is not None for name in mod.__all__)


def test_config_is_exported():
    from spalinalg_tpu_torch import config

    assert "Config" in tsp.__all__ and "default_config" in tsp.__all__
    assert tsp.Config is config.Config
    assert tsp.default_config() is config.current_config()


def test_make_row_mesh_needs_the_card_or_a_cpu_request():
    """Outside any scope and with no ``device``, ``make_row_mesh`` asks for
    the card: on this CPU-only machine it raises, and initialises no
    process group on the way."""
    import torch.distributed as dist

    from spalinalg_tpu_torch.parallel import make_row_mesh

    if torch.cuda.is_available():
        pytest.skip("a card is present: the unscoped mesh would succeed")
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        contextvars.Context().run(make_row_mesh)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_row_mesh(device="cuda")
    assert not dist.is_initialized()


def test_linalg_tier_no_build_on_cpu(monkeypatch):
    """LU, spsolve, QR, the eigensolvers and expm_multiply on CPU tensors
    never reach the kernel build or ``nvcc``."""
    import spalinalg_tpu_torch.linalg as tla

    calls = []
    monkeypatch.setattr(_build, "find_nvcc", lambda: calls.append(1))
    monkeypatch.setattr(_build, "_build", lambda out: calls.append(1))
    monkeypatch.setattr(_build, "_run_all", lambda cmds: calls.append(cmds))
    _build.load_library.cache_clear()
    A = _solver_matrix(tsp, 8)
    b = np.ones(64)
    for method in ("auto", "supernodal", "dense"):
        tla.lu_solve(tla.lu(A, method=method), b)
    tla.spsolve(A, b, assume_a="gen")
    tla.lstsq(tsp.vstack([A, A]), np.ones(128))
    tla.qr_qt_apply(tla.qr(tsp.vstack([A, A]), method="sparse"),
                    np.ones((128, 2)))
    tla.eigsh(A, k=2, sigma=0.0, block=2)
    tla.lobpcg(A, k=2, maxiter=3)
    tla.svds(A, k=2)
    tla.expm_multiply(-A, b, m=8)
    assert calls == []
    assert _build.load_library.cache_info().currsize == 0


def test_solver_metrics_path():
    """The solver's products are the CSR SpMV (its plain version on the
    CPU), each step after its product the torch step, and the supernodal
    host phases are recorded."""
    import spalinalg_tpu_torch.linalg as tla
    from spalinalg_tpu_torch.utils import metrics

    A = _solver_matrix(tsp, 6)
    rec = metrics.enable()
    try:
        rec.records.clear()
        res = tla.cg(A, np.ones(36), tol=1e-10)
        paths = [r.path for r in rec.records]
        assert paths == ["csr_spmv:plain"] + [
            "csr_spmv:plain", "cg_step:plain"] * res.iterations
        rec.records.clear()
        B = A.with_values(A.values.clone())
        B = tsp.CsrMatrix._from_parts(36, 36, B.rowptr.clone(),
                                      B.colind.clone(), B.values)
        tla.cholesky(B, method="supernodal")
        assert [r.op for r in rec.records] == [
            "chol_ordering", "chol_symbolic", "chol_plan"]
    finally:
        metrics.disable()
        rec.records.clear()
