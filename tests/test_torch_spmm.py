"""SpMM of the PyTorch port against the JAX package.

The port runs its plain torch version here (CPU tensors); the kernel itself
is held against it on the GPU by ``chip_smoke.py``. Inputs are made with
NumPy from a seed and handed to both packages.

- values, ``dX`` and ``dvals`` of ``csr @ X`` / ``csc @ X`` against the JAX
  public CPU path and ``jax.grad``, by the scaled error
  ``|Y - Y_jax| <= tol·(|A|·|X|)`` (1e-12 f64, 1e-5 f32);
- against the TPU kernel's own function run as the JAX tests run it,
  ``route_spmm(plan, X, vals, interpret=True)`` (f32), by the error scaled
  as ``tests/test_csr_route.py`` scales it (2e-5), and its gradient
  through the values;
- any ``k``, padding slots, the metrics record, and the wrapper's checks.
"""

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import jax
import jax.numpy as jnp

import spalinalg_tpu as jsp
import spalinalg_tpu_torch as tsp
from spalinalg_tpu.ops.kernels.csr_route import build_route_plan, route_spmm
from spalinalg_tpu_torch.io import csr_from_arrays
from spalinalg_tpu_torch.ops.kernels.csr_spmm import csr_spmm
from spalinalg_tpu_torch.ops.matvec import matmul_dense


@pytest.fixture(autouse=True)
def _cpu_scope():
    """The port's entry points place data on the card unless told
    otherwise; these tests run on the CPU."""
    with tsp.default_device("cpu"):
        yield


TOL = {np.float32: 1e-5, np.float64: 1e-12}


def _dense(rng, n, m, density, dtype, empty_rows=(), empty_cols=()):
    d = np.where(rng.random((n, m)) < density, rng.normal(size=(n, m)), 0)
    d[list(empty_rows), :] = 0
    d[:, list(empty_cols)] = 0
    return d.astype(dtype)


def _pair(d, fmt):
    """The same matrix in both packages, built through COO."""
    rows, cols = np.nonzero(d)
    vals = d[rows, cols]
    out = []
    for pkg in (jsp, tsp):
        coo = pkg.CooMatrix.with_triplets(*d.shape, rows, cols, vals)
        cls = pkg.CsrMatrix if fmt == "csr" else pkg.CscMatrix
        out.append(cls.from_coo(coo))
    return out


def _within(got, want, scale, tol):
    """Entry by entry ``|got - want| <= tol·scale``."""
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert np.all(err <= tol * np.asarray(scale, np.float64)), \
        (err / np.maximum(scale, 1e-300)).max()


def _call(how, mat, X):
    if how == "matmul":
        return mat @ X
    if how == "matmul_dense":
        return matmul_dense(mat, X)
    return (tsp.csr_matmat if isinstance(mat, tsp.CsrMatrix)
            else tsp.csc_matmat)(mat, X)


# ------------------------------------------------ the JAX public CPU path


@pytest.mark.parametrize("how", ["matmul", "matmat", "matmul_dense"])
@pytest.mark.parametrize("fmt", ["csr", "csc"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_spmm_matches_jax(dtype, fmt, how):
    rng = np.random.default_rng(31)
    d = _dense(rng, 70, 50, 0.12, dtype, empty_rows=(4, 40), empty_cols=(7,))
    jmat, tmat = _pair(d, fmt)
    X = rng.normal(size=(50, 6)).astype(dtype)
    Y = _call(how, tmat, torch.from_numpy(X))
    assert Y.dtype == torch.from_numpy(X).dtype and Y.shape == (70, 6)
    _within(Y.numpy(), np.asarray(jmat @ X),
            np.abs(d).astype(np.float64) @ np.abs(X), TOL[dtype])
    assert np.all(Y.numpy()[[4, 40]] == 0)


@pytest.mark.parametrize("fmt", ["csr", "csc"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_grad_matches_jax(dtype, fmt):
    rng = np.random.default_rng(32)
    d = _dense(rng, 26, 20, 0.25, dtype, empty_rows=(3,))
    jmat, tmat = _pair(d, fmt)
    X = rng.normal(size=(20, 5)).astype(dtype)
    G = rng.normal(size=(26, 5)).astype(dtype)

    def f(values, Xv):
        return jnp.vdot(jnp.asarray(G), jmat.with_values(values) @ Xv)

    jdv, jdX = jax.grad(f, argnums=(0, 1))(jmat.values, jnp.asarray(X))
    values = tmat.values.clone().requires_grad_(True)
    Xt = torch.from_numpy(X).requires_grad_(True)
    (tmat.with_values(values) @ Xt).backward(torch.from_numpy(G))
    tol = TOL[dtype]
    ad, aX, aG = (np.abs(v).astype(np.float64) for v in (d, X, G))
    _within(Xt.grad.numpy(), np.asarray(jdX), ad.T @ aG, tol)
    # dvals[p] = Σ_c G[row_p, c]·X[col_p, c], in the matrix's storage order
    scale = aG @ aX.T
    if fmt == "csc":
        cols, rows = (np.repeat(np.arange(20), np.diff(tmat.colptr.numpy())),
                      tmat.rowind.numpy())
    else:
        rows, cols = (np.repeat(np.arange(26), np.diff(tmat.rowptr.numpy())),
                      tmat.colind.numpy())
    _within(values.grad.numpy(), np.asarray(jdv), scale[rows, cols], tol)


@pytest.mark.parametrize("k", [0, 1, 2, 3, 32, 33, 64, 100])
def test_any_k_matches_dense(k):
    """The JAX route takes 1 <= k <= 64 (a VMEM limit) and answers other k
    on its XLA path; the port takes any k, and k == 0 gives an empty
    result."""
    rng = np.random.default_rng(33)
    d = _dense(rng, 40, 35, 0.2, np.float64, empty_rows=(0,))
    jmat, tmat = _pair(d, "csr")
    X = rng.normal(size=(35, k))
    Y = tmat @ torch.from_numpy(X)
    assert Y.shape == (40, k)
    _within(Y.numpy(), d @ X, np.abs(d) @ np.abs(X), 1e-14)
    if k:
        _within(Y.numpy(), np.asarray(jmat @ X), np.abs(d) @ np.abs(X), 1e-12)


def test_padding_slots_count_for_nothing():
    """nse > nnz, with values in the padding slots: they change neither Y
    nor any gradient, and their own gradient is 0."""
    rng = np.random.default_rng(34)
    d = _dense(rng, 30, 25, 0.2, np.float64)
    jmat, _ = _pair(d, "csr")
    pad, nnz = 9, jmat.nnz
    ptr = np.asarray(jmat.rowptr)
    ind = np.concatenate([np.asarray(jmat.colind), rng.integers(0, 25, pad)])
    val = np.concatenate([np.asarray(jmat.values), rng.normal(size=pad)])
    tmat = csr_from_arrays(30, 25, ptr, ind, val)
    assert tmat.nse == nnz + pad
    values = tmat.values.clone().requires_grad_(True)
    X = torch.from_numpy(rng.normal(size=(25, 4))).requires_grad_(True)
    G = rng.normal(size=(30, 4))
    Y = tmat.with_values(values) @ X
    Y.backward(torch.from_numpy(G))
    _within(Y.detach().numpy(), d @ X.detach().numpy(),
            np.abs(d) @ np.abs(X.detach().numpy()), 1e-14)
    assert np.all(values.grad.numpy()[nnz:] == 0)
    _within(X.grad.numpy(), d.T @ G, np.abs(d).T @ np.abs(G), 1e-14)


@pytest.mark.parametrize("vdtype,xdtype", [(np.float32, np.float64),
                                           (np.float64, np.float32)])
def test_mixed_promotion(vdtype, xdtype):
    rng = np.random.default_rng(35)
    d = _dense(rng, 25, 25, 0.3, vdtype)
    jmat, tmat = _pair(d, "csr")
    X = rng.normal(size=(25, 3)).astype(xdtype)
    Yj = np.asarray(jmat @ X)
    Y = tmat @ torch.from_numpy(X)
    assert Yj.dtype == np.float64 and Y.dtype == torch.float64
    _within(Y.numpy(), Yj, np.abs(d).astype(np.float64) @ np.abs(X), 1e-12)


@pytest.mark.parametrize("shape", [(7, 2), (3, 2, 2)])
def test_shape_error_on_mismatch(shape):
    d = _dense(np.random.default_rng(36), 5, 8, 0.5, np.float64)
    jmat, tmat = _pair(d, "csr")
    X = np.ones(shape)
    with pytest.raises(jsp.ShapeError):
        jmat @ X
    with pytest.raises(tsp.ShapeError):
        tmat @ torch.from_numpy(X)


def test_metrics_record_path_and_counts():
    """The record names the path and carries the JAX package's flop and
    byte counts (``spalinalg_tpu/ops/matvec.py:284-288``)."""
    from spalinalg_tpu_torch.utils import metrics

    rec = metrics.enable()
    try:
        rec.records.clear()
        tsp.CsrMatrix.eye(6) @ torch.ones(6, 4, dtype=torch.float64)
        tsp.CscMatrix.eye(6) @ torch.ones(6, 4, dtype=torch.float64)
        itm, k, nnz = 8, 4, 6
        assert [(r.op, r.path, r.nnz, r.flops, r.bytes)
                for r in rec.records] == [
            (op, f"{op}:plain", nnz, 2 * nnz * k, (itm * (1 + 2 * k) + 4) * nnz)
            for op in ("csr_spmm", "csc_spmm")]
    finally:
        metrics.disable()
        rec.records.clear()


def test_wrapper_checks():
    ptr = torch.tensor([0, 1, 2], dtype=torch.int32)
    ind = torch.tensor([0, 1], dtype=torch.int32)
    val = torch.ones(2, dtype=torch.float64)
    X = torch.ones(2, 3, dtype=torch.float64)
    np.testing.assert_array_equal(csr_spmm(ptr, ind, val, X, 2).numpy(),
                                  np.ones((2, 3)))
    with pytest.raises(tsp.DTypeError):
        csr_spmm(ptr.long(), ind, val, X, 2)
    with pytest.raises(tsp.ShapeError):
        csr_spmm(ptr, ind, val, X[:, 0], 2)
    with pytest.raises(ValueError, match="several devices"):
        csr_spmm(ptr, ind, val, X.to("meta"), 2)


# ------------------------------------- the TPU kernel's own function


def _route_case(name, rng):
    if name == "uniform_rows_k64":
        n, row_nnz = 512, 16
        cols = rng.integers(0, n, size=(n, row_nnz))
        rows = np.repeat(np.arange(n), row_nnz)
        A = sps.csr_matrix((rng.normal(size=n * row_nnz),
                            (rows, cols.ravel())), shape=(n, n))
        return A, 64
    lens = np.minimum(rng.zipf(1.7, size=300), 800)     # skewed rows
    rows = np.repeat(np.arange(300), lens)
    cols = rng.integers(0, 300, size=lens.sum())
    A = sps.csr_matrix((rng.normal(size=lens.sum()), (rows, cols)),
                       shape=(300, 300))
    return A, 8


def _port_of(A):
    A = A.tocsr()
    A.sum_duplicates()
    A.sort_indices()
    vals = A.data.astype(np.float32)
    return A, vals, csr_from_arrays(*A.shape, A.indptr, A.indices, vals)


@pytest.mark.parametrize("name", ["uniform_rows_k64", "skewed_rows"])
def test_matches_route_spmm_f32(name):
    rng = np.random.default_rng(37)
    A, k = _route_case(name, rng)
    A, vals, tmat = _port_of(A)
    plan = build_route_plan(A.indptr, A.indices, vals, *A.shape)
    X = rng.normal(size=(A.shape[1], k)).astype(np.float32)
    Y_tpu = np.asarray(route_spmm(plan, jnp.asarray(X), jnp.asarray(vals),
                                  interpret=True), dtype=np.float64)
    Y = (tmat @ torch.from_numpy(X)).numpy().astype(np.float64)
    # the error scale of tests/test_csr_route.py::TestRouteSpmm
    scale = np.abs(A @ X.astype(np.float64)).max() + 1.0
    assert np.abs(Y - Y_tpu).max() / scale < 2e-5


def test_grad_through_values_matches_route_spmm():
    rng = np.random.default_rng(38)
    A, vals, tmat = _port_of(sps.random(200, 150, 0.04, random_state=6))
    plan = build_route_plan(A.indptr, A.indices, vals, *A.shape)
    X = rng.normal(size=(150, 4)).astype(np.float32)
    W = rng.normal(size=(200, 4)).astype(np.float32)

    def loss(v):
        return jnp.sum(jnp.asarray(W) * route_spmm(plan, jnp.asarray(X), v,
                                                   interpret=True))

    g_tpu = np.asarray(jax.grad(loss)(jnp.asarray(vals)))
    values = tmat.values.clone().requires_grad_(True)
    (tmat.with_values(values) @ torch.from_numpy(X)).backward(
        torch.from_numpy(W))
    rows = np.repeat(np.arange(200), np.diff(A.indptr))
    scale = np.abs(W[rows]) @ np.ones(4) * np.abs(X[A.indices]).max(1)
    _within(values.grad.numpy(), g_tpu, scale, 1e-5)
