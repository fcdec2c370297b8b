"""SpMV of the PyTorch port against the JAX package.

The port runs its plain torch versions here (CPU tensors); the kernel
itself is held against them on the GPU by ``chip_smoke.py``. Inputs are
made with NumPy from a seed and handed to both packages.

- against the JAX public CPU path (``csr @ x``, ``csc @ x``), at the
  tolerances of ``tests/test_matvec.py`` (f64 1e-12, f32 1e-5);
- against the TPU kernels' own functions run as the JAX tests run them,
  ``route_spmv(..., interpret=True)`` and ``route_spmv_df(...,
  interpret=True)``, by the scaled error ``|y - y_ref| / (|A|·|x|)``
  (2e-5 f32; 1e-5 f64, since interpret mode loses the double-float
  error-free transforms, see ``tests/test_csr_route_df.py``);
- gradients with respect to ``x`` and ``values`` against ``jax.grad``;
- the transpose cache, keyed on identity and shape.
"""

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import jax
import jax.numpy as jnp

import spalinalg_tpu as jsp
import spalinalg_tpu_torch as tsp
from spalinalg_tpu.ops.kernels.csr_route import build_route_plan, route_spmv
from spalinalg_tpu.ops.kernels.csr_route_df import route_spmv_df
from spalinalg_tpu_torch.io import csc_from_arrays, csr_from_arrays, to_arrays
from spalinalg_tpu_torch.ops.matvec import matmul_dense

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


def _call(how, mat, x):
    if how == "matmul":
        return mat @ x
    if how == "matmul_dense":
        return matmul_dense(mat, x)
    return (tsp.csr_matvec if isinstance(mat, tsp.CsrMatrix)
            else tsp.csc_matvec)(mat, x)


# ------------------------------------------------ the JAX public CPU path


@pytest.mark.parametrize("how", ["matmul", "matvec", "matmul_dense"])
@pytest.mark.parametrize("fmt", ["csr", "csc"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_spmv_matches_jax(dtype, fmt, how):
    rng = np.random.default_rng(11)
    d = _dense(rng, 60, 45, 0.15, dtype, empty_rows=(3, 17), empty_cols=(5,))
    jmat, tmat = _pair(d, fmt)
    x = rng.normal(size=45).astype(dtype)
    y = _call(how, tmat, torch.from_numpy(x))
    assert y.dtype == torch.from_numpy(x).dtype and y.shape == (60,)
    tol = TOL[dtype]
    np.testing.assert_allclose(y.numpy(), np.asarray(jmat @ x), rtol=tol,
                               atol=tol)
    assert np.all(y.numpy()[[3, 17]] == 0)


def test_empty_rows_and_cols():
    x = np.asarray([1.0, 1.0, 1.0])
    j = jsp.CsrMatrix(3, 3, [0, 0, 2, 2], [0, 2], [1.0, 2.0])
    t = tsp.CsrMatrix(3, 3, [0, 0, 2, 2], [0, 2], [1.0, 2.0])
    np.testing.assert_array_equal((t @ x).numpy(), np.asarray(j @ x))
    np.testing.assert_array_equal((t @ x).numpy(), [0.0, 3.0, 0.0])


def test_padded_matrix_matches_jax():
    """nse > nnz: padding slots exist in storage and contribute nothing."""
    rng = np.random.default_rng(12)
    d = _dense(rng, 30, 40, 0.2, np.float64)
    jmat, _ = _pair(d, "csr")
    pad = 13
    ptr = np.asarray(jmat.rowptr)
    ind = np.concatenate([np.asarray(jmat.colind), np.zeros(pad, np.int32)])
    val = np.concatenate([np.asarray(jmat.values), np.zeros(pad)])
    jpad = jsp.CsrMatrix._from_parts(30, 40, jnp.asarray(ptr),
                                     jnp.asarray(ind), jnp.asarray(val))
    tpad = csr_from_arrays(30, 40, ptr, ind, val)
    assert tpad.nse == tpad.nnz + pad
    x = rng.normal(size=40)
    np.testing.assert_allclose((tpad @ x).numpy(), np.asarray(jpad @ x),
                               rtol=1e-12, atol=1e-12)
    # padding that holds values still counts for nothing
    val[-pad:] = rng.normal(size=pad)
    noisy = csr_from_arrays(30, 40, ptr, ind, val)
    np.testing.assert_array_equal((noisy @ x).numpy(), (tpad @ x).numpy())
    np.testing.assert_allclose(noisy.to_dense().numpy(), d, rtol=0, atol=0)


@pytest.mark.parametrize("vdtype,xdtype", [(np.float32, np.float64),
                                           (np.float64, np.float32)])
def test_mixed_promotion(vdtype, xdtype):
    rng = np.random.default_rng(13)
    d = _dense(rng, 25, 25, 0.3, vdtype)
    jmat, tmat = _pair(d, "csr")
    x = rng.normal(size=25).astype(xdtype)
    yj = np.asarray(jmat @ x)
    y = tmat @ torch.from_numpy(x)
    assert yj.dtype == np.float64 and y.dtype == torch.float64
    np.testing.assert_allclose(y.numpy(), yj, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("shape", [(7,), (3, 2, 2), (9, 2)])
def test_shape_error_on_mismatch(shape):
    d = _dense(np.random.default_rng(14), 5, 8, 0.5, np.float64)
    jmat, tmat = _pair(d, "csr")
    x = np.ones(shape)
    with pytest.raises(jsp.ShapeError):
        jmat @ x
    with pytest.raises(tsp.ShapeError):
        tmat @ torch.from_numpy(x)


def test_spmm_on_cpu_matches_jax():
    rng = np.random.default_rng(15)
    d = _dense(rng, 40, 30, 0.2, np.float64)
    for fmt in ("csr", "csc"):
        jmat, tmat = _pair(d, fmt)
        X = rng.normal(size=(30, 3))
        np.testing.assert_allclose((tmat @ torch.from_numpy(X)).numpy(),
                                   np.asarray(jmat @ X), rtol=1e-12,
                                   atol=1e-12)


def test_operand_on_another_device_raises():
    _, tmat = _pair(_dense(np.random.default_rng(16), 4, 4, 0.5,
                           np.float64), "csr")
    with pytest.raises(ValueError, match="device"):
        tmat @ torch.ones(4, dtype=torch.float64, device="meta")


# ------------------------------------- the TPU kernels' own functions


def _heavy(rng):
    """A few very wide rows: virtual rows and recursive spill plans on the
    TPU route (``tests/test_csr_route_df.py:45``)."""
    n = 2048
    r = np.concatenate([np.full(1500, 3), np.full(900, 77),
                        rng.integers(0, n, size=6000)])
    c = np.concatenate([np.sort(rng.choice(n, 1500, replace=False)),
                        np.sort(rng.choice(n, 900, replace=False)),
                        rng.integers(0, n, size=6000)])
    return sps.coo_matrix((rng.normal(size=r.size), (r, c)),
                          shape=(n, n)).tocsr()


def _structures(rng):
    n = 2048
    cols = np.sort(rng.integers(0, n, size=(n, 16)), axis=1)
    return {
        "random": sps.random(700, 900, 0.02, random_state=7,
                             dtype=np.float64).tocsr(),
        "uniform_rows": sps.csr_matrix(
            (rng.normal(size=n * 16), cols.reshape(-1),
             np.arange(n + 1) * 16), shape=(n, n)),
        "heavy_rows_spill": _heavy(rng),
    }


def _port_of(A, dtype):
    A = A.tocsr()
    A.sum_duplicates()
    A.sort_indices()
    return A, csr_from_arrays(*A.shape, A.indptr, A.indices,
                              A.data.astype(dtype))


@pytest.mark.parametrize("name", ["random", "uniform_rows",
                                  "heavy_rows_spill"])
def test_matches_route_spmv_f32(name):
    rng = np.random.default_rng(17)
    A, tmat = _port_of(_structures(rng)[name], np.float32)
    vals = A.data.astype(np.float32)
    plan = build_route_plan(A.indptr, A.indices, vals, *A.shape)
    x = rng.normal(size=A.shape[1]).astype(np.float32)
    y_tpu = np.asarray(route_spmv(plan, jnp.asarray(x), jnp.asarray(vals),
                                  interpret=True), dtype=np.float64)
    y = (tmat @ torch.from_numpy(x)).numpy().astype(np.float64)
    scale = abs(A) @ np.abs(x).astype(np.float64) + 1e-300
    assert (np.abs(y - y_tpu) / scale).max() < 2e-5


@pytest.mark.parametrize("name", ["uniform_rows", "heavy_rows_spill"])
def test_matches_route_spmv_df_f64(name):
    rng = np.random.default_rng(18)
    A, tmat = _port_of(_structures(rng)[name], np.float64)
    plan = build_route_plan(A.indptr, A.indices, A.data, *A.shape)
    x = rng.normal(size=A.shape[1])
    y_tpu = np.asarray(route_spmv_df(plan, jnp.asarray(x),
                                     jnp.asarray(A.data), interpret=True))
    y = (tmat @ torch.from_numpy(x)).numpy()
    scale = abs(A) @ np.abs(x) + 1e-300
    assert (np.abs(y - y_tpu) / scale).max() < 1e-5
    # and the port against the exact f64 product
    assert (np.abs(y - A @ x) / scale).max() < 1e-14


# ------------------------------------------------------------ gradients


@pytest.mark.parametrize("fmt", ["csr", "csc"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_grad_matches_jax(dtype, fmt):
    rng = np.random.default_rng(19)
    d = _dense(rng, 24, 18, 0.25, dtype, empty_rows=(2,))
    jmat, tmat = _pair(d, fmt)
    x = rng.normal(size=18).astype(dtype)
    g = rng.normal(size=24).astype(dtype)

    def f(values, xv):
        return jnp.vdot(jnp.asarray(g), jmat.with_values(values) @ xv)

    jdv, jdx = jax.grad(f, argnums=(0, 1))(jmat.values, jnp.asarray(x))
    values = tmat.values.clone().requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    (tmat.with_values(values) @ xt).backward(torch.from_numpy(g))
    tol = TOL[dtype]
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jdx), rtol=tol,
                               atol=tol)
    np.testing.assert_allclose(values.grad.numpy(), np.asarray(jdv),
                               rtol=tol, atol=tol)


def test_grad_padding_slots_get_zero():
    rng = np.random.default_rng(20)
    d = _dense(rng, 10, 12, 0.3, np.float64)
    jmat, _ = _pair(d, "csr")
    ptr, nnz = np.asarray(jmat.rowptr), jmat.nnz
    ind = np.concatenate([np.asarray(jmat.colind), np.zeros(5, np.int32)])
    val = np.concatenate([np.asarray(jmat.values), rng.normal(size=5)])
    tmat = csr_from_arrays(10, 12, ptr, ind, val)
    values = tmat.values.clone().requires_grad_(True)
    x = torch.from_numpy(rng.normal(size=12)).requires_grad_(True)
    g = rng.normal(size=10)
    (tmat.with_values(values) @ x).backward(torch.from_numpy(g))
    assert np.all(values.grad.numpy()[nnz:] == 0)
    rows, cols, _ = jmat._coo_arrays_host()
    np.testing.assert_allclose(values.grad.numpy()[:nnz],
                               g[rows] * x.detach().numpy()[cols],
                               rtol=1e-12)
    np.testing.assert_allclose(x.grad.numpy(), d.T @ g, rtol=1e-12,
                               atol=1e-12)


# ------------------------------------------------------ transpose cache


def test_transpose_cache_keys_on_shape():
    """Two CSC matrices share every array but differ in nrows: their CSR
    mirrors must not alias (the JAX DIA cache fault, ROADMAP queue C)."""
    ptr = torch.tensor([0, 1, 3, 3, 4], dtype=torch.int32)
    ind = torch.tensor([0, 1, 2, 0], dtype=torch.int32)
    val = torch.tensor([1.0, 2.0, 3.0, 4.0], dtype=torch.float64)
    x = torch.tensor([1.0, 10.0, 100.0, 1000.0], dtype=torch.float64)
    small = tsp.CscMatrix._from_parts(3, 4, ptr, ind, val)
    large = tsp.CscMatrix._from_parts(5, 4, ptr, ind, val)
    ys, yl = small @ x, large @ x
    for t, n in ((small, 3), (large, 5)):
        j = jsp.CscMatrix(n, 4, ptr.numpy(), ind.numpy(), val.numpy())
        np.testing.assert_array_equal((t @ x).numpy(),
                                      np.asarray(j @ x.numpy()))
    assert ys.shape == (3,) and yl.shape == (5,)
    np.testing.assert_array_equal(yl.numpy()[:3], ys.numpy())


def test_transpose_cache_backward_keys_on_ncols(monkeypatch):
    """CSR matrices sharing rowptr/colind but not ncols: dx has each one's
    own length, and a repeated backward reuses the cached structure."""
    from spalinalg_tpu_torch.ops.kernels import csr_spmv

    builds = []
    build = csr_spmv.transpose_structure
    monkeypatch.setattr(csr_spmv, "transpose_structure",
                        lambda *a, **k: builds.append(k) or build(*a, **k))
    ptr = torch.tensor([0, 2, 3, 4], dtype=torch.int32)
    ind = torch.tensor([0, 3, 1, 2], dtype=torch.int32)
    val = torch.tensor([1.0, 2.0, 3.0, 4.0], dtype=torch.float64)
    g = torch.tensor([1.0, -1.0, 0.5], dtype=torch.float64)
    for ncols in (4, 6, 4, 6):
        mat = tsp.CsrMatrix._from_parts(3, ncols, ptr, ind, val)
        x = torch.ones(ncols, dtype=torch.float64, requires_grad=True)
        (mat @ x).backward(g)
        np.testing.assert_array_equal(x.grad.numpy(),
                                      (mat.to_dense().T @ g).numpy())
    assert [b["n_minor"] for b in builds] == [4, 6]


def test_transpose_plan_is_freed_with_its_structure():
    """The cached transpose lives as long as its structure and no longer,
    so a dropped matrix does not pin its plan's memory."""
    import gc
    import weakref

    from spalinalg_tpu_torch.ops.kernels import csr_spmv

    n_before = len(csr_spmv._TRANSPOSE_PLANS)
    ptr = torch.tensor([0, 2, 3, 4], dtype=torch.int32)
    ind = torch.tensor([0, 3, 1, 2], dtype=torch.int32)
    val = torch.tensor([1.0, 2.0, 3.0, 4.0], dtype=torch.float64,
                       requires_grad=True)
    x = torch.ones(4, dtype=torch.float64, requires_grad=True)
    (tsp.CsrMatrix._from_parts(3, 4, ptr, ind, val) @ x).sum().backward()
    plan = csr_spmv.transpose_plan(ptr, ind, 3, 4)
    assert len(csr_spmv._TRANSPOSE_PLANS) == n_before + 1
    assert {plan.ptr.dtype, plan.minor.dtype, plan.perm.dtype,
            plan.major.dtype} == {torch.int32}
    freed = weakref.ref(plan.perm)
    del ptr, ind, plan
    gc.collect()
    assert len(csr_spmv._TRANSPOSE_PLANS) == n_before
    assert freed() is None


def test_carry_across_both_ways():
    rng = np.random.default_rng(21)
    d = _dense(rng, 20, 15, 0.3, np.float64)
    jcsr, _ = _pair(d, "csr")
    jcsc, _ = _pair(d, "csc")
    tcsr = csr_from_arrays(20, 15, jcsr.rowptr, jcsr.colind, jcsr.values)
    tcsc = csc_from_arrays(20, 15, jcsc.colptr, jcsc.rowind, jcsc.values)
    for t, j in ((tcsr, jcsr), (tcsc, jcsc)):
        nrows, ncols, ptr, ind, val = to_arrays(t)
        back = type(j)._from_parts(nrows, ncols, jnp.asarray(ptr),
                                   jnp.asarray(ind), jnp.asarray(val))
        np.testing.assert_array_equal(np.asarray(back.to_dense()), d)
        np.testing.assert_array_equal(t.to_dense().numpy(), d)
    with pytest.raises(tsp.StructureError):
        csr_from_arrays(2, 2, [0, 1, 2], [0, 5], [1.0, 2.0])
