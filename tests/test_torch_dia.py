"""DIA of the PyTorch port against the JAX package.

Every case runs through both packages on the same NumPy inputs:

- construction: the same ``ShapeError``\\ s, ``from_diagonals``,
  ``from_csr`` (its "not diagonal-sparse" bound included), ``nnz``,
  ``to_csr``, ``to_dense`` and ``transpose`` array for array;
- ``A @ x`` and ``A @ X`` against the JAX package's public path, and the
  gradients to ``data`` and ``x`` against ``jax.grad``, in float32 and
  float64, within 1e-5 / 1e-12 of ``|A|·|x|``;
- the port's plain version against the TPU kernels B7
  (``dia_stream.dia_spmv``) and B8 (``dia_df.dia_spmv_df``) in interpret
  mode, within the JAX tests' own tolerances: interpret mode folds B8's
  error-free transforms (``tests/test_dia_df.py:102-104``);
- two matrices sharing one ``data`` tensor with different ``ncols`` give
  their own products (the JAX package's TPU-only plane cache aliases
  them, ROADMAP queue C);
- wide matrices whose largest diagonal runs past ``ncols - nrows``: the
  port against the dense product (the JAX package's ``_matvec_xla``
  under-pads ``x`` there, ROADMAP queue C).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import spalinalg_tpu as jsp
import spalinalg_tpu_torch as tsp
from spalinalg_tpu.ops.kernels.dia_df import dia_spmv_df
from spalinalg_tpu.ops.kernels.dia_stream import dia_spmv as dia_stream_spmv
from spalinalg_tpu_torch.io import dia_from_arrays, to_arrays
from spalinalg_tpu_torch.ops.kernels.dia_spmv import (DiaSpmv, dia_spmv,
                                                      dia_spmv_plain)
from spalinalg_tpu_torch.utils import metrics


@pytest.fixture(autouse=True)
def _cpu_scope():
    """The port's entry points place data on the card unless told
    otherwise; these tests run on the CPU."""
    with tsp.default_device("cpu"):
        yield


TOL = {np.float32: 1e-5, np.float64: 1e-12}
# The rectangular and square cases of tests/test_dia.py:118-121.
KERNEL_CASES = [(4096, 4096, [-1, 0, 1]),
                (5000, 5000, [-130, -1, 0, 7, 129, 257]),
                (300, 1000, [0, 5, 600]),
                (1000, 300, [-299, -1, 0, 200])]
MATVEC_CASES = KERNEL_CASES[2:] + [
    (64, 64, [-5, -1, 0, 2, 7]),
    (50, 50, [3, -7, 0]),               # offsets not sorted
    (40, 40, [0]),                      # one diagonal
    (40, 40, [-39, 39]),                # offsets at +-(n - 1)
    (30, 80, [-29, 0, 11, 50]),
]


def host(a):
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def outcome(case, pkg):
    try:
        return ("ok", case(pkg))
    except pkg.SpalinalgError as e:
        return ("raises", type(e).__name__)


def _within(got, want, scale, tol):
    got, want, scale = (np.asarray(host(a), np.float64)
                        for a in (got, want, scale))
    assert got.shape == want.shape
    assert np.all(np.abs(got - want) <= tol * scale + 1e-300), \
        float(np.max(np.abs(got - want) / (scale + 1e-300)))


def _data(rng, n, offs, dtype):
    return rng.normal(size=(len(offs), n)).astype(dtype)


def _both(n, m, offs, data):
    return (jsp.DiaMatrix(n, m, offs, jnp.asarray(data)),
            tsp.DiaMatrix(n, m, offs, data))


def _dense_oracle(offs, data, n, m):
    d = np.zeros((n, m))
    for k, o in enumerate(offs):
        i = np.arange(max(-o, 0), min(n, m - o))
        d[i, i + o] = data[k, i]
    return d


# ------------------------------------------------------------ construction

CONSTRUCTION = [
    ("zero_dims", lambda m: m.DiaMatrix(0, 3, [0], np.zeros((1, 1)))),
    ("duplicate_offsets", lambda m: m.DiaMatrix(3, 3, [0, 0],
                                                np.zeros((2, 3)))),
    ("data_rows", lambda m: m.DiaMatrix(3, 3, [0, 1], np.zeros((1, 3)))),
    ("data_cols", lambda m: m.DiaMatrix(3, 3, [0], np.zeros((1, 4)))),
    ("data_1d", lambda m: m.DiaMatrix(3, 3, [0], np.zeros(3))),
    ("offset_below", lambda m: m.DiaMatrix(3, 5, [-3], np.zeros((1, 3)))),
    ("offset_right", lambda m: m.DiaMatrix(3, 5, [5], np.zeros((1, 3)))),
    ("offset_edges", lambda m: m.DiaMatrix(3, 5, [-2, 4],
                                           np.ones((2, 3))).nnz),
    ("from_diagonals_outside", lambda m: m.DiaMatrix.from_diagonals(
        [1.0], [9], 3)),
    ("from_diagonals_count", lambda m: m.DiaMatrix.from_diagonals(
        [1.0, 2.0], [0], 3)),
    ("from_diagonals_short", lambda m: m.DiaMatrix.from_diagonals(
        [np.ones(2)], [0], 4)),
    ("operand_length", lambda m: m.DiaMatrix.from_diagonals(
        [-1.0, 2.0, -1.0], [-1, 0, 1], 4) @ np.ones(5)),
    ("nnz_rectangular", lambda m: m.DiaMatrix.from_diagonals(
        [np.arange(1.0, 5.0), 7.0], [1, -1], 4, ncols=6).nnz),
    ("shape", lambda m: m.DiaMatrix.from_diagonals(
        [1.0, 2.0], [0, 3], 5, ncols=9).shape),
]


@pytest.mark.parametrize("case", [c for _, c in CONSTRUCTION],
                         ids=[n for n, _ in CONSTRUCTION])
def test_construction_matches_jax(case):
    assert outcome(case, tsp) == outcome(case, jsp)


@pytest.mark.parametrize("n, m, offs, diagonals", [
    (6, 6, [-1, 0, 1], [-1.0, 2.0, -1.0]),
    (4, 6, [1, -1], [np.arange(1.0, 5.0), 7.0]),
    (7, 5, [2, 0, -3], [np.arange(3.0), 1.5, np.arange(4.0, 8.0)]),
    (5, 5, 2, np.arange(3.0)),
])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_from_diagonals_matches_jax(n, m, offs, diagonals, dtype):
    j = jsp.DiaMatrix.from_diagonals(diagonals, offs, n, ncols=m,
                                     dtype=dtype)
    t = tsp.DiaMatrix.from_diagonals(diagonals, offs, n, ncols=m,
                                     dtype=dtype)
    assert t.shape == j.shape and t.nnz == j.nnz
    assert t.offsets.dtype == np.int64
    np.testing.assert_array_equal(t.offsets, j.offsets)
    np.testing.assert_array_equal(host(t.data), np.asarray(j.data))
    assert host(t.data).dtype == np.asarray(j.data).dtype


def _banded_coo(rng, n, m, offs, dtype=np.float64):
    rows, cols = [], []
    for o in offs:
        i = np.arange(max(-o, 0), min(n, m - o))
        rows.append(i)
        cols.append(i + o)
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    vals = rng.normal(size=rows.size).astype(dtype)
    vals[::5] = 0.0                      # explicit zeros, dropped by COO
    return n, m, rows, cols, vals


@pytest.mark.parametrize("n, m, offs", [(40, 40, [-3, 0, 5]),
                                        (30, 50, [-29, 2, 49]),
                                        (50, 30, [-49, -1, 0, 29])])
def test_from_csr_and_to_csr_match_jax(n, m, offs):
    rng = np.random.default_rng(3)
    args = _banded_coo(rng, n, m, offs)
    j = jsp.DiaMatrix.from_csr(jsp.CsrMatrix.from_coo(
        jsp.CooMatrix.with_triplets(*args)))
    t = tsp.DiaMatrix.from_csr(tsp.CsrMatrix.from_coo(
        tsp.CooMatrix.with_triplets(*args)))
    np.testing.assert_array_equal(t.offsets, j.offsets)
    np.testing.assert_array_equal(host(t.data), np.asarray(j.data))
    assert t.nnz == j.nnz and t.device == torch.device("cpu")
    jc, tc = j.to_csr(), t.to_csr()
    for a, b in ((tc.rowptr, jc.rowptr), (tc.colind, jc.colind),
                 (tc.values, jc.values)):
        np.testing.assert_array_equal(host(a), np.asarray(b))
    np.testing.assert_array_equal(host(t.to_dense()),
                                  np.asarray(j.to_dense()))


def test_from_csr_diagonal_sparse_bound():
    """The "not diagonal-sparse" check bounds the diagonal count by
    ``max(64, band)``. A CSR structure's distinct diagonals never exceed
    its band, so a scattered dense structure (~2n - 1 diagonals) passes in
    both packages and round-trips."""
    rng = np.random.default_rng(4)
    n = 40
    d = np.where(rng.random((n, n)) < 0.3, rng.normal(size=(n, n)), 0)
    rows, cols = np.nonzero(d)
    args = (n, n, rows, cols, d[rows, cols])
    outs = [outcome(lambda m: host(m.DiaMatrix.from_csr(m.CsrMatrix.from_coo(
        m.CooMatrix.with_triplets(*args))).to_dense()).tolist(), pkg)
        for pkg in (tsp, jsp)]
    assert outs[0] == outs[1] and outs[0][0] == "ok"
    np.testing.assert_allclose(np.array(outs[0][1]), d, atol=1e-12)


@pytest.mark.parametrize("n, m, offs", [(24, 24, [-2, 0, 3]),
                                        (30, 50, [7, -29, 0, 49]),
                                        (50, 30, [-49, 29, -1])])
def test_transpose_matches_jax(n, m, offs):
    rng = np.random.default_rng(5)
    j, t = _both(n, m, offs, _data(rng, n, offs, np.float64))
    jt, tt = j.T, t.transpose()
    assert tt.shape == jt.shape == (m, n)
    np.testing.assert_array_equal(tt.offsets, jt.offsets)
    np.testing.assert_array_equal(tt.offsets, -np.asarray(offs))
    np.testing.assert_array_equal(host(tt.data), np.asarray(jt.data))
    np.testing.assert_array_equal(host(tt.to_dense()),
                                  host(t.to_dense()).T)


# ------------------------------------------------------------------ products

@pytest.mark.parametrize("n, m, offs", MATVEC_CASES)
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_matvec_matches_jax(n, m, offs, dtype):
    rng = np.random.default_rng(6)
    data = _data(rng, n, offs, dtype)
    x = rng.normal(size=m).astype(dtype)
    j, t = _both(n, m, offs, data)
    got = t @ torch.from_numpy(x)
    assert got.dtype == getattr(torch, np.dtype(dtype).name)
    scale = np.abs(_dense_oracle(offs, data, n, m)) @ np.abs(x)
    _within(got, np.asarray(j @ x), scale, TOL[dtype])


@pytest.mark.parametrize("n, m, offs", MATVEC_CASES)
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_matmat_matches_jax(n, m, offs, dtype):
    rng = np.random.default_rng(7)
    data = _data(rng, n, offs, dtype)
    X = rng.normal(size=(m, 5)).astype(dtype)
    j, t = _both(n, m, offs, data)
    rec = metrics.enable()
    try:
        rec.records.clear()
        got = t @ torch.from_numpy(X)
        assert [r.path for r in rec.records] == ["dia_spmm:torch"]
    finally:
        metrics.disable()
        rec.records.clear()
    scale = np.abs(_dense_oracle(offs, data, n, m)) @ np.abs(X)
    _within(got, np.asarray(j @ X), scale, TOL[dtype])


@pytest.mark.parametrize("n, m, offs", [(12, 20, [0, 5, 15]),
                                        (30, 50, [0, 5, 40]),
                                        (30, 80, [-3, 70])])
def test_wide_matrix_against_dense(n, m, offs):
    """Wide matrices whose largest diagonal runs past ``ncols - nrows``:
    held against the dense product, not against the JAX package, whose
    ``_matvec_xla`` under-pads ``x`` there (ROADMAP queue C)."""
    rng = np.random.default_rng(8)
    data = _data(rng, n, offs, np.float64)
    x = rng.normal(size=m)
    dense = _dense_oracle(offs, data, n, m)
    t = tsp.DiaMatrix(n, m, offs, data)
    _within(t @ torch.from_numpy(x), dense @ x, np.abs(dense) @ np.abs(x),
            1e-12)
    X = rng.normal(size=(m, 3))
    _within(t @ torch.from_numpy(X), dense @ X, np.abs(dense) @ np.abs(X),
            1e-12)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n, m, offs", [(64, 64, [-2, 0, 3]),
                                        (300, 1000, [0, 5, 600]),
                                        (1000, 300, [-299, -1, 0, 200]),
                                        (50, 50, [4, -9, 0, 1])])
def test_grad_matches_jax(n, m, offs, dtype):
    rng = np.random.default_rng(9)
    data = _data(rng, n, offs, dtype)
    x = rng.normal(size=m).astype(dtype)
    g = rng.normal(size=n).astype(dtype)

    def f(d, xx):
        return jnp.vdot(jnp.asarray(g), jsp.DiaMatrix(n, m, offs, d) @ xx)

    jd, jx = jax.grad(f, argnums=(0, 1))(jnp.asarray(data), jnp.asarray(x))
    td = torch.from_numpy(data).requires_grad_(True)
    tx = torch.from_numpy(x).requires_grad_(True)
    (tsp.DiaMatrix(n, m, offs, td) @ tx).backward(torch.from_numpy(g))
    assert td.grad.dtype == td.dtype and tx.grad.dtype == tx.dtype
    dense = np.abs(_dense_oracle(offs, data, n, m))
    _within(tx.grad, np.asarray(jx), dense.T @ np.abs(g), TOL[dtype])
    # ddata[k, i] = g[i] x[i + o_k]: one product per entry
    scale = np.abs(np.asarray(jd)) + 1e-30
    _within(td.grad, np.asarray(jd), scale, TOL[dtype])


def test_result_dtype_is_the_promotion():
    """As ``_matvec_xla``: float32 data with a float64 operand gives
    float64, bfloat16 data with a float32 operand float32."""
    rng = np.random.default_rng(10)
    data = _data(rng, 20, [0, 1], np.float32)
    t = tsp.DiaMatrix(20, 20, [0, 1], data)
    x64 = torch.from_numpy(rng.normal(size=20))
    assert (t @ x64).dtype == torch.float64
    tb = t.astype(torch.bfloat16)
    y = tb @ x64.float()
    assert y.dtype == torch.float32
    ref = tsp.DiaMatrix(20, 20, [0, 1], tb.data.float()) @ x64.float()
    torch.testing.assert_close(y, ref, rtol=0, atol=0)


def test_shared_data_with_different_ncols():
    """Two matrices on one ``data`` tensor with different ``ncols`` give
    their own products: the port keeps no per-``data`` cache that could
    alias them (the JAX package's ``dia_df.py:156`` fault, ROADMAP queue
    C)."""
    rng = np.random.default_rng(11)
    offs = [-2, 0, 3]
    data = torch.from_numpy(_data(rng, 40, offs, np.float64))
    a = tsp.DiaMatrix(40, 40, offs, data)
    b = tsp.DiaMatrix(40, 60, offs, data)
    assert a.data.data_ptr() == b.data.data_ptr()
    for mat, m in ((a, 40), (b, 60), (a, 40)):
        x = rng.normal(size=m)
        dense = _dense_oracle(offs, data.numpy(), 40, m)
        _within(mat @ torch.from_numpy(x), dense @ x,
                np.abs(dense) @ np.abs(x), 1e-12)


# ---------------------------------------------- against the TPU kernels

@pytest.mark.parametrize("n, m, offs", KERNEL_CASES)
def test_plain_matches_dia_stream_interpret(n, m, offs):
    """The port's plain version against B7 in interpret mode, f32, at the
    JAX test's tolerance (``tests/test_dia.py:128``)."""
    rng = np.random.default_rng(12)
    data = _data(rng, n, offs, np.float32)
    x = rng.normal(size=m).astype(np.float32)
    ref = np.asarray(dia_stream_spmv(offs, jnp.asarray(data),
                                     jnp.asarray(x), n, m, interpret=True))
    got = dia_spmv_plain(offs, torch.from_numpy(data), torch.from_numpy(x),
                         n, m)
    np.testing.assert_allclose(host(got), ref, atol=1e-4)


@pytest.mark.parametrize("n, m, offs", KERNEL_CASES)
def test_plain_matches_dia_df_interpret(n, m, offs):
    """The port's plain version (native f64) against B8 in interpret mode,
    whose folded error-free transforms reach f32-level agreement only:
    the JAX test's scaled bound 1e-5 (``tests/test_dia_df.py:102-104``)."""
    rng = np.random.default_rng(13)
    data = _data(rng, n, offs, np.float64)
    x = rng.normal(size=m)
    ref = np.asarray(dia_spmv_df(offs, jnp.asarray(data), jnp.asarray(x),
                                 n, m, interpret=True))
    got = host(dia_spmv_plain(offs, torch.from_numpy(data),
                              torch.from_numpy(x), n, m))
    scale = np.abs(data).sum(axis=0).max() * np.abs(x).max() + 1e-300
    assert (np.abs(got - ref) / scale).max() < 1e-5


def test_wrapper_transposed_matches_dense():
    """The wrapper's ``transposed`` pass is ``Aᵀ·g`` with the data read in
    place; ``D = 0`` gives zeros."""
    rng = np.random.default_rng(14)
    for n, m, offs in MATVEC_CASES:
        data = _data(rng, n, offs, np.float64)
        g = rng.normal(size=n)
        dense = _dense_oracle(offs, data, n, m)
        got = dia_spmv(offs, torch.from_numpy(data), torch.from_numpy(g),
                       n, m, transposed=True)
        _within(got, dense.T @ g, np.abs(dense).T @ np.abs(g), 1e-12)
    zeros = dia_spmv([], torch.zeros(0, 7, dtype=torch.float64),
                     torch.ones(9, dtype=torch.float64), 7, 9)
    assert zeros.shape == (7,) and not zeros.any()
    d = torch.zeros(0, 7, dtype=torch.float64, requires_grad=True)
    x = torch.ones(9, dtype=torch.float64, requires_grad=True)
    DiaSpmv.apply(d, x, [], 7, 9,
                  torch.zeros(0, dtype=torch.int64)).sum().backward()
    assert d.grad.shape == (0, 7) and not x.grad.any()


# -------------------------------------------------------------- carrying

def test_arrays_carry_both_ways():
    rng = np.random.default_rng(15)
    offs = [4, -1, 0]
    j, _ = _both(30, 35, offs, _data(rng, 30, offs, np.float32))
    t = dia_from_arrays(j.nrows, j.ncols, j.offsets, np.asarray(j.data))
    assert t.device == torch.device("cpu") and t.dtype == torch.float32
    n, m, offsets, data = to_arrays(t)
    back = jsp.DiaMatrix(n, m, offsets, jnp.asarray(data))
    np.testing.assert_array_equal(back.offsets, j.offsets)
    np.testing.assert_array_equal(np.asarray(back.data), np.asarray(j.data))
