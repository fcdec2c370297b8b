"""BSR of the PyTorch port against the JAX package.

The port runs its plain torch versions here (CPU tensors); the kernels
themselves are held against them on the GPU by ``chip_smoke.py``. Inputs
are made with NumPy from a seed and handed to both packages.

- structure, exactly: ``from_csr``/``to_bsr``, ``eye``, ``to_csr``,
  ``to_dense``, ``transpose`` (square and rectangular blocks), ``+``,
  ``-``, ``*``, ``-a``, ``astype(bfloat16)`` and the constructor's typed
  errors, replaying ``tests/test_bsr_ops.py`` and
  ``tests/test_matvec.py::TestBsr``;
- ``bsr @ x`` and ``bsr @ X`` against the JAX public CPU path, entry by
  entry ``|y - y_jax| <= tol·(|A|·|x|)`` (1e-5 f32 and bf16 blocks, 1e-12
  f64), and their gradients against ``jax.grad``;
- against the TPU kernels' own functions run in interpret mode, as the JAX
  tests run them (B4 ``bsr_matvec_stream``, B5 ``bsr_matmat_stream``, B6
  ``bsr_matvec_df``, B9 ``bsr_matvec_pallas``/``bsr_matmat_pallas``), at
  the JAX tests' tolerances;
- the weight carry through ``io/arrays`` and the slice COO -> CSR ->
  ``to_bsr(8)`` -> ``@ x``/``@ X`` with gradients, through both packages.
"""

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import jax
import jax.numpy as jnp

import spalinalg_tpu as jsp
import spalinalg_tpu_torch as tsp
from spalinalg_tpu.ops.kernels.bsr_df import bsr_matvec_df
from spalinalg_tpu.ops.kernels.bsr_spmv import (bsr_matmat_pallas,
                                                bsr_matvec_pallas)
from spalinalg_tpu.ops.kernels.bsr_stream import (bsr_matmat_stream,
                                                  bsr_matvec_stream)
from spalinalg_tpu_torch.io import bsr_from_arrays, to_arrays
from spalinalg_tpu_torch.ops.kernels import bsr_spmv as bsr_spmv_mod
from spalinalg_tpu_torch.ops.kernels.bsr_spmm import bsr_spmm
from spalinalg_tpu_torch.ops.kernels.bsr_spmv import bsr_spmv


@pytest.fixture(autouse=True)
def _cpu_scope():
    """The port's entry points place data on the card unless told
    otherwise; these tests run on the CPU."""
    with tsp.default_device("cpu"):
        yield


TOL = {np.float32: 1e-5, np.float64: 1e-12}
BLOCKSIZES = [1, 3, 8, (4, 8)]


def _dense(rng, n, m, density, dtype, empty_rows=()):
    d = np.where(rng.random((n, m)) < density, rng.normal(size=(n, m)), 0)
    d[list(empty_rows), :] = 0
    return d.astype(dtype)


def _pair(d, bs):
    """The same BSR matrix in both packages, built through COO -> CSR."""
    rows, cols = np.nonzero(d)
    out = []
    for pkg in (jsp, tsp):
        csr = pkg.CsrMatrix.from_coo(pkg.CooMatrix.with_triplets(
            *d.shape, rows, cols, d[rows, cols]))
        out.append(csr.to_bsr(bs))
    return out


def _same_structure(jmat, tmat, data_exact=True):
    assert tmat.shape == jmat.shape and tmat.blocksize == jmat.blocksize
    np.testing.assert_array_equal(tmat.indptr.numpy(), np.asarray(jmat.indptr))
    np.testing.assert_array_equal(tmat.indices.numpy(),
                                  np.asarray(jmat.indices))
    assert tmat.indptr.dtype == tmat.indices.dtype == torch.int32
    if data_exact:
        np.testing.assert_array_equal(tmat.data.float().numpy()
                                      if tmat.dtype == torch.bfloat16
                                      else tmat.data.numpy(),
                                      np.asarray(jmat.data, np.float32)
                                      if tmat.dtype == torch.bfloat16
                                      else np.asarray(jmat.data))


def _within(got, want, scale, tol):
    """Entry by entry ``|got - want| <= tol·scale``."""
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert np.all(err <= tol * np.asarray(scale, np.float64)), \
        (err / np.maximum(scale, 1e-300)).max()


def _banded(rng, nbr, bs, dtype=np.float64, scale_pow=0.0):
    """Block-tridiagonal BSR arrays (the pattern of bench.py's bsr cells)
    and the dense matrix."""
    indptr, indices = [0], []
    for i in range(nbr):
        indices.extend(j for j in (i - 1, i, i + 1) if 0 <= j < nbr)
        indptr.append(len(indices))
    indptr, indices = np.asarray(indptr), np.asarray(indices)
    data = rng.normal(size=(indices.size, bs, bs))
    if scale_pow:
        data *= np.exp(rng.normal(size=(indices.size, 1, 1)) * scale_pow)
    data = data.astype(dtype)
    dense = sps.bsr_matrix((data, indices, indptr),
                           shape=(nbr * bs, nbr * bs)).toarray()
    return indptr, indices, data, dense


def _jax_bsr(n, m, bs, indptr, indices, data):
    return jsp.BsrMatrix._from_parts(
        n, m, bs, bs, jnp.asarray(indptr, dtype=jnp.int32),
        jnp.asarray(indices, dtype=jnp.int32), jnp.asarray(data))


# ------------------------------------------------ structure, exactly


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("bs", BLOCKSIZES + [(8, 4)])
def test_from_csr_matches_jax(bs, dtype):
    rng = np.random.default_rng(40)
    d = _dense(rng, 24, 48, 0.15, dtype, empty_rows=range(8, 16))
    jmat, tmat = _pair(d, bs)
    _same_structure(jmat, tmat)
    assert tmat.dtype == torch.from_numpy(d).dtype
    assert tmat.n_blocks == jmat.n_blocks and tmat.nnz == jmat.nnz
    np.testing.assert_array_equal(tmat.to_dense().numpy(), d)


def test_from_csr_roundtrip():
    """tests/test_matvec.py::TestBsr::test_from_csr_roundtrip."""
    rng = np.random.default_rng(41)
    d = _dense(rng, 32, 24, 0.2, np.float64)
    jmat, tmat = _pair(d, (8, 8))
    np.testing.assert_allclose(tmat.to_dense().numpy(), d, rtol=1e-12)
    np.testing.assert_allclose(tmat.to_csr().to_dense().numpy(), d,
                               rtol=1e-12)


@pytest.mark.parametrize("bs", [1, 3, (4, 8)])
def test_to_csr_matches_jax_with_stored_zeros(bs):
    rng = np.random.default_rng(42)
    d = _dense(rng, 24, 48, 0.1, np.float64)
    jmat, tmat = _pair(d, bs)
    jc, tc = jmat.to_csr(), tmat.to_csr()
    for a, b in ((jc.rowptr, tc.rowptr), (jc.colind, tc.colind),
                 (jc.values, tc.values)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert tc.nnz == tmat.nnz          # zeros inside blocks stay stored


@pytest.mark.parametrize("size,bs,dtype", [(16, 8, np.float64),
                                           (12, 3, np.float32),
                                           (5, 1, np.float64)])
def test_eye_matches_jax(size, bs, dtype):
    jmat = jsp.BsrMatrix.eye(size, bs, dtype=dtype)
    tmat = tsp.BsrMatrix.eye(size, bs, dtype=torch.from_numpy(
        np.zeros(1, dtype)).dtype)
    _same_structure(jmat, tmat)
    np.testing.assert_array_equal(tmat.to_dense().numpy(), np.eye(size))
    for pkg in (jsp, tsp):
        with pytest.raises(pkg.ShapeError):
            pkg.BsrMatrix.eye(9, 2)


def test_to_dense_masks_padding_blocks():
    """Blocks at or past ``indptr[-1]`` are storage only, in both packages,
    for ``to_dense``, ``@ x`` and ``@ X``."""
    rng = np.random.default_rng(43)
    indptr = np.array([0, 2, 2, 3])
    indices = np.array([0, 2, 1, 2, 0])          # two padding blocks
    data = rng.normal(size=(5, 3, 3))
    jmat = jsp.BsrMatrix(9, 9, 3, indptr, indices, data)
    tmat = tsp.BsrMatrix(9, 9, 3, indptr, indices, data)
    dense = np.asarray(jmat.to_dense())
    np.testing.assert_array_equal(tmat.to_dense().numpy(), dense)
    x, X = rng.normal(size=9), rng.normal(size=(9, 2))
    _within((tmat @ torch.from_numpy(x)).numpy(), np.asarray(jmat @ x),
            np.abs(dense) @ np.abs(x), 1e-12)
    _within((tmat @ torch.from_numpy(X)).numpy(), np.asarray(jmat @ X),
            np.abs(dense) @ np.abs(X), 1e-12)


@pytest.mark.parametrize("shape,bs", [((32, 48), 8), ((32, 64), (4, 8)),
                                      ((24, 12), (8, 4)), ((9, 6), 3)])
def test_transpose_matches_jax(shape, bs):
    """Square and rectangular blocks: the block pattern, the block order and
    the transposed blocks equal the JAX package's, array for array."""
    rng = np.random.default_rng(44)
    d = _dense(rng, *shape, 0.15, np.float64)
    jmat, tmat = _pair(d, bs)
    jt, tt = jmat.T, tmat.T
    _same_structure(jt, tt)
    np.testing.assert_array_equal(tt.to_dense().numpy(), d.T)
    np.testing.assert_array_equal(tt.T.to_dense().numpy(), d)
    x = rng.normal(size=shape[0])
    _within((tt @ torch.from_numpy(x)).numpy(), d.T @ x,
            np.abs(d.T) @ np.abs(x), 1e-12)


def test_transpose_structure_is_cached():
    rng = np.random.default_rng(45)
    _, tmat = _pair(_dense(rng, 16, 16, 0.3, np.float64), 4)
    a, b = tmat.T, tmat.T
    assert a.indptr is b.indptr and a.indices is b.indices
    assert a.data is not b.data


@pytest.mark.parametrize("op", ["add", "sub"])
def test_add_sub_match_jax(op):
    rng = np.random.default_rng(46)
    da, db = (_dense(rng, 32, 48, 0.15, np.float64) for _ in range(2))
    (ja, ta), (jb, tb) = _pair(da, 8), _pair(db, 8)
    jc, tc = (ja + jb, ta + tb) if op == "add" else (ja - jb, ta - tb)
    _same_structure(jc, tc, data_exact=False)
    np.testing.assert_allclose(tc.data.numpy(), np.asarray(jc.data),
                               rtol=0, atol=1e-12)
    ref = da + db if op == "add" else da - db
    np.testing.assert_allclose(tc.to_dense().numpy(), ref, atol=1e-12)
    assert tc.n_blocks <= ta.n_blocks + tb.n_blocks


def test_add_matches_scipy_bsr():
    """tests/test_bsr_ops.py::test_add_matches_scipy_bsr."""
    rng = np.random.default_rng(47)
    da, db = (_dense(rng, 32, 48, 0.15, np.float64) for _ in range(2))
    (_, ta), (_, tb) = _pair(da, 8), _pair(db, 8)
    ref = (sps.bsr_matrix(da, blocksize=(8, 8))
           + sps.bsr_matrix(db, blocksize=(8, 8))).toarray()
    np.testing.assert_allclose((ta + tb).to_dense().numpy(), ref, atol=1e-12)


def test_add_sub_errors():
    """tests/test_bsr_ops.py::test_validation, in both packages."""
    rng = np.random.default_rng(48)
    ja, ta = _pair(_dense(rng, 32, 48, 0.15, np.float64), 8)
    jb, tb = _pair(_dense(rng, 48, 32, 0.15, np.float64), 8)
    jc, tc = _pair(_dense(rng, 32, 48, 0.15, np.float64), 16)
    for j, t in ((jb, tb), (jc, tc)):
        with pytest.raises(jsp.ShapeError):
            ja + j
        with pytest.raises(tsp.ShapeError):
            ta + t


@pytest.mark.parametrize("how", ["mul", "rmul", "npscalar", "neg"])
def test_scalar_ops_match_jax(how):
    rng = np.random.default_rng(49)
    for dtype in (np.float32, np.float64):
        ja, ta = _pair(_dense(rng, 16, 24, 0.2, dtype), 8)
        fn = {"mul": lambda a: a * 2.5, "rmul": lambda a: 0.5 * a,
              "npscalar": lambda a: a * np.float64(1.5),
              "neg": lambda a: -a}[how]
        jb, tb = fn(ja), fn(ta)
        assert tb.data.numpy().dtype == np.asarray(jb.data).dtype
        _same_structure(jb, tb)


def test_astype_bf16_matches_jax():
    rng = np.random.default_rng(50)
    ja, ta = _pair(_dense(rng, 16, 24, 0.3, np.float32), 8)
    jb, tb = ja.astype(jnp.bfloat16), ta.astype(torch.bfloat16)
    assert tb.dtype == torch.bfloat16 and tb.device == ta.device
    _same_structure(jb, tb)
    back = tb.astype(torch.float32)
    np.testing.assert_array_equal(back.data.numpy(),
                                  np.asarray(jb.data, np.float32))


def test_bf16_to_dense_and_to_csr():
    """bfloat16 blocks: ``to_dense`` on the device keeps bfloat16;
    ``to_csr`` crosses the host as float32 and gives a bfloat16 CSR, as
    the JAX package's does."""
    rng = np.random.default_rng(51)
    ja, ta = _pair(_dense(rng, 16, 24, 0.3, np.float32), 8)
    jb, tb = ja.astype(jnp.bfloat16), ta.astype(torch.bfloat16)
    dense = tb.to_dense()
    assert dense.dtype == torch.bfloat16
    np.testing.assert_array_equal(dense.float().numpy(),
                                  np.asarray(jb.to_dense(), np.float32))
    jc, tc = jb.to_csr(), tb.to_csr()
    assert tc.dtype == torch.bfloat16
    np.testing.assert_array_equal(tc.rowptr.numpy(), np.asarray(jc.rowptr))
    np.testing.assert_array_equal(tc.colind.numpy(), np.asarray(jc.colind))
    np.testing.assert_array_equal(tc.values.float().numpy(),
                                  np.asarray(jc.values, np.float32))


_OK = dict(nrows=8, ncols=8, blocksize=4, indptr=[0, 1, 2], indices=[0, 1],
           data=np.ones((2, 4, 4)))
_BAD = [
    ("nonpositive", dict(nrows=0), "ShapeError"),
    ("negative", dict(ncols=-4), "ShapeError"),
    ("indivisible", dict(nrows=10), "ShapeError"),
    ("indivisible_rect", dict(blocksize=(4, 3)), "ShapeError"),
    ("indptr_length", dict(indptr=[0, 1, 2, 2]), "StructureError"),
    ("indptr_start", dict(indptr=[1, 1, 2]), "StructureError"),
    ("indptr_decreasing", dict(indptr=[0, 2, 1]), "StructureError"),
    ("column_high", dict(indices=[0, 2]), "StructureError"),
    ("column_negative", dict(indices=[-1, 1]), "StructureError"),
    ("data_shape", dict(data=np.ones((2, 4, 2))), "StructureError"),
    ("data_count", dict(data=np.ones((3, 4, 4))), "StructureError"),
]


@pytest.mark.parametrize("name,change,error", _BAD, ids=[b[0] for b in _BAD])
def test_constructor_errors_match_jax(name, change, error):
    args = {**_OK, **change}
    with pytest.raises(getattr(jsp, error)):
        jsp.BsrMatrix(**args)
    with pytest.raises(getattr(tsp, error)):
        tsp.BsrMatrix(**args)


def test_constructor_accepts_valid_inputs():
    for blocksize in (4, (4, 4)):
        args = {**_OK, "blocksize": blocksize}
        jmat, tmat = jsp.BsrMatrix(**args), tsp.BsrMatrix(**args)
        _same_structure(jmat, tmat)
    on_device = tsp.BsrMatrix(**{**_OK, "data": torch.ones(2, 4, 4)},
                              device="cpu")
    assert on_device.dtype == torch.float32


def test_indivisible_to_bsr_raises():
    """tests/test_matvec.py::TestBsr::test_indivisible_shape_raises."""
    rng = np.random.default_rng(52)
    d = _dense(rng, 30, 30, 0.1, np.float64)
    rows, cols = np.nonzero(d)
    for pkg in (jsp, tsp):
        csr = pkg.CsrMatrix.from_coo(pkg.CooMatrix.with_triplets(
            30, 30, rows, cols, d[rows, cols]))
        with pytest.raises(pkg.ShapeError):
            csr.to_bsr(8)


def test_with_data_checks():
    _, tmat = _pair(_dense(np.random.default_rng(53), 8, 8, 0.5,
                           np.float64), 4)
    with pytest.raises(tsp.ShapeError):
        tmat.with_data(torch.ones(1, 4, 4, dtype=torch.float64))
    with pytest.raises(ValueError):
        tmat.with_data(tmat.data.to("meta"))


# ------------------------------------------------ the JAX public CPU path


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("bs", BLOCKSIZES)
def test_matvec_matches_jax(bs, dtype):
    rng = np.random.default_rng(54)
    d = _dense(rng, 48, 48, 0.12, dtype, empty_rows=range(0, 8))
    jmat, tmat = _pair(d, bs)
    x = rng.normal(size=48).astype(dtype)
    y = tmat @ torch.from_numpy(x)
    assert y.dtype == torch.from_numpy(x).dtype and y.shape == (48,)
    _within(y.numpy(), np.asarray(jmat @ x),
            np.abs(d).astype(np.float64) @ np.abs(x), TOL[dtype])
    assert np.all(y.numpy()[:8] == 0)


@pytest.mark.parametrize("k", [1, 3, 64])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("bs", BLOCKSIZES)
def test_matmat_matches_jax(bs, dtype, k):
    rng = np.random.default_rng(55)
    d = _dense(rng, 48, 48, 0.12, dtype, empty_rows=range(8, 16))
    jmat, tmat = _pair(d, bs)
    X = rng.normal(size=(48, k)).astype(dtype)
    Y = tmat @ torch.from_numpy(X)
    assert Y.dtype == torch.from_numpy(X).dtype and Y.shape == (48, k)
    _within(Y.numpy(), np.asarray(jmat @ X),
            np.abs(d).astype(np.float64) @ np.abs(X), TOL[dtype])
    assert np.all(Y.numpy()[8:16] == 0)


@pytest.mark.parametrize("k", [None, 1, 3, 64])
@pytest.mark.parametrize("xdtype", [np.float32, np.float64])
@pytest.mark.parametrize("bs", [3, 8, (4, 8)])
def test_bf16_blocks_match_jax(bs, xdtype, k):
    """bfloat16 blocks accumulate and return float32 in both packages,
    also for a float64 operand; the operand is not rounded to bfloat16."""
    rng = np.random.default_rng(56)
    d = _dense(rng, 24, 48, 0.2, np.float32, empty_rows=(0, 1, 2))
    jmat, tmat = _pair(d, bs)
    jb, tb = jmat.astype(jnp.bfloat16), tmat.astype(torch.bfloat16)
    x = rng.normal(size=48 if k is None else (48, k)).astype(xdtype)
    y = tb @ torch.from_numpy(x)
    yj = np.asarray(jb @ jnp.asarray(x))
    assert y.dtype == torch.float32 and yj.dtype == np.float32
    a16 = tb.to_dense().float().numpy().astype(np.float64)
    _within(y.numpy(), yj, np.abs(a16) @ np.abs(x), 1e-5)
    _within(y.numpy(), a16 @ x, np.abs(a16) @ np.abs(x), 1e-5)


@pytest.mark.parametrize("ddtype,xdtype", [(np.float32, np.float64),
                                           (np.float64, np.float32)])
def test_mixed_promotion(ddtype, xdtype):
    rng = np.random.default_rng(57)
    d = _dense(rng, 16, 16, 0.3, ddtype)
    jmat, tmat = _pair(d, 4)
    for shape in ((16,), (16, 3)):
        x = rng.normal(size=shape).astype(xdtype)
        yj = np.asarray(jmat @ x)
        y = tmat @ torch.from_numpy(x)
        assert yj.dtype == np.float64 and y.dtype == torch.float64
        _within(y.numpy(), yj, np.abs(d).astype(np.float64) @ np.abs(x),
                1e-12)


def test_bsr_matvec_matmat():
    """tests/test_matvec.py::TestBsr::test_bsr_matvec_matmat."""
    rng = np.random.default_rng(58)
    d = _dense(rng, 32, 32, 0.15, np.float64)
    _, tmat = _pair(d, 8)
    x, X = rng.normal(size=32), rng.normal(size=(32, 16))
    np.testing.assert_allclose((tmat @ torch.from_numpy(x)).numpy(), d @ x,
                               rtol=1e-12)
    np.testing.assert_allclose((tmat @ torch.from_numpy(X)).numpy(), d @ X,
                               rtol=1e-12)
    np.testing.assert_allclose((tmat @ x).numpy(), d @ x, rtol=1e-12)


def test_k0_and_no_blocks():
    rng = np.random.default_rng(59)
    _, tmat = _pair(_dense(rng, 16, 16, 0.3, np.float64), 4)
    assert (tmat @ torch.ones(16, 0, dtype=torch.float64)).shape == (16, 0)
    empty = tsp.BsrMatrix(16, 8, 4, np.zeros(5, np.int32),
                          np.zeros(0, np.int32), np.zeros((0, 4, 4)))
    assert torch.equal(empty @ torch.ones(8, dtype=torch.float64),
                       torch.zeros(16, dtype=torch.float64))
    assert torch.equal(empty @ torch.ones(8, 3, dtype=torch.float64),
                       torch.zeros(16, 3, dtype=torch.float64))


@pytest.mark.parametrize("shape", [(7,), (7, 2), (3, 2, 2)])
def test_operand_shape_errors(shape):
    _, tmat = _pair(_dense(np.random.default_rng(60), 8, 8, 0.5,
                           np.float64), 4)
    x = torch.ones(shape, dtype=torch.float64)
    if len(shape) == 3:
        with pytest.raises(TypeError):
            tmat @ x
    else:
        with pytest.raises(tsp.ShapeError):
            tmat @ x


def test_metrics_record_path_and_counts():
    """The records name the path and carry the JAX package's counts
    (``spalinalg_tpu/ops/bsr_ops.py:67-70``)."""
    from spalinalg_tpu_torch.utils import metrics

    rec = metrics.enable()
    try:
        rec.records.clear()
        eye = tsp.BsrMatrix.eye(8, 4)
        eye @ torch.ones(8, dtype=torch.float64)
        eye @ torch.ones(8, 3, dtype=torch.float64)
        nnz = 32
        assert [(r.op, r.path, r.nnz, r.flops, r.bytes)
                for r in rec.records] == [
            ("bsr_spmv", "bsr_spmv:plain", nnz, 2 * nnz, 8 * nnz),
            ("bsr_spmm", "bsr_spmm:plain", nnz, 2 * nnz * 3, 8 * nnz)]
    finally:
        metrics.disable()
        rec.records.clear()


def test_wrapper_checks():
    ptr = torch.tensor([0, 1, 1], dtype=torch.int32)
    ind = torch.tensor([0], dtype=torch.int32)
    data = torch.ones(1, 2, 2, dtype=torch.float64)
    x = torch.ones(2, dtype=torch.float64)
    np.testing.assert_array_equal(bsr_spmv(ptr, ind, data, x).numpy(),
                                  [2, 2, 0, 0])
    np.testing.assert_array_equal(
        bsr_spmm(ptr, ind, data, torch.ones(2, 3, dtype=torch.float64)
                 ).numpy(), [[2] * 3] * 2 + [[0] * 3] * 2)
    with pytest.raises(tsp.DTypeError):
        bsr_spmv(ptr.long(), ind, data, x)
    with pytest.raises(tsp.ShapeError):
        bsr_spmv(ptr, ind, data, torch.ones(3, dtype=torch.float64))
    with pytest.raises(tsp.ShapeError):
        bsr_spmm(ptr, ind, data, x)
    with pytest.raises(tsp.ShapeError):
        bsr_spmv(ptr, ind[:0], data, x)
    with pytest.raises(ValueError, match="several devices"):
        bsr_spmv(ptr, ind, data, x.to("meta"))


# ------------------------------------------------ gradients


def _grad_case(rng, dtype, bs, k):
    d = _dense(rng, 24, 48, 0.2, dtype, empty_rows=range(8, 16))
    jmat, tmat = _pair(d, bs)
    xshape = (48,) if k is None else (48, k)
    gshape = (24,) if k is None else (24, k)
    x = rng.normal(size=xshape).astype(dtype)
    g = rng.normal(size=gshape).astype(dtype)
    return d, jmat, tmat, x, g


def _jax_grads(jmat, x, g):
    def f(data, xv):
        return jnp.vdot(jnp.asarray(g), jmat.with_data(data) @ xv)

    dd, dx = jax.grad(f, argnums=(0, 1))(jmat.data, jnp.asarray(x))
    return np.asarray(dd), np.asarray(dx)


def _port_grads(tmat, x, g):
    data = tmat.data.clone().requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = tmat.with_data(data) @ xt
    y.backward(torch.from_numpy(g))
    return y.detach().numpy(), data.grad.numpy(), xt.grad.numpy()


def _block_scale(tmat, g, x):
    """``|g_blk[row_k]| ⊗ |x_blk[col_k]|`` summed over columns: the scale
    of ``ddata``."""
    br, bc = tmat.blocksize
    K = 1 if g.ndim == 1 else g.shape[1]
    rows = np.repeat(np.arange(tmat.nrows // br),
                     np.diff(tmat.indptr.numpy()))
    G = np.abs(g).reshape(-1, br, K)[rows]
    X = np.abs(x).reshape(-1, bc, K)[tmat.indices.numpy()]
    return np.einsum("kil,kjl->kij", G, X)


@pytest.mark.parametrize("k", [None, 1, 5])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("bs", [3, 8, (4, 8)])
def test_grad_matches_jax(bs, dtype, k):
    rng = np.random.default_rng(61)
    d, jmat, tmat, x, g = _grad_case(rng, dtype, bs, k)
    jdd, jdx = _jax_grads(jmat, x, g)
    _, dd, dx = _port_grads(tmat, x, g)
    assert dd.dtype == jdd.dtype and dx.dtype == jdx.dtype
    tol = TOL[dtype]
    ad = np.abs(d).astype(np.float64)
    _within(dx, jdx, ad.T @ np.abs(g), tol)
    _within(dd, jdd, _block_scale(tmat, g, x), tol)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_grad_large_blocks_matches_jax(dtype):
    """Blocks of 1024 values or more take ``ddata`` through bmm, smaller
    ones through a broadcast multiply; both give ``jax.grad``'s values."""
    rng = np.random.default_rng(73)
    d = _dense(rng, 64, 96, 0.3, dtype, empty_rows=range(32, 64))
    jmat, tmat = _pair(d, 32)
    x, g = rng.normal(size=96).astype(dtype), rng.normal(size=64).astype(dtype)
    jdd, jdx = _jax_grads(jmat, x, g)
    _, dd, dx = _port_grads(tmat, x, g)
    tol = TOL[dtype]
    _within(dx, jdx, np.abs(d).astype(np.float64).T @ np.abs(g), tol)
    _within(dd, jdd, _block_scale(tmat, g, x), tol)


def test_grad_chunks_and_padding(monkeypatch):
    """``ddata`` computed in many chunks equals the one-chunk result;
    padding blocks get a zero gradient and change nothing."""
    rng = np.random.default_rng(62)
    indptr = np.array([0, 2, 2, 4])
    indices = np.array([0, 2, 1, 2, 1])
    data = rng.normal(size=(5, 3, 3))
    x, g = rng.normal(size=(9, 2)), rng.normal(size=(9, 2))
    tmat = tsp.BsrMatrix(9, 9, 3, indptr, indices, data)
    _, dd1, dx1 = _port_grads(tmat, x, g)
    monkeypatch.setattr(bsr_spmv_mod, "_DDATA_CHUNK", 5)
    _, dd2, dx2 = _port_grads(tmat, x, g)
    np.testing.assert_array_equal(dd1, dd2)
    np.testing.assert_array_equal(dx1, dx2)
    assert np.all(dd1[4] == 0)
    jdd, jdx = _jax_grads(jsp.BsrMatrix(9, 9, 3, indptr, indices, data), x, g)
    np.testing.assert_allclose(dd1, jdd, rtol=0, atol=1e-12)
    np.testing.assert_allclose(dx1, jdx, rtol=0, atol=1e-12)


def test_grad_bf16_blocks():
    """bfloat16 blocks: ``ddata`` is bfloat16, the operand's gradient
    float32, as ``jax.grad`` gives them."""
    rng = np.random.default_rng(63)
    d, jmat, tmat, x, g = _grad_case(rng, np.float32, 8, None)
    jb, tb = jmat.astype(jnp.bfloat16), tmat.astype(torch.bfloat16)
    jdd, jdx = _jax_grads(jb, x, g)
    data = tb.data.clone().requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    (tb.with_data(data) @ xt).backward(torch.from_numpy(g))
    dd, dx = data.grad, xt.grad.numpy()
    assert dd.dtype == torch.bfloat16 and dx.dtype == np.float32
    np.testing.assert_allclose(dd.float().numpy(),
                               np.asarray(jdd, np.float32), rtol=1e-2,
                               atol=1e-2)
    a16 = tb.to_dense().float().numpy().astype(np.float64)
    _within(dx, jdx, np.abs(a16).T @ np.abs(g), 1e-5)


# ------------------------------------ the TPU kernels' own functions


def _v3_case(rng, nbr, bs=128):
    """tests/test_pallas_kernels.py::TestBsrStreamV3::_v3_case (band 1)."""
    indptr, indices, data, dense = _banded(rng, nbr, bs, np.float32)
    n = nbr * bs
    return (_jax_bsr(n, n, bs, indptr, indices, data),
            tsp.BsrMatrix(n, n, bs, indptr, indices, data), dense)


def _random_case(rng, n, m, density, bs):
    d = _dense(rng, n, m, density, np.float32)
    return (*_pair(d, bs), d)


@pytest.mark.parametrize("nbr", [2, 5])
def test_matches_stream_v3(nbr):
    """B4 (``bsr_stream.py::_kernel_v3``), at the 2e-4 of
    tests/test_pallas_kernels.py::test_v3_parity."""
    rng = np.random.default_rng(64)
    jmat, tmat, dense = _v3_case(rng, nbr)
    x = rng.normal(size=dense.shape[1]).astype(np.float32)
    y_tpu = np.asarray(bsr_matvec_stream(jmat, jnp.asarray(x),
                                         interpret=True))
    y = (tmat @ torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(y, y_tpu, rtol=2e-4, atol=2e-4)


def test_matches_stream_v3_bf16():
    """B4 with bfloat16 blocks, at the ``2e-2·max|ref|`` of
    test_v3_bf16_storage, which absorbs the TPU kernel's bfloat16 rounding
    of x (the port does not round x)."""
    rng = np.random.default_rng(65)
    jmat, tmat, dense = _v3_case(rng, 3)
    x = rng.normal(size=dense.shape[1]).astype(np.float32)
    y_tpu = np.asarray(bsr_matvec_stream(jmat.astype(jnp.bfloat16),
                                         jnp.asarray(x), interpret=True))
    y = (tmat.astype(torch.bfloat16) @ torch.from_numpy(x)).numpy()
    assert y.dtype == y_tpu.dtype == np.float32
    np.testing.assert_allclose(y, y_tpu, rtol=0,
                               atol=2e-2 * float(np.abs(y_tpu).max()))


@pytest.mark.parametrize("n,m", [(32, 32), (64, 48)])
def test_matches_stream_v2(n, m):
    """B5 in its K = 1 role (bs = 8 is not v3-eligible), at 2e-5."""
    rng = np.random.default_rng(66)
    jmat, tmat, d = _random_case(rng, n, m, 0.2, 8)
    x = rng.normal(size=m).astype(np.float32)
    y_tpu = np.asarray(bsr_matvec_stream(jmat, jnp.asarray(x),
                                         interpret=True))
    y = (tmat @ torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(y, y_tpu, rtol=2e-5, atol=2e-5)


def test_matches_stream_matmat():
    """B5 (``bsr_stream.py::_kernel_v2``), at 3e-5."""
    rng = np.random.default_rng(67)
    jmat, tmat, d = _random_case(rng, 48, 64, 0.3, 8)
    X = rng.normal(size=(64, 16)).astype(np.float32)
    Y_tpu = np.asarray(bsr_matmat_stream(jmat, jnp.asarray(X),
                                         interpret=True))
    Y = (tmat @ torch.from_numpy(X)).numpy()
    np.testing.assert_allclose(Y, Y_tpu, rtol=2e-5, atol=3e-5)


@pytest.mark.parametrize("n,m,density", [(32, 32, 0.2), (64, 64, 0.02),
                                         (32, 256, 0.6)])
def test_matches_pallas_v1_matvec(n, m, density):
    """B9 (``bsr_spmv.py::_kernel``) as ``bsr_matvec_pallas``, including
    empty block rows and rows longer than its DMA chunk, at 2e-5."""
    rng = np.random.default_rng(68)
    jmat, tmat, d = _random_case(rng, n, m, density, 8)
    x = rng.normal(size=m).astype(np.float32)
    y_tpu = np.asarray(bsr_matvec_pallas(jmat, jnp.asarray(x),
                                         chunk_blocks=2, interpret=True))
    y = (tmat @ torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(y, y_tpu, rtol=2e-5, atol=3e-5)


def test_matches_pallas_v1_matmat():
    """B9 as ``bsr_matmat_pallas``, at 3e-5."""
    rng = np.random.default_rng(69)
    jmat, tmat, d = _random_case(rng, 48, 64, 0.2, 8)
    X = rng.normal(size=(64, 16)).astype(np.float32)
    Y_tpu = np.asarray(bsr_matmat_pallas(jmat, jnp.asarray(X),
                                         interpret=True))
    Y = (tmat @ torch.from_numpy(X)).numpy()
    np.testing.assert_allclose(Y, Y_tpu, rtol=2e-5, atol=3e-5)


@pytest.mark.parametrize("nbr,bs,scale_pow", [(6, 128, 3.0), (3, 384, 0.0)])
def test_matches_bsr_df(nbr, bs, scale_pow):
    """B6 (``bsr_df.py::_kernel_df``) in interpret mode, at the scaled 1e-5
    of tests/test_bsr_df.py (interpret mode rewrites its error-free
    transforms, so only f32-level agreement holds there); the port's f64
    itself holds 1e-12 against the f64 dense product."""
    rng = np.random.default_rng(70)
    indptr, indices, data, dense = _banded(rng, nbr, bs, np.float64,
                                           scale_pow)
    n = nbr * bs
    jmat = _jax_bsr(n, n, bs, indptr, indices, data)
    tmat = tsp.BsrMatrix(n, n, bs, indptr, indices, data)
    x = rng.normal(size=n)
    y_tpu = np.asarray(bsr_matvec_df(jmat, jnp.asarray(x), interpret=True))
    y = (tmat @ torch.from_numpy(x)).numpy()
    scale = np.abs(dense).sum(axis=1) * np.abs(x).max() + 1e-300
    assert (np.abs(y - y_tpu) / scale).max() < 1e-5
    _within(y, dense @ x, np.abs(dense) @ np.abs(x), 1e-12)


# ------------------------------------------------ the weight carry


@pytest.mark.parametrize("dtype", ["float32", "float64", "bfloat16"])
def test_arrays_round_trip(dtype):
    """JAX BsrMatrix -> NumPy -> the port -> NumPy -> JAX BsrMatrix; bf16
    crosses as float32, exactly."""
    rng = np.random.default_rng(71)
    jmat, _ = _pair(_dense(rng, 24, 16, 0.3, np.float32), (4, 8))
    jmat = jmat.astype(getattr(jnp, dtype))
    tmat = bsr_from_arrays(jmat.nrows, jmat.ncols, jmat.blocksize,
                           np.asarray(jmat.indptr), np.asarray(jmat.indices),
                           np.asarray(jmat.data), device="cpu")
    assert str(tmat.dtype) == f"torch.{dtype}"
    _same_structure(jmat, tmat)
    nrows, ncols, bs, ip, ix, data = to_arrays(tmat)
    assert data.dtype == (np.float32 if dtype == "bfloat16" else dtype)
    back = jsp.BsrMatrix(nrows, ncols, bs, ip, ix,
                         jnp.asarray(data).astype(jmat.dtype))
    assert back.dtype == jmat.dtype
    for a, b in ((back.indptr, jmat.indptr), (back.indices, jmat.indices),
                 (back.data, jmat.data)):
        np.testing.assert_array_equal(np.asarray(a, np.float64),
                                      np.asarray(b, np.float64))


def test_arrays_validate():
    with pytest.raises(tsp.StructureError):
        bsr_from_arrays(8, 8, 4, [0, 1, 2], [0, 2], np.ones((2, 4, 4)))


# ------------------------------------------------ the slice as a whole


@pytest.mark.parametrize("k", [None, 4])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_slice_matches_jax(dtype, k):
    """COO (duplicates, explicit zeros) -> CSR -> ``to_bsr(8)`` -> ``@ x``
    or ``@ X`` -> backward to ``data`` and the operand, in both packages."""
    rng = np.random.default_rng(72)
    n, m, nnz = 96, 80, 900
    rows = rng.integers(0, n, size=nnz)
    cols = rng.integers(0, m, size=nnz)
    vals = rng.normal(size=nnz).astype(dtype)
    vals[rng.random(nnz) < 0.05] = 0
    rows, cols = np.concatenate([rows, rows[:50]]), np.concatenate(
        [cols, cols[:50]])
    vals = np.concatenate([vals, rng.normal(size=50).astype(dtype)])
    mats = [pkg.CsrMatrix.from_coo(pkg.CooMatrix.with_triplets(
        n, m, rows, cols, vals)).to_bsr(8) for pkg in (jsp, tsp)]
    jmat, tmat = mats
    _same_structure(jmat, tmat)
    x = rng.normal(size=m if k is None else (m, k)).astype(dtype)
    g = rng.normal(size=n if k is None else (n, k)).astype(dtype)
    y, dd, dx = _port_grads(tmat, x, g)
    jdd, jdx = _jax_grads(jmat, x, g)
    d = np.abs(tmat.to_dense().numpy()).astype(np.float64)
    tol = TOL[dtype]
    assert y.dtype == dtype
    _within(y, np.asarray(jmat @ x), d @ np.abs(x), tol)
    _within(dx, jdx, d.T @ np.abs(g), tol)
    _within(dd, jdd, _block_scale(tmat, g, x), tol)
