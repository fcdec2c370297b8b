"""``row_slice``, ``select_rows``, ``select_cols``, ``submatrix``,
``getrow`` and ``getcol`` of the port against the JAX package on the cases
of ``test_indexing.py``: the same CSR arrays (values within atol 1e-12)
and errors of the same classes (``IndexError_``, ``ShapeError``)."""

import numpy as np
import pytest
import scipy.sparse as sps

import spalinalg_tpu as jsp
import spalinalg_tpu_torch as tsp
from spalinalg_tpu.ops import indexing as jix
from spalinalg_tpu_torch.ops import indexing as tix


@pytest.fixture(autouse=True)
def _cpu_scope():
    """The port's entry points place data on the card unless told
    otherwise; these tests run on the CPU."""
    with tsp.default_device("cpu"):
        yield


def pair(seed=0, n=8, m=10, density=0.3):
    rng = np.random.default_rng(seed)
    d = np.where(rng.random((n, m)) < density, rng.normal(size=(n, m)), 0)
    A = sps.csr_matrix(d)
    args = (n, m, A.indptr, A.indices, A.data)
    return jsp.CsrMatrix(*args), tsp.CsrMatrix(*args), d


def same(t, j, dense):
    assert t.shape == j.shape
    nnz = int(np.asarray(j.rowptr)[-1])
    np.testing.assert_array_equal(t.rowptr.numpy(), np.asarray(j.rowptr))
    np.testing.assert_array_equal(t.colind.numpy()[:nnz],
                                  np.asarray(j.colind)[:nnz])
    np.testing.assert_allclose(t.values.numpy()[:nnz],
                               np.asarray(j.values)[:nnz], rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(t.to_dense().numpy(), dense, atol=1e-12)


CASES = {
    "row_slice": (lambda ix, a: ix.row_slice(a, 2, 6), lambda d: d[2:6]),
    "row_slice_empty": (lambda ix, a: ix.row_slice(a, 3, 3),
                        lambda d: d[3:3]),
    "select_rows": (lambda ix, a: ix.select_rows(a, [5, 0, 5, 2]),
                    lambda d: d[[5, 0, 5, 2]]),
    "select_rows_none": (lambda ix, a: ix.select_rows(a, []),
                         lambda d: d[[]]),
    "select_cols": (lambda ix, a: ix.select_cols(a, [9, 1, 1, 4]),
                    lambda d: d[:, [9, 1, 1, 4]]),
    "submatrix": (lambda ix, a: ix.submatrix(a, [1, 3, 7], [0, 2, 9, 4]),
                  lambda d: d[np.ix_([1, 3, 7], [0, 2, 9, 4])]),
    "getrow": (lambda ix, a: ix.getrow(a, 3), lambda d: d[3:4]),
    "getcol": (lambda ix, a: ix.getcol(a, 7), lambda d: d[:, 7:8]),
}


@pytest.mark.parametrize("case", list(CASES))
def test_matches_jax(case):
    ja, ta, d = pair(1)
    fn, ref = CASES[case]
    same(fn(tix, ta), fn(jix, ja), ref(d))


@pytest.mark.parametrize("fmt", ["csc", "bsr"])
def test_other_formats(fmt):
    ja, ta, d = pair(2, 8, 8)
    conv = (lambda m: m.to_csc()) if fmt == "csc" else (lambda m: m.to_bsr(2))
    same(tix.row_slice(conv(ta), 1, 5), jix.row_slice(conv(ja), 1, 5),
         d[1:5])


ERRORS = {
    "row_slice_past_end": (lambda ix, a: ix.row_slice(a, 0, 99), "index"),
    "row_slice_reversed": (lambda ix, a: ix.row_slice(a, 5, 2), "index"),
    "select_rows_out_of_range": (lambda ix, a: ix.select_rows(a, [99]),
                                 "index"),
    "select_rows_negative": (lambda ix, a: ix.select_rows(a, [-1]), "index"),
    "select_rows_2d": (lambda ix, a: ix.select_rows(a, [[0, 1]]), "shape"),
    "getcol_out_of_range": (lambda ix, a: ix.getcol(a, 10), "index"),
    "not_a_matrix": (lambda ix, a: ix.row_slice(object(), 0, 1), "shape"),
}


@pytest.mark.parametrize("case", list(ERRORS))
def test_errors_match_jax(case):
    ja, ta, _ = pair(3)
    fn, kind = ERRORS[case]
    for pkg, ix, a in ((jsp, jix, ja), (tsp, tix, ta)):
        err = pkg.IndexError_ if kind == "index" else pkg.ShapeError
        with pytest.raises(err):
            fn(ix, a)


def test_top_level_names():
    for name in ("mat_sum", "mat_mean", "diagonal", "multiply", "norm",
                 "row_slice", "select_rows", "select_cols", "submatrix",
                 "getrow", "getcol"):
        assert name in tsp.__all__ and callable(getattr(tsp, name))
        assert hasattr(jsp, name)
