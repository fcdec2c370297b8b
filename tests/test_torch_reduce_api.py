"""``mat_sum``, ``mat_mean``, ``diagonal``, ``multiply`` and ``norm`` of the
port (and the matching ``CsrMatrix``/``CscMatrix`` methods) against the
JAX package on the cases of ``test_reduce_api.py``: the same values
within atol 1e-12 (diagonal, multiply) or 1e-10 (sums, means, norms), the
same CSR arrays for ``multiply``, and errors of the same classes."""

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import spalinalg_tpu as jsp
import spalinalg_tpu_torch as tsp
from spalinalg_tpu.ops import reduce_api as jred
from spalinalg_tpu_torch.ops import reduce_api as tred


@pytest.fixture(autouse=True)
def _cpu_scope():
    """The port's entry points place data on the card unless told
    otherwise; these tests run on the CPU."""
    with tsp.default_device("cpu"):
        yield


def pair(seed, n=7, m=9, density=0.3, dtype=np.float64):
    rng = np.random.default_rng(seed)
    d = np.where(rng.random((n, m)) < density, rng.normal(size=(n, m)), 0)
    A = sps.csr_matrix(d.astype(dtype))
    args = (n, m, A.indptr, A.indices, A.data)
    return jsp.CsrMatrix(*args), tsp.CsrMatrix(*args), d


def host(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def close(got, want, atol):
    got, want = host(got), host(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("axis", [None, 0, 1])
def test_sum_and_mean(axis, dtype):
    ja, ta, d = pair(1, dtype=dtype)
    atol = 1e-10 if dtype == np.float64 else 1e-5
    close(tred.mat_sum(ta, axis), jred.mat_sum(ja, axis), atol)
    close(ta.sum(axis=axis), ja.sum(axis=axis), atol)
    close(tred.mat_mean(ta, axis), jred.mat_mean(ja, axis), atol)
    close(ta.mean(axis), ja.mean(axis), atol)
    np.testing.assert_allclose(host(ta.sum(axis=axis)), d.sum(axis=axis),
                               atol=atol)


@pytest.mark.parametrize("k", [0, 1, -2, 3, -5, 8])
def test_diagonal(k):
    ja, ta, d = pair(2, 6, 9)
    close(tred.diagonal(ta, k), jred.diagonal(ja, k), 1e-12)
    close(ta.diagonal(k), np.diag(d, k), 1e-12)


@pytest.mark.parametrize("k", [9, -6, 12])
def test_diagonal_out_of_range(k):
    ja, ta, _ = pair(3, 6, 9)
    with pytest.raises(jsp.ShapeError):
        jred.diagonal(ja, k)
    with pytest.raises(tsp.ShapeError):
        tred.diagonal(ta, k)


@pytest.mark.parametrize("other", ["csr", "csc", "coo", "dok"])
def test_multiply(other):
    ja, ta, da = pair(4)
    jb, tb, db = pair(5)
    jb = {"csr": jb, "csc": jb.to_csc(), "coo": jb.to_coo(),
          "dok": jb.to_dok()}[other]
    tb = {"csr": tb, "csc": tb.to_csc(), "coo": tb.to_coo(),
          "dok": tb.to_dok()}[other]
    jh, th = jred.multiply(ja, jb), ta.multiply(tb)
    np.testing.assert_array_equal(th.rowptr.numpy(), np.asarray(jh.rowptr))
    np.testing.assert_array_equal(th.colind.numpy(), np.asarray(jh.colind))
    close(th.values, jh.values, 1e-12)
    close(th.to_dense(), da * db, 1e-12)
    assert th.nnz <= min(ta.nnz, tb.nnz)


def test_multiply_shape_mismatch():
    ja, ta, _ = pair(6)
    jc, tc, _ = pair(7, 3, 3)
    with pytest.raises(jsp.ShapeError):
        ja.multiply(jc)
    with pytest.raises(tsp.ShapeError):
        ta.multiply(tc)


@pytest.mark.parametrize("ord", ["fro", 1, np.inf])
def test_norms(ord):
    ja, ta, d = pair(8)
    close(tred.norm(ta, ord), jred.norm(ja, ord), 1e-10)
    close(ta.norm(ord), ja.norm(ord), 1e-10)
    want = {"fro": np.linalg.norm(d, "fro"),
            1: np.abs(d).sum(axis=0).max(),
            np.inf: np.abs(d).sum(axis=1).max()}[ord]
    assert float(ta.norm(ord)) == pytest.approx(want, abs=1e-10)


def test_errors():
    ja, ta, _ = pair(9)
    for red, a, pkg in ((jred, ja, jsp), (tred, ta, tsp)):
        with pytest.raises(ValueError):
            red.norm(a, 2)
        with pytest.raises(pkg.ShapeError):
            red.mat_sum(a, axis=2)
        with pytest.raises(pkg.ShapeError):
            red.mat_sum(object())


@pytest.mark.parametrize("fmt", ["csc", "coo", "dok", "bsr"])
def test_works_on_all_formats(fmt):
    ja, ta, d = pair(10, 8, 8)
    conv = {"csc": lambda m: m.to_csc(), "coo": lambda m: m.to_coo(),
            "dok": lambda m: m.to_dok(), "bsr": lambda m: m.to_bsr(2)}[fmt]
    jm, tm = conv(ja), conv(ta)
    close(tred.mat_sum(tm), jred.mat_sum(jm), 1e-10)
    close(tred.mat_sum(tm, 1), jred.mat_sum(jm, 1), 1e-10)
    close(tred.diagonal(tm, 1), jred.diagonal(jm, 1), 1e-12)
    close(tred.norm(tm, 1), jred.norm(jm, 1), 1e-10)
