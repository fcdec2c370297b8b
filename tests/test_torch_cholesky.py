"""The port's Cholesky tier (BASELINE config[3]) against the JAX package
on the same NumPy inputs: the symbolic phase (``etree``, ``postorder``,
``amd_ordering``, ``chol_symbolic``) and the supernodal plan's index
arrays equal exactly; the factor's ordering (``perm``) equal; the
supernodal and banded panels in float64 within rtol 1e-10;
``cholesky_solve`` within rtol 1e-9 (float64) or 1e-5 (float32) for each
``method`` and with ``reorder`` on and off; the band LU; the error cases
and the not-positive-definite behaviour (NaNs, no exception).
"""

import importlib

import numpy as np
import pytest
import scipy.sparse as sps

import spalinalg_tpu as jsp
import spalinalg_tpu.linalg as jla
import spalinalg_tpu_torch as tsp
import spalinalg_tpu_torch.linalg as tla
from spalinalg_tpu.linalg import supernodal as jsn
from spalinalg_tpu.linalg import symbolic as jsym
from spalinalg_tpu_torch.linalg import supernodal as tsn
from spalinalg_tpu_torch.linalg import symbolic as tsym
from spalinalg_tpu_torch.linalg.cholesky import _supernodal_symbolic


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


def lap2d(k):
    T = sps.diags([-1.0, 4.0, -1.0], [-1, 0, 1], shape=(k, k))
    D = sps.diags([-1.0, -1.0], [-1, 1], shape=(k, k))
    return (sps.kron(sps.eye(k), T) + sps.kron(D, sps.eye(k))).tocsr()


def lap3d(k):
    T = sps.diags([-1.0, 6.0, -1.0], [-1, 0, 1], shape=(k, k))
    D = sps.diags([-1.0, -1.0], [-1, 1], shape=(k, k))
    eye = sps.eye(k)
    return (sps.kron(sps.kron(eye, eye), T) + sps.kron(sps.kron(eye, D), eye)
            + sps.kron(sps.kron(D, eye), eye)).tocsr()


def random_spd(n, density, seed):
    B = sps.random(n, n, density, random_state=seed)
    return (B @ B.T + n * density * 4 * sps.eye(n)).tocsr()


def scrambled(A, seed=0):
    p = np.random.default_rng(seed).permutation(A.shape[0])
    return A[p][:, p].tocsr()


MATRICES = {
    "lap2d_12": lambda: lap2d(12),
    "lap2d_20": lambda: lap2d(20),
    "lap3d_6": lambda: lap3d(6),
    "random_spd_300": lambda: random_spd(300, 0.02, 1),
    "scrambled_lap2d_15": lambda: scrambled(lap2d(15)),
}


def both(A, dtype=np.float64):
    A = A.tocsr()
    A.sort_indices()
    args = (A.shape[0], A.shape[1], A.indptr, A.indices,
            A.data.astype(dtype))
    return jsp.CsrMatrix(*args), tsp.CsrMatrix(*args)


def structure(A):
    A = A.tocsr()
    A.sort_indices()
    return A.indptr.astype(np.int64), A.indices.astype(np.int64), A.shape[0]


@pytest.mark.parametrize("name", list(MATRICES))
def test_symbolic_phase_matches_jax(name):
    A = MATRICES[name]()
    ptr, ind, n = structure(A)
    jparent, tparent = jsym.etree(ptr, ind, n), tsym.etree(ptr, ind, n)
    np.testing.assert_array_equal(tparent, jparent)
    np.testing.assert_array_equal(tsym.postorder(tparent),
                                  jsym.postorder(jparent))
    jA, tA = both(A)
    np.testing.assert_array_equal(tsym.amd_ordering(tA),
                                  jsym.amd_ordering(jA))
    js, ts = jsym.chol_symbolic(ptr, ind, n), tsym.chol_symbolic(ptr, ind, n)
    for field in ("snode_ptr", "rows_ptr", "rows_idx", "sn_parent"):
        np.testing.assert_array_equal(getattr(ts, field), getattr(js, field))
    assert len(ts.levels) == len(js.levels)
    for a, b in zip(ts.levels, js.levels):
        np.testing.assert_array_equal(a, b)
    assert ts.l_nnz == js.l_nnz


def _jax_plan(jA):
    jchol = importlib.import_module("spalinalg_tpu.linalg.cholesky")
    perm, plan = jchol._supernodal_symbolic_cached(jA, True)
    return perm, plan


@pytest.mark.parametrize("name", ["lap2d_20", "lap3d_6", "random_spd_300"])
def test_supernodal_plan_matches_jax(name):
    jA, tA = both(MATRICES[name]())
    jperm, jplan = _jax_plan(jA)
    tsymb = _supernodal_symbolic(tA, True)
    np.testing.assert_array_equal(tsymb.perm, jperm)
    tplan = tsymb.plan
    assert tplan.n == jplan.n and tplan.l_nnz == jplan.l_nnz
    assert len(tplan.levels) == len(jplan.levels)
    for tb_level, jb_level in zip(tplan.levels, jplan.levels):
        assert len(tb_level) == len(jb_level)
        for tb, jb in zip(tb_level, jb_level):
            assert (tb.nsp, tb.mup) == (jb.nsp, jb.mup)
            for field in ("sids", "a_dst", "a_src", "pad_diag", "colg",
                          "rowg"):
                np.testing.assert_array_equal(getattr(tb, field),
                                              getattr(jb, field))
            assert [k for k, _, _ in tb.ext] == [k for k, _, _ in jb.ext]
            for (_, ts, td), (_, js, jd) in zip(tb.ext, jb.ext):
                np.testing.assert_array_equal(ts, js)
                np.testing.assert_array_equal(td, jd)


@pytest.mark.parametrize("name", ["lap2d_20", "lap3d_6", "random_spd_300"])
def test_supernodal_panels_match_jax(name):
    jA, tA = both(MATRICES[name]())
    jfac = jla.cholesky(jA, method="supernodal")
    tfac = tla.cholesky(tA, method="supernodal")
    np.testing.assert_array_equal(tfac.perm, jfac.perm)
    assert tfac.path == "supernodal" and tfac.snf.ok
    assert set(tfac.snf.panels) == set(jfac.snf.panels)
    for key, jp in jfac.snf.panels.items():
        np.testing.assert_allclose(tfac.snf.panels[key].numpy(),
                                   np.asarray(jp), rtol=1e-10,
                                   atol=1e-10 * np.abs(np.asarray(jp)).max())


def test_band_panels_match_jax():
    jA, tA = both(scrambled(lap2d(14)))
    jfac, tfac = jla.cholesky(jA), tla.cholesky(tA)
    assert tfac.path == "banded" and jfac.band is not None
    np.testing.assert_array_equal(tfac.perm, jfac.perm)
    assert (tfac.band.nb, tfac.band.b, tfac.band.n_pad) == (
        jfac.band.nb, jfac.band.b, jfac.band.n_pad)
    jp = np.asarray(jfac.band.panels)
    np.testing.assert_allclose(tfac.band.panels.numpy(), jp, rtol=1e-10,
                               atol=1e-10 * np.abs(jp).max())


CASES = [(name, method, reorder)
         for name in ("lap2d_12", "lap3d_6", "random_spd_300",
                      "scrambled_lap2d_15")
         for method in ("auto", "banded", "supernodal", "dense")
         for reorder in (True, False)]


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("name,method,reorder", CASES)
def test_cholesky_solve_matches_jax(name, method, reorder, dtype):
    A = MATRICES[name]()
    jA, tA = both(A, dtype)
    b = np.random.default_rng(2).normal(size=A.shape[0]).astype(dtype)
    jfac = jla.cholesky(jA, method=method, reorder=reorder)
    tfac = tla.cholesky(tA, method=method, reorder=reorder)
    jpath = ("supernodal" if jfac.snf is not None else
             "dense" if jfac.is_dense else "banded")
    assert tfac.path == jpath
    if jfac.perm is None:
        assert tfac.perm is None
    else:
        np.testing.assert_array_equal(tfac.perm, jfac.perm)
    jx = np.asarray(jla.cholesky_solve(jfac, b))
    tx = tla.cholesky_solve(tfac, b).numpy()
    assert tx.dtype == jx.dtype == dtype
    rtol = 1e-9 if dtype == np.float64 else 1e-5
    np.testing.assert_allclose(tx, jx, rtol=rtol, atol=rtol * np.abs(jx).max())
    xref = np.linalg.solve(A.toarray(), b.astype(np.float64))
    np.testing.assert_allclose(tx, xref, rtol=0,
                               atol=(1e-9 if dtype == np.float64 else 1e-3)
                               * np.abs(xref).max())


def test_auto_picks_supernodal_on_a_wide_band():
    """A band wider than ``band_threshold·n`` after RCM: both packages
    take the supernodal path."""
    jA, tA = both(random_spd(300, 0.02, 1))
    assert jla.cholesky(jA).snf is not None
    assert tla.cholesky(tA).path == "supernodal"


def test_refactor_reuses_the_symbolic_phase():
    """A second matrix of the same structure tensors and new values reuses
    the cached ordering and plan, and factors its own values."""
    A = lap2d(10)
    _, tA = both(A)
    fac1 = tla.cholesky(tA, method="supernodal")
    tB = tA.with_values(tA.values * 2.0)
    fac2 = tla.cholesky(tB, method="supernodal")
    assert fac2.snf.plan is fac1.snf.plan
    b = np.ones(A.shape[0])
    np.testing.assert_allclose(tla.cholesky_solve(fac2, b).numpy(),
                               np.linalg.solve(2 * A.toarray(), b),
                               rtol=1e-10)


@pytest.mark.parametrize("method", ["auto", "banded", "supernodal", "dense"])
def test_not_positive_definite_gives_nans(method):
    """No exception: NaNs in the factor and the solution, in both
    packages."""
    A = lap2d(6) - 5.0 * sps.eye(36)
    jA, tA = both(A)
    b = np.ones(36)
    jx = np.asarray(jla.cholesky_solve(jla.cholesky(jA, method=method), b))
    tfac = tla.cholesky(tA, method=method)
    tx = tla.cholesky_solve(tfac, b).numpy()
    assert np.isnan(jx).any() and np.isnan(tx).any()
    if method == "supernodal":
        assert not tfac.snf.ok


def test_errors_match_jax():
    rect = (2, 3, [0, 1, 2], [0, 1], [1.0, 1.0])
    for pkg, la in ((jsp, jla), (tsp, tla)):
        with pytest.raises(pkg.ShapeError):
            la.cholesky(pkg.CsrMatrix(*rect))
        with pytest.raises(ValueError, match="unknown cholesky method"):
            la.cholesky(pkg.CsrMatrix.eye(3), method="qr")
        with pytest.raises(pkg.ShapeError):
            la.permute_csr(pkg.CsrMatrix.eye(3), np.arange(2))


def test_permute_csr_matches_jax():
    jA, tA = both(random_spd(50, 0.1, 4))
    p = np.random.default_rng(5).permutation(50)
    jp, tp = jla.permute_csr(jA, p), tla.permute_csr(tA, p)
    np.testing.assert_array_equal(tp.rowptr.numpy(), np.asarray(jp.rowptr))
    np.testing.assert_array_equal(tp.colind.numpy(), np.asarray(jp.colind))
    np.testing.assert_array_equal(tp.values.numpy(), np.asarray(jp.values))


@pytest.mark.parametrize("panel", [4, 16, 64])
def test_band_lu_matches_jax(panel):
    k = 9
    T = sps.diags([-1.3, 4.5, -0.7], [-1, 0, 1], shape=(k, k))
    D = sps.diags([-1.2, -0.8], [-1, 1], shape=(k, k))
    A = (sps.kron(sps.eye(k), T) + sps.kron(D, sps.eye(k))).tocsr()
    jA, tA = both(A)
    jfac = jla.band_lu_factor(jA, bandwidth=k, panel=panel)
    tfac = tla.band_lu_factor(tA, bandwidth=k, panel=panel)
    np.testing.assert_allclose(tfac.panels.numpy(), np.asarray(jfac.panels),
                               rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(tfac.u12.numpy(), np.asarray(jfac.u12),
                               rtol=1e-10, atol=1e-12)
    b = np.random.default_rng(1).normal(size=k * k)
    np.testing.assert_allclose(tla.band_lu_solve(tfac, b).numpy(),
                               np.asarray(jla.band_lu_solve(jfac, b)),
                               rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(tla.band_lu_solve(tfac, b).numpy(),
                               np.linalg.solve(A.toarray(), b), atol=1e-10)


@pytest.mark.parametrize("panel", [3, 8, 64])
def test_band_cholesky_direct_matches_jax(panel):
    A = lap2d(7)
    jA, tA = both(A)
    jfac = jla.band_cholesky_factor(jA, bandwidth=7, panel=panel)
    tfac = tla.band_cholesky_factor(tA, bandwidth=7, panel=panel)
    np.testing.assert_allclose(tfac.panels.numpy(), np.asarray(jfac.panels),
                               rtol=1e-10, atol=1e-12)
    b = np.random.default_rng(3).normal(size=49)
    np.testing.assert_allclose(tla.band_cholesky_solve(tfac, b).numpy(),
                               np.asarray(jla.band_cholesky_solve(jfac, b)),
                               rtol=1e-9, atol=1e-12)
