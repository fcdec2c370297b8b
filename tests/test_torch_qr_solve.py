"""The port's direct-solve front door (``linalg/solve.py``) and sparse QR
(``linalg/qr.py``) against the JAX package on the same NumPy inputs.

- ``is_symmetric`` equal to the JAX answer; ``spsolve`` / ``factorized``
  within rtol 1e-9 (float64) for symmetric positive definite, symmetric
  indefinite (the LU fallback after the probe solve) and unsymmetric
  matrices, each ``assume_a``, and a ``factorized`` closure reused.
- ``lstsq`` and ``qr_solve`` (``refine`` 0 and 1, one and several
  right-hand sides, sparse and dense ``method``) within rtol 1e-9;
  ``qr_r_dense`` equal to the JAX one up to row signs (atol 1e-9 of its
  largest entry); ``qr_qt_apply(qr_q_apply(y)) == y`` within 1e-9;
  ``m < n`` raising ``ShapeError``.
"""

import numpy as np
import pytest
import scipy.sparse as sps

import spalinalg_tpu as jsp
import spalinalg_tpu.linalg as jla
import spalinalg_tpu_torch as tsp
import spalinalg_tpu_torch.linalg as tla
from spalinalg_tpu.errors import ShapeError as JShapeError
from spalinalg_tpu_torch.errors import ShapeError
from spalinalg_tpu_torch.utils import metrics


@pytest.fixture(autouse=True)
def _cpu_scope():
    """The port's entry points place data on the card unless told
    otherwise; these tests run on the CPU."""
    with tsp.default_device("cpu"):
        yield


@pytest.fixture(autouse=True)
def _plan_cache(tmp_path, monkeypatch):
    """The on-disk Cholesky plans these tests build go to the test's own
    directory, not the user's cache."""
    monkeypatch.setenv("SPALINALG_PLAN_CACHE", str(tmp_path / "plans"))


def both(A, dtype=np.float64):
    A = A.tocsr().astype(dtype)
    A.sort_indices()
    args = (A.shape[0], A.shape[1], A.indptr, A.indices, A.data)
    return jsp.CsrMatrix(*args), tsp.CsrMatrix(*args)


def lap2d(k):
    T = sps.diags([-1.0, 4.0, -1.0], [-1, 0, 1], shape=(k, k))
    D = sps.diags([-1.0, -1.0], [-1, 1], shape=(k, k))
    return (sps.kron(sps.eye(k), T) + sps.kron(D, sps.eye(k))).tocsr()


def convdiff2d(k, c=0.4):
    T = sps.diags([-1.0 - c, 4.0, -1.0 + c], [-1, 0, 1], shape=(k, k))
    D = sps.diags([-1.0 - c, -1.0 + c], [-1, 1], shape=(k, k))
    return (sps.kron(sps.eye(k), T) + sps.kron(D, sps.eye(k))).tocsr()


def gradient_operator(k, reg=0.1):
    """``[Dx; Dy; reg·I]`` of a k x k grid: least-squares reconstruction
    from gradients (forward differences)."""
    d = sps.diags([-1.0, 1.0], [0, 1], shape=(k - 1, k))
    eye = sps.eye(k)
    return sps.vstack([sps.kron(eye, d), sps.kron(d, eye),
                       reg * sps.eye(k * k)]).tocsr()


SQUARE = {
    "spd": lambda: lap2d(8),
    "sym_indefinite": lambda: (lap2d(8) - 3.0 * sps.eye(64)).tocsr(),
    "unsym": lambda: convdiff2d(8),
}


def rhs(n, seed=3, k=None):
    rng = np.random.default_rng(seed)
    return rng.normal(size=n if k is None else (n, k))


def close(got, want, tol=1e-9):
    got = got.numpy() if hasattr(got, "numpy") else got
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * np.abs(want).max())


@pytest.mark.parametrize("name", sorted(SQUARE))
def test_is_symmetric_matches_jax(name):
    jA, tA = both(SQUARE[name]())
    assert tla.is_symmetric(tA) == jla.is_symmetric(jA) == (name != "unsym")


def test_is_symmetric_tolerance_and_shape():
    A = lap2d(4).tolil()
    A[0, 1] = -1.0 + 1e-9
    jA, tA = both(A)
    for tol in (0.0, 1e-8):
        assert tla.is_symmetric(tA, tol=tol) == jla.is_symmetric(jA, tol=tol)
    assert tla.is_symmetric(tA, tol=1e-8) and not tla.is_symmetric(tA)
    _, rect = both(sps.random(3, 4, 0.5, random_state=1))
    assert not tla.is_symmetric(rect)


@pytest.mark.parametrize("name,assume_a", [
    ("spd", "auto"), ("spd", "pos"), ("spd", "gen"),
    ("sym_indefinite", "auto"), ("sym_indefinite", "gen"),
    ("unsym", "auto"), ("unsym", "gen")])
def test_spsolve_matches_jax(name, assume_a):
    jA, tA = both(SQUARE[name]())
    b = rhs(64)
    close(tla.spsolve(tA, b, assume_a=assume_a),
          jla.spsolve(jA, b, assume_a=assume_a))


def test_auto_probe_falls_back_to_lu():
    """A symmetric indefinite matrix: Cholesky's probe solve is not
    finite, so ``auto`` factors by LU."""
    _, tA = both(SQUARE["sym_indefinite"]())
    fac = tla.cholesky(tA)
    x = tla.cholesky_solve(fac, np.ones(64))
    assert not bool(np.isfinite(x.numpy()).all())
    A = SQUARE["sym_indefinite"]()
    b = rhs(64)
    close(tla.spsolve(tA, b), sps.linalg.spsolve(A.tocsc(), b))


@pytest.mark.parametrize("name", sorted(SQUARE))
def test_factorized_closure_reused(name):
    jA, tA = both(SQUARE[name]())
    jsolve = jla.factorized(jA)
    tsolve = tla.factorized(tA)
    for seed in (1, 2, 3):
        b = rhs(64, seed)
        close(tsolve(b), jsolve(b))


def test_spsolve_errors():
    jA, tA = both(sps.random(4, 5, 0.5, random_state=0))
    with pytest.raises(JShapeError):
        jla.spsolve(jA, np.ones(4))
    with pytest.raises(ShapeError):
        tla.spsolve(tA, np.ones(4))
    _, tB = both(lap2d(3))
    with pytest.raises(ValueError, match="assume_a"):
        tla.factorized(tB, assume_a="sym")


QR_K = 34     # n = 1156 > dense_threshold: the sparse path under auto


@pytest.fixture(scope="module")
def grad_pair():
    with tsp.default_device("cpu"):
        jA, tA = both(gradient_operator(QR_K))
        return jA, tA, jla.qr(jA), tla.qr(tA)


@pytest.mark.parametrize("k", [None, 3])
@pytest.mark.parametrize("refine", [0, 1])
def test_qr_solve_sparse_matches_jax(grad_pair, refine, k):
    jA, tA, jfac, tfac = grad_pair
    assert tfac.chol is not None and not tfac.is_dense
    b = rhs(tA.shape[0], k=k)
    close(tla.qr_solve(tfac, b, refine=refine),
          jla.qr_solve(jfac, b, refine=refine))


def test_lstsq_matches_jax_and_numpy():
    A = gradient_operator(10)
    jA, tA = both(A)
    b = rhs(A.shape[0])
    x = tla.lstsq(tA, b)
    close(x, jla.lstsq(jA, b))
    close(x, np.linalg.lstsq(A.toarray(), b, rcond=None)[0])


def test_lstsq_spgemm_gram(grad_pair):
    """The sparse path's Gram is ``Aᵀ * A`` through the SpGEMM tier, and
    a one-step refined solve is three SpMVs."""
    _, tA, _, tfac = grad_pair
    close(tfac.gram.to_dense(), (tA.to_dense().T @ tA.to_dense()).numpy())
    rec = metrics.enable()
    try:
        rec.records.clear()
        tla.qr_solve(tfac, rhs(tA.shape[0]), refine=1)
        assert [r.path for r in rec.records] == ["csr_spmv:plain"] * 3
    finally:
        metrics.disable()
        rec.records.clear()


@pytest.mark.parametrize("method", ["sparse", "dense"])
def test_qr_r_dense_up_to_row_signs(method):
    jA, tA = both(gradient_operator(8))
    jr = np.asarray(jla.qr_r_dense(jla.qr(jA, method=method)))
    tr = tla.qr_r_dense(tla.qr(tA, method=method)).numpy()
    signs = np.sign(np.diag(tr)) * np.sign(np.diag(jr))
    np.testing.assert_allclose(tr * signs[:, None], jr, rtol=1e-9,
                               atol=1e-9 * np.abs(jr).max())
    np.testing.assert_allclose(np.triu(tr), tr)


@pytest.mark.parametrize("k", [None, 2])
@pytest.mark.parametrize("method", ["sparse", "dense"])
def test_q_apply_round_trip(method, k):
    jA, tA = both(gradient_operator(8))
    jfac, tfac = jla.qr(jA, method=method), tla.qr(tA, method=method)
    y = rhs(64, 7, k)
    qy = tla.qr_q_apply(tfac, y)
    assert tuple(qy.shape) == ((tA.shape[0],) if k is None
                               else (tA.shape[0], k))
    close(tla.qr_qt_apply(tfac, qy), y)
    b = rhs(tA.shape[0], 8, k)
    qtb = tla.qr_qt_apply(tfac, b)
    # Qᵀb is defined up to the signs of R's rows: compare through R⁻¹
    close(tla.qr_solve(tfac, b, refine=0),
          np.linalg.solve(tla.qr_r_dense(tfac).numpy(), qtb.numpy()))
    close(np.abs(qtb.numpy()), np.abs(np.asarray(jla.qr_qt_apply(jfac, b))))


@pytest.mark.parametrize("refine", [0, 1])
def test_qr_dense_method_matches_jax(refine):
    A = gradient_operator(6)
    jA, tA = both(A)
    jfac, tfac = jla.qr(jA), tla.qr(tA)          # n = 36: dense under auto
    assert tfac.is_dense and jfac.is_dense
    b = rhs(A.shape[0])
    close(tla.qr_solve(tfac, b, refine=refine),
          jla.qr_solve(jfac, b, refine=refine))


def test_qr_float32_sparse():
    A = gradient_operator(12)
    jA, tA = both(A, np.float32)
    b = rhs(A.shape[0]).astype(np.float32)
    close(tla.qr_solve(tla.qr(tA, method="sparse"), b),
          jla.qr_solve(jla.qr(jA, method="sparse"), b), tol=1e-4)


def test_qr_errors_match_jax():
    wide = sps.random(4, 6, 0.5, random_state=2)
    jA, tA = both(wide)
    with pytest.raises(JShapeError):
        jla.qr(jA)
    with pytest.raises(ShapeError, match="m >= n"):
        tla.qr(tA)
    _, tB = both(gradient_operator(3))
    with pytest.raises(ValueError, match="unknown qr method"):
        tla.qr(tB, method="householder")
