"""The port's eigensolvers (``linalg/eigen.py``) and Krylov matrix
functions (``linalg/funm.py``) against the JAX package on the same NumPy
inputs.

- ``lanczos`` and ``arnoldi`` with the same ``v0`` on both sides:
  ``alpha``, ``beta``, ``V`` and ``H`` within 1e-10; ``expm_multiply``
  within 1e-10.
- ``eigsh`` (LA, SA, ``block=2`` on a degenerate cluster, ``sigma=0``
  shift-invert), ``lobpcg`` (random start, ``X0`` given, IC(0) and
  Chebyshev ``M``) and ``svds``: eigenvalues and singular values against
  the JAX package's and the exact ones within the JAX tests' tolerances
  (``tests/test_eigen.py``: 1e-7, 1e-6, 1e-5). The port draws its start
  vectors from a torch generator, not from ``jax.random``, so Ritz
  vectors are compared as subspaces (what is left of each after its
  projection onto the exact eigenvectors), never entrywise.
- The validation errors.
"""

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import spalinalg_tpu as jsp
import spalinalg_tpu.linalg as jla
import spalinalg_tpu_torch as tsp
import spalinalg_tpu_torch.linalg as tla
from spalinalg_tpu_torch.errors import ShapeError


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
    A = sps.csr_matrix(A).astype(dtype)
    A.sort_indices()
    args = (A.shape[0], A.shape[1], A.indptr, A.indices, A.data)
    return jsp.CsrMatrix(*args), tsp.CsrMatrix(*args)


def random_symmetric(n, seed, density=0.1, shift=0.0):
    """``tests/test_eigen.py``'s ``_sym``, from its own generator."""
    rng = np.random.default_rng(seed)
    d = np.where(rng.random((n, n)) < density, rng.normal(size=(n, n)), 0)
    return (d + d.T) / 2 + shift * np.eye(n)


def grid_laplacian(g):
    T = sps.diags([-1.0, 4.0, -1.0], [-1, 0, 1], shape=(g, g))
    D = sps.diags([-1.0, -1.0], [-1, 1], shape=(g, g))
    return (sps.kron(sps.eye(g), T) + sps.kron(D, sps.eye(g))).tocsr()


def grid_eigenvalues(g, count):
    lam = [4 - 2 * np.cos(p * np.pi / (g + 1)) - 2 * np.cos(q * np.pi / (g + 1))
           for p in range(1, 6) for q in range(1, 6)]
    return np.sort(lam)[:count]


def in_subspace(v, d, idx, tol):
    """Each column of ``v`` lies in the span of the exact eigenvectors
    ``idx`` of the dense symmetric ``d``, within ``tol``."""
    _, vecs = np.linalg.eigh(d)
    basis = vecs[:, idx]
    v = v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
    resid = v - basis @ (basis.T @ v)
    assert np.linalg.norm(resid, axis=0).max() <= tol


V0 = np.random.default_rng(21).normal(size=96)


def test_lanczos_same_v0_matches_jax():
    d = random_symmetric(96, 1)
    jA, tA = both(d)
    ja, jb, jV = jla.lanczos(jA, 30, v0=V0)
    ta, tb, tV = tla.lanczos(tA, 30, v0=V0)
    for got, want in ((ta, ja), (tb, jb), (tV, jV)):
        assert tuple(got.shape) == tuple(want.shape)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-10)
    np.testing.assert_allclose(tV.numpy() @ tV.numpy().T, np.eye(30),
                               atol=1e-10)


def test_arnoldi_same_v0_matches_jax():
    A = sps.random(96, 96, 0.08, random_state=4) + sps.eye(96)
    jA, tA = both(A)
    jV, jH = jla.arnoldi(jA, V0, 24)
    tV, tH = tla.arnoldi(tA, V0, 24)
    np.testing.assert_allclose(tV.numpy(), np.asarray(jV), atol=1e-10)
    np.testing.assert_allclose(tH.numpy(), np.asarray(jH), atol=1e-10)


def test_arnoldi_breakdown_guard():
    """An exact breakdown (``v0`` an eigenvector): every basis vector
    after the first is zero, with no NaN (the 1e-300 guards), as in the
    JAX package."""
    jA, tA = both(sps.diags([1.0, 2.0, 3.0, 4.0], 0))
    v0 = np.array([0.0, 3.0, 0.0, 0.0])
    V, H = tla.arnoldi(tA, v0, 3)
    jV, jH = jla.arnoldi(jA, v0, 3)
    assert torch.isfinite(V).all() and torch.isfinite(H).all()
    assert float(V[1:].abs().max()) == 0.0
    np.testing.assert_array_equal(V.numpy(), np.asarray(jV))
    np.testing.assert_array_equal(H.numpy(), np.asarray(jH))


@pytest.mark.parametrize("t", [0.25, 1.0])
def test_expm_multiply_matches_jax(t):
    from scipy.sparse.linalg import expm_multiply as sp_expm

    L = -grid_laplacian(10)
    jA, tA = both(L)
    b = np.random.default_rng(5).normal(size=100)
    got = tla.expm_multiply(tA, b, t=t).numpy()
    np.testing.assert_allclose(got, np.asarray(jla.expm_multiply(jA, b, t=t)),
                               atol=1e-10)
    np.testing.assert_allclose(got, sp_expm(t * L.tocsc(), b), atol=1e-10)


def test_expm_multiply_ring_conserves_mass():
    n = 16
    ring = (sps.diags([-2.0], [0], shape=(n, n))
            + sps.diags([1.0, 1.0], [1, -1], shape=(n, n))
            + sps.diags([1.0, 1.0], [n - 1, -(n - 1)], shape=(n, n)))
    _, tA = both(ring)
    b = np.zeros(n)
    b[n // 2] = 1.0
    u = tla.expm_multiply(tA, b, t=0.5, m=12)
    assert abs(float(u.sum()) - 1.0) < 1e-8 and float(u[n // 2]) < 1.0


@pytest.mark.parametrize("which", ["LA", "SA"])
def test_eigsh_extremal_matches_jax(which):
    d = random_symmetric(96, 2)
    jA, tA = both(d)
    ew = np.linalg.eigvalsh(d)
    ref = ew[-4:] if which == "LA" else ew[:4]
    w, v = tla.eigsh(tA, k=4, which=which, m=60)
    jw, _ = jla.eigsh(jA, k=4, which=which, m=60)
    np.testing.assert_allclose(w.numpy(), ref, atol=1e-7)
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), atol=1e-7)
    for j in range(4):
        vv = v[:, j].numpy()
        assert np.linalg.norm(d @ vv - float(w[j]) * vv) < 1e-6
    idx = np.arange(92, 96) if which == "LA" else np.arange(4)
    in_subspace(v, d, idx, 1e-6)


def test_eigsh_given_v0_matches_jax_exactly():
    d = random_symmetric(96, 2)
    jA, tA = both(d)
    w, v = tla.eigsh(tA, k=3, which="LA", m=40, v0=V0)
    jw, jv = jla.eigsh(jA, k=3, which="LA", m=40, v0=V0)
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), atol=1e-10)
    np.testing.assert_allclose(np.abs(v.numpy()), np.abs(np.asarray(jv)),
                               atol=1e-8)


def test_eigsh_seed_is_repeatable():
    _, tA = both(random_symmetric(64, 3))
    w1, v1 = tla.eigsh(tA, k=2, seed=7)
    w2, v2 = tla.eigsh(tA, k=2, seed=7)
    assert torch.equal(w1, w2) and torch.equal(v1, v2)


def test_eigsh_block_resolves_degenerate_cluster():
    g = 12
    A = grid_laplacian(g)
    jA, tA = both(A)
    ref = grid_eigenvalues(g, 4)                  # includes a pair
    w, v = tla.eigsh(tA, k=4, which="SA", block=2, m=40)
    jw, _ = jla.eigsh(jA, k=4, which="SA", block=2, m=40)
    np.testing.assert_allclose(w.numpy(), ref, atol=1e-7)
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), atol=1e-7)
    np.testing.assert_allclose(v.numpy().T @ v.numpy(), np.eye(4),
                               atol=1e-7)
    in_subspace(v, A.toarray(), np.arange(4), 1e-5)


def test_eigsh_block_matches_single_on_simple_spectrum():
    d = random_symmetric(80, 4)
    _, tA = both(d)
    ref = np.linalg.eigvalsh(d)[-3:]
    w1, _ = tla.eigsh(tA, k=3, which="LA", m=50)
    w2, _ = tla.eigsh(tA, k=3, which="LA", block=3, m=18)
    np.testing.assert_allclose(w1.numpy(), ref, atol=1e-6)
    np.testing.assert_allclose(w2.numpy(), ref, atol=1e-6)


def test_block_lanczos_basis_orthonormal():
    _, tA = both(random_symmetric(64, 5))
    V = tla.block_lanczos(tA, 10, 3).numpy()
    np.testing.assert_allclose(V @ V.T, np.eye(30), atol=1e-8)


@pytest.mark.parametrize("block", [1, 2])
def test_eigsh_shift_invert_smallest_modes(block):
    """``sigma=0``: the smallest modes through ``lu`` (the degenerate pair
    included with ``block=2``)."""
    g = 16
    A = grid_laplacian(g)
    jA, tA = both(A)
    ref = grid_eigenvalues(g, 4)
    k = 4 if block == 2 else 1
    w, v = tla.eigsh(tA, k=k, sigma=0.0, block=block, m=24)
    jw, _ = jla.eigsh(jA, k=k, sigma=0.0, block=block, m=24)
    np.testing.assert_allclose(w.numpy(), ref[:k], atol=1e-10)
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), atol=1e-10)
    d = A.toarray()
    for j in range(k):
        vv = v[:, j].numpy()
        assert np.linalg.norm(d @ vv - float(w[j]) * vv) < 1e-5


def test_eigsh_interior_shift():
    d = random_symmetric(60, 6)
    _, tA = both(d)
    ew = np.linalg.eigvalsh(d)
    sigma = float((ew[29] + ew[30]) / 2)
    w, _ = tla.eigsh(tA, k=3, sigma=sigma, m=40)
    ref = ew[np.argsort(np.abs(ew - sigma))[:3]]
    np.testing.assert_allclose(np.sort(w.numpy()), np.sort(ref), atol=1e-7)


def test_eigsh_bsr_operand():
    d = random_symmetric(64, 7)
    _, tA = both(d)
    w, _ = tla.eigsh(tA.to_bsr(8), k=3, which="LA", m=48)
    np.testing.assert_allclose(w.numpy(), np.linalg.eigvalsh(d)[-3:],
                               atol=1e-5)


def test_lobpcg_smallest_cluster():
    g = 12
    A = grid_laplacian(g)
    jA, tA = both(A)
    ref = grid_eigenvalues(g, 4)
    w, X, resid = tla.lobpcg(tA, k=4, maxiter=80, seed=3)
    jw, _, _ = jla.lobpcg(jA, k=4, maxiter=80, seed=3)
    np.testing.assert_allclose(w.numpy(), ref, atol=1e-5)
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), atol=1e-5)
    assert float(resid.max()) < 1e-3
    np.testing.assert_allclose(X.numpy().T @ X.numpy(), np.eye(4), atol=1e-5)
    in_subspace(X, A.toarray(), np.arange(4), 1e-3)


def test_lobpcg_largest():
    d = random_symmetric(96, 8)
    jA, tA = both(d)
    w, _, _ = tla.lobpcg(tA, k=3, which="LA", maxiter=80, seed=5)
    jw, _, _ = jla.lobpcg(jA, k=3, which="LA", maxiter=80, seed=5)
    ref = np.linalg.eigvalsh(d)[-3:]
    np.testing.assert_allclose(w.numpy(), ref, atol=1e-5)
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), atol=1e-5)


def test_lobpcg_x0_and_callable_preconditioner():
    """``X0`` given, in float32 (the operand's float64 wins), and a
    callable Jacobi ``M``."""
    d = random_symmetric(60, 9, shift=8.0)
    jA, tA = both(d)
    diag = torch.from_numpy(np.diag(d).copy())
    X0 = np.random.default_rng(10).normal(size=(60, 2)).astype(np.float32)
    w, X, _ = tla.lobpcg(tA, X0=X0, which="SA", maxiter=80,
                         M=lambda r: r / diag.to(r.dtype))
    jw, _, _ = jla.lobpcg(jA, X0=X0, which="SA", maxiter=80,
                          M=lambda r: r / np.diag(d).astype(r.dtype))
    ref = np.linalg.eigvalsh(d)[:2]
    assert X.dtype == torch.float64
    np.testing.assert_allclose(w.numpy(), ref, atol=1e-4)
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), atol=1e-4)


@pytest.mark.parametrize("precond", ["ic0", "chebyshev"])
def test_lobpcg_preconditioned(precond):
    """IC(0) or Chebyshev ``M`` (objects with ``.solve``) lower the
    residual at equal ``maxiter``, as in the JAX package."""
    A = grid_laplacian(14)
    jA, tA = both(A)
    M = getattr(tla, precond)(tA)
    w_p, _, r_p = tla.lobpcg(tA, k=2, maxiter=15, M=M, seed=2)
    _, _, r_u = tla.lobpcg(tA, k=2, maxiter=15, seed=2)
    assert float(r_p.max()) < float(r_u.max())
    jw, _, _ = jla.lobpcg(jA, k=2, maxiter=60, M=getattr(jla, precond)(jA),
                          seed=2)
    w, _, _ = tla.lobpcg(tA, k=2, maxiter=60, M=M, seed=2)
    ref = grid_eigenvalues(14, 2)
    np.testing.assert_allclose(w.numpy(), ref, atol=1e-5)
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), atol=1e-5)


@pytest.mark.parametrize("shape", [(60, 40), (40, 60)])
def test_svds_matches_jax_and_numpy(shape):
    rng = np.random.default_rng(11)
    d = np.where(rng.random(shape) < 0.15, rng.normal(size=shape), 0.0)
    jA, tA = both(d)
    u, s, vt = tla.svds(tA, k=3, m=40)
    _, js, _ = jla.svds(jA, k=3, m=40)
    ref = np.linalg.svd(d, compute_uv=False)[:3]
    np.testing.assert_allclose(s.numpy(), ref, atol=1e-6)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), atol=1e-6)
    assert tuple(u.shape) == (shape[0], 3) and tuple(vt.shape) == (3, shape[1])
    for j in range(3):
        np.testing.assert_allclose(d @ vt[j].numpy(), float(s[j]) * u[:, j].numpy(),
                                   atol=1e-6)
        np.testing.assert_allclose(d.T @ u[:, j].numpy(),
                                   float(s[j]) * vt[j].numpy(), atol=1e-6)


def test_validation_errors():
    _, tA = both(random_symmetric(30, 12))
    _, rect = both(sps.random(4, 5, 0.5, random_state=0))
    with pytest.raises(ValueError, match="which"):
        tla.eigsh(tA, k=2, which="LM")
    with pytest.raises(ValueError, match="0 < k < n"):
        tla.eigsh(tA, k=30)
    with pytest.raises(ValueError, match="0 < k < n"):
        tla.eigsh(tA, k=0, sigma=0.5)
    with pytest.raises(ShapeError):
        tla.eigsh(rect, k=1)
    with pytest.raises(ShapeError):
        tla.eigsh(rect, k=1, block=2)
    with pytest.raises(ValueError, match="X0 or k"):
        tla.lobpcg(tA)
    with pytest.raises(ValueError, match="n ≥ 3k"):
        tla.lobpcg(tA, k=11)
    with pytest.raises(ValueError, match="which"):
        tla.lobpcg(tA, k=2, which="SM")
    with pytest.raises(TypeError):
        tla.lobpcg(tA, k=2, M=3.0)
    with pytest.raises(ValueError, match="conflicts"):
        tla.lobpcg(tA, X0=np.ones((30, 2)), k=3)
    with pytest.raises(ValueError, match="X0 must be"):
        tla.lobpcg(tA, X0=np.ones((29, 2)))
    with pytest.raises(ShapeError):
        tla.lobpcg(rect, k=1)
    with pytest.raises(ValueError, match="min"):
        tla.svds(rect, k=4)
    with pytest.raises(ShapeError):
        tla.expm_multiply(rect, np.ones(5))
