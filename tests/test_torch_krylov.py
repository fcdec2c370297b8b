"""The port's Krylov tier against the JAX package: ``cg`` with each
preconditioner (none, ``"jacobi"``, a callable, ``ic0``, ``chebyshev``),
``gmres`` and ``bicgstab`` (none and ``ilu0``), on the same NumPy inputs.
In float64 the solutions agree within atol 1e-8 and the iteration counts
are equal; in float32 the solutions agree within rtol 1e-4. Also: the
GMRES happy breakdown (``b`` in a 3-dimensional Krylov space, restart 32),
``cg`` on a BSR operand, the preconditioners' own applications, and the
``ValueError``/``ShapeError`` cases.
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


def lap2d(k, shift=0.0):
    T = sps.diags([-1.0, 4.0 + shift, -1.0], [-1, 0, 1], shape=(k, k))
    D = sps.diags([-1.0, -1.0], [-1, 1], shape=(k, k))
    return (sps.kron(sps.eye(k), T) + sps.kron(D, sps.eye(k))).tocsr()


def convdiff2d(k, c=0.6):
    """Upwind convection-diffusion: nonsymmetric, diagonally dominant."""
    T = sps.diags([-1.0 - c, 4.0 + 2 * c, -1.0], [-1, 0, 1], shape=(k, k))
    D = sps.diags([-1.0 - c, -1.0], [-1, 1], shape=(k, k))
    return (sps.kron(sps.eye(k), T) + sps.kron(D, sps.eye(k))).tocsr()


def both(A, dtype=np.float64):
    A = A.tocsr()
    A.sort_indices()
    args = (A.shape[0], A.shape[1], A.indptr, A.indices,
            A.data.astype(dtype))
    return jsp.CsrMatrix(*args), tsp.CsrMatrix(*args)


def rhs(n, dtype=np.float64, seed=3):
    return np.random.default_rng(seed).normal(size=n).astype(dtype)


def check(jres, tres, dtype):
    jx, tx = np.asarray(jres.x), tres.x.numpy()
    assert tx.dtype == jx.dtype
    if dtype == np.float64:
        assert tres.iterations == int(jres.iterations)
        np.testing.assert_allclose(tx, jx, rtol=0, atol=1e-8)
        np.testing.assert_allclose(float(tres.residual),
                                   float(jres.residual), rtol=1e-6,
                                   atol=1e-12)
    else:
        np.testing.assert_allclose(tx, jx, rtol=1e-4,
                                   atol=1e-4 * np.abs(jx).max())


CG_PRECONDS = {
    "none": lambda pkg, la, A: None,
    "jacobi": lambda pkg, la, A: "jacobi",
    "callable": lambda pkg, la, A: (lambda r: 0.25 * r),
    "ic0": lambda pkg, la, A: la.ic0(A),
    "chebyshev": lambda pkg, la, A: la.chebyshev(A, degree=6),
}


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("precond", list(CG_PRECONDS))
def test_cg_matches_jax(precond, dtype):
    jA, tA = both(lap2d(10, shift=0.05), dtype)
    b = rhs(jA.nrows, dtype)
    tol = 1e-9 if dtype == np.float64 else 1e-4
    jres = jla.cg(jA, b, tol=tol,
                  precondition=CG_PRECONDS[precond](jsp, jla, jA))
    tres = tla.cg(tA, b, tol=tol,
                  precondition=CG_PRECONDS[precond](tsp, tla, tA))
    check(jres, tres, dtype)
    assert tres.iterations > 0 and float(tres.residual) <= tol


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_cg_bsr_operand(dtype):
    """The JAX ``cg`` takes BSR; so does the port's (its SpMV is the BSR
    product), and Jacobi reads the BSR's diagonal."""
    jA, tA = both(lap2d(16), dtype)
    b = rhs(jA.nrows, dtype)
    tol = 1e-9 if dtype == np.float64 else 1e-4
    for precond in (None, "jacobi"):
        check(jla.cg(jA.to_bsr(4), b, tol=tol, precondition=precond),
              tla.cg(tA.to_bsr(4), b, tol=tol, precondition=precond), dtype)


@pytest.mark.parametrize("x0", [False, True])
def test_cg_maxiter_and_x0(x0):
    jA, tA = both(lap2d(12))
    b = rhs(jA.nrows)
    start = rhs(jA.nrows, seed=9) if x0 else None
    jres = jla.cg(jA, b, start, tol=1e-12, maxiter=7)
    tres = tla.cg(tA, b, start, tol=1e-12, maxiter=7)
    assert tres.iterations == int(jres.iterations) == 7
    check(jres, tres, np.float64)


SOLVERS = ["gmres", "bicgstab"]


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("precond", ["none", "ilu0"])
@pytest.mark.parametrize("solver", SOLVERS)
def test_nonsymmetric_solvers_match_jax(solver, precond, dtype):
    jA, tA = both(convdiff2d(15), dtype)
    b = rhs(jA.nrows, dtype)
    tol = 1e-10 if dtype == np.float64 else 1e-5
    jM = jla.ilu0(jA) if precond == "ilu0" else None
    tM = tla.ilu0(tA) if precond == "ilu0" else None
    kw = {"restart": 20} if solver == "gmres" else {}
    jres = getattr(jla, solver)(jA, b, tol=tol, M=jM, **kw)
    tres = getattr(tla, solver)(tA, b, tol=tol, M=tM, **kw)
    check(jres, tres, dtype)


@pytest.mark.parametrize("solver", SOLVERS)
def test_solvers_x0_and_callable_precond(solver):
    jA, tA = both(convdiff2d(10))
    b = rhs(jA.nrows)
    x0 = rhs(jA.nrows, seed=4)
    jres = getattr(jla, solver)(jA, b, x0, tol=1e-10, M=lambda r: r / 5.0)
    tres = getattr(tla, solver)(tA, b, x0, tol=1e-10, M=lambda r: r / 5.0)
    check(jres, tres, np.float64)


def test_gmres_happy_breakdown():
    """``b`` in a 3-dimensional Krylov space: the Arnoldi process breaks
    down at step 3 of a restart-32 cycle, and the least-squares step takes
    the rank-deficient Hessenberg matrix."""
    n = 40
    diag = np.full(n, 2.0)
    diag[:3] = [1.0, 3.0, 5.0]
    A = sps.diags(diag).tocsr()
    jA, tA = both(A)
    b = np.zeros(n)
    b[:3] = [1.0, -2.0, 0.5]
    jres = jla.gmres(jA, b, tol=1e-12, restart=32)
    tres = tla.gmres(tA, b, tol=1e-12, restart=32)
    check(jres, tres, np.float64)
    assert tres.iterations == 33
    np.testing.assert_allclose(tres.x.numpy()[:3], b[:3] / diag[:3],
                               atol=1e-12)
    assert np.isfinite(tres.x.numpy()).all()


@pytest.mark.parametrize("kind", ["ilu0", "ic0"])
def test_factor_preconditioner_matches_jax(kind):
    jA, tA = both(lap2d(12, shift=0.3))
    jM, tM = getattr(jla, kind)(jA), getattr(tla, kind)(tA)
    for jm, tm in ((jM.l_mat, tM.l_mat), (jM.u_mat, tM.u_mat)):
        np.testing.assert_array_equal(tm.rowptr.numpy(), np.asarray(jm.rowptr))
        np.testing.assert_array_equal(tm.colind.numpy(), np.asarray(jm.colind))
        np.testing.assert_allclose(tm.values.numpy(), np.asarray(jm.values),
                                   rtol=1e-12, atol=0)
    r = rhs(jA.nrows)
    np.testing.assert_allclose(tM.solve(r).numpy(), np.asarray(jM.solve(r)),
                               rtol=1e-12, atol=1e-12)
    assert tM.l_plan.use_device and tM.u_plan.use_device


def test_chebyshev_estimate_float32_matches_jax():
    """The power iteration starts from NumPy's ``default_rng(0)`` in
    float64 in both packages, on a float32 operand: the same ``lmax``."""
    jA, tA = both(lap2d(12), np.float32)
    jM, tM = jla.chebyshev(jA, degree=5), tla.chebyshev(tA, degree=5)
    assert tM.lmax == pytest.approx(jM.lmax, rel=1e-12)
    assert tM.lmin == pytest.approx(jM.lmin, rel=1e-12)
    r = rhs(jA.nrows, np.float32)
    np.testing.assert_allclose(tM.solve(r).numpy(), np.asarray(jM.solve(r)),
                               rtol=1e-4, atol=1e-5)


def test_deep_factor_preconditioner_sweeps_on_the_host():
    """A structure deeper than the device cap is applied by the host
    sweep: ``M.solve`` still gives ``U⁻¹ L⁻¹ r``."""
    n = 300
    A = sps.diags([-1.0, 3.0, -1.0], [-1, 0, 1], shape=(n, n)).tocsr()
    _, tA = both(A)
    M = tla.ilu0(tA)
    assert not M.l_plan.use_device
    r = rhs(n)
    np.testing.assert_allclose(M.solve(r).numpy(),
                               np.linalg.solve(A.toarray(), r), atol=1e-10)


def test_validation_errors():
    jA, tA = both(lap2d(4))
    rect = tsp.CsrMatrix(2, 3, [0, 1, 2], [0, 1], [1.0, 1.0])
    jrect = jsp.CsrMatrix(2, 3, [0, 1, 2], [0, 1], [1.0, 1.0])
    b = np.ones(16)
    for pkg, la, A, R in ((jsp, jla, jA, jrect), (tsp, tla, tA, rect)):
        with pytest.raises(ValueError):
            la.cg(A, b, precondition=42)
        with pytest.raises(ValueError):
            la.gmres(A, b, M=42)
        with pytest.raises(ValueError):
            la.bicgstab(A, b, M=42)
        with pytest.raises(ValueError):
            la.chebyshev(A, degree=0)
        with pytest.raises(ValueError):
            la.chebyshev(A, lmin=5.0, lmax=1.0)
        for build in (la.ilu0, la.ic0, la.chebyshev):
            with pytest.raises(pkg.ShapeError):
                build(R)
    assert issubclass(ShapeError, ValueError)
    bad = tsp.CsrMatrix(2, 2, [0, 1, 2], [1, 0], [1.0, 1.0])
    with pytest.raises(tsp.StructureError):
        tla.ilu0(bad)
    with pytest.raises(tsp.StructureError):
        tla.ic0(tsp.CsrMatrix(2, 2, [0, 1, 3], [0, 0, 1], [1.0, 2.0, -5.0]))


def test_solutions_stay_on_the_operand_device():
    """Vectors given as NumPy land on the operand's device; an operand
    with no device of its own takes the default device's scope."""
    _, tA = both(lap2d(4))
    res = tla.cg(tA, np.ones(16))
    assert res.x.device == tA.device and res.x.dtype == torch.float64

    class Op:
        ncols = 3

        def __matmul__(self, v):
            return 2 * v

    with tsp.default_device("meta"):
        assert tla.cg(Op(), np.ones(3), maxiter=0).x.device.type == "meta"
    res = tla.cg(Op(), np.ones(3), tol=1e-12)
    np.testing.assert_allclose(res.x.numpy(), 0.5)
