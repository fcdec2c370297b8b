"""Orderings and the level-scheduled triangular solve of the port against
the JAX package: ``rcm_ordering``, ``bandwidth`` and ``level_schedule``
equal exactly (NumPy below 2048 rows, the native library above, in both
packages); ``solve_triangular_csr`` lower, upper and ``unit_diag`` within
atol 1e-12 in float64 on both sides of the 256-level device cap; the
zero-diagonal ``StructureError``.
"""

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import spalinalg_tpu as jsp
import spalinalg_tpu.linalg as jla
import spalinalg_tpu_torch as tsp
import spalinalg_tpu_torch.linalg as tla
from spalinalg_tpu_torch.linalg.triangular import MAX_DEVICE_LEVELS


@pytest.fixture(autouse=True)
def _cpu_scope():
    """The port's entry points place data on the card unless told
    otherwise; these tests run on the CPU."""
    with tsp.default_device("cpu"):
        yield


def lap2d(k):
    T = sps.diags([-1.0, 4.0, -1.0], [-1, 0, 1], shape=(k, k))
    D = sps.diags([-1.0, -1.0], [-1, 1], shape=(k, k))
    return (sps.kron(sps.eye(k), T) + sps.kron(D, sps.eye(k))).tocsr()


def both(A, dtype=np.float64):
    A = A.tocsr()
    A.sort_indices()
    args = (A.shape[0], A.shape[1], A.indptr, A.indices,
            A.data.astype(dtype))
    return jsp.CsrMatrix(*args), tsp.CsrMatrix(*args)


def scrambled(A, seed):
    p = np.random.default_rng(seed).permutation(A.shape[0])
    return A[p][:, p].tocsr()


ORDER_CASES = {
    "lap2d_15": lambda: lap2d(15),
    "scrambled_lap2d_20": lambda: scrambled(lap2d(20), 1),
    "two_components": lambda: sps.block_diag([lap2d(5), lap2d(4)]).tocsr(),
    "random_sym": lambda: (lambda B: (B + B.T + sps.eye(120)).tocsr())(
        sps.random(120, 120, 0.03, random_state=7)),
    "native_scrambled_lap2d_50": lambda: scrambled(lap2d(50), 2),
}


@pytest.mark.parametrize("name", list(ORDER_CASES))
def test_orderings_match_jax(name):
    jA, tA = both(ORDER_CASES[name]())
    perm = tla.rcm_ordering(tA)
    np.testing.assert_array_equal(perm, jla.rcm_ordering(jA))
    assert sorted(perm.tolist()) == list(range(tA.nrows))
    assert tla.bandwidth(tA) == jla.bandwidth(jA)
    pt, pj = tla.permute_csr(tA, perm), jla.permute_csr(jA, perm)
    assert tla.bandwidth(pt) == jla.bandwidth(pj)
    ptr = tA.rowptr.numpy().astype(np.int64)
    ind = tA.colind.numpy().astype(np.int64)
    for lower in (True, False):
        for got, want in zip(tla.level_schedule(ptr, ind, tA.nrows,
                                                lower=lower),
                             jla.level_schedule(ptr, ind, jA.nrows,
                                                lower=lower)):
            np.testing.assert_array_equal(got, want)


def triangle(n, lower, seed, unit=False, band=None):
    """A random well-conditioned triangular matrix (``band`` limits how
    far below/above the diagonal its entries reach)."""
    rng = np.random.default_rng(seed)
    B = sps.random(n, n, 4.0 / n, random_state=seed).toarray()
    if band is not None:
        i, j = np.indices((n, n))
        B[np.abs(i - j) > band] = 0
    B = np.tril(B, -1) if lower else np.triu(B, 1)
    d = 0 if unit else rng.uniform(1.0, 2.0, size=n)
    return sps.csr_matrix(B + np.diag(d) + (np.eye(n) if unit else 0))


@pytest.mark.parametrize("lower", [True, False])
@pytest.mark.parametrize("unit", [False, True])
@pytest.mark.parametrize("deep", [False, True])
def test_solve_matches_jax(lower, unit, deep):
    """``deep``: a bidiagonal structure of 300 levels (past the cap: the
    host sweep); otherwise a random one of far fewer (the device path)."""
    n = 300
    if deep:
        d = sps.diags([1.5 + np.arange(n) / n], [0])
        off = sps.diags([0.3 * np.ones(n - 1)], [-1 if lower else 1])
        A = (d + off).tocsr()
    else:
        A = triangle(n, lower, seed=3, band=8)
    jA, tA = both(A)
    b = np.random.default_rng(4).normal(size=n)
    plan = tla.plan_triangular(tA, lower=lower, unit_diag=unit)
    assert plan.use_device == (not deep)
    assert (plan.n_levels > MAX_DEVICE_LEVELS) == deep
    tx = tla.solve_triangular_csr(tA, b, lower=lower, unit_diag=unit)
    jx = np.asarray(jla.solve_triangular_csr(jA, b, lower=lower,
                                             unit_diag=unit))
    np.testing.assert_allclose(tx.numpy(), jx, rtol=0, atol=1e-12)
    dense = A.toarray()
    if unit:
        dense = np.tril(dense, -1) if lower else np.triu(dense, 1)
        dense += np.eye(n)
    np.testing.assert_allclose(dense @ tx.numpy(), b, atol=1e-10)
    again = tla.solve_triangular_csr(tA, torch.from_numpy(b), plan=plan)
    np.testing.assert_array_equal(again.numpy(), tx.numpy())


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_plan_layout_matches_jax(dtype):
    """The same level boundaries and row order as the JAX plan, and a
    float32 solve within the float32 tolerance."""
    A = triangle(200, True, seed=8, band=20)
    jA, tA = both(A, dtype)
    jplan = jla.plan_triangular(jA, lower=True)
    tplan = tla.plan_triangular(tA, lower=True)
    np.testing.assert_array_equal(tplan.order, jplan.order)
    np.testing.assert_array_equal(tplan.bounds, jplan.bounds)
    assert tplan.n_levels == jplan.n_levels
    for (te, tc, _), (je, jc, _) in zip(tplan.levels, jplan.levels):
        np.testing.assert_array_equal(te.numpy(), np.asarray(je))
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    b = np.random.default_rng(1).normal(size=200).astype(dtype)
    tol = 1e-12 if dtype == np.float64 else 1e-5
    np.testing.assert_allclose(
        tla.solve_triangular_csr(tA, b, plan=tplan).numpy(),
        np.asarray(jla.solve_triangular_csr(jA, b, plan=jplan)),
        rtol=tol, atol=tol)


@pytest.mark.parametrize("lower", [True, False])
def test_zero_diagonal_raises(lower):
    A = triangle(20, lower, seed=2).tolil()
    A[5, 5] = 0
    A = A.tocsr()
    A.eliminate_zeros()
    jA, tA = both(A)
    for pkg, la, mat in ((jsp, jla, jA), (tsp, tla, tA)):
        with pytest.raises(pkg.StructureError, match="diagonal"):
            la.plan_triangular(mat, lower=lower)
        la.plan_triangular(mat, lower=lower, unit_diag=True)


def test_segment_sum():
    from spalinalg_tpu_torch.ops.reduction import segment_sum

    stream = torch.arange(6, dtype=torch.float64)
    seg = torch.tensor([0, 0, 3, 3, 3, 1])
    assert segment_sum(stream, seg, 5).tolist() == [1.0, 5.0, 0.0, 9.0, 0.0]
    two = segment_sum(torch.ones(4, 2), torch.tensor([1, 1, 1, 0]), 2)
    assert two.tolist() == [[1.0, 1.0], [3.0, 3.0]]
