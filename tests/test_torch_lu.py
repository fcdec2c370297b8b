"""The port's sparse LU (``linalg/supernodal_lu.py``, ``linalg/lu.py``)
against the JAX package on the same NumPy inputs.

- ``symmetrize_structure``, ``map_values_to_structure``, the ordering and
  every array of ``build_supernodal_lu_plan`` equal the JAX ones exactly
  (structurally unsymmetric matrices, ``reorder`` on and off).
- Per bucket of the factor, in float64: ``perm11`` equal where both
  packages pivot the same way, and there ``lu11``/``l21``/``u12`` within
  rtol 1e-10.
- ``lu_solve`` within rtol 1e-9 (float64) and 2e-3 (float32, the JAX
  test's figure) for each ``method``, ``pivot=True``, ``perturb`` on a
  zero diagonal, a matrix scaled by 1e-6, and ``refine`` 0, 1 and 2.
- The slab guard: with ``cholesky.SLAB_LIMIT_BYTES`` lowered, ``auto``
  takes the supernodal path where the JAX ``lu`` would build the banded
  slab stack, and its solution matches the JAX supernodal one.
- The error cases.
"""

import sys
from types import SimpleNamespace

import numpy as np
import pytest
import scipy.sparse as sps

import spalinalg_tpu as jsp
import spalinalg_tpu.linalg as jla
import spalinalg_tpu_torch as tsp
import spalinalg_tpu_torch.linalg as tla
from spalinalg_tpu.errors import ShapeError as JShapeError
from spalinalg_tpu.linalg import supernodal_lu as jsl
from spalinalg_tpu_torch.errors import ShapeError
from spalinalg_tpu_torch.linalg import supernodal_lu as tsl

tchol = sys.modules["spalinalg_tpu_torch.linalg.cholesky"]
tlu = sys.modules["spalinalg_tpu_torch.linalg.lu"]


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


def convdiff2d(k, c=0.4):
    """2-D convection-diffusion: the unsymmetric 5-point stencil of
    ``tests/test_supernodal_lu.py``."""
    T = sps.diags([-1.0 - c, 4.0, -1.0 + c], [-1, 0, 1], shape=(k, k))
    D = sps.diags([-1.0 - c, -1.0 + c], [-1, 1], shape=(k, k))
    return (sps.kron(sps.eye(k), T) + sps.kron(D, sps.eye(k))).tocsr()


def unsym_structure(n, seed):
    """Structurally unsymmetric: a random pattern plus a dominant
    diagonal (entries (i, j) without (j, i))."""
    B = sps.random(n, n, 0.06, random_state=seed, format="csr")
    B.data = np.random.default_rng(seed).normal(size=B.nnz)
    return (sps.triu(B, 1) * 2.0 + sps.tril(B, -1) * 0.5
            + sps.eye(n) * (2.0 + abs(B).sum(axis=1).max())).tocsr()


MATRICES = {
    "convdiff_10": lambda: convdiff2d(10),
    "convdiff_12_c07": lambda: convdiff2d(12, c=0.7),
    "unsym_80": lambda: unsym_structure(80, 3),
}


def both(A, dtype=np.float64):
    A = A.tocsr().astype(dtype)
    A.sort_indices()
    args = (A.shape[0], A.shape[1], A.indptr, A.indices, A.data)
    return jsp.CsrMatrix(*args), tsp.CsrMatrix(*args)


def rhs(n, dtype=np.float64, seed=5):
    return np.random.default_rng(seed).normal(size=n).astype(dtype)


_JAX_PLANS = {}


def jax_plan(name, reorder, monkeypatch):
    """The JAX ``lu``'s plan and symmetrized values for one matrix,
    without its numeric phase (the factor call is replaced by a
    recorder)."""
    key = (name, reorder)
    if key not in _JAX_PLANS:
        monkeypatch.setattr(
            jsl, "supernodal_lu_factor",
            lambda plan, svals, perturb: SimpleNamespace(
                plan=plan, svals=np.asarray(svals)))
        jA, _ = both(MATRICES[name]())
        fac = jla.lu(jA, method="supernodal", reorder=reorder)
        monkeypatch.undo()
        _JAX_PLANS[key] = (fac.perm, fac.snlu.plan, fac.snlu.svals)
    return _JAX_PLANS[key]


_JAX_FACTORS = {}


def jax_factor(name):
    if name not in _JAX_FACTORS:
        jA, _ = both(MATRICES[name]())
        _JAX_FACTORS[name] = jla.lu(jA, method="supernodal")
    return _JAX_FACTORS[name]


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_symmetrize_and_map_equal_jax(name):
    A = MATRICES[name]()
    A.sort_indices()
    ptr, ind, n = A.indptr, A.indices, A.shape[0]
    js_ptr, js_ind = jsl.symmetrize_structure(ptr, ind, n)
    ts_ptr, ts_ind = tsl.symmetrize_structure(ptr, ind, n)
    np.testing.assert_array_equal(ts_ptr, js_ptr)
    np.testing.assert_array_equal(ts_ind, js_ind)
    np.testing.assert_array_equal(
        tsl.map_values_to_structure(ptr, ind, ts_ptr, ts_ind, n),
        jsl.map_values_to_structure(ptr, ind, js_ptr, js_ind, n))
    if name.startswith("unsym"):
        assert ts_ind.size > A.nnz          # really unsymmetric


def test_map_values_rejects_a_subset():
    A = convdiff2d(4)
    A.sort_indices()
    diag = sps.eye(16, format="csr")
    with pytest.raises(ValueError, match="superset"):
        tsl.map_values_to_structure(A.indptr, A.indices, diag.indptr,
                                    diag.indices, 16)


@pytest.mark.parametrize("reorder", [True, False])
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_plan_equals_jax(name, reorder, monkeypatch):
    """Every index array of the plan, the ordering and the symmetrized
    values equal the JAX package's."""
    jperm, jplan, jsvals = jax_plan(name, reorder, monkeypatch)
    _, tA = both(MATRICES[name]())
    fac = tla.lu(tA, method="supernodal", reorder=reorder)
    tplan = fac.snlu.plan
    np.testing.assert_array_equal(fac.perm, jperm)
    assert tplan.n == jplan.n and tplan.lu_nnz == jplan.lu_nnz
    assert len(tplan.levels) == len(jplan.levels)
    for tb, jb in zip((b for lv in tplan.levels for b in lv),
                      (b for lv in jplan.levels for b in lv)):
        assert (tb.nsp, tb.mup) == (jb.nsp, jb.mup)
        for field in ("sids", "a_dst", "a_src", "pad_diag", "colg", "rowg"):
            np.testing.assert_array_equal(getattr(tb, field),
                                          getattr(jb, field))
        assert [k for k, _, _ in tb.ext] == [k for k, _, _ in jb.ext]
        for (_, ts, td), (_, js, jd) in zip(tb.ext, jb.ext):
            np.testing.assert_array_equal(ts, js)
            np.testing.assert_array_equal(td, jd)
    # the symmetrized values, the numeric phase's input
    tsym = tlu._supernodal_symbolic(tA, reorder)
    np.testing.assert_array_equal(
        tlu.symmetrized_values(tsym, tA.values).numpy(), jsvals)


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_factor_buckets_match_jax(name):
    """Per bucket, float64: the local row order equal where both pivot
    alike (all buckets here), and there the factors within rtol 1e-10."""
    jfac = jax_factor(name).snlu
    _, tA = both(MATRICES[name]())
    tfac = tla.lu(tA, method="supernodal").snlu
    assert tfac.lu11.keys() == jfac.lu11.keys()
    same = 0
    for key in jfac.lu11:
        jp = np.asarray(jfac.perm11[key])
        tp = tfac.perm11[key].numpy()
        if not np.array_equal(tp, jp):
            continue
        same += 1
        for part in ("lu11", "l21", "u12"):
            want = np.asarray(getattr(jfac, part)[key])
            got = getattr(tfac, part)[key].numpy()
            assert got.shape == want.shape
            scale = max(np.abs(want).max(initial=0.0), 1e-300)
            np.testing.assert_allclose(got, want, rtol=1e-10,
                                       atol=1e-10 * scale)
    assert same == len(jfac.lu11)


def test_row_order_from_lapack_swaps():
    """The pivots of ``lu_factor_ex`` become the row order with
    ``F11[perm] = L·U``."""
    import torch

    F = torch.from_numpy(np.random.default_rng(2).normal(size=(4, 9, 9)))
    lu_, piv, _ = torch.linalg.lu_factor_ex(F)
    perm = tsl._row_order(lu_, piv)
    L = torch.tril(lu_, -1) + torch.eye(9, dtype=F.dtype)
    U = torch.triu(lu_)
    PF = torch.gather(F, 1, perm.unsqueeze(-1).expand(4, 9, 9))
    np.testing.assert_allclose(PF.numpy(), (L @ U).numpy(), rtol=1e-12,
                               atol=1e-12)


def _solve_both(A, b, dtype, jkw=None, **kw):
    jA, tA = both(A, dtype)
    jfac = jla.lu(jA, **(kw if jkw is None else jkw))
    tfac = tla.lu(tA, **kw)
    return jfac, tfac, np.asarray(jla.lu_solve(jfac, b)), \
        tla.lu_solve(tfac, b).numpy()


TOL = {np.float64: 1e-9, np.float32: 2e-3}


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("method,pivot,path", [
    ("auto", False, "banded"), ("banded", False, "banded"),
    ("supernodal", False, "supernodal"), ("dense", False, "dense"),
    ("auto", True, "dense")])
def test_lu_solve_matches_jax(method, pivot, path, dtype):
    A = convdiff2d(10)
    b = rhs(A.shape[0], dtype)
    jfac, tfac, jx, tx = _solve_both(A, b, dtype, method=method,
                                     pivot=pivot)
    assert tfac.path == path
    assert (tfac.snlu is None) == (jfac.snlu is None)
    assert (tfac.dense_lu is None) == (jfac.dense_lu is None)
    tol = TOL[dtype]
    np.testing.assert_allclose(tx, jx, rtol=tol, atol=tol * np.abs(jx).max())
    xref = sps.linalg.spsolve(A.tocsc(), b.astype(np.float64))
    np.testing.assert_allclose(tx, xref, rtol=tol,
                               atol=tol * np.abs(xref).max())


@pytest.mark.parametrize("refine", [0, 1, 2])
def test_refine_steps_match_jax(refine):
    A = convdiff2d(12, c=0.7)
    b = rhs(A.shape[0])
    jfac = jax_factor("convdiff_12_c07")
    _, tA = both(A)
    tfac = tla.lu(tA, method="supernodal")
    jx = np.asarray(jla.lu_solve(jfac, b, refine=refine))
    tx = tla.lu_solve(tfac, b, refine=refine).numpy()
    np.testing.assert_allclose(tx, jx, rtol=1e-9, atol=1e-9 * np.abs(jx).max())


def test_refine_is_one_spmv_a_step():
    from spalinalg_tpu_torch.utils import metrics

    _, tA = both(convdiff2d(8))
    fac = tla.lu(tA, method="supernodal")
    rec = metrics.enable()
    try:
        rec.records.clear()
        tla.lu_solve(fac, rhs(64), refine=2)
        assert [r.path for r in rec.records] == ["csr_spmv:plain"] * 2
    finally:
        metrics.disable()
        rec.records.clear()


def test_unsymmetric_structure_supernodal():
    A = MATRICES["unsym_80"]()
    b = rhs(80)
    jx = np.asarray(jla.lu_solve(jax_factor("unsym_80"), b))
    _, tA = both(A)
    tx = tla.lu_solve(tla.lu(tA, method="supernodal"), b).numpy()
    np.testing.assert_allclose(tx, jx, rtol=1e-9, atol=1e-9 * np.abs(jx).max())


def test_perturb_lifts_a_zero_diagonal():
    """A zero on the diagonal: the lift keeps the factor finite, and the
    refined solution matches the JAX one."""
    A = convdiff2d(8).tolil()
    A[5, 5] = 0.0
    A = A.tocsr()
    b = rhs(64)
    for perturb in (True, False):
        jfac, tfac, jx, tx = _solve_both(A, b, np.float64,
                                         method="supernodal",
                                         perturb=perturb)
        assert np.all(np.isfinite(tx))
        np.testing.assert_allclose(tx, jx, rtol=1e-9,
                                   atol=1e-9 * np.abs(jx).max())


def test_small_magnitude_values_not_corrupted_by_perturb():
    """The lift's threshold scales with the operand's max |value| (the
    JAX test ``test_supernodal_lu.py:157``)."""
    A = (convdiff2d(8) * 1e-6).tocsr()
    b = rhs(64, np.float32) * np.float32(1e-6)
    jfac, tfac, jx, tx = _solve_both(A, b, np.float32, method="supernodal",
                                     perturb=True)
    xref = sps.linalg.spsolve(A.tocsc().astype(np.float64),
                              b.astype(np.float64))
    for x in (tx, jx):
        np.testing.assert_allclose(x, xref, rtol=2e-3,
                                   atol=2e-3 * np.abs(xref).max())


def test_slab_guard_sends_auto_supernodal(monkeypatch):
    """The JAX ``lu`` takes the banded path for any tight band (its slab
    stack unbounded); the port's leaves it past ``SLAB_LIMIT_BYTES``."""
    A = convdiff2d(12)
    b = rhs(144)
    jA, tA = both(A)
    assert tla.lu(tA).path == "banded"
    assert jla.lu(jA).band is not None
    monkeypatch.setattr(tchol, "SLAB_LIMIT_BYTES", 10_000)
    fac = tla.lu(tA)
    assert fac.path == "supernodal"
    jx = np.asarray(jla.lu_solve(jla.lu(jA, method="supernodal"), b))
    tx = tla.lu_solve(fac, b).numpy()
    np.testing.assert_allclose(tx, jx, rtol=1e-9, atol=1e-9 * np.abs(jx).max())


def test_band_too_costly_counts_the_slab_stack():
    """``ceil(n/nb)·(nb+bw)²·itemsize`` against the limit: the 512 x 512
    grid's 10.9 GB stack in float64."""
    import torch

    n, bw = 512 * 512, 512
    assert tchol.band_too_costly(n, bw, 64, torch.float64, 0.12)
    assert not tchol.band_too_costly(256 * 256, 256, 64, torch.float64,
                                     0.12)
    assert tchol.band_too_costly(100, 20, 64, torch.float64, 0.12)


def test_factor_refactor_reuses_the_plan():
    """A second factor of the same structure reuses the cached host
    plan, and ``supernodal_lu_factor`` on the cached values gives the
    same factor."""
    _, tA = both(convdiff2d(8))
    f1 = tla.lu(tA, method="supernodal")
    f2 = tla.lu(tA, method="supernodal")
    assert f1.snlu.plan is f2.snlu.plan
    for key, v in f1.snlu.lu11.items():
        np.testing.assert_array_equal(v.numpy(), f2.snlu.lu11[key].numpy())


def test_refactor_from_the_factor_values():
    """``LuFactor.values`` is the supernodal factor's input (A's values on
    the symmetrized structure, zeros where A has no entry): a re-factor
    from it on the factor's plan gives the same factor."""
    A = convdiff2d(8)
    _, tA = both(A)
    fac = tla.lu(tA, method="supernodal")
    vals = fac.values.numpy()
    assert np.count_nonzero(vals) == A.nnz
    np.testing.assert_allclose(np.sort(vals[vals != 0]), np.sort(A.data),
                               rtol=0, atol=0)
    again = tsl.supernodal_lu_factor(fac.snlu.plan, fac.values, perturb=True)
    for part in ("lu11", "perm11", "l21", "u12"):
        for key, v in getattr(fac.snlu, part).items():
            np.testing.assert_array_equal(v.numpy(),
                                          getattr(again, part)[key].numpy())
    assert tla.lu(tA, method="banded").values is None


def test_banded_lu_records_its_slab_build():
    """The banded path's host slab build is on the metrics recorder as
    ``lu_band_slabs`` (path ``host``), and recording changes no result."""
    from spalinalg_tpu_torch.utils import metrics

    _, tA = both(convdiff2d(10))
    b = rhs(100)
    x0 = tla.lu_solve(tla.lu(tA), b).numpy()
    rec = metrics.enable()
    rec.records.clear()
    try:
        fac = tla.lu(tA)
        ops = [(r.op, r.path) for r in rec.records]
    finally:
        metrics.disable()
        rec.records.clear()
    assert fac.path == "banded"
    assert ops == [("lu_band_slabs", "lu_band_slabs:host")]
    np.testing.assert_array_equal(tla.lu_solve(fac, b).numpy(), x0)


def test_plan_flops_counts_lu_fronts():
    _, tA = both(convdiff2d(8))
    plan = tla.lu(tA, method="supernodal").snlu.plan
    want = sum(bk.sids.size * (2 * bk.nsp ** 3 / 3 + 2 * bk.nsp ** 2 * bk.mup
                               + 2 * bk.nsp * bk.mup ** 2)
               for lv in plan.levels for bk in lv)
    assert plan.flops() == int(want) > 0


def test_dense_path_for_tiny_systems():
    A = sps.csr_matrix(np.array([[2.0, 1.0], [1.0, 3.0]]))
    jfac, tfac, jx, tx = _solve_both(A, np.array([1.0, 2.0]), np.float64)
    assert tfac.path == "dense" and jfac.dense_lu is not None
    np.testing.assert_allclose(tx, jx, rtol=1e-12)


def test_errors_match_jax():
    jrect, trect = both(sps.random(4, 5, 0.5, random_state=0))
    with pytest.raises(JShapeError):
        jla.lu(jrect)
    with pytest.raises(ShapeError):
        tla.lu(trect)
    jA, tA = both(convdiff2d(4))
    for lib, A in ((jla, jA), (tla, tA)):
        with pytest.raises(ValueError, match="unknown lu method"):
            lib.lu(A, method="qr")
        with pytest.raises(ValueError, match="partial pivoting"):
            lib.lu(A, method="supernodal", pivot=True)
