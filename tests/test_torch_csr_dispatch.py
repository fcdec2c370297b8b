"""The CSR kernels' variant choice, the vector SpMV's work split, and the
SDDMM and ``perm`` paths of the CSR backward passes, against the JAX
package.

``csrc/csr_spmv.cu`` (``vector`` and ``scalar``), ``csrc/csr_spmm.cu``
(``vector`` and ``register``) and ``csrc/csr_sddmm.cu`` (``vector`` and
``scalar``) each have two variants, picked in Python by
``csr_spmv_variant`` / ``csr_spmm_variant`` / ``csr_sddmm_variant`` from
dtypes, shapes and addresses; those functions run on any device, so the
choice is checked here on CPU tensors, alignment included (views at a
storage offset). The vector SpMV's plan (``build_spmv_plan``) is a pure
function of ``rowptr``: a model of the kernel's walk over it must cover
every stored entry below ``rowptr[-1]`` exactly once, in order, and none
past it. The kernels themselves are held against the plain versions on
the card by ``chip_smoke.py``.

``csr_sddmm_plain`` (the ``dvals`` of both backward passes) is held
against ``jax.grad`` with respect to the values of the JAX package's
``csr @ x`` and ``csr @ X``, with padding slots and empty rows, entry by
entry ``|d - d_jax| <= tol·Σ_c|G[row, c]||X[col, c]|`` (1e-5 f32, 1e-12
f64); the ``perm`` argument of ``csr_spmv`` / ``csr_spmm`` against the
gathered values.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import spalinalg_tpu as jsp
import spalinalg_tpu_torch as tsp
from spalinalg_tpu_torch.convert.engine import major_ids
from spalinalg_tpu_torch.io import csr_from_arrays
from spalinalg_tpu_torch.ops.kernels import csr_spmv as spmv_mod
from spalinalg_tpu_torch.ops.kernels.csr_sddmm import (csr_sddmm,
                                                       csr_sddmm_plain,
                                                       csr_sddmm_variant)
from spalinalg_tpu_torch.ops.kernels.csr_spmm import (csr_spmm,
                                                      csr_spmm_variant)
from spalinalg_tpu_torch.ops.kernels.csr_spmv import (BUDGET, build_spmv_plan,
                                                      csr_spmv,
                                                      csr_spmv_plain,
                                                      csr_spmv_plan,
                                                      csr_spmv_variant)
from spalinalg_tpu_torch.utils import metrics


@pytest.fixture(autouse=True)
def _cpu_scope():
    """The port's entry points place data on the card unless told
    otherwise; these tests run on the CPU."""
    with tsp.default_device("cpu"):
        yield


DTYPES = {"float32": torch.float32, "float64": torch.float64}
TOL = {"float32": 1e-5, "float64": 1e-12}
NP = {"float32": np.float32, "float64": np.float64}


def _view(n, dtype, shift: bool):
    """``n`` zeros of ``dtype``, as a view one element past a 16-byte
    boundary when ``shift``."""
    base = torch.zeros(n + 1, dtype=dtype)
    return base[1:] if shift else base[:-1]


# ---------------------------------------------------------------------------
# The variant choice


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shift", [None, "colind", "values", "perm"])
@pytest.mark.parametrize("use_perm", [False, True])
@pytest.mark.parametrize("nse", [1, 4, 37, 4096])
def test_spmv_variant(dtype, shift, use_perm, nse):
    """vector when colind and the array the values stream from (perm if
    given, else values) start on a 16-byte boundary."""
    colind = _view(nse, torch.int32, shift == "colind")
    values = _view(nse, DTYPES[dtype], shift == "values")
    perm = _view(nse, torch.int32, shift == "perm") if use_perm else None
    streamed_off = shift == "colind" or shift == ("perm" if use_perm
                                                  else "values")
    want = "scalar" if streamed_off else "vector"
    assert csr_spmv_variant(colind, values, perm) == want


@pytest.mark.parametrize("mean", [0.1, 1, 32, 300, 5000])
def test_spmv_variant_ignores_row_lengths(mean):
    """Row lengths do not enter the choice: the plan splits long rows and
    packs short ones, so every aligned structure takes the vector
    variant."""
    rng = np.random.default_rng(40)
    lens = rng.poisson(mean, size=50)
    nse = int(lens.sum()) + 3
    assert csr_spmv_variant(torch.zeros(nse, dtype=torch.int32),
                            torch.zeros(nse)) == "vector"


def test_spmv_variant_refuses_other_dtypes():
    with pytest.raises(tsp.DTypeError):
        csr_spmv_variant(torch.zeros(4, dtype=torch.int32),
                         torch.zeros(4, dtype=torch.bfloat16))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("k", [1, 2, 3, 4, 8, 17, 32, 64, 65, 100, 130])
@pytest.mark.parametrize("shift", [False, True])
def test_spmm_and_sddmm_variants(dtype, k, shift):
    """vector when a row is a whole number of 16-byte vectors and the
    operand starts on a 16-byte boundary (SpMM: in float32 only);
    register (SpMM) / rowwalk at k = 1, else scalar (SDDMM) otherwise.
    (With no tile plan the staged variants are not in play.)"""
    itemsize = torch.empty(0, dtype=DTYPES[dtype]).element_size()
    X = _view(7 * k, DTYPES[dtype], shift).view(7, k)
    G = _view(5 * k, DTYPES[dtype], False).view(5, k)
    whole = k * itemsize % 16 == 0
    vector_spmm = dtype == "float32" and whole and not shift
    assert csr_spmm_variant(X) == ("vector" if vector_spmm else "register")
    assert csr_sddmm_variant(G, X) == ("vector" if whole and not shift
                                       else "rowwalk" if k == 1
                                       else "scalar")
    assert csr_sddmm_variant(X, G) == csr_sddmm_variant(G, X)


# ---------------------------------------------------------------------------
# The vector SpMV's plan


def _walk(rowptr, plan):
    """A model of the vector kernel's walk: ``(windows, pieces, finish)``:
    per window warp the rows it writes and the entry range it reads; per
    piece warp its row and entry range; per long row its pieces."""
    ptr = rowptr.tolist()
    windows, piece_row, piece_start, long_rows, first = (
        t.tolist() for t in plan.parts())
    walked = []
    for r0, r1, e0, e1 in windows:
        assert (e0, e1) == (ptr[r0], ptr[r1])
        walked.append((list(range(r0, r1)), (e0, e1)))
    pieces = []
    for row, start in zip(piece_row, piece_start):
        pieces.append((row, (start, min(start + BUDGET, ptr[row + 1]))))
    finish = {row: list(range(first[i], first[i + 1]))
              for i, row in enumerate(long_rows)}
    return walked, pieces, finish


def _structures():
    rng = np.random.default_rng(41)
    yield "empty", [0] * 6
    yield "one entry", [0, 0, 1, 0]
    yield "uniform 32", [32] * 40
    yield "0, 1, 31, 32, 33", list(rng.choice([0, 1, 31, 32, 33], 300))
    yield "4096 and short", list(rng.choice([0, 3, 4096], 60,
                                            p=[0.3, 0.6, 0.1]))
    yield "exactly the budget", [BUDGET, BUDGET + 1, BUDGET - 1, 2 * BUDGET,
                                 2 * BUDGET + 1, 0, 0]
    lens = list(rng.poisson(4, 500))
    lens[17] = 150_000
    yield "one row of 150,000", lens
    yield "all empty but the last", [0] * 1000 + [5]
    yield "power law", list(np.minimum(rng.zipf(1.8, 2000), 512))


@pytest.mark.parametrize("pad", [0, 13])
@pytest.mark.parametrize("name,lens", list(_structures()),
                         ids=[n for n, _ in _structures()])
def test_plan_covers_every_entry_once_in_order(name, lens, pad):
    lens = np.asarray(lens, dtype=np.int64)
    rowptr = torch.from_numpy(
        np.concatenate([[0], np.cumsum(lens)]).astype(np.int32))
    nnz, nrows = int(rowptr[-1]), lens.size
    plan = build_spmv_plan(rowptr)
    assert plan.plan.dtype == torch.int32
    assert plan.nwin == nnz // BUDGET + 1
    windows, pieces, finish = _walk(rowptr, plan)
    # every row written exactly once: by one window, or by the finishing
    # pass of a long row
    written = [r for rows, _ in windows for r in rows] + sorted(finish)
    assert sorted(written) == list(range(nrows))
    assert sorted(finish) == [r for r in range(nrows) if lens[r] > BUDGET]
    # every entry below nnz read exactly once; none at or past it
    reads = np.zeros(nnz + pad, dtype=np.int64)
    for rows, (e0, e1) in windows:
        assert e1 - e0 < 2 * BUDGET          # the kernel's staging buffer
        assert all(lens[r] <= BUDGET for r in rows)
        if rows:
            assert (e0, e1) == (int(rowptr[rows[0]]),
                                int(rowptr[rows[-1] + 1]))
        reads[e0:e1] += 1
    for row, (e0, e1) in pieces:
        assert 0 < e1 - e0 <= BUDGET
        reads[e0:e1] += 1
    assert np.all(reads[:nnz] == 1) and np.all(reads[nnz:] == 0)
    # a long row's pieces are consecutive, in entry order, and cover it
    for row, idx in finish.items():
        spans = [pieces[i][1] for i in idx]
        assert all(pieces[i][0] == row for i in idx)
        assert spans[0][0] == int(rowptr[row])
        assert spans[-1][1] == int(rowptr[row + 1])
        assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    # windows own their rows in order
    flat = [r for rows, _ in windows for r in rows]
    assert flat == sorted(flat)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_plan_model_gives_the_product(dtype):
    """The walk's partial sums, combined as the kernel combines them (a
    row's window sum, or its pieces in order), give the plain product."""
    rng = np.random.default_rng(42)
    lens = rng.poisson(6, 400)
    lens[5], lens[300] = 1000, 257
    lens[::9] = 0
    ptr = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    nse = int(ptr[-1]) + 11
    rowptr = torch.from_numpy(ptr)
    colind = torch.from_numpy(rng.integers(0, 350, nse).astype(np.int32))
    values = torch.from_numpy(rng.normal(size=nse)).to(DTYPES[dtype])
    x = torch.from_numpy(rng.normal(size=350)).to(DTYPES[dtype])
    prod = values * x[colind.long()]
    windows, pieces, finish = _walk(rowptr, build_spmv_plan(rowptr))
    y = torch.full((400,), float("nan"), dtype=DTYPES[dtype])
    for rows, _ in windows:
        for r in rows:
            y[r] = prod[ptr[r]:ptr[r + 1]].sum()
    partial = [prod[e0:e1].sum() for _, (e0, e1) in pieces]
    for row, idx in finish.items():
        y[row] = sum((partial[i] for i in idx), torch.zeros((), dtype=y.dtype))
    ref = csr_spmv_plain(rowptr, colind, values, x, 400)
    scale = csr_spmv_plain(rowptr, colind, values.abs(), x.abs(), 400)
    assert torch.all((y - ref).abs() <= TOL[dtype] * scale)


def test_plan_is_cached_with_the_structure():
    rowptr = torch.tensor([0, 2, 700, 701], dtype=torch.int32)
    plan = csr_spmv_plan(rowptr)
    assert csr_spmv_plan(rowptr) is plan
    assert csr_spmv_plan(rowptr.clone()) is not plan
    assert plan.nlong == 1 and plan.npieces == 3


# ---------------------------------------------------------------------------
# SDDMM (dvals) against jax.grad, and the perm path


def _padded_pair(rng, n, m, dtype, pad):
    """A CSR matrix with empty rows and ``pad`` padding slots holding
    values, in both packages (the JAX one through its trusted
    constructor)."""
    d = np.where(rng.random((n, m)) < 0.3, rng.normal(size=(n, m)), 0.0)
    d[[0, 4, n - 1], :] = 0.0
    d = d.astype(dtype)
    jmat = jsp.CsrMatrix.from_dense(d)
    ptr = np.asarray(jmat.rowptr)
    ind = np.concatenate([np.asarray(jmat.colind),
                          rng.integers(0, m, pad).astype(np.int32)])
    val = np.concatenate([np.asarray(jmat.values),
                          rng.normal(size=pad).astype(dtype)])
    jpad = jsp.CsrMatrix._from_parts(n, m, jnp.asarray(ptr),
                                     jnp.asarray(ind), jnp.asarray(val))
    return d, jpad, csr_from_arrays(n, m, ptr, ind, val)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("k", [1, 3, 64, 100])
def test_sddmm_plain_matches_jax_grad(dtype, k):
    rng = np.random.default_rng(43 + k)
    n, m = 23, 19
    d, jmat, tmat = _padded_pair(rng, n, m, NP[dtype], pad=7)
    shape = (m,) if k == 1 else (m, k)
    X = rng.normal(size=shape).astype(NP[dtype])
    G = rng.normal(size=(n,) + shape[1:]).astype(NP[dtype])

    def f(values):
        return jnp.vdot(jnp.asarray(G), jmat.with_values(values)
                        @ jnp.asarray(X))

    want = np.asarray(jax.grad(f)(jmat.values))
    major = major_ids(tmat.rowptr, tmat.nse)
    got = csr_sddmm_plain(major, tmat.colind, torch.from_numpy(G),
                          torch.from_numpy(X), n)
    wrapped = csr_sddmm(tmat.rowptr, tmat.colind, torch.from_numpy(G),
                        torch.from_numpy(X), n)
    given = csr_sddmm(tmat.rowptr, tmat.colind, torch.from_numpy(G),
                      torch.from_numpy(X), n, major=major)
    assert got.dtype == DTYPES[dtype] and torch.equal(got, wrapped)
    assert torch.equal(got, given)
    aG, aX = np.abs(G).reshape(n, -1), np.abs(X).reshape(m, -1)
    rows = np.minimum(major.numpy(), n - 1)
    scale = np.einsum("pc,pc->p", aG[rows], aX[tmat.colind.numpy()])
    nnz = tmat.nnz
    assert np.all(np.abs(got.numpy()[:nnz] - want[:nnz])
                  <= TOL[dtype] * scale[:nnz])
    assert np.all(got.numpy()[nnz:] == 0)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("k", [None, 1, 3, 64])
def test_backward_matches_jax_grad(dtype, k):
    """dvals and dx (dX) of ``csr @ x`` / ``csr @ X`` through the port's
    autograd Functions, whose backward now runs SDDMM and reads the
    values through the transpose's perm."""
    rng = np.random.default_rng(50 + (k or 0))
    n, m = 21, 17
    d, jmat, tmat = _padded_pair(rng, n, m, NP[dtype], pad=5)
    shape = (m,) if k is None else (m, k)
    X = rng.normal(size=shape).astype(NP[dtype])
    G = rng.normal(size=(n,) + shape[1:]).astype(NP[dtype])

    def f(values, Xv):
        return jnp.vdot(jnp.asarray(G), jmat.with_values(values) @ Xv)

    jdv, jdX = jax.grad(f, argnums=(0, 1))(jmat.values, jnp.asarray(X))
    values = tmat.values.clone().requires_grad_(True)
    Xt = torch.from_numpy(X).requires_grad_(True)
    (tmat.with_values(values) @ Xt).backward(torch.from_numpy(G))
    aG, aX = np.abs(G).reshape(n, -1), np.abs(X).reshape(m, -1)
    nnz = tmat.nnz
    rows = np.repeat(np.arange(n), np.diff(tmat.rowptr.numpy()))
    cols = tmat.colind.numpy()[:nnz]
    scale = np.einsum("pc,pc->p", aG[rows], aX[cols])
    dv = values.grad.numpy()
    assert np.all(np.abs(dv[:nnz] - np.asarray(jdv)[:nnz])
                  <= TOL[dtype] * scale)
    assert np.all(dv[nnz:] == 0)
    scale_x = (np.abs(d).T @ aG).reshape(shape)
    assert np.all(np.abs(Xt.grad.numpy() - np.asarray(jdX))
                  <= TOL[dtype] * scale_x)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("k", [None, 1, 5])
def test_perm_path_matches_the_gathered_form(dtype, k):
    """``csr_spmv`` / ``csr_spmm`` with ``perm`` give exactly the product
    on ``values[perm]``."""
    rng = np.random.default_rng(60)
    lens = rng.poisson(3, 30)
    lens[::6] = 0
    ptr = torch.from_numpy(np.concatenate([[0], np.cumsum(lens)])
                           .astype(np.int32))
    nse = int(ptr[-1]) + 4
    colind = torch.from_numpy(rng.integers(0, 25, nse).astype(np.int32))
    values = torch.from_numpy(rng.normal(size=nse)).to(DTYPES[dtype])
    perm = torch.from_numpy(rng.permutation(nse).astype(np.int32))
    if k is None:
        x = torch.from_numpy(rng.normal(size=25)).to(DTYPES[dtype])
        got = csr_spmv(ptr, colind, values, x, 30, perm=perm)
        want = csr_spmv(ptr, colind, values[perm], x, 30)
    else:
        X = torch.from_numpy(rng.normal(size=(25, k))).to(DTYPES[dtype])
        got = csr_spmm(ptr, colind, values, X, 30, perm=perm)
        want = csr_spmm(ptr, colind, values[perm], X, 30)
    assert torch.equal(got, want)


def test_perm_is_checked():
    ptr = torch.tensor([0, 1, 2], dtype=torch.int32)
    ind = torch.tensor([0, 1], dtype=torch.int32)
    val = torch.ones(2)
    with pytest.raises(tsp.DTypeError):
        csr_spmv(ptr, ind, val, torch.ones(2), 2,
                 perm=torch.tensor([1, 0]))
    with pytest.raises(tsp.ShapeError):
        csr_spmv(ptr, ind, val, torch.ones(2), 2,
                 perm=torch.tensor([0], dtype=torch.int32))
    with pytest.raises(tsp.ShapeError):
        csr_spmm(ptr, ind, val, torch.ones(2, 3), 2,
                 perm=torch.tensor([0, 1, 1], dtype=torch.int32))


def test_sddmm_is_checked_and_refuses_meta():
    rowptr = torch.tensor([0, 1, 2], dtype=torch.int32)
    major = torch.tensor([0, 1], dtype=torch.int32)
    colind = torch.tensor([1, 0], dtype=torch.int32)
    with pytest.raises(tsp.ShapeError):
        csr_sddmm(rowptr, colind, torch.ones(3, 2), torch.ones(2, 2), 2)
    with pytest.raises(tsp.ShapeError):
        csr_sddmm(rowptr, colind, torch.ones(2, 2), torch.ones(2, 3), 2)
    with pytest.raises(tsp.ShapeError):
        csr_sddmm(rowptr, colind, torch.ones(2), torch.ones(2), 2,
                  major=major[:1])
    with pytest.raises(tsp.DTypeError):
        csr_sddmm(rowptr.long(), colind, torch.ones(2), torch.ones(2), 2)
    with pytest.raises(tsp.DTypeError):
        csr_sddmm(rowptr, colind, torch.ones(2), torch.ones(2), 2,
                  major=major.long())
    with pytest.raises(ValueError, match="unknown csr_sddmm variant"):
        csr_sddmm(rowptr, colind, torch.ones(2), torch.ones(2), 2,
                  variant="tiled")
    with pytest.raises(ValueError, match="no csr_sddmm kernel for device"):
        csr_sddmm(rowptr.to("meta"), colind.to("meta"),
                  torch.ones(2, device="meta"), torch.ones(2, device="meta"),
                  2)


def test_metrics_path_names_plain_off_the_card():
    rec = metrics.enable()
    try:
        rec.records.clear()
        a = tsp.CsrMatrix.eye(4)
        a @ torch.ones(4, dtype=torch.float64)
        a @ torch.ones(4, 8, dtype=torch.float64)
        assert [r.path for r in rec.records] == ["csr_spmv:plain",
                                                 "csr_spmm:plain"]
    finally:
        metrics.disable()
        rec.records.clear()


def test_wrapper_counts_no_launch_on_the_cpu():
    before = (dict(spmv_mod.LAUNCHES), dict(spmv_mod.VARIANT_LAUNCHES))
    a = tsp.CsrMatrix.from_dense(np.eye(5) * 2.0)
    vals = a.values.clone().requires_grad_(True)
    (a.with_values(vals) @ torch.ones(5, dtype=torch.float64)).sum().backward()
    assert torch.equal(vals.grad, torch.ones(5, dtype=torch.float64))
    assert (dict(spmv_mod.LAUNCHES), dict(spmv_mod.VARIANT_LAUNCHES)) == before
