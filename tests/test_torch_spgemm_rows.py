"""The SpGEMM kernel's row plan (the ``rowwise`` variant) on the CPU.

The rowwise kernel itself runs only on the GPU (``chip_smoke.py`` holds it
against the plain version there). Here, with inputs made by NumPy from a
seed:

- every row of C lands in exactly one bin, and the grids cover each bin's
  rows with their longest C row; thread-bin rows fit its register slots;
- the row plan's term counts equal the plan's slot term ranges, row by row;
- the budget: a C row exactly at ``ROW_BUDGET`` stays in the cta bin, one
  slot more makes it wide (and ``row_bytes`` at the boundary);
- CSC-mirror and ``DistCsr``-shell plans carry the structures they were
  planned on;
- a plain torch walk of the row plan (grid by grid, row by row, over the
  CSR arrays of A, B and C only) equals ``spgemm_numeric_plain`` and the
  JAX package's ``spgemm_apply`` within the tolerances of
  ``tests/test_torch_spgemm.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import spalinalg_tpu as jsp
import spalinalg_tpu_torch as tsp
from spalinalg_tpu_torch.ops import spgemm as tsg
from spalinalg_tpu_torch.ops.kernels import spgemm_numeric as nm


@pytest.fixture(autouse=True)
def _cpu_scope():
    with tsp.default_device("cpu"):
        yield


TOL = {np.float32: 1e-5, np.float64: 1e-12}


def _power_law(n, seed, cap=64, ncols=None, dtype=np.float64,
               unsorted=False):
    """Host CSR arrays: zipf row lengths, uniform columns that may repeat
    within a row (sorted unless ``unsorted``)."""
    rng = np.random.default_rng(seed)
    ncols = n if ncols is None else ncols
    deg = np.minimum(rng.zipf(1.8, size=n), cap)
    deg[::11] = 0
    rowptr = np.concatenate([[0], np.cumsum(deg)])
    colind = rng.integers(0, ncols, size=int(rowptr[-1]))
    if not unsorted:
        colind = colind[np.lexsort((colind, np.repeat(np.arange(n), deg)))]
    values = rng.normal(size=colind.size).astype(dtype)
    return n, ncols, rowptr, colind, values


def _trusted(n, m, rowptr, colind, values):
    return tsp.CsrMatrix._from_parts(
        n, m, torch.from_numpy(rowptr.astype(np.int32)),
        torch.from_numpy(colind.astype(np.int32)), torch.from_numpy(values))


def _pair(seed, dtype=np.float64, unsorted=False):
    a = _power_law(300, seed, dtype=dtype, unsorted=unsorted)
    b = _power_law(300, seed + 1, cap=200, ncols=250, dtype=dtype,
                   unsorted=unsorted)
    return a, b


def _row_walk(plan, rows, a_values, b_values):
    """The kernel's function as the row plan lays it out, in plain torch:
    for each grid, each of its rows, each A entry in order and each entry
    of its B row, the product added to the slot of its column in C's row
    (found by a search of C's sorted row). Reads only the CSR arrays of A,
    B and C and the row plan."""
    acc = torch.promote_types(a_values.dtype, b_values.dtype)
    out = torch.full((plan.n_out,), float("nan"), dtype=acc)
    a_ptr, a_col = plan.a_ptr.long(), plan.a_col.long()
    b_ptr, b_col = plan.b_ptr.long(), plan.b_col.long()
    c_ptr, c_col = plan.rowptr.long(), plan.colind.long()
    av, bv = a_values.to(acc), b_values.to(acc)
    for _, first, count, _ in rows.grids.tolist():
        for i in rows.rows[first:first + count].tolist():
            c0, c1 = int(c_ptr[i]), int(c_ptr[i + 1])
            row = torch.zeros(c1 - c0, dtype=acc)
            for e in range(int(a_ptr[i]), int(a_ptr[i + 1])):
                k = int(a_col[e])
                p = torch.arange(int(b_ptr[k]), int(b_ptr[k + 1]))
                slot = torch.searchsorted(c_col[c0:c1], b_col[p])
                assert torch.equal(c_col[c0:c1][slot], b_col[p])
                row.index_add_(0, slot, av[e] * bv[p])
            out[c0:c1] = row
    return out


def _scale(plan, a_values, b_values):
    return nm.spgemm_numeric_plain(plan.gid, plan.a_idx, plan.b_idx,
                                   a_values.abs().double(),
                                   b_values.abs().double(), plan.n_out)


# ------------------------------------------------------------ the bins


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("seed", [70, 71])
def test_each_row_in_one_bin(itemsize, seed):
    (a_args, b_args) = _pair(seed)
    plan = tsp.spgemm_plan(_trusted(*a_args), _trusted(*b_args))
    rows = nm.spgemm_rows(plan.a_ptr, plan.a_col, plan.b_ptr, plan.rowptr,
                          itemsize)
    n = plan.nrows
    ids = rows.rows.long()
    assert rows.rows.dtype == torch.int32 and ids.numel() == n
    assert torch.equal(torch.sort(ids)[0], torch.arange(n))
    assert sum(rows.counts) == n
    # bins laid out one after another, in BINS order
    starts = np.concatenate([[0], np.cumsum(rows.counts)])
    for b in range(len(nm.BINS)):
        assert bool((rows.bins[ids[starts[b]:starts[b + 1]]] == b).all())
    # the grids cover each bin's rows, heaviest bins first, and name each
    # grid's longest C row
    length = plan.rowptr[1:] - plan.rowptr[:-1]
    covered = []
    order = [int(g[0]) for g in rows.grids]
    assert order == sorted(order, reverse=True)
    for b, first, count, longest in rows.grids.tolist():
        part = ids[first:first + count]
        assert bool((rows.bins[part] == b).all())
        assert int(length[part].max()) == longest
        covered.extend(part.tolist())
    assert sorted(covered) == list(range(n))
    thread = ids[:rows.counts[0]]
    assert int(length[thread].max()) <= nm.THREAD_SLOTS
    work = torch.maximum(rows.terms,
                         (plan.a_ptr[1:] - plan.a_ptr[:-1]).long())
    assert int(work[thread].max()) <= nm.THREAD_TERMS
    assert int(work[ids[rows.counts[0]:rows.counts[0] + rows.counts[1]]]
               .max()) <= nm.WARP_TERMS
    assert rows.counts[0] > 0 and rows.counts[1] > 0


@pytest.mark.parametrize("seed", [72, 73])
def test_terms_equal_slot_term_ranges(seed):
    (a_args, b_args) = _pair(seed, unsorted=True)
    plan = tsp.spgemm_plan(_trusted(*a_args), _trusted(*b_args))
    rows = nm.row_plan(plan, 8)
    tptr = plan.tptr.numpy().astype(np.int64)
    rowptr = plan.rowptr.numpy()
    np.testing.assert_array_equal(rows.terms.numpy(),
                                  tptr[rowptr[1:]] - tptr[rowptr[:-1]])
    assert nm.row_plan(plan, 8) is rows          # cached with the plan
    assert nm.row_plan(plan, 4) is not rows


@pytest.mark.parametrize("itemsize", [4, 8])
def test_budget_boundary(itemsize):
    """A C row exactly at the budget is a cta row; one slot more is wide."""
    fixed = nm.row_bytes(0, nm.CTA_WARPS, itemsize)
    at = (nm.ROW_BUDGET - fixed) // (itemsize + 6)
    while nm.row_bytes(at + 1, nm.CTA_WARPS, itemsize) <= nm.ROW_BUDGET:
        at += 1
    while nm.row_bytes(at, nm.CTA_WARPS, itemsize) > nm.ROW_BUDGET:
        at -= 1
    assert nm.row_bytes(at, nm.CTA_WARPS, itemsize) <= nm.ROW_BUDGET
    assert nm.row_bytes(at + 1, nm.CTA_WARPS, itemsize) > nm.ROW_BUDGET
    # rows 0 and 1 of A: `at` and `at + 1` distinct columns; B the identity
    rng = np.random.default_rng(74)
    cols = np.concatenate([rng.permutation(at), rng.permutation(at + 1)])
    a = _trusted(2, at + 1, np.array([0, at, 2 * at + 1]), cols,
                 rng.normal(size=cols.size))
    b = _trusted(at + 1, at + 1, np.arange(at + 2), np.arange(at + 1),
                 rng.normal(size=at + 1))
    plan = tsp.spgemm_plan(a, b)
    rows = nm.row_plan(plan, itemsize)
    assert rows.bins.tolist() == [2, 3]
    assert [g[0] for g in rows.grids.tolist()] == [3, 2]
    walk = _row_walk(plan, rows, a.values, b.values)
    ref = nm.spgemm_numeric_plain(plan.gid, plan.a_idx, plan.b_idx,
                                  a.values, b.values, plan.n_out)
    assert torch.equal(walk, ref)               # one term a slot


# ----------------------------------------- the structures of a plan


def test_csc_mirror_plan_structures(monkeypatch):
    (a_args, b_args) = _pair(75)
    n, m, rowptr, colind, values = a_args
    # CSC storage: the arrays of the transposes
    a = tsp.CscMatrix._from_parts(m, n, torch.from_numpy(
        rowptr.astype(np.int32)), torch.from_numpy(colind.astype(np.int32)),
        torch.from_numpy(values))
    nb, mb, ptr_b, col_b, val_b = _power_law(m, 76, ncols=n)
    b = tsp.CscMatrix._from_parts(n, nb, torch.from_numpy(
        ptr_b.astype(np.int32)), torch.from_numpy(col_b.astype(np.int32)),
        torch.from_numpy(val_b))
    plans = []
    build = tsg.spgemm_plan
    monkeypatch.setattr(tsg, "spgemm_plan",
                        lambda x, y: plans.append(build(x, y)) or plans[-1])
    c = a * b
    (plan,) = plans
    # C's CSC arrays are the CSR arrays of Bᵀ·Aᵀ: B's mirror on the left
    for got, want in ((plan.a_ptr, b._ptr), (plan.a_col, b._minor),
                      (plan.b_ptr, a._ptr), (plan.b_col, a._minor)):
        assert got.data_ptr() == want.data_ptr() and torch.equal(got, want)
    walk = _row_walk(plan, nm.row_plan(plan, 8), b.values, a.values)
    scale = _scale(plan, b.values, a.values)
    assert bool(((walk - c.values).abs() <= 1e-12 * scale).all())


def test_dist_shell_plan_structures(monkeypatch):
    """``DistCsr * DistCsr`` plans on its shells' global structures."""
    import torch.distributed as dist

    from spalinalg_tpu_torch.parallel import make_row_mesh, partition_csr

    (a_args, b_args) = _pair(77)
    n, m, rowptr, colind, values = a_args
    a = _trusted(n, n, rowptr, colind, values)
    plans = []
    build = tsg.spgemm_plan
    monkeypatch.setattr(tsg, "spgemm_plan",
                        lambda x, y: plans.append(build(x, y)) or plans[-1])
    assert not dist.is_initialized()
    try:
        mesh = make_row_mesh()
        da = partition_csr(a, mesh)
        dc = da * da
        (plan,) = plans
        for got in (plan.a_ptr, plan.b_ptr):
            np.testing.assert_array_equal(got.numpy(), rowptr)
        for got in (plan.a_col, plan.b_col):
            np.testing.assert_array_equal(got.numpy(), colind)
        whole = dc.to_csr()
        walk = _row_walk(plan, nm.row_plan(plan, 8), a.values, a.values)
        scale = _scale(plan, a.values, a.values)
        assert bool(((walk - whole.values).abs() <= 1e-12 * scale).all())
    finally:
        dist.destroy_process_group()


# ------------------------------------------------ the walk's values


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("unsorted", [False, True])
def test_row_walk_matches_plain_and_jax(dtype, unsorted):
    (a_args, b_args) = _pair(78, dtype=dtype, unsorted=unsorted)
    a, b = _trusted(*a_args), _trusted(*b_args)
    plan = tsp.spgemm_plan(a, b)
    rows = nm.row_plan(plan, np.dtype(dtype).itemsize)
    walk = _row_walk(plan, rows, a.values, b.values)
    scale = _scale(plan, a.values, b.values)
    plain = nm.spgemm_numeric_plain(plan.gid, plan.a_idx, plan.b_idx,
                                    a.values, b.values, plan.n_out)
    err = (walk.double() - plain.double()).abs()
    assert bool((err <= TOL[dtype] * scale).all())
    # the JAX package on the same arrays, through its trusted constructor
    # (repeated and unsorted columns as they are)
    ja, jb = (jsp.CsrMatrix._from_parts(
        n, m, jnp.asarray(ptr, jnp.int32), jnp.asarray(col, jnp.int32),
        jnp.asarray(val)) for n, m, ptr, col, val in (a_args, b_args))
    jplan = jsp.spgemm_plan(ja, jb)
    want = np.asarray(jsp.spgemm_apply(jplan, ja.values, jb.values))
    assert want.dtype == dtype
    assert np.all(np.abs(walk.double().numpy() - want)
                  <= TOL[dtype] * scale.numpy())
