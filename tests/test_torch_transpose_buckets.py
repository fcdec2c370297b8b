"""The CSR backward's column buckets (``ops/kernels/csr_transpose.py``)
against their definition and the JAX package.

The bucket plan is a pure function of the structure, built here on CPU
tensors; ``bucket_values`` runs its plain version here (the kernel,
``csrc/csr_transpose.cu``, is held against it on the card by
``chip_smoke.py``). Checked exactly:

- the plan's invariant ``vb[bperm] == values[perm]`` on random, banded,
  power-law structures, with empty rows and columns, padding slots, a
  block width past ``ncols``, ``ncols`` not a multiple of it, several
  slabs and no entries;
- the plain pass 1 equals its definition: the values stably sorted by
  column block, padding last;
- the plan, its runs and the route rule; the plan is freed with its
  structure;
- pass 1 of the SpMV's products route (``values·g[row]``, padding kept)
  against its definition;
- the gradients of ``csr @ x`` and ``csr @ X`` against ``jax.grad`` of
  the JAX package's CPU path, through the port's backward and through the
  buckets and products routes named on purpose, which give the ``perm``
  route's bits.
"""

import gc
import weakref

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import spalinalg_tpu as jsp
import spalinalg_tpu_torch as tsp
from spalinalg_tpu_torch.convert.engine import transpose_structure
from spalinalg_tpu_torch.io import csr_from_arrays
from spalinalg_tpu_torch.ops.kernels import csr_transpose as ct
from spalinalg_tpu_torch.ops.kernels import csr_spmm as spmm_mod
from spalinalg_tpu_torch.ops.kernels import csr_spmv as spmv_mod
from spalinalg_tpu_torch.ops.kernels.csr_spmm import csr_spmm, transposed_spmm
from spalinalg_tpu_torch.ops.kernels.csr_spmv import (csr_spmv,
                                                      csr_spmv_products,
                                                      transpose_plan,
                                                      transposed_spmv)


@pytest.fixture(autouse=True)
def _cpu_scope():
    """The port's entry points place data on the card unless told
    otherwise; these tests run on the CPU."""
    with tsp.default_device("cpu"):
        yield


DTYPES = {"float32": torch.float32, "float64": torch.float64}
NP = {"float32": np.float32, "float64": np.float64}
TOL = {"float32": 1e-5, "float64": 1e-12}


def _structure(name: str, rng):
    """``(rowptr, colind, nrows, ncols)`` as int32 tensors, padding slots
    (in-range columns) past ``rowptr[-1]`` included."""
    pad = 0
    if name == "random":
        n, m = 400, 300
        lens = rng.poisson(6, n)
    elif name == "banded":
        n = m = 500
        lo = np.maximum(np.arange(n) - 4, 0)
        hi = np.minimum(np.arange(n) + 4, n - 1)
        lens = hi - lo + 1
        ptr = np.concatenate([[0], np.cumsum(lens)])
        cols = np.repeat(lo - ptr[:-1], lens) + np.arange(ptr[-1])
        return (torch.from_numpy(ptr.astype(np.int32)),
                torch.from_numpy(cols.astype(np.int32)), n, m)
    elif name == "power_law":
        n, m = 600, 700
        lens = np.minimum(rng.zipf(1.8, n), 300)
    elif name == "empty_rows_and_columns":
        n, m = 300, 500
        lens = rng.poisson(4, n)
        lens[::3] = 0
    elif name == "padding":
        n, m, pad = 200, 257, 37
        lens = rng.poisson(3, n)
    elif name == "several_slabs":
        n, m = 3000, 4099
        lens = rng.poisson(9, n)
    elif name == "no_entries":
        n, m, pad = 50, 40, 5
        lens = np.zeros(n, dtype=np.int64)
    else:
        raise ValueError(name)
    ptr = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    cols = np.empty(int(ptr[-1]) + pad, dtype=np.int32)
    for i in range(n):
        # sorted distinct columns a row; empty columns where name says
        pool = np.arange(m) if name != "empty_rows_and_columns" \
            else np.arange(0, m, 2)
        k = min(int(lens[i]), pool.size)
        ptr[i + 1] = ptr[i] + k
        cols[ptr[i]:ptr[i + 1]] = np.sort(rng.choice(pool, k, replace=False))
    cols = np.concatenate([cols[:ptr[-1]],
                           rng.integers(0, m, pad).astype(np.int32)])
    return torch.from_numpy(ptr), torch.from_numpy(cols), n, m


STRUCTURES = ["random", "banded", "power_law", "empty_rows_and_columns",
              "padding", "several_slabs", "no_entries"]
# None: bucket_width's own at BUCKET_BYTES (one block at these sizes); 1: a
# block a column; 64 with ncols not a multiple of it; 1 << 12 past every
# ncols here (one block). The small widths come from a BUCKET_BYTES made as
# small as these structures are.
WIDTHS = [None, 1, 64, 1 << 12]


def _plan(rowptr, colind, perm, ncols, itemsize, width, monkeypatch):
    """build_bucket_plan with BUCKET_BYTES set so that bucket_width gives
    ``width`` (at most the power of two covering ncols; that one where
    there are no entries), or as it is for None."""
    nnz = int(rowptr[-1])
    cover = 1 << max(ncols - 1, 0).bit_length()
    if width is not None:
        monkeypatch.setattr(ct, "BUCKET_BYTES",
                            -(-width * max(nnz, 1) * itemsize // ncols))
    plan = ct.build_bucket_plan(rowptr, colind, perm, ncols, itemsize)
    if width is not None:
        assert plan.width == (min(width, cover) if nnz else cover)
    return plan


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("name", STRUCTURES)
def test_plan_invariant(name, width, dtype, monkeypatch):
    """``vb[bperm] == values[perm]``, exactly, and pass 1 is the values
    stably sorted by block (padding last)."""
    rng = np.random.default_rng(sum(map(ord, name)))
    rowptr, colind, n, m = _structure(name, rng)
    t = transpose_structure(rowptr, colind, n_major=n, n_minor=m)
    values = torch.from_numpy(rng.normal(size=colind.numel())).to(
        DTYPES[dtype])
    plan = _plan(rowptr, colind, t.perm, m, values.element_size(), width,
                 monkeypatch)
    vb = ct.bucket_values(values, plan)
    perm = t.perm.to(torch.int64)
    assert torch.equal(vb[plan.bperm.to(torch.int64)], values[perm])
    nnz = int(rowptr[-1])
    key = ct.bucket_key(colind, nnz, plan.width, plan.nblocks)
    assert torch.equal(vb, values[torch.sort(key, stable=True).indices])
    assert torch.equal(vb, ct.bucket_values_plain(values, plan))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name", STRUCTURES)
def test_products_pass_one(name, dtype):
    """With g and the rows of the slots, pass 1 moves values·g[row] (the
    products of Aᵀ·g; padding slots keep their value) in the same order;
    summed by the transposed rows they are Aᵀ·g bitwise, as the plain
    versions sum."""
    rng = np.random.default_rng(sum(map(ord, name)) + 1)
    rowptr, colind, n, m = _structure(name, rng)
    t = transpose_structure(rowptr, colind, n_major=n, n_minor=m)
    values = torch.from_numpy(rng.normal(size=colind.numel())).to(
        DTYPES[dtype])
    g = torch.from_numpy(rng.normal(size=n)).to(DTYPES[dtype])
    plan = ct.build_bucket_plan(rowptr, colind, t.perm, m,
                                values.element_size())
    vb = ct.bucket_values(values, plan, g=g, major=t.major)
    rows = t.major.to(torch.int64)
    moved = values.clone()
    real = rows < n
    moved[real] = values[real] * g[rows[real]]
    key = ct.bucket_key(colind, int(rowptr[-1]), plan.width, plan.nblocks)
    assert torch.equal(vb, moved[torch.sort(key, stable=True).indices])
    got = csr_spmv_products(t.ptr, t.minor, vb, m, perm=plan.bperm)
    assert torch.equal(got, csr_spmv(t.ptr, t.minor, values, g, m,
                                     perm=t.perm))
    with pytest.raises(tsp.ShapeError):
        ct.bucket_values(values, plan, g=g)
    with pytest.raises(tsp.ShapeError):
        ct.bucket_values(values, plan, g=g.to(torch.float16),
                         major=t.major)


@pytest.mark.parametrize("name", STRUCTURES)
def test_plan_layout(name, monkeypatch):
    """The plan's arrays: dtypes and lengths, ``bperm`` a permutation, each
    slab's ``lpos`` a permutation of its places, its runs in place order
    starting at 0, each run's slots one block, consecutive in ``vb``."""
    rng = np.random.default_rng(7)
    rowptr, colind, n, m = _structure(name, rng)
    t = transpose_structure(rowptr, colind, n_major=n, n_minor=m)
    plan = _plan(rowptr, colind, t.perm, m, 8, 16, monkeypatch)
    nse = colind.numel()
    assert (plan.bperm.dtype, plan.lpos.dtype, plan.run_ptr.dtype,
            plan.run_start.dtype, plan.run_goff.dtype) == (
        torch.int32, torch.int16, torch.int32, torch.int32, torch.int32)
    assert plan.nslab == -(-nse // ct.SLAB)
    assert torch.equal(torch.sort(plan.bperm).values,
                       torch.arange(nse, dtype=torch.int32))
    key = ct.bucket_key(colind, int(rowptr[-1]), plan.width, plan.nblocks)
    pos = torch.empty(nse, dtype=torch.int64)
    pos[torch.sort(key, stable=True).indices] = torch.arange(nse)
    for s in range(plan.nslab):
        p0, p1 = s * ct.SLAB, min((s + 1) * ct.SLAB, nse)
        lpos = plan.lpos[p0:p1].to(torch.int64)
        assert torch.equal(torch.sort(lpos).values, torch.arange(p1 - p0))
        r0, r1 = int(plan.run_ptr[s]), int(plan.run_ptr[s + 1])
        starts = plan.run_start[r0:r1].tolist() + [p1 - p0]
        assert starts[0] == 0 and starts == sorted(set(starts))
        slot_at = torch.empty(p1 - p0, dtype=torch.int64)
        slot_at[lpos] = torch.arange(p0, p1)
        for r, (a, b) in enumerate(zip(starts[:-1], starts[1:])):
            slots = slot_at[a:b]
            assert len(set(key[slots].tolist())) == 1
            assert torch.equal(pos[slots], int(plan.run_goff[r0 + r])
                               + torch.arange(b - a))


def test_bucket_width():
    """A power of two: the block's mean share of the values fits
    BUCKET_BYTES; at most the power of two covering ncols."""
    assert ct.bucket_width(2**26, 2**21, 4) == 16384      # 2 MiB f32
    assert ct.bucket_width(2**26, 2**21, 8) == 8192       # 2 MiB f64
    assert ct.bucket_width(2**24, 2**19, 4) == 16384
    assert ct.bucket_width(100, 1000, 8) == 1024          # one block
    assert ct.bucket_width(0, 0, 4) == 1
    assert ct.bucket_width(10**9, 10, 8) == 1
    # chip_smoke.py's narrow edge structures: a block a column, and blocks
    # that do not divide ncols = 5
    assert ct.bucket_width(1_200_000, 4, 4) == ct.bucket_width(
        1_200_000, 4, 8) == 1
    assert ct.bucket_width(600_000, 5, 4) == 4
    assert ct.bucket_width(600_000, 5, 8) == 2
    for nnz, ncols, itemsize in ((2**26, 2**21, 4), (5000, 3001, 8),
                                 (2**30, 7, 4)):
        w = ct.bucket_width(nnz, ncols, itemsize)
        assert w & (w - 1) == 0
        assert w == 1 or w * nnz * itemsize <= ct.BUCKET_BYTES * ncols


def test_route_rule():
    """buckets on the card where the values do not fit the L2 and perm
    reaches past a block's bytes in a chunk; perm elsewhere, and always
    on the CPU; the SpMM keeps perm where one row of Aᵀ bounds its
    launch."""
    # the SpMV's route off the card: perm
    rowptr, colind, n, m = _structure("several_slabs",
                                      np.random.default_rng(2))
    t = transpose_structure(rowptr, colind, n_major=n, n_minor=m)
    assert spmv_mod.spmv_route(rowptr, colind, t, m, 4) == "perm"
    l2 = 50 << 20           # the H100's
    far = float(2**26)
    assert ct.route_for(2**26, 4, far, l2) == "buckets"
    assert ct.route_for(2**24, 8, far, l2) == "buckets"
    assert ct.route_for(2**24, 4, far, l2) == "buckets"      # 67 MB
    assert ct.route_for(l2 // 4, 4, far, l2) == "perm"
    assert ct.route_for(l2 // 4 + 1, 4, far, l2) == "buckets"
    assert ct.route_for(l2 // 4 + 1, 4, far, 2 * l2) == "perm"
    assert ct.route_for(8_535_214, 4, far, l2) == "perm"     # 34 MB
    assert ct.route_for(8_535_214, 8, far, l2) == "buckets"  # 68 MB
    assert ct.route_for(2**26, 4, ct.BUCKET_BYTES / 4, l2) == "perm"
    assert ct.route_for(2**26, 4, 3100.0, l2) == "perm"        # banded
    rowptr, colind, n, m = _structure("random", np.random.default_rng(1))
    t = transpose_structure(rowptr, colind, n_major=n, n_minor=m)
    assert ct.transposed_route(rowptr, colind, t, m, 8) == "perm"
    assert spmm_mod.spmm_route(rowptr, colind, t, m, 8) == "perm"
    # one row of Aᵀ past a resident warp's share of the entries (132 SMs
    # of 64 warps) bounds the SpMM's launch
    assert spmm_mod.one_row_bounds(150_001, 8_535_214, 132)
    assert not spmm_mod.one_row_bounds(60, 2**24, 132)
    assert not spmm_mod.one_row_bounds(2**24 // (132 * 64), 2**24, 132)
    assert spmm_mod.one_row_bounds(2**24 // (132 * 64) + 1, 2**24, 132)


def test_perm_span():
    """The mean reach of the transposed walk over chunks of SPAN_CHUNK
    slots below nnz."""
    n = 3 * ct.SPAN_CHUNK + 5
    assert ct.perm_span(torch.arange(n, dtype=torch.int32), n) == pytest.approx(
        (3 * ct.SPAN_CHUNK + 5) / 4)
    rev = torch.arange(n, dtype=torch.int32).flip(0)
    assert ct.perm_span(rev, n) == ct.perm_span(
        torch.arange(n, dtype=torch.int32), n)
    assert ct.perm_span(torch.zeros(0, dtype=torch.int32), 0) == 0.0
    assert ct.perm_span(torch.tensor([9, 0, 5], dtype=torch.int32), 2) == 10.0


def test_plan_is_cached_and_freed_with_its_structure():
    """One plan a structure, ncols and value size; it lives as long as the
    structure and no longer."""
    rng = np.random.default_rng(3)
    rowptr, colind, n, m = _structure("random", rng)
    n_before = len(ct._BUCKET_PLANS)
    t = transpose_structure(rowptr, colind, n_major=n, n_minor=m)
    plan = ct.bucket_plan(rowptr, colind, t, m, 8)
    assert ct.bucket_plan(rowptr, colind, t, m, 8) is plan
    assert ct.bucket_plan(rowptr, colind, t, m, 4) is not plan
    assert len(ct._BUCKET_PLANS) == n_before + 2
    freed = weakref.ref(plan.bperm)
    del rowptr, colind, plan
    gc.collect()
    assert len(ct._BUCKET_PLANS) == n_before
    assert freed() is None


def test_checks():
    rng = np.random.default_rng(4)
    rowptr, colind, n, m = _structure("padding", rng)
    t = transpose_structure(rowptr, colind, n_major=n, n_minor=m)
    plan = ct.build_bucket_plan(rowptr, colind, t.perm, m, 4)
    nse = colind.numel()
    with pytest.raises(tsp.DTypeError):
        ct.bucket_values(torch.ones(nse, dtype=torch.bfloat16), plan)
    with pytest.raises(tsp.ShapeError):
        ct.bucket_values(torch.ones(nse + 1), plan)
    with pytest.raises(tsp.ShapeError):
        ct.bucket_values(torch.ones(nse, 2), plan)
    with pytest.raises(ValueError, match="unknown transposed route"):
        ct.transposed_values(rowptr, colind, t, torch.ones(nse), m,
                             route="gather")
    with pytest.raises(ValueError, match="needs g"):
        ct.transposed_values(rowptr, colind, t, torch.ones(nse), m,
                             route="products")
    with pytest.raises(ValueError, match="no csr_transpose kernel"):
        ct.bucket_values(torch.ones(nse, device="meta"), plan._replace(
            lpos=plan.lpos.to("meta")))
    before = (dict(ct.LAUNCHES), dict(ct.VARIANT_LAUNCHES))
    ct.bucket_values(torch.ones(nse), plan)
    assert (dict(ct.LAUNCHES), dict(ct.VARIANT_LAUNCHES)) == before


def _jax_pair(rng, n, m, dtype, pad):
    """A CSR matrix with empty rows and columns and ``pad`` padding slots
    holding values, in both packages."""
    d = np.where(rng.random((n, m)) < 0.3, rng.normal(size=(n, m)), 0.0)
    d[[0, 5, n - 1], :] = 0.0
    d[:, [1, m - 2]] = 0.0
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
@pytest.mark.parametrize("k", [None, 1, 7])
def test_gradients_match_jax_grad(dtype, k):
    """dvals and dx (dX) of ``csr @ x`` / ``csr @ X`` through the port's
    backward against ``jax.grad``; the transposed product on the bucket
    route, named on purpose, gives the backward's dx bitwise."""
    rng = np.random.default_rng(80 + (k or 0))
    n, m = 29, 23
    d, jmat, tmat = _jax_pair(rng, n, m, NP[dtype], pad=6)
    shape = (m,) if k is None else (m, k)
    X = rng.normal(size=shape).astype(NP[dtype])
    G = rng.normal(size=(n,) + shape[1:]).astype(NP[dtype])

    def f(values, Xv):
        return jnp.vdot(jnp.asarray(G), jmat.with_values(values) @ Xv)

    jdv, jdX = jax.grad(f, argnums=(0, 1))(jmat.values, jnp.asarray(X))
    values = tmat.values.clone().requires_grad_(True)
    Xt = torch.from_numpy(X).requires_grad_(True)
    Gt = torch.from_numpy(G)
    before = dict(ct.ROUTES)
    (tmat.with_values(values) @ Xt).backward(Gt)
    assert ct.ROUTES["perm"] == before["perm"] + 1
    aG, aX = np.abs(G).reshape(n, -1), np.abs(X).reshape(m, -1)
    nnz = tmat.nnz
    rows = np.repeat(np.arange(n), np.diff(tmat.rowptr.numpy()))
    scale = np.einsum("pc,pc->p", aG[rows], aX[tmat.colind.numpy()[:nnz]])
    dv = values.grad.numpy()
    assert np.all(np.abs(dv[:nnz] - np.asarray(jdv)[:nnz])
                  <= TOL[dtype] * scale)
    assert np.all(dv[nnz:] == 0)
    scale_x = (np.abs(d).T @ aG).reshape(shape)
    assert np.all(np.abs(Xt.grad.numpy() - np.asarray(jdX))
                  <= TOL[dtype] * scale_x)
    t = transpose_plan(tmat.rowptr, tmat.colind, n, m)
    vals, perm = ct.transposed_values(tmat.rowptr, tmat.colind, t,
                                      tmat.values, m, route="buckets")
    assert torch.equal(vals[perm.to(torch.int64)],
                       tmat.values[t.perm.to(torch.int64)])
    if k is None:
        for route in ("perm", "buckets", "products"):
            assert torch.equal(transposed_spmv(
                tmat.rowptr, tmat.colind, t, tmat.values, Gt, m, route=route),
                Xt.grad)
    else:
        for route in ("perm", "buckets"):
            assert torch.equal(transposed_spmm(
                tmat.rowptr, tmat.colind, t, tmat.values, Gt, m, route=route),
                Xt.grad)
        assert torch.equal(csr_spmm(t.ptr, t.minor, vals, Gt, m, perm=perm),
                           Xt.grad)


def test_module_doctests():
    import doctest

    result = doctest.testmod(ct)
    assert result.attempted > 0 and result.failed == 0
