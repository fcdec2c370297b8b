"""The staged CSR kernels' tile plan, their dispatch and a model of their
walk, and the k = 1 SDDMM's row walk, on the CPU.

``csrc/csr_spmm.cu`` and ``csrc/csr_sddmm.cu`` have a ``staged`` variant:
a CTA owns a tile of consecutive rows and copies the rows ``[c0, c0 + w)``
of ``X`` its slots read (the tile's window, ``csr_tile_plan``) into shared
memory. The plan is a pure function of the structure, so it is held here:
every slot below ``rowptr[-1]`` lies in exactly one tile, in order, and the
window covers every column the tile reads. A pure-torch model of the
staged walk (a windowed gather per tile) gives the plain product and
``dvals``. The dispatch (``csr_spmm_variant``, ``csr_sddmm_variant``)
takes ``staged`` on a banded structure and not on a random one, and the
``STAGE_BUDGET`` boundary is held on both sides over dtypes, ``k`` and
storage offsets. The ``rowwalk`` SDDMM finds each slot's row from
``rowptr`` over the windows of ``csr_spmv_plan``; a model of that search
gives every slot its row. Finally ``csr @ X`` and ``csr @ x`` with their
gradients on a small banded matrix match the JAX package (float64, the
JAX package's own tolerances: 1e-12 forward, 1e-10 gradients). The
kernels themselves are held against the plain versions on the card by
``chip_smoke.py`` (phases 3, 6 and 22).
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
from spalinalg_tpu_torch.ops.kernels import csr_sddmm as sddmm_mod
from spalinalg_tpu_torch.ops.kernels import csr_spmm as spmm_mod
from spalinalg_tpu_torch.ops.kernels.csr_sddmm import (csr_sddmm_plain,
                                                       csr_sddmm_variant)
from spalinalg_tpu_torch.ops.kernels.csr_spmm import (csr_spmm_plain,
                                                      csr_spmm_variant)
from spalinalg_tpu_torch.ops.kernels.csr_spmv import (
    STAGE_BUDGET, TILE_ROWS, TilePlan, build_spmv_plan, build_tile_plan,
    csr_tile_plan, stage_bytes, staged_fits)


@pytest.fixture(autouse=True)
def _cpu_scope():
    """The port's entry points place data on the card unless told
    otherwise; these tests run on the CPU."""
    with tsp.default_device("cpu"):
        yield


DTYPES = {"float32": torch.float32, "float64": torch.float64}
ITEMSIZE = {"float32": 4, "float64": 8}
TOL = {"float32": 1e-5, "float64": 1e-12}
KS = (1, 3, 32, 64, 100)


def _banded(n, lo, hi):
    """Host CSR arrays of the band of offsets ``lo..hi`` clipped at the
    edges (config[1]'s banded matrix is ``-16..16``)."""
    first = np.maximum(np.arange(n) + lo, 0)
    last = np.minimum(np.arange(n) + hi, n - 1)
    lens = last - first + 1
    ptr = np.concatenate([[0], np.cumsum(lens)])
    cols = np.repeat(first - ptr[:-1], lens) + np.arange(ptr[-1])
    return ptr.astype(np.int32), cols.astype(np.int32)


def _random(n, m, mean, rng):
    lens = rng.poisson(mean, n)
    ptr = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    return ptr, rng.integers(0, m, int(ptr[-1])).astype(np.int32)


def _structures():
    """(name, rowptr, colind, ncols) on the host; colind may run past
    ``rowptr[-1]`` (padding slots)."""
    rng = np.random.default_rng(70)
    ptr, cols = _banded(300, -4, 4)
    yield "banded -4..4", ptr, cols, 300
    ptr, cols = _banded(1000, -16, 16)
    yield "banded -16..16", ptr, cols, 1000
    lens = rng.poisson(4, 400)
    lens[::5] = 0                                # empty rows
    lens[64:192] = 0                             # empty tiles
    ptr = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    cols = rng.integers(0, 350, int(ptr[-1]) + 13).astype(np.int32)
    yield "empty rows and tiles, padding", ptr, cols, 350
    lens = rng.poisson(3, 2 * TILE_ROWS + 17)    # a last partial tile
    lens[40] = 500                               # a row wider than a tile
    ptr = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    cols = np.sort(rng.integers(0, 900, int(ptr[-1])).astype(np.int32))
    yield "a wide row, a last partial tile", ptr, cols, 900
    yield "no rows", np.zeros(1, np.int32), np.zeros(3, np.int32), 5
    yield "all empty", np.zeros(70, np.int32), np.zeros(0, np.int32), 5


STRUCTURES = list(_structures())
IDS = [s[0] for s in STRUCTURES]


def _tiles(ptr, cols, rows):
    plan = build_tile_plan(torch.from_numpy(ptr), torch.from_numpy(cols),
                           rows)
    return plan, plan.tiles.tolist()


@pytest.mark.parametrize("rows", [TILE_ROWS, 32, 5])
@pytest.mark.parametrize("name,ptr,cols,m", STRUCTURES, ids=IDS)
def test_tile_plan_covers_every_slot_once_in_order(name, ptr, cols, m, rows):
    plan, tiles = _tiles(ptr, cols, rows)
    nrows, nnz = ptr.size - 1, int(ptr[-1])
    assert plan.tiles.dtype == torch.int32 and plan.rows == rows
    assert plan.ntiles == -(-nrows // rows)
    reads = np.zeros(cols.size, dtype=np.int64)
    prev_end = 0
    for t, (e0, e1, c0, w) in enumerate(tiles):
        r0, r1 = t * rows, min((t + 1) * rows, nrows)
        assert (e0, e1) == (int(ptr[r0]), int(ptr[r1]))   # its rows' slots
        assert e0 == prev_end                              # in order
        prev_end = e1
        reads[e0:e1] += 1
        if e1 > e0:
            read = cols[e0:e1]
            assert c0 == read.min() and c0 + w == read.max() + 1
        else:
            assert (c0, w) == (0, 0)
    assert np.all(reads[:nnz] == 1) and np.all(reads[nnz:] == 0)
    assert plan.max_window == max([w for *_, w in tiles], default=0)
    assert plan.max_slots == max([e1 - e0 for e0, e1, *_ in tiles],
                                 default=0)


def test_tile_plan_is_cached_with_the_structure():
    ptr, cols = (torch.from_numpy(a) for a in _banded(200, -3, 3))
    plan = csr_tile_plan(ptr, cols)
    assert csr_tile_plan(ptr, cols) is plan
    assert csr_tile_plan(ptr, cols, 32) is not plan
    assert csr_tile_plan(ptr, cols, 32).rows == 32
    assert csr_tile_plan(ptr.clone(), cols) is not plan
    assert csr_tile_plan(ptr, cols.clone()) is not plan


def test_tile_plan_refuses_no_rows_a_tile():
    with pytest.raises(ValueError):
        build_tile_plan(torch.zeros(2, dtype=torch.int32),
                        torch.zeros(0, dtype=torch.int32), 0)


def test_tile_plan_chunks_give_the_same_plan(monkeypatch):
    """The plan built over slots in passes (``_TILE_CHUNK``) is the plan
    built in one."""
    from spalinalg_tpu_torch.ops.kernels import csr_spmv as spmv_mod

    rng = np.random.default_rng(71)
    ptr, cols = _random(500, 400, 6, rng)
    whole = build_tile_plan(torch.from_numpy(ptr), torch.from_numpy(cols))
    monkeypatch.setattr(spmv_mod, "_TILE_CHUNK", 97)
    parts = build_tile_plan(torch.from_numpy(ptr), torch.from_numpy(cols))
    assert torch.equal(whole.tiles, parts.tiles)
    assert (whole.max_window, whole.max_slots) == (parts.max_window,
                                                   parts.max_slots)


# ---------------------------------------------------------------------------
# A model of the staged walk


def _staged_spmm_model(ptr, cols, values, X, rows, plan):
    """Each tile gathers its window of X once and runs its rows on it with
    column ids relative to ``c0``, as a staged CTA does."""
    nrows = ptr.numel() - 1
    Y = torch.zeros((nrows, X.shape[1]), dtype=X.dtype)
    for t, (e0, e1, c0, w) in enumerate(plan.tiles.tolist()):
        window = X[c0:c0 + w]
        for r in range(t * rows, min((t + 1) * rows, nrows)):
            p0, p1 = int(ptr[r]), int(ptr[r + 1])
            assert e0 <= p0 <= p1 <= e1
            local = cols[p0:p1].long() - c0
            assert bool((local >= 0).all()) and bool((local < w).all())
            Y[r] = (values[p0:p1, None] * window[local]).sum(0)
    return Y


def _staged_sddmm_model(ptr, cols, G, X, rows, plan):
    nrows = ptr.numel() - 1
    out = torch.zeros(cols.numel(), dtype=X.dtype)   # padding stays 0
    for t, (e0, e1, c0, w) in enumerate(plan.tiles.tolist()):
        window = X[c0:c0 + w]
        g_rows = G[t * rows:min((t + 1) * rows, nrows)]
        for r in range(t * rows, min((t + 1) * rows, nrows)):
            p0, p1 = int(ptr[r]), int(ptr[r + 1])
            local = cols[p0:p1].long() - c0
            out[p0:p1] = (g_rows[r - t * rows][None, :] * window[local]).sum(1)
    return out


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("k", [1, 3, 64])
@pytest.mark.parametrize("name,ptr,cols,m", STRUCTURES[:4], ids=IDS[:4])
def test_staged_model_gives_the_product_and_dvals(name, ptr, cols, m, k,
                                                  dtype):
    rng = np.random.default_rng(72 + k)
    n = ptr.size - 1
    tp, tc = torch.from_numpy(ptr), torch.from_numpy(cols)
    values = torch.from_numpy(rng.normal(size=cols.size)).to(DTYPES[dtype])
    X = torch.from_numpy(rng.normal(size=(m, k))).to(DTYPES[dtype])
    G = torch.from_numpy(rng.normal(size=(n, k))).to(DTYPES[dtype])
    plan = build_tile_plan(tp, tc, TILE_ROWS)
    Y = _staged_spmm_model(tp, tc, values, X, TILE_ROWS, plan)
    ref = csr_spmm_plain(tp, tc, values, X, n)
    scale = csr_spmm_plain(tp, tc, values.abs(), X.abs(), n)
    assert torch.all((Y - ref).abs() <= TOL[dtype] * scale)
    rows = sddmm_mod.SDDMM_TILE_ROWS
    plan = build_tile_plan(tp, tc, rows)
    out = _staged_sddmm_model(tp, tc, G, X, rows, plan)
    major = major_ids(tp, cols.size)
    ref = csr_sddmm_plain(major, tc, G, X, n)
    scale = csr_sddmm_plain(major, tc, G.abs(), X.abs(), n)
    assert torch.all((out - ref).abs() <= TOL[dtype] * scale)
    assert torch.all(out[int(ptr[-1]):] == 0)


def _rowwalk_rows(ptr, plan):
    """A model of the rowwalk kernel: per slot the row a window warp's
    search (the count of row ends at or before it) or a piece warp gives;
    -1 where no warp writes (padding)."""
    windows, piece_row, piece_start, _, _ = (t.tolist() for t in plan.parts())
    nnz = int(ptr[-1])
    rows = np.full(nnz, -1)
    for r0, r1, e0, e1 in windows:
        ends = ptr[r0 + 1:r1 + 1]
        for p in range(e0, e1):
            assert rows[p] == -1
            rows[p] = r0 + int(np.sum(ends <= p))
    for row, start in zip(piece_row, piece_start):
        for p in range(start, min(start + 256, int(ptr[row + 1]))):
            assert rows[p] == -1
            rows[p] = row
    return rows


@pytest.mark.parametrize("name,ptr,cols,m", STRUCTURES[:-2] + STRUCTURES[-1:],
                         ids=IDS[:-2] + IDS[-1:])
def test_rowwalk_model_gives_every_slot_its_row(name, ptr, cols, m):
    """(A matrix with no rows launches nothing: the wrapper returns its
    zeros first.)"""
    plan = build_spmv_plan(torch.from_numpy(ptr))
    rows = _rowwalk_rows(ptr, plan)
    want = major_ids(torch.from_numpy(ptr), int(ptr[-1])).numpy()
    assert np.array_equal(rows, want)


def test_rowwalk_model_on_long_and_empty_rows():
    lens = np.array([0, 3, 700, 0, 0, 256, 257, 1, 0, 513] + [2] * 300)
    ptr = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    plan = build_spmv_plan(torch.from_numpy(ptr))
    assert plan.npieces > 0
    rows = _rowwalk_rows(ptr, plan)
    assert np.array_equal(rows, np.repeat(np.arange(lens.size), lens))


# ---------------------------------------------------------------------------
# The dispatch


def _plans(n=4 * TILE_ROWS):
    rng = np.random.default_rng(73)
    banded = [torch.from_numpy(a) for a in _banded(n, -16, 16)]
    random = [torch.from_numpy(a) for a in _random(n, 50_000, 33, rng)]
    return {name: (ptr, cols) for name, (ptr, cols) in
            (("banded", banded), ("random", random))}


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("k", [1, 64])
def test_staged_on_banded_and_not_on_random(dtype, k):
    for name, (ptr, cols) in _plans().items():
        X = torch.zeros(50_000, k, dtype=DTYPES[dtype])
        G = torch.zeros(ptr.numel() - 1, k, dtype=DTYPES[dtype])
        mm = csr_spmm_variant(X, build_tile_plan(ptr, cols))
        sd = csr_sddmm_variant(
            G, X, build_tile_plan(ptr, cols, sddmm_mod.SDDMM_TILE_ROWS), cols)
        if name == "banded":
            assert (mm, sd) == ("staged", "staged")
        else:
            assert mm == ("vector" if dtype == "float32" and k % 4 == 0
                          else "register")
            assert sd == ("vector" if ITEMSIZE[dtype] * k % 16 == 0
                          else "rowwalk")


def _view(shape, dtype, shift):
    n = int(np.prod(shape))
    base = torch.zeros(n + 1, dtype=dtype)
    return (base[1:] if shift else base[:-1]).view(shape)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("side", ["under", "at", "over"])
@pytest.mark.parametrize("shift", [False, True])
def test_spmm_budget_boundary(dtype, k, side, shift):
    """staged where the widest window fits STAGE_BUDGET (at or under it)
    and X starts on a 16-byte boundary; otherwise the variant the dispatch
    took before (vector for float32 rows of whole 16-byte vectors, else
    register)."""
    row = k * ITEMSIZE[dtype]
    width = STAGE_BUDGET // row + {"under": -1, "at": 0, "over": 1}[side]
    plan = TilePlan(torch.zeros(1, 4, dtype=torch.int32), TILE_ROWS, width,
                    TILE_ROWS)
    fits = width * row <= STAGE_BUDGET
    assert fits == (side != "over")
    assert staged_fits(plan, k, ITEMSIZE[dtype]) == fits
    X = _view((9, k), DTYPES[dtype], shift)
    vector = dtype == "float32" and k % 4 == 0 and not shift
    want = "staged" if fits and not shift else (
        "vector" if vector else "register")
    assert csr_spmm_variant(X, plan) == want
    assert csr_spmm_variant(X) == ("vector" if vector else "register")


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("side", ["under", "at", "over"])
@pytest.mark.parametrize("shift", [None, "G", "X", "colind"])
def test_sddmm_budget_boundary(dtype, k, side, shift):
    """staged where the window of X, a tile's rows of G and its column ids
    fit STAGE_BUDGET and X, G and colind start on a 16-byte boundary;
    otherwise vector (whole 16-byte rows, G and X aligned), rowwalk (k =
    1), or scalar."""
    rows = sddmm_mod.SDDMM_TILE_ROWS
    row, slots = k * ITEMSIZE[dtype], 4 * rows
    width = (STAGE_BUDGET - 4 * slots) // row - rows \
        + {"under": -1, "at": 0, "over": 1}[side]
    plan = TilePlan(torch.zeros(1, 4, dtype=torch.int32), rows, width, slots)
    nbytes = stage_bytes(plan, k, ITEMSIZE[dtype], with_rows=True)
    assert nbytes == (width + rows) * row + 4 * slots
    fits = nbytes <= STAGE_BUDGET
    assert fits == (side != "over")
    G = _view((7, k), DTYPES[dtype], shift == "G")
    X = _view((9, k), DTYPES[dtype], shift == "X")
    colind = _view((11,), torch.int32, shift == "colind")
    whole = row % 16 == 0 and shift not in ("G", "X")
    want = ("staged" if fits and shift is None else "vector" if whole
            else "rowwalk" if k == 1 else "scalar")
    assert csr_sddmm_variant(G, X, plan, colind) == want
    assert csr_sddmm_variant(G, X) == ("vector" if whole else "rowwalk"
                                       if k == 1 else "scalar")


def test_variant_names_are_checked():
    ptr, cols = (torch.from_numpy(a) for a in _banded(20, -2, 2))
    vals = torch.ones(cols.numel())
    with pytest.raises(ValueError, match="unknown csr_spmm variant"):
        spmm_mod.csr_spmm(ptr, cols, vals, torch.ones(20, 3), 20,
                          variant="tiled")
    # "finish" counts the second kernel of a launch with pieces; it names
    # no variant
    with pytest.raises(ValueError, match="unknown csr_spmm variant"):
        spmm_mod.csr_spmm(ptr, cols, vals, torch.ones(20, 3), 20,
                          variant="finish")
    assert set(spmm_mod.VARIANT_LAUNCHES) == {"register", "vector", "staged",
                                              "finish"}
    assert set(sddmm_mod.VARIANT_LAUNCHES) == {"scalar", "vector", "staged",
                                               "rowwalk"}


@pytest.mark.parametrize("variant", [None, "register", "vector", "staged"])
def test_named_variant_runs_the_plain_version_on_the_cpu(variant):
    """On CPU tensors a named variant changes nothing: the plain version
    runs and no kernel launch is counted."""
    ptr, cols = (torch.from_numpy(a) for a in _banded(40, -3, 3))
    rng = np.random.default_rng(74)
    vals = torch.from_numpy(rng.normal(size=cols.numel()))
    X = torch.from_numpy(rng.normal(size=(40, 5)))
    before = (dict(spmm_mod.LAUNCHES), dict(spmm_mod.VARIANT_LAUNCHES))
    Y = spmm_mod.csr_spmm(ptr, cols, vals, X, 40, variant=variant)
    assert torch.equal(Y, csr_spmm_plain(ptr, cols, vals, X, 40))
    assert (dict(spmm_mod.LAUNCHES), dict(spmm_mod.VARIANT_LAUNCHES)) == before
    out = sddmm_mod.csr_sddmm(ptr, cols, X, X, 40,
                              variant=None if variant is None else "staged")
    assert torch.equal(out, csr_sddmm_plain(major_ids(ptr, cols.numel()),
                                            cols, X, X, 40))


# ---------------------------------------------------------------------------
# The slice on a small banded matrix against the JAX package


def _banded_pair(n=300, lo=-4, hi=4):
    rng = np.random.default_rng(75)
    ptr, cols = _banded(n, lo, hi)
    vals = rng.normal(size=cols.size)
    jmat = jsp.CsrMatrix._from_parts(n, n, jnp.asarray(ptr), jnp.asarray(cols),
                                     jnp.asarray(vals))
    return jmat, csr_from_arrays(n, n, ptr, cols, vals), rng


@pytest.mark.parametrize("k", [None, 1, 3, 64])
def test_banded_product_and_gradients_match_jax(k):
    """``csr @ x`` / ``csr @ X`` forward (rtol 1e-12) and the gradients
    to the values and the operand (rtol 1e-10), as the JAX package's
    tests hold its own, on the banded matrix of offsets -4..4 at n = 300
    in float64."""
    jmat, tmat, rng = _banded_pair()
    n = jmat.shape[0]
    shape = (n,) if k is None else (n, k)
    X = rng.normal(size=shape)
    G = rng.normal(size=shape)
    np.testing.assert_allclose((tmat @ torch.from_numpy(X)).numpy(),
                               np.asarray(jmat @ jnp.asarray(X)), rtol=1e-12)

    def f(values, Xv):
        return jnp.vdot(jnp.asarray(G), jmat.with_values(values) @ Xv)

    jdv, jdX = jax.grad(f, argnums=(0, 1))(jmat.values, jnp.asarray(X))
    values = tmat.values.clone().requires_grad_(True)
    Xt = torch.from_numpy(X).requires_grad_(True)
    (tmat.with_values(values) @ Xt).backward(torch.from_numpy(G))
    np.testing.assert_allclose(values.grad.numpy(), np.asarray(jdv),
                               rtol=1e-10)
    np.testing.assert_allclose(Xt.grad.numpy(), np.asarray(jdX), rtol=1e-10)
