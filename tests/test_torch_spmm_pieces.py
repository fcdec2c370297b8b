"""The CSR SpMM's long rows in pieces (``csrc/csr_spmm.cu``'s piece warps and
``csr_spmm_finish``; ``ops/kernels/csr_spmm.py``'s ``row_split`` and
``row_pieces``).

On the CPU: a model of the kernel's grid over the SpMV's long-row plan
(piece warps first, then a warp a row; a long row's warp writes nothing)
reads every slot below ``rowptr[-1]`` exactly once, in order, and none past
it; the gate is ``one_row_bounds`` on the structure, with pieces only where
some row is longer than ``BUDGET``; the plain emulation of the pieces'
partials added in piece order gives the plain product.

On the card (the tests marked ``card``; they skip without one): the
kernels on a power-law structure with a 150,000-entry row and padding
slots, at k in {1, 3, 47, 64, 256}, float32 and float64, with and without
``perm``, in the register and vector variants, against the plain version,
bitwise from call to call, with the launch counters; a structure whose
longest row does not bound the launch launches no finishing kernel. This
file imports no JAX, so that it runs on a machine without it:

    python -m pytest tests/test_torch_spmm_pieces.py --noconftest -q
"""

import numpy as np
import pytest
import torch

import spalinalg_tpu_torch as tsp
from spalinalg_tpu_torch.ops.kernels import csr_spmm as spmm_mod
from spalinalg_tpu_torch.ops.kernels.csr_spmm import (
    PIECED, VARIANT_LAUNCHES, csr_spmm, csr_spmm_plain, kernel_path,
    one_row_bounds, row_pieces, row_split, row_split_of)
from spalinalg_tpu_torch.ops.kernels.csr_spmv import (BUDGET, build_spmv_plan,
                                                      csr_spmv_plan)

DTYPES = {"float32": torch.float32, "float64": torch.float64}
TOL = {"float32": 1e-5, "float64": 1e-12}
SMS = 132   # an H100's


@pytest.fixture
def cpu():
    """The port's entry points place data on the card unless told
    otherwise; the CPU tests run on the CPU."""
    with tsp.default_device("cpu"):
        yield torch.device("cpu")


@pytest.fixture
def card():
    """The first CUDA card; skips the test where there is none (decided
    when the test runs, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the SpMM's piece kernels run only "
                    "there")
    return torch.device("cuda", 0)


def _rowptr(lens):
    return torch.from_numpy(np.concatenate(
        [[0], np.cumsum(np.asarray(lens, dtype=np.int64))]).astype(np.int32))


def _structures():
    rng = np.random.default_rng(51)
    yield "empty rows", [0] * 6
    yield "uniform 32", [32] * 40
    yield "exactly the budget", [BUDGET, BUDGET + 1, BUDGET - 1, 2 * BUDGET,
                                 2 * BUDGET + 1, 0, 0]
    lens = list(rng.poisson(4, 500))
    lens[17] = 150_000
    yield "one row of 150,000", lens
    yield "long rows first and last", [3 * BUDGET + 7] + [2] * 30 + [
        BUDGET + 1]
    yield "power law", list(np.minimum(rng.zipf(1.6, 3000), 20_000))


STRUCTURES = list(_structures())
IDS = [name for name, _ in STRUCTURES]


def _grid(rowptr, plan):
    """A model of the register and vector kernels' grid with pieces, warp
    by warp in launch order: ``("piece", w, start, end)`` for a piece warp
    (its partial is row ``w`` of the scratch), ``("row", r, start, end)``
    for a row warp that writes row ``r``; a long row's warp writes
    nothing. And the finishing kernel's pieces a long row."""
    ptr = rowptr.tolist()
    _, piece_row, piece_start, long_rows, first = (t.tolist()
                                                   for t in plan.parts())
    warps = [("piece", w, start, min(start + BUDGET, ptr[row + 1]))
             for w, (row, start) in enumerate(zip(piece_row, piece_start))]
    for r in range(len(ptr) - 1):
        if not (plan.npieces and ptr[r + 1] - ptr[r] > BUDGET):
            warps.append(("row", r, ptr[r], ptr[r + 1]))
    finish = {row: list(range(first[i], first[i + 1]))
              for i, row in enumerate(long_rows)}
    return warps, finish, piece_row


@pytest.mark.parametrize("pad", [0, 13])
@pytest.mark.parametrize("name,lens", STRUCTURES, ids=IDS)
def test_every_slot_in_one_short_row_or_one_piece(name, lens, pad):
    """Below ``rowptr[-1]`` every slot lies in exactly one short row's walk
    or one piece, in order; padding slots in none; every row is written
    once, a long one by the finishing kernel from its pieces in order."""
    lens = np.asarray(lens, dtype=np.int64)
    rowptr = _rowptr(lens)
    nnz, nrows = int(rowptr[-1]), lens.size
    warps, finish, piece_row = _grid(rowptr, build_spmv_plan(rowptr))
    reads = np.zeros(nnz + pad, dtype=np.int64)
    kinds = [kind for kind, *_ in warps]
    assert kinds == sorted(kinds)          # "piece" < "row": pieces first
    for kind, i, start, end in warps:
        assert start <= end
        if kind == "piece":
            assert 0 < end - start <= BUDGET
        else:
            assert end - start == lens[i] <= BUDGET
        reads[start:end] += 1
    assert np.all(reads[:nnz] == 1) and np.all(reads[nnz:] == 0)
    written = [i for kind, i, *_ in warps if kind == "row"] + sorted(finish)
    assert sorted(written) == list(range(nrows))
    assert sorted(finish) == [r for r in range(nrows) if lens[r] > BUDGET]
    for row, idx in finish.items():
        spans = [warps[w][2:] for w in idx]
        assert all(piece_row[w] == row for w in idx)
        assert spans[0][0] == int(rowptr[row])
        assert spans[-1][1] == int(rowptr[row + 1])
        assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))


@pytest.mark.parametrize("sms", [1, 8, SMS])
@pytest.mark.parametrize("name,lens", STRUCTURES, ids=IDS)
def test_gate_follows_one_row_bounds(name, lens, sms):
    lens = np.asarray(lens, dtype=np.int64)
    rowptr = _rowptr(lens)
    split = row_split_of(rowptr, sms)
    longest, nnz = int(lens.max()), int(lens.sum())
    assert split.bounded == one_row_bounds(longest, nnz, sms)
    assert split.slots == int(lens[lens > BUDGET].sum())
    assert split.pieced == (split.bounded and longest > BUDGET)


def test_gate_on_real_sizes():
    """graph500-s22's adjacency with self-loops (longest row 163,243 of
    132,503,278 entries) splits; csr_random at n = 2**19 (32 a row) and
    the banded matrix (33 a row) do not, nor does a 150-entry row among
    2**19 rows of 32."""
    assert one_row_bounds(163_243, 132_503_278, SMS)
    assert not one_row_bounds(32, 32 * 2**19, SMS)
    assert not one_row_bounds(33, 33 * 2**19, SMS)
    assert not one_row_bounds(150, 32 * 2**19, SMS)


def test_wrapper_gate_is_cached_per_rowptr(cpu, monkeypatch):
    """``row_split`` decides once per ``rowptr`` on its card's SM count;
    ``row_pieces`` is the SpMV's cached plan where that split is pieced,
    else None."""
    calls = []

    class Props:
        multi_processor_count = SMS

    def props(device):
        calls.append(device)
        return Props()

    monkeypatch.setattr(torch.cuda, "get_device_properties", props)
    long_ptr = _rowptr([3, 2 * BUDGET, 1])
    short_ptr = _rowptr([3, BUDGET, 1])        # bounded, nothing to split
    even_ptr = _rowptr([BUDGET + 1] * 2 * SMS * 64)   # long, not bounded
    assert row_split(long_ptr) is row_split(long_ptr)
    assert len(calls) == 1
    assert row_pieces(long_ptr) is csr_spmv_plan(long_ptr)
    assert row_pieces(long_ptr).npieces == 2
    assert row_split(short_ptr).bounded and row_pieces(short_ptr) is None
    assert row_split(even_ptr).slots and not row_split(even_ptr).bounded
    assert row_pieces(even_ptr) is None
    assert row_split(long_ptr.clone()) is not row_split(long_ptr)


def _emulate(rowptr, colind, values, X, nrows):
    """Plain torch in the kernel's order with pieces: a short row's sum, a
    long row's pieces each summed, then their partials added in piece
    order."""
    plan = build_spmv_plan(rowptr)
    warps, finish, _ = _grid(rowptr, plan)
    prod = values[:, None] * X[colind.long()]
    Y = torch.full((nrows, X.shape[1]), float("nan"), dtype=X.dtype)
    partial = {}
    for kind, i, start, end in warps:
        s = prod[start:end].sum(0)
        if kind == "piece":
            partial[i] = s
        else:
            Y[i] = s
    for row, idx in finish.items():
        acc = torch.zeros(X.shape[1], dtype=X.dtype)
        for w in idx:
            acc = acc + partial[w]
        Y[row] = acc
    return Y


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("k", [1, 3, 47])
@pytest.mark.parametrize("use_perm", [False, True])
def test_piece_order_gives_the_plain_product(cpu, dtype, k, use_perm):
    rng = np.random.default_rng(52)
    lens = rng.poisson(5, 300)
    lens[7], lens[100], lens[299] = 3000, BUDGET + 1, 2 * BUDGET
    lens[::11] = 0
    rowptr = _rowptr(lens)
    nse, ncols = int(rowptr[-1]) + 9, 250      # 9 padding slots
    colind = torch.from_numpy(rng.integers(0, ncols, nse).astype(np.int32))
    values = torch.from_numpy(rng.normal(size=nse)).to(DTYPES[dtype])
    X = torch.from_numpy(rng.normal(size=(ncols, k))).to(DTYPES[dtype])
    if use_perm:
        perm = torch.from_numpy(rng.permutation(nse).astype(np.int32))
        values = values[perm.long()]
    Y = _emulate(rowptr, colind, values, X, lens.size)
    ref = csr_spmm_plain(rowptr, colind, values, X, lens.size)
    scale = csr_spmm_plain(rowptr, colind, values.abs(), X.abs(), lens.size)
    assert torch.all((Y - ref).abs() <= TOL[dtype] * scale)


def test_no_pieces_off_the_card(cpu):
    """On CPU tensors the wrapper runs the plain version: no launch, no
    piece count, the path ``plain``."""
    rowptr = _rowptr([3, 2 * BUDGET, 1])
    colind = torch.zeros(int(rowptr[-1]), dtype=torch.int32)
    values = torch.ones(colind.numel())
    X = torch.ones(1, 4)
    before = (dict(VARIANT_LAUNCHES), dict(PIECED))
    csr_spmm(rowptr, colind, values, X, 3)
    assert (dict(VARIANT_LAUNCHES), dict(PIECED)) == before
    assert kernel_path(rowptr, colind, values, X) == "plain"


# ---------------------------------------------------------------------------
# On the card


def _power_law(device, pad: int = 37):
    """``(rowptr, colind, ncols)``: 2**17 rows of zipf lengths up to 4,000,
    one row of 150,000 entries, rows of BUDGET - 1 to 2 * BUDGET + 1, empty
    rows, and ``pad`` padding slots."""
    rng = np.random.default_rng(53)
    n = 2**17
    lens = np.minimum(rng.zipf(1.7, n), 4000)
    lens[::13] = 0
    lens[1000] = 150_000
    lens[2000:2005] = [BUDGET - 1, BUDGET, BUDGET + 1, 2 * BUDGET,
                       2 * BUDGET + 1]
    ptr = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    cols = rng.integers(0, n, int(ptr[-1]) + pad).astype(np.int32)
    return (torch.from_numpy(ptr).to(device),
            torch.from_numpy(cols).to(device), n)


CARD_CASES = ([("register", d, k) for d in DTYPES for k in (1, 3, 47, 64, 256)]
              + [("vector", "float32", k) for k in (64, 256)])


@pytest.mark.card
@pytest.mark.parametrize("use_perm", [False, True])
@pytest.mark.parametrize("variant,dtype,k", CARD_CASES)
def test_pieces_on_the_card(card, variant, dtype, k, use_perm):
    rowptr, colind, n = _power_law(card)
    nse = colind.numel()
    gen = torch.Generator(device=card)
    gen.manual_seed(54)
    values = torch.randn(nse, generator=gen, dtype=DTYPES[dtype], device=card)
    X = torch.randn(n, k, generator=gen, dtype=DTYPES[dtype], device=card)
    perm = (torch.randperm(nse, generator=gen, device=card).to(torch.int32)
            if use_perm else None)
    split = row_split(rowptr)
    assert split.pieced
    before = (dict(VARIANT_LAUNCHES), dict(PIECED))
    Y = csr_spmm(rowptr, colind, values, X, n, perm=perm, variant=variant)
    assert VARIANT_LAUNCHES[variant] == before[0][variant] + 1
    assert VARIANT_LAUNCHES["finish"] == before[0]["finish"] + 1
    assert PIECED == {"launches": before[1]["launches"] + 1,
                      "slots": before[1]["slots"] + split.slots}
    assert torch.equal(Y, csr_spmm(rowptr, colind, values, X, n, perm=perm,
                                   variant=variant))
    v = values if perm is None else values[perm.long()]
    if perm is not None:
        assert torch.equal(Y, csr_spmm(rowptr, colind, v, X, n,
                                       variant=variant))
    ref = csr_spmm_plain(rowptr, colind, v, X, n)
    scale = csr_spmm_plain(rowptr, colind, v.abs(), X.abs(), n)
    assert bool(((Y - ref).abs() <= TOL[dtype] * scale).all())
    # a short row is walked by a warp of its own as before: its bits are
    # those of the same structure with the long rows emptied, which splits
    # nothing
    lens = rowptr[1:] - rowptr[:-1]
    short = lens <= BUDGET
    kept = torch.where(short, lens, 0).to(torch.int64)
    starts = torch.repeat_interleave(rowptr[:-1].to(torch.int64), kept)
    firsts = torch.repeat_interleave(torch.cumsum(kept, 0) - kept, kept)
    slots = starts + torch.arange(int(kept.sum()), device=card) - firsts
    sub_ptr = torch.cat([kept.new_zeros(1), torch.cumsum(kept, 0)]).to(
        torch.int32)
    assert not row_split(sub_ptr).pieced
    finishes = VARIANT_LAUNCHES["finish"]
    Y_short = csr_spmm(sub_ptr, colind[slots], v[slots], X, n,
                       variant=variant)
    assert VARIANT_LAUNCHES["finish"] == finishes
    assert torch.equal(Y[short], Y_short[short])


@pytest.mark.card
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_no_finish_where_no_row_bounds_the_launch(card, dtype):
    """csr_random at n = 2**17 (32 a row) with one row of 300 entries, past
    BUDGET but short of a resident warp's share of the launch: the gate is
    false, so no piece, no finishing kernel, no ``+pieces``."""
    n = 2**17
    lens = torch.full((n,), 32, dtype=torch.int64)
    lens[5] = 300
    rowptr = torch.cat([lens.new_zeros(1), torch.cumsum(lens, 0)]).to(
        device=card, dtype=torch.int32)
    gen = torch.Generator(device=card)
    gen.manual_seed(55)
    nse = int(lens.sum())
    colind = torch.randint(0, n, (nse,), generator=gen, device=card,
                           dtype=torch.int32)
    values = torch.randn(nse, generator=gen, dtype=DTYPES[dtype], device=card)
    X = torch.randn(n, 64, generator=gen, dtype=DTYPES[dtype], device=card)
    assert not row_split(rowptr).bounded and row_pieces(rowptr) is None
    before = (dict(VARIANT_LAUNCHES), dict(PIECED), dict(spmm_mod.LAUNCHES))
    Y = csr_spmm(rowptr, colind, values, X, n)
    assert VARIANT_LAUNCHES["finish"] == before[0]["finish"]
    assert PIECED == before[1]
    assert sum(spmm_mod.LAUNCHES.values()) == sum(before[2].values()) + 1
    assert "+pieces" not in kernel_path(rowptr, colind, values, X)
    ref = csr_spmm_plain(rowptr, colind, values, X, n)
    scale = csr_spmm_plain(rowptr, colind, values.abs(), X.abs(), n)
    assert bool(((Y - ref).abs() <= TOL[dtype] * scale).all())


@pytest.mark.card
def test_metrics_path_names_the_pieces(card):
    rowptr, colind, n = _power_law(card)
    values = torch.ones(colind.numel(), device=card)
    assert kernel_path(rowptr, colind, values,
                       torch.ones(n, 256, device=card)) == "cuda:vector+pieces"
    assert kernel_path(rowptr, colind, values,
                       torch.ones(n, 47, device=card)) == (
        "cuda:register+pieces")
