"""The stored-diagonal kernel (``csrc/diagonal.cu``) and its plain version
(``ops/kernels/diagonal.py``), in the PyTorch port alone (no JAX here, so
the tests marked ``card`` also run on a card: ``python -m pytest
--noconftest -p no:cacheprovider tests/test_torch_diagonal_kernel.py -m
card``).

On the CPU: CPU tensors take the plain version and launch nothing; it
matches scipy's ``diagonal(k)`` and a row-by-row walk that keeps the last
hit, for ``k`` in {0, ±1, ±3} on rectangular shapes with duplicates,
padding slots, empty rows and a row with no diagonal entry, in float32
and float64 (and bfloat16), and for BSR blocks of 2 and 3 with missing
and duplicated diagonal blocks; ``invert`` maps zero and missing entries
to 1; a tensor on another device raises; the C entry points take pointers
and 64-bit integers.

On the card: the kernel equals the plain version bit for bit on those
cases with both index loads (16-byte and, off a 16-byte boundary, one
index a lane), on a row of 100,000 entries, a 27-point stencil at 32^3
and PETSc ex56's 3 x 3 block pattern; one launch
a ``diagonal`` call and a Jacobi set-up; ``cg`` with ``"jacobi"`` gives
the bits and the iteration count of ``cg`` with the built-in Jacobi
around the plain inverse.
"""

import ctypes

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import spalinalg_tpu_torch as tsp
from spalinalg_tpu_torch import BsrMatrix, CsrMatrix
from spalinalg_tpu_torch.errors import DTypeError, ShapeError
from spalinalg_tpu_torch.linalg import cg
from spalinalg_tpu_torch.linalg.cg import Jacobi
from spalinalg_tpu_torch.ops.kernels import _build
from spalinalg_tpu_torch.ops.kernels import diagonal as diag_mod
from spalinalg_tpu_torch.ops.kernels.diagonal import (diagonal,
                                                      diagonal_plain)
from spalinalg_tpu_torch.ops.reduce_api import diagonal as mat_diagonal
from spalinalg_tpu_torch.utils import metrics


@pytest.fixture(autouse=True)
def _cpu_scope():
    """The port's entry points place data on the card unless told
    otherwise; these tests run on the CPU unless they name the card."""
    with tsp.default_device("cpu"):
        yield


@pytest.fixture
def card():
    """The first CUDA card; skips the test where there is none (decided
    when the test runs, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


DTYPES = {"float32": torch.float32, "float64": torch.float64}
KS = [0, 1, -1, 3, -3]
SHAPES = [(9, 12), (12, 9)]
PAD = 5


def _csr_case(nrows, ncols, dtype, seed=0):
    """``(ptr, idx, values)`` (int32, int32, ``dtype``) of a random
    ``nrows x ncols`` pattern: rows 2 and 5 empty, the entries of row 4 all
    off every diagonal tested (none in columns 1..7), a diagonal slot of
    rows 0 and 6 stored again later in the row (k = 0 and k = 1) with
    another value, columns unsorted, and ``PAD`` padding slots past
    ``ptr[-1]`` whose indices hit every diagonal."""
    rng = np.random.default_rng(seed)
    rows = []
    for r in range(nrows):
        if r in (2, 5):
            cols = []
        elif r == 4:
            cols = [c for c in (0, 8, 9, 10, 11) if c < ncols]
        else:
            cols = list(rng.choice(ncols, size=min(ncols, 6), replace=False))
            if r in (0, 6):
                cols += [c for c in (r, r + 1) if c < ncols]
        rows.append(cols)
    lens = [len(c) for c in rows]
    ptr = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    idx = np.concatenate([np.asarray(c, dtype=np.int32) for c in rows]
                         + [np.arange(PAD, dtype=np.int32) % ncols])
    values = rng.normal(size=idx.size)
    return (torch.from_numpy(ptr), torch.from_numpy(idx),
            torch.from_numpy(values).to(dtype))


def _bsr_case(nbr, nbc, b, dtype, seed=0):
    """``(indptr, indices, data)`` of a random block pattern: block rows 1
    and 3 without a diagonal block, block row 2 empty, the diagonal block
    of block rows 0 and 4 stored twice, and ``PAD`` padding blocks past
    ``indptr[-1]`` on the diagonal."""
    rng = np.random.default_rng(seed)
    rows = []
    for r in range(nbr):
        if r == 2:
            cols = []
        else:
            cols = [c for c in rng.choice(nbc, size=min(nbc, 3),
                                          replace=False)
                    if not (r in (1, 3) and c == r)]
            if r in (0, 4) and r < nbc:
                cols = [r] + cols + [r]
        rows.append(cols)
    lens = [len(c) for c in rows]
    indptr = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    indices = np.concatenate([np.asarray(c, dtype=np.int32) for c in rows]
                             + [np.arange(PAD, dtype=np.int32) % nbc])
    data = rng.normal(size=(indices.size, b, b))
    return (torch.from_numpy(indptr), torch.from_numpy(indices),
            torch.from_numpy(data).to(dtype))


def _length(nrows, ncols, k):
    return min(nrows + min(k, 0), ncols - max(k, 0))


def _walk(ptr, idx, values, length, k=0):
    """Row by row in Python: each output row's last hit, its ``b``
    diagonal values (float64), zeros where there is none."""
    ptr, idx = ptr.tolist(), idx.tolist()
    vals = values.double().numpy()
    b = 1 if vals.ndim == 1 else vals.shape[1]
    out = np.zeros(length * b)
    for i in range(length):
        r = i + max(-k, 0)
        hits = [p for p in range(ptr[r], ptr[r + 1]) if idx[p] == r + k]
        if hits:
            v = vals[hits[-1]]
            out[i * b:(i + 1) * b] = v if b == 1 else np.diag(v)
    return out


def _cases():
    """Every CSR and BSR case: ``(id, (ptr, idx, values, length, k))``."""
    out = []
    for name, dtype in DTYPES.items():
        for nrows, ncols in SHAPES:
            for k in KS:
                out.append((f"csr-{nrows}x{ncols}-k{k}-{name}",
                            (*_csr_case(nrows, ncols, dtype, seed=nrows + k),
                             _length(nrows, ncols, k), k)))
        for b, nbr, nbc in ((2, 6, 6), (3, 7, 5), (3, 5, 8)):
            out.append((f"bsr-{b}-{nbr}x{nbc}-{name}",
                        (*_bsr_case(nbr, nbc, b, dtype, seed=b + nbr),
                         min(nbr, nbc), 0)))
    return out


CASES = _cases()
CASE_IDS = [c[0] for c in CASES]


@pytest.mark.parametrize("case", [c[1] for c in CASES], ids=CASE_IDS)
def test_plain_version_keeps_the_last_hit(case):
    ptr, idx, values, length, k = case
    before = dict(diag_mod.LAUNCHES)
    got = diagonal(ptr, idx, values, length, k)
    assert diag_mod.LAUNCHES == before
    assert got.dtype == values.dtype and got.device.type == "cpu"
    b = 1 if values.ndim == 1 else values.shape[1]
    assert got.shape == (length * b,)
    np.testing.assert_array_equal(got.double().numpy(),
                                  _walk(ptr, idx, values, length, k))
    assert torch.equal(got, diagonal_plain(ptr, idx, values, length, k))


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("shape", SHAPES, ids=["wide", "tall"])
@pytest.mark.parametrize("dtype", list(DTYPES.values()),
                         ids=list(DTYPES))
def test_matches_scipy(k, shape, dtype):
    """Without duplicates scipy's ``diagonal(k)`` is the same function
    (scipy sums a slot stored twice)."""
    nrows, ncols = shape
    rng = np.random.default_rng(abs(k) + nrows)
    dense = np.where(rng.random(shape) < 0.4, rng.normal(size=shape), 0)
    dense[1, :] = 0                                     # an empty row
    ref = sps.csr_matrix(dense)
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    a = CsrMatrix(nrows, ncols, ref.indptr, ref.indices,
                  ref.data.astype(np_dtype))
    assert a.dtype == dtype
    got = mat_diagonal(a, k)
    np.testing.assert_array_equal(got.numpy(),
                                  ref.diagonal(k).astype(got.numpy().dtype))


@pytest.mark.parametrize("case", [c[1] for c in CASES], ids=CASE_IDS)
def test_invert_maps_zero_and_missing_to_one(case):
    ptr, idx, values, length, k = case
    values = values.clone()
    values[::3] = 0                           # some diagonal entries are 0
    d = diagonal(ptr, idx, values, length, k)
    inv = diagonal(ptr, idx, values, length, k, invert=True)
    want = torch.where(d != 0, 1 / torch.where(d != 0, d, 1), 1)
    assert torch.equal(inv, want)
    assert bool((inv[d == 0] == 1).all())
    assert bool((d == 0).any()) and bool((d != 0).any())


def test_entry_points_take_pointers_and_64_bit_integers():
    for t in ("f32", "bf16", "f64"):
        types = _build._ENTRIES[f"spal_diagonal_{t}"]
        assert len(types) == 11
        assert types[:4] == [ctypes.c_void_p] * 4
        assert types[-1] is ctypes.c_void_p
        assert all(ctypes.sizeof(a) == 8 for a in types)
        assert all(a in (ctypes.c_void_p, ctypes.c_longlong) for a in types)


@pytest.mark.parametrize("case", [c[1] for c in CASES if c[1][2].dtype
                                  == torch.float32],
                         ids=[c[0].replace("float32", "bfloat16")
                              for c in CASES if c[1][2].dtype
                              == torch.float32])
def test_plain_version_in_bfloat16(case):
    """bfloat16 values: the stored entries copied exactly, and the inverse
    rounded once from float32's."""
    ptr, idx, values, length, k = case
    values = values.to(torch.bfloat16)
    got = diagonal(ptr, idx, values, length, k)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.double().numpy(),
                                  _walk(ptr, idx, values, length, k))
    inv = diagonal(ptr, idx, values, length, k, invert=True)
    want = torch.where(got != 0, 1 / torch.where(got != 0, got, 1), 1)
    assert torch.equal(inv, want)


def test_no_kernel_for_another_device():
    """A tensor on neither the CPU nor a CUDA card raises: no fallback."""
    ptr, idx, values = (t.to("meta") for t in _csr_case(9, 12,
                                                         torch.float64))
    with pytest.raises(ValueError, match="no diagonal kernel"):
        diagonal(ptr, idx, values, 9)


def test_checks_its_operands():
    ptr, idx, values = _csr_case(9, 12, torch.float64)
    with pytest.raises(DTypeError):
        diagonal(ptr.long(), idx, values, 9)
    with pytest.raises(ShapeError):
        diagonal(ptr, idx, values, 10)                # past the rows
    with pytest.raises(ShapeError):
        diagonal(ptr, idx, values.reshape(-1, 1), 9)
    indptr, indices, data = _bsr_case(6, 6, 2, torch.float64)
    with pytest.raises(ShapeError):
        diagonal(indptr, indices, data, 6, 1)         # blocks: k = 0 only
    with pytest.raises(ShapeError):
        diagonal(indptr, indices, data[:, :, :1], 6)


def test_jacobi_on_the_cpu_records_the_plain_path():
    a = CsrMatrix(6, 6, np.arange(7), np.arange(6), np.full(6, 2.0))
    b = torch.ones(6, dtype=torch.float64)
    rec = metrics.enable()
    try:
        rec.records.clear()
        res = cg(a, b, tol=1e-12, precondition="jacobi")
        paths = [r.path for r in rec.records]
    finally:
        metrics.disable()
        rec.records.clear()
    assert paths.count("diagonal:plain") == 1
    assert torch.equal(res.x, torch.full((6,), 0.5, dtype=torch.float64))


# ---- on the card ------------------------------------------------------

def _on(card, case, offset=False):
    """The case on the card; with ``offset`` the index array is a view
    one element past a 16-byte boundary (the one-index-a-lane loads)."""
    ptr, idx, values, length, k = case
    ptr, idx, values = ptr.to(card), idx.to(card), values.to(card)
    if offset:
        store = torch.empty(idx.numel() + 1, dtype=idx.dtype, device=card)
        idx = store[1:].copy_(idx)
        assert idx.data_ptr() % 16
    return ptr, idx, values, length, k


def _held(ptr, idx, values, length, k, key):
    """The kernel against the plain version, bitwise, diagonal and
    inverse, one launch each."""
    for invert in (False, True):
        before = diag_mod.LAUNCHES[key]
        got = diagonal(ptr, idx, values, length, k, invert=invert)
        assert diag_mod.LAUNCHES[key] == before + 1
        want = diagonal_plain(ptr, idx, values, length, k, invert=invert)
        assert got.dtype == want.dtype and got.shape == want.shape
        assert torch.equal(got, want), (invert, (got != want).nonzero())


@pytest.mark.card
@pytest.mark.parametrize("offset", [False, True], ids=["int4", "int"])
@pytest.mark.parametrize("case", [c[1] for c in CASES], ids=CASE_IDS)
def test_kernel_equals_plain_on_the_card(card, case, offset):
    ptr, idx, values, length, k = _on(card, case, offset)
    key = str(values.dtype).removeprefix("torch.")
    _held(ptr, idx, values, length, k, key)
    _held(ptr, idx, values.to(torch.bfloat16), length, k, "bfloat16")
    np.testing.assert_array_equal(
        diagonal(ptr, idx, values, length, k).double().cpu().numpy(),
        _walk(*(t.cpu() for t in (ptr, idx, values)), length, k))


def _long_row(card):
    """1,000 rows of 4 entries and row 500 of 100,000, whose diagonal slot
    is stored at 30,000 and again at 99,990; padding past ``ptr[-1]``."""
    gen = torch.Generator().manual_seed(3)
    lens = torch.full((1000,), 4)
    lens[500] = 100_000
    ptr = torch.zeros(1001, dtype=torch.int32)
    ptr[1:] = torch.cumsum(lens, 0)
    idx = torch.randint(0, 1000, (int(ptr[-1]) + PAD,), generator=gen,
                        dtype=torch.int32)
    row = idx[int(ptr[500]):int(ptr[501])]
    row[row == 500] = 501
    row[30_000] = row[99_990] = 500
    values = torch.randn(idx.numel(), generator=gen, dtype=torch.float64)
    return ptr.to(card), idx.to(card), values.to(card)


@pytest.mark.card
@pytest.mark.parametrize("offset", [False, True], ids=["int4", "int"])
def test_long_row_on_the_card(card, offset):
    ptr, idx, values = _long_row(card)
    ptr, idx, values, length, k = _on(card, (ptr, idx, values, 1000, 0),
                                      offset)
    _held(ptr, idx, values, length, k, "float64")
    d = diagonal(ptr, idx, values, length)
    assert float(d[500]) == float(values[int(ptr[500]) + 99_990])


@pytest.mark.card
def test_stencil_and_ex56_on_the_card(card):
    """A 27-point stencil at 32^3 (CSR, float64 and float32) and PETSc
    ex56's operator at 8^3 elements (3 x 3 float64 blocks), through
    ``diagonal`` and the Jacobi set-up: one launch each, the plain
    version's bits."""
    from spbench.structures import hex8_elasticity
    from spalinalg_tpu_torch.tools.bench_bsr import grid27_pattern

    indptr, indices = grid27_pattern(32, card)
    n = 32 ** 3
    gen = torch.Generator(device=card).manual_seed(4)
    for dtype in (torch.float64, torch.float32):
        values = torch.randn(indices.numel(), generator=gen, dtype=dtype,
                             device=card)
        key = str(dtype).removeprefix("torch.")
        _held(indptr, indices, values, n, 0, key)
        a = CsrMatrix._from_parts(n, n, indptr, indices, values)
        before = diag_mod.LAUNCHES[key]
        assert torch.equal(mat_diagonal(a),
                           diagonal_plain(indptr, indices, values, n))
        assert diag_mod.LAUNCHES[key] == before + 1
    ne = 8
    m = hex8_elasticity.counts(ne)["rows"]
    bsr = BsrMatrix.from_block_triplets(
        m, m, *hex8_elasticity.triplets(ne, device=card))
    _held(bsr.indptr, bsr.indices, bsr.data, m // 3, 0, "float64")
    before = diag_mod.LAUNCHES["float64"]
    assert torch.equal(mat_diagonal(bsr), diagonal_plain(
        bsr.indptr, bsr.indices, bsr.data, m // 3))
    assert diag_mod.LAUNCHES["float64"] == before + 1


def _spd_stencil(card, m=16):
    """The 27-point stencil of an ``m^3`` grid with HPCG's values (26 on
    the diagonal, -1 off it), float64 on the card."""
    from spalinalg_tpu_torch.tools.bench_bsr import grid27_pattern

    indptr, indices = grid27_pattern(m, card)
    n = m ** 3
    rows = torch.repeat_interleave(
        torch.arange(n, device=card), (indptr[1:] - indptr[:-1]).long())
    values = torch.where(indices.long() == rows, 26.0, -1.0).double()
    return CsrMatrix._from_parts(n, n, indptr, indices, values)


@pytest.mark.card
def test_jacobi_cg_gives_the_plain_inverse_bits(card):
    a = _spd_stencil(card)
    gen = torch.Generator(device=card).manual_seed(8)
    b = torch.rand(a.nrows, generator=gen, dtype=torch.float64,
                   device=card) + 0.5
    before = diag_mod.LAUNCHES["float64"]
    got = cg(a, b, tol=0.0, maxiter=30, precondition="jacobi")
    assert diag_mod.LAUNCHES["float64"] == before + 1
    inv = diagonal_plain(a.rowptr, a.colind, a.values, a.nrows, invert=True)
    # the built-in Jacobi around the plain inverse: the same (fused) step
    want = cg(a, b, tol=0.0, maxiter=30, precondition=Jacobi(inv))
    assert got.iterations == want.iterations == 30
    assert torch.equal(got.x, want.x)
    assert torch.equal(got.residual, want.residual)
