"""The BSR path of a finite-element code, in the PyTorch port alone (no
JAX here, so the test marked ``card`` also runs on a card:
``python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_bsr_assembly.py -m card``).

- ``BsrMatrix.from_block_triplets`` (the block assembly on the device)
  against ``BsrMatrix.from_csr(CsrMatrix.from_coo(...))`` on the same
  scalar triplets: random block triplets with duplicates and empty block
  rows, block sizes 2 and 3, float32 and float64; the arrays equal;
- ``diagonal(bsr)`` from the blocks against ``diagonal(bsr.to_csr())``;
- ``cg(bsr, b, precondition="jacobi")`` with no CSR form against
  ``cg(bsr.to_csr(), ...)``;
- the spans ``spal.bsr.build`` and ``spal.bsr_spmv``;
- on the card: the 3 x 3 float64 kernel (``stream`` variant) against its
  plain version on PETSc ex56's operator at 16^3 elements.
"""

import numpy as np
import pytest
import torch

import spalinalg_tpu_torch as tsp
from spalinalg_tpu_torch import BsrMatrix, CooMatrix, CsrMatrix
from spalinalg_tpu_torch.errors import ShapeError, StructureError
from spalinalg_tpu_torch.linalg import cg
from spalinalg_tpu_torch.ops.kernels import bsr_spmv as bsr_spmv_mod
from spalinalg_tpu_torch.ops.reduce_api import diagonal
from spalinalg_tpu_torch.utils import profiling


@pytest.fixture(autouse=True)
def _cpu_scope():
    """The port's entry points place data on the card unless told
    otherwise; these tests run on the CPU."""
    with tsp.default_device("cpu"):
        yield


@pytest.fixture
def card():
    """The first CUDA card; skips the test where there is none (decided
    when the test runs, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


DTYPES = [torch.float32, torch.float64]


def _triplets(seed, nbr, nbc, b, n, dtype, empty=(1, 4)):
    """``n`` random block triplets on ``nbr x nbc`` blocks of ``b x b``:
    a third of them repeat earlier positions, the block rows ``empty``
    get none."""
    gen = torch.Generator().manual_seed(seed)
    rows = [r for r in range(nbr) if r not in empty]
    brow = torch.tensor(rows, dtype=torch.int32)[
        torch.randint(0, len(rows), (n,), generator=gen)]
    bcol = torch.randint(0, nbc, (n,), generator=gen, dtype=torch.int32)
    again = torch.randint(0, n // 2, (n // 3,), generator=gen)
    brow[n - n // 3:], bcol[n - n // 3:] = brow[again], bcol[again]
    blocks = torch.randn((n, b, b), generator=gen, dtype=torch.float64)
    return brow, bcol, blocks.to(dtype)


def _through_csr(nrows, ncols, brow, bcol, blocks):
    """The same triplets as scalar entries, through COO -> CSR -> BSR."""
    n, b, _ = blocks.shape
    r = torch.arange(b)
    rows = (brow.long()[:, None, None] * b + r[None, :, None]).expand(n, b, b)
    cols = (bcol.long()[:, None, None] * b + r[None, None, :]).expand(n, b, b)
    coo = CooMatrix.with_triplets(nrows, ncols, rows.reshape(-1).numpy(),
                                  cols.reshape(-1).numpy(),
                                  blocks.reshape(-1).numpy())
    return BsrMatrix.from_csr(CsrMatrix.from_coo(coo), b)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,nbr,nbc,n", [(2, 9, 7, 60), (3, 8, 8, 90),
                                         (3, 6, 11, 40)])
def test_block_assembly_equals_the_csr_route(b, nbr, nbc, n, dtype):
    brow, bcol, blocks = _triplets(nbr * 31 + b, nbr, nbc, b, n, dtype)
    got = BsrMatrix.from_block_triplets(nbr * b, nbc * b, brow, bcol, blocks)
    want = _through_csr(nbr * b, nbc * b, brow, bcol, blocks)
    distinct = torch.unique(brow.long() * nbc + bcol.long()).numel()
    assert got.n_blocks == want.n_blocks == distinct
    assert got.indptr.dtype == got.indices.dtype == torch.int32
    assert torch.equal(got.indptr, want.indptr)
    assert torch.equal(got.indices, want.indices)
    assert got.data.dtype == dtype
    assert torch.equal(got.data, want.data)
    assert int(got.indptr[2] - got.indptr[1]) == 0       # block row 1


def test_block_assembly_keeps_zero_blocks():
    """A zero block, given or summed to zero, stays stored: the block
    pattern is kept, as PETSc keeps it under ``MatZeroRowsColumns``."""
    brow = torch.tensor([0, 1, 1, 0], dtype=torch.int32)
    bcol = torch.tensor([0, 1, 1, 1], dtype=torch.int32)
    blocks = torch.stack([torch.eye(2), torch.ones(2, 2), -torch.ones(2, 2),
                          torch.zeros(2, 2)]).double()
    a = BsrMatrix.from_block_triplets(4, 4, brow, bcol, blocks)
    assert a.indptr.tolist() == [0, 2, 3]
    assert a.indices.tolist() == [0, 1, 1]
    assert torch.equal(a.to_dense(), torch.block_diag(
        torch.eye(2), torch.zeros(2, 2)).double())


def test_block_assembly_checks_its_input():
    brow = torch.tensor([0, 2], dtype=torch.int32)
    bcol = torch.tensor([0, 0], dtype=torch.int32)
    blocks = torch.ones(2, 2, 2, dtype=torch.float64)
    with pytest.raises(StructureError):
        BsrMatrix.from_block_triplets(4, 4, brow, bcol, blocks)
    with pytest.raises(StructureError):
        BsrMatrix.from_block_triplets(4, 4, bcol, brow, blocks)
    with pytest.raises(StructureError):         # past int32: no wrap
        BsrMatrix.from_block_triplets(4, 4, bcol.long() + 2 ** 32,
                                      bcol, blocks)
    with pytest.raises(ShapeError):
        BsrMatrix.from_block_triplets(5, 4, bcol, bcol, blocks)
    with pytest.raises(ShapeError):
        BsrMatrix.from_block_triplets(4, 4, bcol[:1], bcol, blocks)
    empty = BsrMatrix.from_block_triplets(
        4, 6, brow[:0], bcol[:0], blocks[:0])
    assert empty.n_blocks == 0 and empty.indptr.tolist() == [0, 0, 0]
    assert torch.equal(empty.to_dense(), torch.zeros(4, 6,
                                                     dtype=torch.float64))


def _with_duplicate():
    """Block (0, 0) stored twice: the last copy counts."""
    data = torch.arange(3 * 9, dtype=torch.float64).reshape(3, 3, 3) + 1
    return BsrMatrix(6, 6, 3, [0, 2, 3], [0, 0, 1], data)


@pytest.mark.parametrize("k", [0, 3, -3, 6, -6, 1, -2])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b", [2, 3])
def test_block_diagonal_equals_the_csr_diagonal(k, dtype, b):
    nb = 5
    brow, bcol, blocks = _triplets(7 * b, nb, nb, b, 30, dtype)
    a = BsrMatrix.from_block_triplets(nb * b, nb * b, brow, bcol, blocks)
    assert torch.equal(diagonal(a, k), diagonal(a.to_csr(), k))


@pytest.mark.parametrize("k", [0, 3, -3, 1])
def test_block_diagonal_of_a_duplicate(k):
    a = _with_duplicate()
    assert torch.equal(diagonal(a, k), diagonal(a.to_csr(), k))


def test_block_diagonal_rectangular():
    brow, bcol, blocks = _triplets(3, 4, 7, 3, 25, torch.float64)
    a = BsrMatrix.from_block_triplets(12, 21, brow, bcol, blocks)
    for k in (0, 3, 9, -3):
        assert torch.equal(diagonal(a, k), diagonal(a.to_csr(), k))
    with pytest.raises(ShapeError):
        diagonal(a, 21)


def _spd_bsr(nb=12, b=3, seed=5):
    """A symmetric positive definite BSR: ``MᵀM + 3I`` of a random block
    matrix, assembled from its blocks."""
    gen = torch.Generator().manual_seed(seed)
    m = torch.randn(nb * b, nb * b, generator=gen, dtype=torch.float64)
    m = m * (torch.rand(nb * b, nb * b, generator=gen) < 0.2)
    dense = m.T @ m + torch.eye(nb * b, dtype=torch.float64) * 3
    blocks = dense.view(nb, b, nb, b).permute(0, 2, 1, 3).reshape(-1, b, b)
    ij = torch.arange(nb * nb, dtype=torch.int32)
    keep = blocks.abs().amax(dim=(1, 2)) > 0
    return BsrMatrix.from_block_triplets(nb * b, nb * b, (ij // nb)[keep],
                                         (ij % nb)[keep], blocks[keep])


def test_jacobi_cg_on_bsr_needs_no_csr(monkeypatch):
    a = _spd_bsr()
    csr = a.to_csr()
    b = torch.linspace(0.5, 1.5, a.nrows, dtype=torch.float64)
    want = cg(csr, b, tol=0.0, maxiter=20, precondition="jacobi")

    def refuse(self):
        raise AssertionError("the BSR CG path converted to CSR")

    monkeypatch.setattr(BsrMatrix, "to_csr", refuse)
    got = cg(a, b, tol=0.0, maxiter=20, precondition="jacobi")
    assert got.iterations == want.iterations == 20
    np.testing.assert_allclose(got.x.numpy(), want.x.numpy(), rtol=0,
                               atol=1e-12 * float(want.x.abs().max()))
    assert abs(float(got.residual - want.residual)) <= \
        1e-12 * float(b.norm())


def test_spans_of_the_bsr_path():
    brow, bcol, blocks = _triplets(2, 6, 6, 3, 30, torch.float64)
    x = torch.ones(18, dtype=torch.float64)
    profiling.reset()
    try:
        a = BsrMatrix.from_block_triplets(18, 18, brow, bcol, blocks)
        a @ x
        assert {"spal.bsr.build", "spal.bsr_spmv"}.isdisjoint(
            profiling.span_totals())
        with profiling.tracing():
            a = BsrMatrix.from_block_triplets(18, 18, brow, bcol, blocks)
            for _ in range(3):
                a @ x
        totals = profiling.span_totals()
        assert totals["spal.bsr.build"]["count"] == 1
        assert totals["spal.bsr_spmv"]["count"] == 3
        assert totals["spal.bsr_spmv"]["host_s"] > 0
    finally:
        profiling.reset()


@pytest.mark.card
def test_ex56_scalar_kernel_against_plain_on_the_card(card):
    """PETSc ex56's operator at 16^3 elements (14,739 unknowns), assembled
    on the card: its 3 x 3 float64 blocks run the ``stream`` variant, held
    against the plain version entry by entry at ``1e-13·(|A|·|x|)``."""
    from spbench.structures import hex8_elasticity

    ne = 16
    n = hex8_elasticity.counts(ne)["rows"]
    a = BsrMatrix.from_block_triplets(
        n, n, *hex8_elasticity.triplets(ne, device=card))
    assert a.n_blocks == hex8_elasticity.counts(ne)["blocks"]
    x = torch.rand(n, dtype=torch.float64, device=card) + 0.5
    before = bsr_spmv_mod.VARIANT_LAUNCHES["stream"]
    y = a @ x
    assert bsr_spmv_mod.VARIANT_LAUNCHES["stream"] == before + 1
    plain = bsr_spmv_mod.bsr_spmv_plain(a.indptr, a.indices, a.data, x)
    scale = bsr_spmv_mod.bsr_spmv_plain(a.indptr, a.indices, a.data.abs(),
                                        x.abs())
    assert bool(((y - plain).abs() <= 1e-13 * scale).all())
    op = hex8_elasticity.Operator(ne, device=card)
    assert bool(((y - op.apply(x)).abs() <= 1e-13 * scale).all())
