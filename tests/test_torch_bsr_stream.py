"""The ``stream`` variant of the BSR SpMV (``csrc/bsr_spmv.cu``), in the
PyTorch port alone (no JAX here, so the tests marked ``card`` also run on a
card: ``python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_bsr_stream.py -m card``).

On the card: the kernel against ``bsr_spmv_plain`` and against the
``scalar`` variant on block rows of 0, 1, 27 and 40 blocks (more than a
warp's 32 lanes), padding blocks past ``indptr[-1]`` and a ``data`` cut
short of ``indptr[-1]``, with ``data`` or ``x`` a view off a 16-byte
boundary, and a bitwise repeat. On normal values the tolerance is
``tol·(|A|·|x|)`` entry by entry: 1e-13 in float64, 1e-5 for float32 and
bfloat16 blocks (float32 sums), since the variants sum a row in different
orders (the kernel by lane, then by a shuffle tree; the plain version by
``einsum`` and ``index_add_``). On integer-valued blocks and ``x``, whose
sums are exact in any order, the kernel must give the plain version's
bits: every stored value multiplied once, every row written once.
"""

import pytest
import torch

from spalinalg_tpu_torch.ops.kernels import bsr_spmv as bsr_spmv_mod
from spalinalg_tpu_torch.ops.kernels.bsr_spmv import (bsr_spmv,
                                                      bsr_spmv_plain)


@pytest.fixture
def card():
    """The first CUDA card; skips the test where there is none (decided
    when the test runs, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float64": torch.float64}
TOL = {"float32": 1e-5, "bfloat16": 1e-5, "float64": 1e-13}

# Blocks in the special block rows: none, one, ex56's interior 27 and 40,
# more than the 32 lanes of the warp that owns the row.
SPECIAL_ROWS = {0: 0, 1: 1, 2: 27, 3: 40}


def _structure(seed, nbr=64, nbc=50, pad=3):
    """``(indptr, indices)`` (int32) with the block rows of
    ``SPECIAL_ROWS``, every fourth other row empty, the rest of 1 to 9
    blocks, and ``pad`` padding blocks past ``indptr[-1]``."""
    gen = torch.Generator().manual_seed(seed)
    lens = torch.randint(1, 10, (nbr,), generator=gen)
    lens[::4] = 0
    for row, n in SPECIAL_ROWS.items():
        lens[row] = n
    indptr = torch.zeros(nbr + 1, dtype=torch.int32)
    indptr[1:] = torch.cumsum(lens, 0)
    indices = torch.randint(0, nbc, (int(indptr[-1]) + pad,), generator=gen,
                            dtype=torch.int32)
    return indptr, indices


# (br, bc), storage dtype: 3 x 3 in every dtype (ex56's blocks), a
# width-1 block, a one-block step (5 x 5, 32 x 1) and a 32-slot step (1 x 1).
CARD_CASES = [((3, 3), "float64"), ((3, 3), "float32"), ((3, 3), "bfloat16"),
              ((3, 1), "float64"), ((1, 1), "float32"), ((5, 5), "float64"),
              ((32, 1), "float32")]


def _card_operands(card, br, bc, dtype, layout, values):
    """The structure on the card, blocks and ``x`` drawn from a seeded
    generator (``values`` "integers": rounded to whole numbers of at most
    about 20, exact in every dtype), ``data`` or ``x`` (``layout``) a view
    one element past a 16-byte boundary."""
    indptr, indices = (t.to(card) for t in _structure(5))
    gen = torch.Generator(device=card).manual_seed(6)
    acc = torch.float64 if dtype == "float64" else torch.float32
    data = torch.randn((indices.numel(), br, bc), generator=gen, dtype=acc,
                       device=card)
    x = torch.randn(50 * bc, generator=gen, dtype=acc, device=card)
    if values == "integers":
        data, x = (4 * data).round(), (4 * x).round()
    data = data.to(DTYPES[dtype])
    if layout == "data view":
        off = torch.empty(data.numel() + 1, dtype=data.dtype, device=card)
        data = off[1:].view(data.shape).copy_(data)
    if layout == "x view":
        off = torch.empty(x.numel() + 1, dtype=x.dtype, device=card)
        x = off[1:].copy_(x)
    return indptr, indices, data, x


@pytest.mark.card
@pytest.mark.parametrize("values", ["normal", "integers"])
@pytest.mark.parametrize("layout", ["aligned", "data view", "x view"])
@pytest.mark.parametrize("bs,dtype", CARD_CASES,
                         ids=[f"{b[0]}x{b[1]}-{d}" for b, d in CARD_CASES])
def test_stream_kernel_on_the_card(card, bs, dtype, layout, values):
    """The ``stream`` variant, named, agrees with the plain version and
    with the ``scalar`` variant within ``TOL`` of ``|A|·|x|`` (bitwise on
    integer values), writes 0 to empty block rows, reads no padding block
    nor a block past a ``data`` cut short of ``indptr[-1]``, and repeats
    bitwise."""
    br, bc = bs
    indptr, indices, data, x = _card_operands(card, br, bc, dtype, layout,
                                              values)
    if layout != "aligned":
        off = data if layout == "data view" else x
        assert off.data_ptr() % 16
    tol = TOL[dtype]
    cut = int(indptr[3]) - 5
    for nb in (indices.numel(), cut):
        ix, d = indices[:nb], data[:nb]
        before = dict(bsr_spmv_mod.VARIANT_LAUNCHES)
        y = bsr_spmv(indptr, ix, d, x, variant="stream")
        assert bsr_spmv_mod.VARIANT_LAUNCHES["stream"] == before["stream"] + 1
        scalar = bsr_spmv(indptr, ix, d, x, variant="scalar")
        assert bsr_spmv_mod.VARIANT_LAUNCHES["scalar"] == before["scalar"] + 1
        plain = bsr_spmv_plain(indptr, ix, d, x)
        scale = bsr_spmv_plain(indptr, ix, d.abs(), x.abs())
        assert y.dtype == plain.dtype and y.shape == plain.shape
        assert bool(((y - plain).abs() <= tol * scale).all())
        assert bool(((y - scalar).abs() <= tol * scale).all())
        if values == "integers":
            assert torch.equal(y, plain) and torch.equal(y, scalar)
        assert bool((y[:br] == 0).all())            # block row 0: empty
        assert torch.equal(y, bsr_spmv(indptr, ix, d, x, variant="stream"))
