"""The BSR kernels' variant choice, and the plain versions at the shapes
that sit on either side of it, against the JAX package.

The BSR sources have variants (``csrc/bsr_spmv.cu``: ``vector``,
``stream`` and ``scalar``; ``csrc/bsr_spmm.cu``: ``tiled``, ``staged`` and ``register``),
picked in Python by ``bsr_spmv_variant`` / ``bsr_spmm_variant`` from
shapes, dtypes and addresses and passed to the kernel by name. Those
functions run on any device, so the choice is checked here on CPU tensors,
alignment included (views at a storage offset); the kernels themselves are
held against the plain versions on the card by ``chip_smoke.py``. The
plain versions at the shapes around the variants' bounds ((128, 128)
blocks with k = 17 and 130, (96, 160) blocks, and the small blocks of the
staged SpMM: 2 x 2, 4 x 4 and 8 x 8 at k = 8, 16, 64 and 65) are held
against the JAX package's public BSR path on the CPU, entry by entry
``|y - y_jax| <= tol·(|A|·|x|)`` (1e-5 f32 and bf16 blocks, 1e-12 f64), as
``tests/test_torch_bsr.py`` does; at the small blocks their gradients are
held against ``jax.grad`` at the same tolerance.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import spalinalg_tpu as jsp
import spalinalg_tpu_torch as tsp
from spalinalg_tpu_torch.ops.kernels import bsr_spmm as bsr_spmm_mod
from spalinalg_tpu_torch.ops.kernels import bsr_spmv as bsr_spmv_mod
from spalinalg_tpu_torch.ops.kernels.bsr_spmm import (bsr_spmm,
                                                      bsr_spmm_variant)
from spalinalg_tpu_torch.ops.kernels.bsr_spmv import (bsr_spmv,
                                                      bsr_spmv_variant,
                                                      kernel_operands)
from spalinalg_tpu_torch.utils import metrics


@pytest.fixture(autouse=True)
def _cpu_scope():
    """The port's entry points place data on the card unless told
    otherwise; these tests run on the CPU."""
    with tsp.default_device("cpu"):
        yield


DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float64": torch.float64}
TOL = {"float32": 1e-5, "bfloat16": 1e-5, "float64": 1e-12}


def _operands(br, bc, dtype, k=None, nblocks=3, nbc=2, shift=None):
    """Blocks and an operand as the kernels take them; ``shift`` names the
    one ("data" or "x") given as a view one element past a 16-byte
    boundary."""
    acc = torch.float64 if dtype == "float64" else torch.float32
    data = torch.zeros(nblocks * br * bc + 1, dtype=DTYPES[dtype])
    data = data[1:] if shift == "data" else data[:-1]
    size = nbc * bc * (1 if k is None else k)
    x = torch.zeros(size + 1, dtype=acc)
    x = x[1:] if shift == "x" else x[:-1]
    data = data.reshape(nblocks, br, bc)
    x = x if k is None else x.reshape(nbc * bc, k)
    return kernel_operands(data, x)[:2]


# (br, bc): the SpMV variant for float32, bfloat16 and float64 blocks, in a
# block row of 96 blocks where they hold at most 32 values. The vector variant needs bc * itemsize to be a
# multiple of 16 bytes; where it is not, the stream variant takes blocks of
# at most 32 values.
SPMV_CASES = {
    (8, 8): ("vector", "vector", "vector"),        # banded8
    (128, 128): ("vector", "vector", "vector"),    # tri128
    (96, 160): ("vector", "vector", "vector"),
    (64, 64): ("vector", "vector", "vector"),
    (384, 384): ("vector", "vector", "vector"),
    (4, 8): ("vector", "vector", "vector"),
    (8, 4): ("vector", "stream", "vector"),        # 8 bytes of bf16
    (5, 40): ("vector", "vector", "vector"),
    (40, 18): ("scalar", "scalar", "vector"),      # 72 / 36 / 144 bytes
    (3, 3): ("stream", "stream", "stream"),        # ex56
    (1, 1): ("stream", "stream", "stream"),
    (3, 1): ("stream", "stream", "stream"),
    (5, 5): ("stream", "stream", "stream"),
    (10, 3): ("stream", "stream", "stream"),       # the largest br at bc = 3
    (11, 3): ("scalar", "scalar", "scalar"),       # 33 values
    (32, 1): ("stream", "stream", "stream"),       # the largest br at bc = 1
    (33, 1): ("scalar", "scalar", "scalar"),
    (2, 16): ("vector", "vector", "vector"),       # 32 values, 16-byte rows
    (4, 9): ("scalar", "scalar", "scalar"),        # 36 values
}


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("bs", list(SPMV_CASES), ids=str)
def test_spmv_variant(bs, dtype):
    want = SPMV_CASES[bs][list(DTYPES).index(dtype)]
    small = bs[0] * bs[1] <= 32
    nblocks = 96 if small else 3
    assert bsr_spmv_variant(*_operands(*bs, dtype, nblocks=nblocks), 1) \
        == want
    # a data or x view off a 16-byte boundary takes the stream variant
    # where a block holds at most 32 values, else the scalar one
    off = "stream" if small else "scalar"
    for shift in ("data", "x"):
        data, x = _operands(*bs, dtype, nblocks=nblocks, shift=shift)
        assert data.data_ptr() % 16 or x.data_ptr() % 16
        assert bsr_spmv_variant(data, x, 1) == off


# (br, bc), blocks, block rows: the stream variant needs block rows of
# STREAM_MIN_STEPS = 3 warp steps (32 // (br * bc) blocks a step) on
# average; below, the scalar variant runs.
ROW_CASES = {
    ((3, 3), 9, 1): "stream",
    ((3, 3), 8, 1): "scalar",
    ((3, 3), 111_284_641, 4_173_281): "stream",   # ex56 at -ne 160
    ((3, 3), 17_000, 2_000): "scalar",            # 8.5 blocks a block row
    ((1, 1), 96, 1): "stream",
    ((1, 1), 95, 1): "scalar",
    ((3, 1), 30, 1): "stream",
    ((3, 1), 29, 1): "scalar",
    ((5, 5), 3, 1): "stream",
    ((5, 5), 2, 1): "scalar",
    ((32, 1), 3, 1): "stream",
}


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(ROW_CASES), ids=str)
def test_spmv_variant_follows_the_mean_block_row(case, dtype):
    (br, bc), nblocks, nbr = case
    data = torch.zeros(1, br, bc, dtype=DTYPES[dtype]).expand(nblocks, br, bc)
    x = torch.zeros(bc, dtype=torch.float64 if dtype == "float64"
                    else torch.float32)
    assert bsr_spmv_variant(data, x, nbr) == ROW_CASES[case]


# (br, bc, k): the SpMM variant for float32, bfloat16 and float64 blocks.
# Both wide variants need bc * itemsize and k * itemsize of X (float32 for
# bfloat16 blocks) to be multiples of 16 bytes; then the tiled variant
# takes br >= 32, bc >= 16, k >= 16 (32 for a float64 X), the staged one
# 2 <= br <= 16 and bc <= 16 at k >= 8.
SPMM_CASES = {
    (128, 128, 64): ("tiled", "tiled", "tiled"),    # tri128
    (128, 128, 16): ("tiled", "tiled", "register"),
    (128, 128, 32): ("tiled", "tiled", "tiled"),
    (128, 128, 17): ("register", "register", "register"),
    (128, 128, 65): ("register", "register", "register"),
    (128, 128, 100): ("tiled", "tiled", "tiled"),   # two column tiles
    (128, 128, 130): ("register", "register", "tiled"),  # 1040 bytes in f64
    (128, 128, 8): ("register", "register", "register"),
    (96, 160, 64): ("tiled", "tiled", "tiled"),
    (64, 64, 64): ("tiled", "tiled", "tiled"),
    (384, 384, 32): ("tiled", "tiled", "tiled"),
    (32, 16, 16): ("tiled", "tiled", "register"),   # every bound met exactly
    (32, 16, 32): ("tiled", "tiled", "tiled"),
    (31, 16, 16): ("register", "register", "register"),
    (32, 15, 16): ("register", "register", "register"),
    (64, 8, 64): ("register", "register", "register"),
    (40, 18, 64): ("register", "register", "tiled"),  # 72 / 36 / 144 bytes
    (8, 8, 64): ("staged", "staged", "staged"),     # banded8
    (5, 40, 64): ("register", "register", "register"),
    (16, 16, 64): ("staged", "staged", "staged"),
    (16, 16, 8): ("staged", "staged", "staged"),
    (17, 16, 64): ("register", "register", "register"),
    (16, 17, 64): ("register", "register", "register"),
    (4, 4, 64): ("staged", "register", "staged"),   # 8 bytes of bf16
    (4, 8, 64): ("staged", "staged", "staged"),
    (8, 4, 64): ("staged", "register", "staged"),
    (2, 2, 64): ("register", "register", "staged"),  # 8 / 4 / 16 bytes
    (3, 3, 64): ("register", "register", "register"),
    (1, 8, 64): ("register", "register", "register"),  # one-row blocks
    (2, 8, 64): ("staged", "staged", "staged"),
    (8, 8, 8): ("staged", "staged", "staged"),
    (8, 8, 4): ("register", "register", "register"),   # k below 8
    (8, 8, 65): ("register", "register", "register"),  # 260 / 520 bytes
    (8, 8, 66): ("register", "register", "staged"),    # 264 / 528 bytes
    (8, 8, 68): ("staged", "staged", "staged"),        # 17 / 34 groups
}


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(SPMM_CASES), ids=str)
def test_spmm_variant(case, dtype):
    br, bc, k = case
    want = SPMM_CASES[case][list(DTYPES).index(dtype)]
    assert bsr_spmm_variant(*_operands(br, bc, dtype, k)) == want
    for shift in ("data", "x"):
        assert bsr_spmm_variant(*_operands(br, bc, dtype, k, shift=shift)) \
            == "register"


def test_variant_follows_the_kernel_operands():
    """The choice is made on the operands as the kernel takes them: a
    float64 operand of bfloat16 blocks becomes float32 (k = 34: rows of 136
    bytes, not 272), a strided one a fresh, aligned copy."""
    data = torch.zeros(2, 64, 64, dtype=torch.bfloat16)
    X = torch.zeros(128, 34, dtype=torch.float64)
    assert bsr_spmm_variant(*kernel_operands(data, X)[:2]) == "register"
    assert bsr_spmm_variant(data, X) == "tiled"
    wide = torch.zeros(129, 64)[1:, :]            # a row offset: 256 bytes
    assert bsr_spmm_variant(data, wide) == "tiled"
    strided = torch.zeros(128, 65)[:, 1:]
    assert strided.data_ptr() % 16
    assert bsr_spmm_variant(*kernel_operands(data, strided)[:2]) == "tiled"


def test_cpu_wrappers_count_no_launches():
    """On the CPU the wrappers run the plain versions and advance no launch
    count, by storage type or by variant."""
    before = [dict(m.LAUNCHES) for m in (bsr_spmv_mod, bsr_spmm_mod)] + [
        dict(m.VARIANT_LAUNCHES) for m in (bsr_spmv_mod, bsr_spmm_mod)]
    ptr = torch.tensor([0, 1], dtype=torch.int32)
    ind = torch.tensor([0], dtype=torch.int32)
    data = torch.ones(1, 32, 16)
    bsr_spmv(ptr, ind, data, torch.ones(16))
    bsr_spmm(ptr, ind, data, torch.ones(16, 16))
    after = [dict(m.LAUNCHES) for m in (bsr_spmv_mod, bsr_spmm_mod)] + [
        dict(m.VARIANT_LAUNCHES) for m in (bsr_spmv_mod, bsr_spmm_mod)]
    assert after == before
    assert set(bsr_spmv_mod.VARIANT_LAUNCHES) == {"scalar", "vector",
                                                  "stream"}
    assert set(bsr_spmm_mod.VARIANT_LAUNCHES) == {"register", "tiled",
                                                  "staged"}


def test_variant_override():
    """``bsr_spmm(..., variant=...)`` names a variant on purpose (the card
    compares two on the same operands); on the CPU the plain version runs
    whatever is named, and counts nothing. A name the kernel has not
    raises."""
    ptr = torch.tensor([0, 1, 1], dtype=torch.int32)
    ind = torch.tensor([0], dtype=torch.int32)
    data = torch.arange(64.0).reshape(1, 8, 8)
    X = torch.ones(8, 16)
    before = dict(bsr_spmm_mod.VARIANT_LAUNCHES)
    ys = [bsr_spmm(ptr, ind, data, X, variant=v)
          for v in (None, "register", "tiled", "staged")]
    for y in ys[1:]:
        torch.testing.assert_close(y, ys[0], rtol=0, atol=0)
    assert bsr_spmm_mod.VARIANT_LAUNCHES == before
    with pytest.raises(ValueError, match="no variant 'vector'"):
        bsr_spmm(ptr, ind, data, X, variant="vector")


def test_spmv_variant_override():
    """``bsr_spmv(..., variant=...)`` names a variant on purpose, as
    ``bsr_spmm`` does; on the CPU the plain version runs whatever is named
    and counts nothing. A name the kernel has not raises."""
    ptr = torch.tensor([0, 1, 1], dtype=torch.int32)
    ind = torch.tensor([0], dtype=torch.int32)
    data = torch.arange(9.0, dtype=torch.float64).reshape(1, 3, 3)
    x = torch.ones(3, dtype=torch.float64)
    before = dict(bsr_spmv_mod.VARIANT_LAUNCHES)
    ys = [bsr_spmv(ptr, ind, data, x, variant=v)
          for v in (None, "scalar", "vector", "stream")]
    for y in ys[1:]:
        torch.testing.assert_close(y, ys[0], rtol=0, atol=0)
    assert bsr_spmv_mod.VARIANT_LAUNCHES == before
    with pytest.raises(ValueError, match="no variant 'tiled'"):
        bsr_spmv(ptr, ind, data, x, variant="tiled")


def test_metrics_path_is_lazy():
    """``instrument`` calls a path function only when it records: BSR
    products then prepare no operands for a path nobody reads."""
    calls = []

    def path():
        calls.append(1)
        return "cuda:tiled"

    dev = torch.device("cpu")
    assert metrics.instrument("op", lambda: 3, path=path, device=dev) == 3
    assert calls == []
    rec = metrics.enable()
    try:
        rec.records.clear()
        metrics.instrument("op", lambda: 4, path=path, device=dev)
        assert calls == [1] and rec.records[-1].path == "op:cuda:tiled"
    finally:
        metrics.disable()
        rec.records.clear()


# ------------------------------------ the plain versions against the JAX path


def _block_pair(rng, br, bc, nbr, nbc, dtype, empty=(1,)):
    """The same BSR matrix in both packages: a random block pattern with the
    block rows ``empty`` left empty and one padding block past
    ``indptr[-1]``."""
    lens = rng.integers(1, nbc + 1, size=nbr)
    lens[list(empty)] = 0
    indptr = np.concatenate([[0], np.cumsum(lens)])
    indices = np.concatenate([np.sort(rng.choice(nbc, n, replace=False))
                              for n in lens] + [[0]])
    data = rng.normal(size=(indices.size, br, bc))
    data = data.astype(np.float64 if dtype == "float64" else np.float32)
    n, m = nbr * br, nbc * bc
    jmat = jsp.BsrMatrix(n, m, (br, bc), indptr, indices, data)
    tmat = tsp.BsrMatrix(n, m, (br, bc), indptr, indices, data)
    if dtype == "bfloat16":
        jmat, tmat = jmat.astype(jnp.bfloat16), tmat.astype(torch.bfloat16)
    dense = tmat.to_dense().double().numpy()
    return jmat, tmat, dense


# Small blocks of the staged SpMM (and of register below its bounds): br =
# bc in {2, 4, 8} at k = 8, 16, 64 and 65.
SMALL_CASES = [((b, b), k) for b in (2, 4, 8) for k in (8, 16, 64, 65)]
SMALL_IDS = [f"{b}x{b}-k{k}" for (b, _), k in SMALL_CASES]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("bs,k", [((128, 128), 17), ((128, 128), 130),
                                  ((96, 160), None), ((96, 160), 64)]
                         + SMALL_CASES,
                         ids=["128x128-k17", "128x128-k130", "96x160-x",
                              "96x160-k64"] + SMALL_IDS)
def test_edge_shapes_match_jax(bs, k, dtype):
    """``bsr @ x`` / ``bsr @ X`` at the shapes around the variants'
    bounds, with an empty block row, through both packages' public
    paths."""
    rng = np.random.default_rng(90)
    br, bc = bs
    jmat, tmat, dense = _block_pair(rng, br, bc, 3, 3, dtype)
    acc = np.float64 if dtype == "float64" else np.float32
    x = rng.normal(size=tmat.ncols if k is None else (tmat.ncols, k)
                   ).astype(acc)
    y = (tmat @ torch.from_numpy(x)).numpy()
    yj = np.asarray(jmat @ jnp.asarray(x))
    assert y.dtype == yj.dtype == acc
    assert y.shape == yj.shape == ((tmat.nrows,) if k is None
                                   else (tmat.nrows, k))
    scale = np.abs(dense) @ np.abs(x.astype(np.float64))
    err = np.abs(y.astype(np.float64) - yj.astype(np.float64))
    assert np.all(err <= TOL[dtype] * scale), (err / (scale + 1e-300)).max()
    np.testing.assert_array_equal(y[br:2 * br], 0)   # the empty block row


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("bs,k", SMALL_CASES, ids=SMALL_IDS)
def test_small_blocks_grad_match_jax(bs, k, dtype):
    """The gradients of ``bsr @ X`` to the blocks and to X at the small
    blocks of the staged SpMM, with an empty block row and a padding block,
    against ``jax.grad`` of ``<G, A @ X>`` through the JAX package's public
    path: ``dX`` within ``tol·(|A|ᵀ·|G|)``, ``ddata`` within
    ``tol·Σ_c |G||X|`` per entry."""
    rng = np.random.default_rng(91)
    br, bc = bs
    jmat, tmat, dense = _block_pair(rng, br, bc, 4, 3, dtype)
    acc = np.float64 if dtype == "float64" else np.float32
    x = rng.normal(size=(tmat.ncols, k)).astype(acc)
    g = rng.normal(size=(tmat.nrows, k)).astype(acc)

    def f(data, xv):
        return jnp.vdot(jnp.asarray(g), jmat.with_data(data) @ xv)

    jdd, jdx = (np.asarray(a) for a in jax.grad(f, argnums=(0, 1))(
        jmat.data, jnp.asarray(x)))
    data = tmat.data.clone().requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    (tmat.with_data(data) @ xt).backward(torch.from_numpy(g))
    dd, dx = data.grad.numpy(), xt.grad.numpy()
    assert dd.dtype == jdd.dtype and dx.dtype == jdx.dtype
    tol = TOL[dtype]
    scale = np.abs(dense).T @ np.abs(g.astype(np.float64))
    assert np.all(np.abs(dx - jdx) <= tol * scale)
    nblocks = int(tmat.indptr[-1])
    rows = np.repeat(np.arange(tmat.nrows // br),
                     np.diff(tmat.indptr.numpy()))
    G = np.abs(g).reshape(-1, br, k)[rows]
    X = np.abs(x).reshape(-1, bc, k)[tmat.indices.numpy()[:nblocks]]
    block_scale = np.einsum("kil,kjl->kij", G, X)
    assert np.all(np.abs(dd[:nblocks] - jdd[:nblocks])
                  <= tol * block_scale)
