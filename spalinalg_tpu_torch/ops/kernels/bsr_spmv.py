"""BSR SpMV: the Hopper kernel's wrapper, its plain torch version, its launch
count, and the gradient.

The kernel (``spalinalg_tpu_torch/csrc/bsr_spmv.cu``) replaces the Pallas
kernels on the JAX package's BSR SpMV path:

- ``spalinalg_tpu/ops/kernels/bsr_stream.py::_kernel_v3`` (B4, f32 or bf16
  blocks),
- ``spalinalg_tpu/ops/kernels/bsr_stream.py::_kernel_v2`` in its K = 1
  role (B5),
- ``spalinalg_tpu/ops/kernels/bsr_df.py::_kernel_df`` (B6, f64 as
  double-float),
- ``spalinalg_tpu/ops/kernels/bsr_spmv.py::_kernel`` in its K = 1 role
  (B9).

Their block windows, VMEM-resident accumulators and double-float planes
work around TPU limits, so one source, instantiated for float32, bfloat16
and float64 blocks, reads ``indptr``/``indices``/``data`` directly. It has
three variants, chosen by :func:`bsr_spmv_variant` from shapes, dtypes and
addresses and passed to the kernel by name: ``vector`` (16-byte loads,
several blocks in flight) where a block row's slice is a whole number of
16-byte vectors and ``data`` and ``x`` start on a 16-byte boundary,
``stream`` (a warp reads a block row's stored values as one contiguous
run) for the other operands whose blocks hold at most 32 values, where
block rows are long enough to fill the warp, ``scalar`` (one element a
lane) for the rest. Each launch adds one to ``LAUNCHES`` (by storage type)
and to ``VARIANT_LAUNCHES`` (by variant); the metrics path names the
variant, for example ``bsr_spmv:cuda:stream``.

**Dtypes** follow the JAX package's public path (``bsr_ops.py:26,119``):
bfloat16 blocks accumulate and return float32, whatever ``x`` is;
otherwise the result type is the promotion of the two. ``x`` is not
rounded to bfloat16 (the TPU kernels round it, ``bsr_stream.py:86``; the
public path does not, and the port follows the public path).

:func:`bsr_spmv` is the wrapper. For CUDA tensors it launches the kernel or
raises; for CPU tensors it runs :func:`bsr_spmv_plain`. :class:`BsrSpmv`
carries the gradient of the public path (``jax.grad`` through its einsum
and ``segment_sum``): ``dx = Aᵀ·g`` runs the same kernel on the block
transpose, whose structure is cached, and ``ddata[k] = g_blk[row_k] ⊗
x_blk[col_k]`` is plain torch.

>>> import torch
>>> indptr = torch.tensor([0, 1, 1], dtype=torch.int32)
>>> indices = torch.tensor([1], dtype=torch.int32)
>>> data = torch.tensor([[[1.0, 2.0], [3.0, 4.0]]])
>>> bsr_spmv(indptr, indices, data, torch.tensor([0.0, 0.0, 1.0, 1.0]))
tensor([3., 7., 0., 0.])
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from ...convert.engine import major_ids
from ...dtypes import INDEX_DTYPE, canonical_value_dtype, result_dtype
from ...errors import DTypeError, ShapeError
from .csr_spmv import aligned16, transpose_plan

__all__ = ["LAUNCHES", "STREAM_MAX_VALUES", "STREAM_MIN_STEPS",
           "VARIANT_LAUNCHES", "BsrSpmv", "bsr_acc_dtype", "bsr_spmv",
           "bsr_spmv_plain", "bsr_spmv_variant", "kernel_operands",
           "kernel_path", "transposed_blocks"]

# Kernel launches per storage type and per variant: plain integers,
# advanced only where the wrapper launches the kernel.
LAUNCHES = {"float32": 0, "bfloat16": 0, "float64": 0}
VARIANT_LAUNCHES = {"scalar": 0, "vector": 0, "stream": 0}

# Values a block may hold for the stream variant: a warp's step of 32
# lanes takes 32 // (br * bc) whole blocks, so larger blocks cannot go; and
# the warp steps a block row must hold on average (bsr_spmv_variant).
STREAM_MAX_VALUES = 32
STREAM_MIN_STEPS = 3

# The variant's code in the C entry points.
_VARIANT_CODE = {"scalar": 0, "vector": 1, "stream": 2}

_ENTRY = {torch.float32: ("spal_bsr_spmv_f32", "float32"),
          torch.bfloat16: ("spal_bsr_spmv_bf16", "bfloat16"),
          torch.float64: ("spal_bsr_spmv_f64", "float64")}

# Elements per gathered temporary of the plain ``ddata`` product.
_DDATA_CHUNK = 1 << 26


def bsr_acc_dtype(data_dtype, x_dtype) -> torch.dtype:
    """Accumulation and result dtype of a BSR product: float32 for
    bfloat16 blocks whatever ``x`` is (``spalinalg_tpu/ops/bsr_ops.py:26``),
    the promoted type otherwise.

    >>> bsr_acc_dtype(torch.bfloat16, torch.float64)
    torch.float32
    """
    if canonical_value_dtype(data_dtype) == torch.bfloat16:
        canonical_value_dtype(x_dtype)
        return torch.float32
    return result_dtype(data_dtype, x_dtype)


def kernel_operands(data, x):
    """``(data, x, acc)`` as the kernels take them: ``data`` in its storage
    type (bfloat16 kept, anything else in the accumulation type), ``x`` in
    the accumulation type, both contiguous (a contiguous view keeps its
    storage offset)."""
    acc = bsr_acc_dtype(data.dtype, x.dtype)
    store = torch.bfloat16 if data.dtype == torch.bfloat16 else acc
    return data.to(store).contiguous(), x.to(acc).contiguous(), acc


def bsr_spmv_variant(data, x, nbr: int) -> str:
    """The variant of ``csrc/bsr_spmv.cu`` for the blocks ``data`` and the
    operand ``x`` as the kernel takes them (:func:`kernel_operands`), in a
    matrix of ``nbr`` block rows:

    - ``"vector"`` when a row's slice of a block is a whole number of
      16-byte vectors (``bc * itemsize % 16 == 0``) and ``data`` and ``x``
      start on a 16-byte boundary;
    - else ``"stream"`` when a block holds at most ``STREAM_MAX_VALUES``
      values and the block rows hold on average at least
      ``STREAM_MIN_STEPS`` of a warp's steps (``32 // (br * bc)`` blocks a
      step);
    - else ``"scalar"``.

    The stream variant gives a block row a warp, so short block rows leave
    its lanes idle. On the H100, banded patterns of 2**25 stored values
    (``bsr @ x``, ms, stream against scalar): 3 x 3 blocks at 7 a block
    row (2.3 steps) 0.212 / 0.194 in float64, 0.189 / 0.158 in float32; at
    9 (3 steps) 0.166 / 0.190 and 0.148 / 0.152; at 27 0.100 / 0.188 and
    0.085 / 0.155; 2 x 2 float32 blocks at 21 (2.6 steps) 0.142 / 0.135,
    at 27 (3.4 steps) 0.130 / 0.147; 3 x 1 float32 at 27 (2.7 steps) 0.146
    / 0.119, at 45 0.133 / 0.136; PETSc ex56's 3 x 3 float64 pattern at
    161**3 nodes (8.9 steps) 2.98 / 5.27. Shapes, dtypes, addresses and
    the mean block row alone decide, so it answers for tensors on any
    device.

    >>> bsr_spmv_variant(torch.zeros(4, 8, 8), torch.zeros(64), 2)
    'vector'
    >>> bsr_spmv_variant(torch.zeros(27, 3, 3, dtype=torch.float64),
    ...                  torch.zeros(9, dtype=torch.float64), 1)
    'stream'
    >>> bsr_spmv_variant(torch.zeros(7, 3, 3, dtype=torch.float64),
    ...                  torch.zeros(9, dtype=torch.float64), 1)
    'scalar'
    >>> bsr_spmv_variant(torch.zeros(65)[1:].reshape(1, 8, 8), torch.zeros(8),
    ...                  1)
    'scalar'
    """
    nblocks, br, bc = data.shape
    if bc * data.element_size() % 16 == 0 and aligned16(data) \
            and aligned16(x):
        return "vector"
    values = br * bc
    if values <= STREAM_MAX_VALUES and nblocks >= (
            STREAM_MIN_STEPS * (STREAM_MAX_VALUES // values) * nbr):
        return "stream"
    return "scalar"


def kernel_path(variant_of, data, x, *structure) -> str:
    """The metrics path of a BSR product: ``"plain"`` off the card, else
    ``"cuda:"`` and the variant ``variant_of`` (:func:`bsr_spmv_variant`
    or ``bsr_spmm_variant``) picks for the operands as the kernel takes
    them and ``structure`` (the SpMV's block row count), for example
    ``"cuda:vector"``.

    >>> kernel_path(bsr_spmv_variant, torch.zeros(1, 2, 2), torch.zeros(2),
    ...             1)
    'plain'
    """
    if x.device.type != "cuda":
        return "plain"
    data, x, _ = kernel_operands(data, x)
    return f"cuda:{variant_of(data, x, *structure)}"


def checked_operands(name, indptr, indices, data, x, ndim):
    """``(data, x, acc)`` as :func:`kernel_operands` gives them. Devices,
    index dtypes and shapes are checked; anything the kernels do not take
    raises."""
    data, x, acc = kernel_operands(data, x)
    devices = {t.device for t in (indptr, indices, data, x)}
    if len(devices) != 1:
        raise ValueError(f"{name} operands on several devices: {devices}")
    if indptr.dtype != INDEX_DTYPE or indices.dtype != INDEX_DTYPE:
        raise DTypeError(
            f"indices must be {INDEX_DTYPE}, got {indptr.dtype} and "
            f"{indices.dtype}")
    if (indptr.ndim != 1 or indptr.numel() < 1 or indices.ndim != 1
            or data.ndim != 3 or min(data.shape[1:]) < 1
            or data.shape[0] != indices.numel() or x.ndim != ndim
            or x.shape[0] % data.shape[2]):
        raise ShapeError(
            f"{name} shapes: indptr {tuple(indptr.shape)}, indices "
            f"{tuple(indices.shape)}, data {tuple(data.shape)}, x "
            f"{tuple(x.shape)}")
    return data, x, acc


def bsr_spmv_plain(indptr, indices, data, x) -> torch.Tensor:
    """Plain torch ``y = A @ x`` (or ``Y = A @ X`` for a 2-D ``x``): one
    batched product of the blocks with their gathered slices of ``x``,
    summed into block rows with ``index_add_``. Blocks at or past
    ``indptr[-1]`` land in a sentinel block row that is cut off. Runs on
    any device; differentiable by autograd."""
    acc = bsr_acc_dtype(data.dtype, x.dtype)
    nblocks, br, bc = data.shape
    nbr = indptr.numel() - 1
    rows = major_ids(indptr, nblocks)
    xb = x.to(acc).reshape(x.shape[0] // bc, bc, *x.shape[1:])[indices]
    if x.ndim == 1:
        prod = torch.einsum("kij,kj->ki", data.to(acc), xb)
    else:
        prod = torch.einsum("kij,kjl->kil", data.to(acc), xb)
    y = torch.zeros((nbr + 1, br) + tuple(x.shape[1:]), dtype=acc,
                    device=x.device)
    y.index_add_(0, rows, prod)
    return y[:nbr].reshape((nbr * br,) + tuple(x.shape[1:]))


def bsr_spmv(indptr, indices, data, x, variant=None) -> torch.Tensor:
    """``y = A @ x`` for BSR ``A`` (``data`` of shape ``(nblocks, br,
    bc)``): the kernel on CUDA tensors, the plain version on CPU tensors.

    ``variant`` names the kernel's variant instead of
    :func:`bsr_spmv_variant`'s choice. It is the tests' and tools' hook to
    compare two variants on the same operands, as ``bsr_spmm``'s is; no
    caller in the port sets it. The kernel refuses a variant that does not
    take the operands, and the wrapper raises. A matrix with no block rows
    or no blocks launches nothing.
    """
    if variant is not None and variant not in _VARIANT_CODE:
        raise ValueError(f"bsr_spmv has no variant {variant!r}; it has "
                         f"{sorted(_VARIANT_CODE)}")
    data, x, acc = checked_operands("bsr_spmv", indptr, indices, data, x, 1)
    device = x.device
    if device.type == "cpu":
        return bsr_spmv_plain(indptr, indices, data, x)
    if device.type != "cuda":
        raise ValueError(f"no bsr_spmv kernel for device {device}")
    nblocks, br, bc = data.shape
    nbr = indptr.numel() - 1
    if nbr == 0 or nblocks == 0:
        return torch.zeros(nbr * br, dtype=acc, device=device)
    from ._build import launch

    name, key = _ENTRY[data.dtype]
    variant = variant or bsr_spmv_variant(data, x, nbr)
    indptr, indices = indptr.contiguous(), indices.contiguous()
    y = torch.empty(nbr * br, dtype=acc, device=device)
    with torch.cuda.device(device):
        launch(name, indptr.data_ptr(), indices.data_ptr(), data.data_ptr(),
               x.data_ptr(), y.data_ptr(), nbr, br, bc, nblocks,
               _VARIANT_CODE[variant],
               torch.cuda.current_stream(device).cuda_stream)
    LAUNCHES[key] += 1
    VARIANT_LAUNCHES[variant] += 1
    return y


def transposed_blocks(indptr, indices, data, ncols: int):
    """The block transpose of a BSR matrix: ``(plan, dataT)``. ``plan`` is
    the cached transposed structure (``plan.ptr`` over block columns,
    ``plan.minor`` the block rows, ``plan.perm`` the source block of each
    slot, ``plan.major`` each source block's row); ``dataT`` (nblocks, bc,
    br) is gathered and transposed per call."""
    nblocks, br, bc = data.shape
    t = transpose_plan(indptr, indices, indptr.numel() - 1, ncols // bc)
    out = data.new_empty((nblocks, bc, br))
    torch.index_select(data.transpose(1, 2), 0, t.perm, out=out)
    return t, out


def _block_outer(g, x, rows, cols, br: int, bc: int) -> torch.Tensor:
    """``out[k] = g_blk[rows[k]] @ x_blk[cols[k]]ᵀ`` (an outer product for
    1-D ``g`` and ``x``), in chunks of blocks so that no gathered temporary
    passes ``_DDATA_CHUNK`` elements. A row ``rows[k]`` past the last
    block row (padding) gives 0."""
    K = 1 if g.ndim == 1 else g.shape[1]
    G = torch.cat([g.reshape(g.shape[0] // br, br, K), g.new_zeros(1, br, K)])
    X = x.reshape(x.shape[0] // bc, bc, K)
    out = g.new_empty((rows.numel(), br, bc))
    step = max(1, _DDATA_CHUNK // (max(br, bc) * K))
    for s in range(0, rows.numel(), step):
        gb, xb = G[rows[s:s + step]], X[cols[s:s + step]]
        if K == 1 and br * bc < 1024:
            # One product per entry, so a broadcast multiply gives bmm's
            # values. On the H100 it takes 0.07 ms for the 327,674 blocks
            # of 8 x 8 at n = 2^19, bmm 1.00 ms; for 12,286 blocks of
            # 128 x 128 bmm is the faster, 0.36 ms against 0.52 ms.
            torch.mul(gb, xb.transpose(1, 2), out=out[s:s + step])
        else:
            torch.bmm(gb, xb.transpose(1, 2), out=out[s:s + step])
    return out


def bsr_backward(ctx, kernel, data, x, g, indptr, indices):
    """``(ddata, dx)`` of ``y = A @ x`` (SpMV or SpMM, by the ``kernel``
    given): ``dx = Aᵀ·g`` through ``kernel`` on the block transpose, whose
    gathered data is freed on return; ``ddata`` plain torch."""
    nblocks, br, bc = data.shape
    acc = bsr_acc_dtype(data.dtype, x.dtype)
    g = g.to(acc)
    t = transpose_plan(indptr, indices, indptr.numel() - 1, x.shape[0] // bc)
    ddata = dx = None
    if ctx.needs_input_grad[0]:
        ddata = _block_outer(g, x.to(acc), t.major, indices, br, bc
                             ).to(data.dtype)
    if ctx.needs_input_grad[1]:
        _, data_t = transposed_blocks(indptr, indices, data, x.shape[0])
        dx = kernel(t.ptr, t.minor, data_t, g).to(x.dtype)
        del data_t
    return ddata, dx


class BsrSpmv(torch.autograd.Function):
    """``y = A @ x`` with the gradient of the JAX package's public path.

    ``BsrSpmv.apply(data, x, indptr, indices)``; gradients flow to
    ``data`` and ``x``.
    """

    @staticmethod
    def forward(ctx, data, x, indptr, indices):
        # The structure tensors are kept as they are (not saved tensors) so
        # that the transpose cache sees the same objects on every call.
        ctx.structure = (indptr, indices)
        ctx.save_for_backward(data, x)
        return bsr_spmv(indptr, indices, data, x)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        data, x = ctx.saved_tensors
        ddata, dx = bsr_backward(ctx, bsr_spmv, data, x, g, *ctx.structure)
        return ddata, dx, None, None
