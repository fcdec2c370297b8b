"""BSR SpMM: the Hopper kernel's wrapper, its plain torch version, its launch
count, and the gradient.

The kernel (``spalinalg_tpu_torch/csrc/bsr_spmm.cu``) replaces the Pallas
kernels on the JAX package's BSR SpMM path:

- ``spalinalg_tpu/ops/kernels/bsr_stream.py::_kernel_v2`` (B5),
- ``spalinalg_tpu/ops/kernels/bsr_spmv.py::_kernel`` in its K > 1 role
  (B9).

The kernel reads the block arrays directly, for float32, bfloat16 and
float64 blocks and any number of columns, in one of three variants chosen
by :func:`bsr_spmm_variant` and passed to it by name: ``tiled`` (a
CUDA-core GEMM tile staged through shared memory with ``cp.async``) for
block rows of at least 32 rows, blocks at least 16 wide and ``k >= 16``
(32 in float64) with 16-byte-aligned rows; ``staged`` (a CTA copies the
blocks of a run of consecutive block rows and the window of ``X``'s rows
they read into shared memory once, with 16-byte ``cp.async`` copies, so
neighbouring block rows share the rows of ``X`` they both read; each
thread owns up to 8 rows of a block row and 16 bytes of columns) for the
small blocks FEM and multi-component PDE codes store, 2 to 16 rows and
at most 16 columns, at ``k >= 8`` with 16-byte-aligned rows; ``register``
(a group of lanes owns up to 8 rows of a block row and applies each
element of ``X`` it loads to all of them) otherwise. ``staged`` sums in
``register``'s order, so the two give the same bits. Each launch adds one
to ``LAUNCHES`` (by storage type) and to ``VARIANT_LAUNCHES`` (by
variant); the metrics path names the variant, for example
``bsr_spmm:cuda:staged``. Dtypes follow the SpMV rule
(:func:`~spalinalg_tpu_torch.ops.kernels.bsr_spmv.bsr_acc_dtype`):
bfloat16 blocks accumulate and return float32.

:func:`bsr_spmm` is the wrapper. For CUDA tensors it launches the kernel or
raises; for CPU tensors it runs the plain version, which is
:func:`~spalinalg_tpu_torch.ops.kernels.bsr_spmv.bsr_spmv_plain` on a 2-D
right-hand side. :class:`BsrSpmm` carries the gradient of the JAX
package's public path: ``dX = Aᵀ·G`` runs the same kernel on the block
transpose, and ``ddata[k] = G_blk[row_k] @ X_blk[col_k]ᵀ`` is plain torch,
in chunks.

>>> import torch
>>> indptr = torch.tensor([0, 1], dtype=torch.int32)
>>> indices = torch.tensor([0], dtype=torch.int32)
>>> data = torch.tensor([[[1.0, 2.0], [3.0, 4.0]]])
>>> bsr_spmm(indptr, indices, data, torch.eye(2))
tensor([[1., 2.],
        [3., 4.]])
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from .bsr_spmv import (aligned16, bsr_backward, bsr_spmv_plain,
                       checked_operands)

__all__ = ["LAUNCHES", "VARIANT_LAUNCHES", "BsrSpmm", "bsr_spmm",
           "bsr_spmm_plain", "bsr_spmm_variant"]

# Kernel launches per storage type and per variant: plain integers,
# advanced only where the wrapper launches the kernel.
LAUNCHES = {"float32": 0, "bfloat16": 0, "float64": 0}
VARIANT_LAUNCHES = {"register": 0, "tiled": 0, "staged": 0}

# The variant's code in the C entry points.
_VARIANT_CODE = {"register": 0, "tiled": 1, "staged": 2}

_ENTRY = {torch.float32: ("spal_bsr_spmm_f32", "float32"),
          torch.bfloat16: ("spal_bsr_spmm_bf16", "bfloat16"),
          torch.float64: ("spal_bsr_spmm_f64", "float64")}

bsr_spmm_plain = bsr_spmv_plain

# Smallest block rows, block widths and column counts the tiled variant
# takes: below them most of its 128 x 64 output tile (and of each 16- or
# 32-deep step) would be masked. Its tile computes all 64 columns whatever
# k is, so its time does not fall with k: on the H100, 128 x 128 blocks at
# k = 16 took 0.71 ms tiled against 1.14 ms register in float32, but 1.39
# against 1.33 ms in float64, whose register variant is the faster there
# (``spalinalg_tpu_torch/tools/bench_bsr.py``); float64 starts at k = 32.
TILED_MIN_BR = 32
TILED_MIN_BC = 16
TILED_MIN_K = {4: 16, 8: 32}   # by the itemsize of X

# Block shapes and column counts the staged variant takes where the tiled
# one does not (block rows and rows of X whole 16-byte loads). On the H100
# it beat the register variant at every shape measured: square blocks of 2
# (float64; a float32 row of 2 is 8 bytes), 4, 8 and 16 at k = 8, 16, 32
# and 64, by 1.07x (16 x 16 float64, k = 8: 0.1899 against 0.2037 ms) to
# 4.05x (16 x 16 bfloat16, k = 32), on a banded pattern at n = 2**19
# (``spalinalg_tpu_torch/tools/bench_bsr.py --sweep``). So the bounds are
# the kernel's own (blocks up to 16 x 16) and the smallest k measured;
# one-row blocks and k below 8 stay with register, unmeasured.
STAGED_MIN_BR = 2
STAGED_MAX_BS = 16
STAGED_MIN_K = 8


def bsr_spmm_variant(data, X) -> str:
    """The variant of ``csrc/bsr_spmm.cu`` for the blocks ``data`` and the
    operand ``X`` as the kernel takes them
    (:func:`~spalinalg_tpu_torch.ops.kernels.bsr_spmv.kernel_operands`).
    Both wide variants need a block row (``bc * itemsize``) and a row of
    ``X`` (``k * itemsize``) to be whole numbers of 16-byte loads, and
    ``data`` and ``X`` to start on a 16-byte boundary. Then ``"tiled"``
    when ``br >= 32``, ``bc >= 16`` and ``k >= 16`` (32 for a float64
    ``X``); ``"staged"`` when ``2 <= br <= 16``, ``bc <= 16`` and ``k >=
    8``; else, and without them, ``"register"``. Shapes, dtypes and
    addresses alone decide, so it answers for tensors on any device.

    >>> bsr_spmm_variant(torch.zeros(3, 128, 128), torch.zeros(384, 64))
    'tiled'
    >>> bsr_spmm_variant(torch.zeros(3, 8, 8), torch.zeros(24, 64))
    'staged'
    >>> bsr_spmm_variant(torch.zeros(3, 128, 128), torch.zeros(384, 17))
    'register'
    """
    _, br, bc = data.shape
    k = X.shape[1]
    if not (bc * data.element_size() % 16 == 0
            and k * X.element_size() % 16 == 0
            and aligned16(data) and aligned16(X)):
        return "register"
    if (br >= TILED_MIN_BR and bc >= TILED_MIN_BC
            and k >= TILED_MIN_K[X.element_size()]):
        return "tiled"
    if (STAGED_MIN_BR <= br <= STAGED_MAX_BS and bc <= STAGED_MAX_BS
            and k >= STAGED_MIN_K):
        return "staged"
    return "register"


def bsr_spmm(indptr, indices, data, X, variant=None) -> torch.Tensor:
    """``Y = A @ X`` for BSR ``A`` and dense ``X`` of shape ``(ncols, k)``:
    the kernel on CUDA tensors, the plain version on CPU tensors.

    ``variant`` names the kernel's variant instead of
    :func:`bsr_spmm_variant`'s choice, to compare two of them on the same
    operands; the kernel refuses one that does not take them, and the
    wrapper raises. ``k == 0``, a matrix with no block rows and one with no
    blocks launch nothing.
    """
    if variant is not None and variant not in _VARIANT_CODE:
        raise ValueError(f"bsr_spmm has no variant {variant!r}; it has "
                         f"{sorted(_VARIANT_CODE)}")
    data, X, acc = checked_operands("bsr_spmm", indptr, indices, data, X, 2)
    device = X.device
    if device.type == "cpu":
        return bsr_spmm_plain(indptr, indices, data, X)
    if device.type != "cuda":
        raise ValueError(f"no bsr_spmm kernel for device {device}")
    nblocks, br, bc = data.shape
    nbr = indptr.numel() - 1
    k = X.shape[1]
    if nbr == 0 or nblocks == 0 or k == 0:
        return torch.zeros((nbr * br, k), dtype=acc, device=device)
    from ._build import launch

    name, key = _ENTRY[data.dtype]
    variant = variant or bsr_spmm_variant(data, X)
    indptr, indices = indptr.contiguous(), indices.contiguous()
    Y = torch.empty((nbr * br, k), dtype=acc, device=device)
    with torch.cuda.device(device):
        launch(name, indptr.data_ptr(), indices.data_ptr(), data.data_ptr(),
               X.data_ptr(), Y.data_ptr(), nbr, br, bc, nblocks, k,
               _VARIANT_CODE[variant],
               torch.cuda.current_stream(device).cuda_stream)
    LAUNCHES[key] += 1
    VARIANT_LAUNCHES[variant] += 1
    return Y


class BsrSpmm(torch.autograd.Function):
    """``Y = A @ X`` with the gradient of the JAX package's public path.

    ``BsrSpmm.apply(data, X, indptr, indices)``; gradients flow to
    ``data`` and ``X``.
    """

    @staticmethod
    def forward(ctx, data, X, indptr, indices):
        # Kept as they are, not saved, so the transpose cache sees the same
        # objects on every call.
        ctx.structure = (indptr, indices)
        ctx.save_for_backward(data, X)
        return bsr_spmm(indptr, indices, data, X)

    @staticmethod
    @once_differentiable
    def backward(ctx, G):
        data, X = ctx.saved_tensors
        ddata, dX = bsr_backward(ctx, bsr_spmm, data, X, G, *ctx.structure)
        return ddata, dX, None, None
