"""BSR SpMM: the Hopper kernel's wrapper, its plain torch version, its launch
count, and the gradient.

The kernel (``spalinalg_tpu_torch/csrc/bsr_spmm.cu``) replaces the Pallas
kernels on the JAX package's BSR SpMM path:

- ``spalinalg_tpu/ops/kernels/bsr_stream.py::_kernel_v2`` (B5),
- ``spalinalg_tpu/ops/kernels/bsr_spmv.py::_kernel`` in its K > 1 role
  (B9).

A group of lanes owns a tile of up to 8 rows of one block row and a range
of the columns: it reads the block arrays directly and applies each row of
``X`` it loads to all the tile's rows, for float32, bfloat16 and float64
blocks and any number of columns. Dtypes follow the SpMV rule
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

from .bsr_spmv import bsr_backward, bsr_spmv_plain, checked_operands

__all__ = ["LAUNCHES", "BsrSpmm", "bsr_spmm", "bsr_spmm_plain"]

# Kernel launches per storage type: plain integers, advanced only where the
# wrapper launches the kernel.
LAUNCHES = {"float32": 0, "bfloat16": 0, "float64": 0}

_ENTRY = {torch.float32: ("spal_bsr_spmm_f32", "float32"),
          torch.bfloat16: ("spal_bsr_spmm_bf16", "bfloat16"),
          torch.float64: ("spal_bsr_spmm_f64", "float64")}

bsr_spmm_plain = bsr_spmv_plain


def bsr_spmm(indptr, indices, data, X) -> torch.Tensor:
    """``Y = A @ X`` for BSR ``A`` and dense ``X`` of shape ``(ncols, k)``:
    the kernel on CUDA tensors, the plain version on CPU tensors.

    ``k == 0``, a matrix with no block rows and one with no blocks launch
    nothing.
    """
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
    indptr, indices = indptr.contiguous(), indices.contiguous()
    Y = torch.empty((nbr * br, k), dtype=acc, device=device)
    with torch.cuda.device(device):
        launch(name, indptr.data_ptr(), indices.data_ptr(), data.data_ptr(),
               X.data_ptr(), Y.data_ptr(), nbr, br, bc, nblocks, k,
               torch.cuda.current_stream(device).cuda_stream)
    LAUNCHES[key] += 1
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
