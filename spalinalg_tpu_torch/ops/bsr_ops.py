"""BSR compute (counterpart of ``spalinalg_tpu/ops/bsr_ops.py``).

``Y[i] += B[i, j] @ X[j]`` over the stored blocks.

- :func:`bsr_matvec` (``bsr @ x``) runs ``BsrSpmv``: the hand-written
  kernel ``csrc/bsr_spmv.cu`` for CUDA tensors, its plain torch version
  for CPU tensors, with the gradient to ``data`` and ``x``. The metrics
  path names the kernel's variant (``bsr_spmv:cuda:vector``, ``:stream``
  or ``:scalar``; ``bsr_spmv:plain`` on the CPU). Each product is the
  span ``spal.bsr_spmv``.
- :func:`bsr_matmat` (``bsr @ X``, ``X`` of shape ``(ncols, k)``) runs
  ``BsrSpmm``: ``csrc/bsr_spmm.cu`` or its plain version, with the
  gradient to ``data`` and ``X``. Any ``k >= 1``; ``k == 0`` gives an
  empty result. The metrics path is ``bsr_spmm:cuda:tiled``,
  ``:staged`` or ``:register``, or ``bsr_spmm:plain``.

bfloat16 blocks accumulate and return float32, whatever the dense operand
is; otherwise the result type is the promotion of the two. The JAX
package's TPU dispatch (the VMEM operand budget, the double-float and v2/v3
eligibility gates, the stream group knob) has no counterpart: every CUDA
operand goes to the kernel. Operands must lie on the matrix's device.

>>> import torch
>>> from spalinalg_tpu_torch import BsrMatrix
>>> a = BsrMatrix.eye(4, blocksize=2)
>>> bsr_matvec(a, torch.arange(4.0, dtype=torch.float64)).tolist()
[0.0, 1.0, 2.0, 3.0]
>>> bsr_matmat(a, torch.ones(4, 3, dtype=torch.float64)).shape
torch.Size([4, 3])
"""

from __future__ import annotations

import torch

from ..utils.metrics import instrument
from ..utils.profiling import annotate
from .kernels.bsr_spmm import BsrSpmm, bsr_spmm_variant
from .kernels.bsr_spmv import BsrSpmv, bsr_spmv_variant, kernel_path
from .matvec import _dense_operand

__all__ = ["bsr_matvec", "bsr_matmat"]


def bsr_matvec(bsr, x) -> torch.Tensor:
    """``y = A @ x`` for BSR ``A``: the span ``spal.bsr_spmv``
    (``utils/profiling.py``) from here to the kernel launch's return."""
    with annotate("spal.bsr_spmv"):
        x = _dense_operand(bsr, x, (1,))
        nnz = bsr.nnz

        def run():
            return BsrSpmv.apply(bsr.data, x, bsr.indptr, bsr.indices)

        return instrument(
            "bsr_spmv", run,
            path=lambda: kernel_path(bsr_spmv_variant, bsr.data, x,
                                     bsr.indptr.numel() - 1),
            device=x.device, nnz=nnz, flops=2 * nnz)


def bsr_matmat(bsr, X) -> torch.Tensor:
    """``Y = A @ X`` for BSR ``A`` and dense ``X`` of shape ``(ncols, k)``."""
    X = _dense_operand(bsr, X, (2,))
    nnz = bsr.nnz

    def run():
        return BsrSpmm.apply(bsr.data, X, bsr.indptr, bsr.indices)

    return instrument("bsr_spmm", run,
                      path=lambda: kernel_path(bsr_spmm_variant, bsr.data, X),
                      device=X.device, nnz=nnz, flops=2 * nnz * X.shape[1])
