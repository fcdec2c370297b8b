"""SpMV: sparse x dense products (counterpart of
``spalinalg_tpu/ops/matvec.py``; absent from the reference, whose docs only
state the intent, `csr.rs:16-17`).

- :func:`csr_matvec` runs ``CsrSpmv``: the hand-written kernel for CUDA
  tensors, its plain torch version for CPU tensors, with the gradient to
  ``values`` and ``x``.
- :func:`csc_matvec` runs the same kernel on a cached CSR mirror of the CSC
  structure (the CSR of A has the transposed CSC structure and the values
  ``values[perm]``), as ``spalinalg_tpu/ops/matvec.py`` does.
- :func:`matmul_dense` dispatches ``A @ dense``. A 2-D right-hand side
  (SpMM) runs a plain torch version on CPU tensors; on CUDA tensors it
  raises until its kernel is ported.

Operands must lie on the matrix's device; nothing here moves them.
"""

from __future__ import annotations

import numpy as np
import torch

from ..errors import ShapeError
from ..utils.metrics import instrument
from .kernels.csr_spmv import CsrSpmv, csr_spmv_plain, path_for, transpose_plan

__all__ = ["matmul_dense", "csr_matvec", "csc_matvec"]


def _dense_operand(mat, other, ndims) -> torch.Tensor:
    """``other`` as a tensor on the matrix's device, with checked shape.
    A NumPy array is a CPU tensor."""
    if isinstance(other, np.ndarray):
        other = torch.from_numpy(np.ascontiguousarray(other))
    if other.ndim not in ndims:
        raise ShapeError(
            f"dense rhs must be {' or '.join(f'{d}-D' for d in ndims)}, "
            f"got ndim={other.ndim}")
    if other.shape[0] != mat.ncols:
        raise ShapeError(
            f"dimension mismatch: {mat.shape} @ {tuple(other.shape)} "
            "(reference: csr/ops/mul.rs:8)"
        )
    if other.device != mat.device:
        raise ValueError(
            f"operand on device {other.device}, matrix on device "
            f"{mat.device}: move one of them first")
    return other


def _csr_arrays(mat):
    """``(rowptr, colind, values)`` of the CSR form of ``mat``: the arrays
    themselves for CSR, the cached mirror for CSC."""
    from ..formats.compressed import CscMatrix

    if isinstance(mat, CscMatrix):
        t = transpose_plan(mat.colptr, mat.rowind, mat.ncols, mat.nrows)
        return t.ptr, t.minor, mat.values[t.perm]
    return mat.rowptr, mat.colind, mat.values


def _spmv(op, mat, x):
    x = _dense_operand(mat, x, (1,))
    nnz = mat.nse
    itm = mat.values.element_size()

    def run():
        rowptr, colind, values = _csr_arrays(mat)
        return CsrSpmv.apply(values, x, rowptr, colind, mat.nrows,
                             mat.ncols)

    return instrument(op, run, path=path_for(x.device), device=x.device,
                      nnz=nnz, flops=2 * nnz, bytes=(itm * 2 + 4) * nnz)


def csr_matvec(csr, x) -> torch.Tensor:
    """``y = A @ x`` for CSR ``A``."""
    return _spmv("csr_spmv", csr, x)


def csc_matvec(csc, x) -> torch.Tensor:
    """``y = A @ x`` for CSC ``A``, through the cached CSR mirror."""
    return _spmv("csc_spmv", csc, x)


def _spmm_plain(mat, X) -> torch.Tensor:
    """Plain torch ``Y = A @ X`` (CPU tensors only until the SpMM kernel,
    ROADMAP queue B item B2, is ported)."""
    if X.device.type != "cpu":
        raise NotImplementedError(
            "SpMM (2-D right-hand side) on a GPU waits for its kernel: "
            "ROADMAP queue B, item B2")
    rowptr, colind, values = _csr_arrays(mat)
    return csr_spmv_plain(rowptr, colind, values, X, mat.nrows)


def matmul_dense(mat, other) -> torch.Tensor:
    """Dispatch ``A @ dense`` to SpMV (1-D rhs) or SpMM (2-D rhs)."""
    other = _dense_operand(mat, other, (1, 2))
    if other.ndim == 2:
        return _spmm_plain(mat, other)
    from ..formats.compressed import CscMatrix

    if isinstance(mat, CscMatrix):
        return csc_matvec(mat, other)
    return csr_matvec(mat, other)
