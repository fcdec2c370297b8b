"""SpMV and SpMM: sparse x dense products (counterpart of
``spalinalg_tpu/ops/matvec.py``; absent from the reference, whose docs only
state the intent, `csr.rs:16-17`).

- :func:`csr_matvec` runs ``CsrSpmv``: the hand-written kernel for CUDA
  tensors, its plain torch version for CPU tensors, with the gradient to
  ``values`` and ``x``.
- :func:`csc_matvec` runs the same kernel on a cached CSR mirror of the CSC
  structure (the CSR of A has the transposed CSC structure and the values
  ``values[perm]``), as ``spalinalg_tpu/ops/matvec.py`` does.
- :func:`csr_matmat` / :func:`csc_matmat` (SpMM, ``Y = A @ X`` for dense
  ``X`` of shape ``(ncols, k)``) run ``CsrSpmm``: the hand-written SpMM
  kernel for CUDA tensors, its plain torch version for CPU tensors, with
  the gradient to ``values`` and ``X``; CSC goes through the same CSR
  mirror. Any ``k >= 1`` is taken; ``k == 0`` gives an empty result.
- The metrics path names the kernel variant that runs
  (``csr_spmv:cuda:vector``, ``csr_spmm:cuda:register``, ...) or
  ``:plain`` off the card.
- :func:`matmul_dense` dispatches ``A @ dense`` to SpMV (1-D) or SpMM
  (2-D).

Operands must lie on the matrix's device; nothing here moves them.
"""

from __future__ import annotations

import numpy as np
import torch

from ..errors import ShapeError
from ..utils.metrics import instrument
from .kernels import csr_spmm as spmm_kernel
from .kernels import csr_spmv as spmv_kernel
from .kernels.csr_spmm import CsrSpmm
from .kernels.csr_spmv import CsrSpmv, transpose_plan

__all__ = ["matmul_dense", "csr_matvec", "csr_matmat", "csc_matvec",
           "csc_matmat"]


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

    def path():
        from ..formats.compressed import CscMatrix

        if isinstance(mat, CscMatrix):
            t = transpose_plan(mat.colptr, mat.rowind, mat.ncols, mat.nrows)
            return spmv_kernel.kernel_path(t.minor, mat.values, x, fresh=True)
        return spmv_kernel.kernel_path(mat.colind, mat.values, x)

    return instrument(op, run, path=path, device=x.device,
                      nnz=nnz, flops=2 * nnz, bytes=(itm * 2 + 4) * nnz)


def csr_matvec(csr, x) -> torch.Tensor:
    """``y = A @ x`` for CSR ``A``."""
    return _spmv("csr_spmv", csr, x)


def csc_matvec(csc, x) -> torch.Tensor:
    """``y = A @ x`` for CSC ``A``, through the cached CSR mirror."""
    return _spmv("csc_spmv", csc, x)


def _spmm(op, mat, X):
    X = _dense_operand(mat, X, (2,))
    nnz, k = mat.nse, int(X.shape[1])
    itm = mat.values.element_size()

    def run():
        rowptr, colind, values = _csr_arrays(mat)
        return CsrSpmm.apply(values, X, rowptr, colind, mat.nrows,
                             mat.ncols)

    def path():
        from ..formats.compressed import CscMatrix

        if isinstance(mat, CscMatrix):
            t = transpose_plan(mat.colptr, mat.rowind, mat.ncols, mat.nrows)
            return spmm_kernel.kernel_path(t.ptr, t.minor, mat.values, X)
        return spmm_kernel.kernel_path(mat.rowptr, mat.colind, mat.values, X)

    return instrument(op, run, path=path, device=X.device,
                      nnz=nnz, flops=2 * nnz * k,
                      bytes=(itm * (1 + 2 * k) + 4) * nnz)


def csr_matmat(csr, X) -> torch.Tensor:
    """``Y = A @ X`` for CSR ``A`` and dense ``X`` of shape ``(ncols, k)``."""
    return _spmm("csr_spmm", csr, X)


def csc_matmat(csc, X) -> torch.Tensor:
    """``Y = A @ X`` for CSC ``A``, through the cached CSR mirror."""
    return _spmm("csc_spmm", csc, X)


def matmul_dense(mat, other) -> torch.Tensor:
    """Dispatch ``A @ dense`` to SpMV (1-D rhs) or SpMM (2-D rhs)."""
    other = _dense_operand(mat, other, (1, 2))
    from ..formats.compressed import CscMatrix

    if isinstance(mat, CscMatrix):
        return (csc_matvec if other.ndim == 1 else csc_matmat)(mat, other)
    return (csr_matvec if other.ndim == 1 else csr_matmat)(mat, other)
