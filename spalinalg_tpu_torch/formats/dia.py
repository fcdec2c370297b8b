"""DIA (diagonal) format, the storage for banded and stencil matrices
(counterpart of ``spalinalg_tpu/formats/dia.py``; a `scipy.sparse.dia_matrix`
peer, absent from the reference).

SpMV needs no indices: ``y[i] = Σ_k data[k, i]·x[i + offsets[k]]``, one
multiply-add per stored diagonal with a shifted operand window. ``A @ x``
runs the hand-written kernel ``csrc/dia_spmv.cu`` on CUDA tensors (its
plain torch version on CPU tensors), with the gradient to ``data`` and
``x``; ``A @ X`` for a 2-D ``X`` is plain torch shifted multiply-adds on
the matrix's device (the JAX package has no kernel for it either).

Storage convention (row-aligned): ``data[k, i] = A[i, i + offsets[k]]``
for the in-range part of row ``i``; out-of-range slots hold zeros and
contribute nothing. (`scipy.sparse.dia_matrix` aligns by column.) The
offsets stay in the order given: ``transpose`` negates them in place.

Examples
--------
>>> import torch
>>> from spalinalg_tpu_torch import DiaMatrix
>>> A = DiaMatrix.from_diagonals([-1.0, 2.0, -1.0], [-1, 0, 1], 4,
...                              device="cpu")
>>> (A @ torch.ones(4, dtype=torch.float64)).tolist()
[1.0, 0.0, 0.0, 1.0]
>>> A.shape, A.nnz
((4, 4), 10)
>>> back = DiaMatrix.from_csr(A.to_csr())
>>> torch.equal(back.to_dense(), A.to_dense())
True
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..dtypes import numpy_dtype, result_dtype
from ..errors import ShapeError
from .compressed import _values_tensor

__all__ = ["DiaMatrix"]


def _diag_span(o: int, nrows: int, ncols: int) -> Tuple[int, int]:
    """``(i0, length)``: the first row and the number of rows of diagonal
    ``o`` that lie inside an ``nrows x ncols`` matrix."""
    return max(-o, 0), min(nrows + min(o, 0), ncols - max(o, 0))


def _diagonal_values(d, o: int, nrows: int, ncols: int,
                     dtype) -> Tuple[int, np.ndarray]:
    """``(i0, values)``: the first row of diagonal ``o`` of an ``nrows x
    ncols`` matrix and its in-range values taken from ``d`` (a scalar
    broadcasts). Raises ``ShapeError`` for a diagonal outside the matrix
    or shorter than its span. Shared by ``from_diagonals`` and ``diags``."""
    i0, length = _diag_span(o, nrows, ncols)
    if length <= 0:
        raise ShapeError(f"offset {o} outside a {nrows}x{ncols} matrix")
    d = np.asarray(d, dtype=dtype)
    if d.size == 1:
        return i0, np.broadcast_to(d.reshape(()), (length,))
    if d.size < length:
        raise ShapeError(
            f"diagonal for offset {o} has {d.size} < {length} entries")
    return i0, d[:length]


class DiaMatrix:
    """Diagonal-storage sparse matrix (square or rectangular) on one
    device."""

    __slots__ = ("_nrows", "_ncols", "_offsets", "_data", "_kernel_offsets")

    def __init__(self, nrows: int, ncols: int, offsets: Sequence[int], data,
                 *, device=None):
        """Validating constructor (``spalinalg_tpu/formats/dia.py:49-71``,
        the same checks and ``ShapeError``\\ s). ``data`` is ``(D, nrows)``
        and goes to ``device`` (``None``: the default device, see
        ``spalinalg_tpu_torch/device.py``); a tensor keeps its autograd
        graph."""
        nrows, ncols = int(nrows), int(ncols)
        if nrows <= 0 or ncols <= 0:
            raise ShapeError(
                f"matrix dimensions must be positive, got {nrows}x{ncols}")
        offsets = np.asarray(offsets, dtype=np.int64).reshape(-1)
        if np.unique(offsets).size != offsets.size:
            raise ShapeError("duplicate diagonal offsets")
        shape = (tuple(data.shape) if isinstance(data, torch.Tensor)
                 else np.shape(data))
        if len(shape) != 2 or shape[0] != offsets.size:
            raise ShapeError(
                f"data must be ({offsets.size}, nrows), got {shape}")
        if shape[1] != nrows:
            raise ShapeError(
                f"row-aligned data needs {nrows} columns, got {shape[1]}")
        if offsets.size and (offsets.min() <= -nrows
                             or offsets.max() >= ncols):
            raise ShapeError("diagonal offset outside the matrix")
        self._nrows, self._ncols = nrows, ncols
        self._offsets = offsets
        self._data = _values_tensor(data, resolve_device(device)).contiguous()
        self._kernel_offsets = None

    # ---- constructors ----

    @classmethod
    def from_diagonals(cls, diagonals, offsets, n, *, ncols=None,
                       dtype=np.float64, device=None) -> "DiaMatrix":
        """Build from per-diagonal scalars or arrays (like ``diags``), on
        the host, then onto ``device``."""
        ncols = int(ncols) if ncols is not None else int(n)
        if np.isscalar(offsets):
            offsets, diagonals = [int(offsets)], [diagonals]
        offs = [int(o) for o in offsets]
        if len(diagonals) != len(offs):
            raise ShapeError(
                f"{len(diagonals)} diagonals for {len(offs)} offsets")
        data = np.zeros((len(offs), n), dtype=dtype)
        for k, (d, o) in enumerate(zip(diagonals, offs)):
            i0, values = _diagonal_values(d, o, n, ncols, dtype)
            data[k, i0: i0 + values.size] = values
        return cls(n, ncols, offs, data, device=device)

    @classmethod
    def from_csr(cls, csr) -> "DiaMatrix":
        """CSR -> DIA, a host structure pass; the result lands on the CSR
        matrix's device. Raises if impractically many distinct diagonals
        (over ``max(64, band)``) would densify, as the JAX package does."""
        rows, ind, val = csr._coo_arrays_host()
        n, m = csr.shape
        offs = np.unique(ind - rows)
        if offs.size > max(64, int(offs.max(initial=0)
                                   - offs.min(initial=0)) + 1):
            raise ShapeError("structure not diagonal-sparse")
        data = np.zeros((offs.size, n), dtype=val.dtype)
        k = np.searchsorted(offs, ind - rows)
        data[k, rows] = val
        return cls(n, m, offs, data, device=csr.device)

    # ---- properties ----

    @property
    def shape(self) -> Tuple[int, int]:
        return (self._nrows, self._ncols)

    @property
    def nrows(self) -> int:
        return self._nrows

    @property
    def ncols(self) -> int:
        return self._ncols

    @property
    def offsets(self) -> np.ndarray:
        """The diagonal offsets, NumPy int64, in the order given."""
        return self._offsets

    @property
    def data(self) -> torch.Tensor:
        return self._data

    @property
    def dtype(self) -> torch.dtype:
        return self._data.dtype

    @property
    def device(self) -> torch.device:
        return self._data.device

    @property
    def nnz(self) -> int:
        """Stored slots that are structurally in range (explicit zeros on
        the diagonals included: DIA stores whole diagonals)."""
        return int(sum(_diag_span(int(o), self._nrows, self._ncols)[1]
                       for o in self._offsets))

    def astype(self, dtype) -> "DiaMatrix":
        """The same diagonals with ``data`` cast to ``dtype`` on the
        matrix's device."""
        return DiaMatrix(self._nrows, self._ncols, self._offsets,
                         self._data.to(dtype), device=self.device)

    # ---- compute ----

    def _device_offsets(self) -> torch.Tensor:
        """The offsets as an int64 tensor on the matrix's device, made once
        and read by the kernel as it is."""
        if self._kernel_offsets is None:
            self._kernel_offsets = torch.as_tensor(self._offsets,
                                                   device=self.device)
        return self._kernel_offsets

    def __matmul__(self, other):
        from ..ops.kernels.csr_spmv import path_for
        from ..ops.kernels.dia_spmv import DiaSpmv, dia_spmv_plain
        from ..utils.metrics import instrument

        if isinstance(other, np.ndarray):
            other = torch.from_numpy(np.ascontiguousarray(other))
        if not isinstance(other, torch.Tensor) or other.ndim not in (1, 2):
            return NotImplemented
        if other.shape[0] != self._ncols:
            raise ShapeError(
                f"operand length {other.shape[0]} != ncols {self._ncols}")
        if other.device != self.device:
            raise ValueError(
                f"operand on device {other.device}, matrix on device "
                f"{self.device}: move one of them first")
        out_dtype = result_dtype(self.dtype, other.dtype)
        n, m = self._nrows, self._ncols
        nnz = self.nnz
        counts = dict(nnz=nnz, flops=2 * nnz)
        if other.ndim == 1:
            return instrument(
                "dia_spmv", lambda: DiaSpmv.apply(
                    self._data, other, self._offsets, n, m,
                    self._device_offsets()).to(out_dtype),
                path=path_for(other.device), device=other.device, **counts)
        return instrument(
            "dia_spmm", lambda: dia_spmv_plain(
                self._offsets, self._data, other, n, m).to(out_dtype),
            path="torch", device=other.device, **counts)

    # ---- conversions / export ----

    def to_csr(self):
        """CSR on the matrix's device, every in-range slot kept (explicit
        zeros included), through ``compress_host``."""
        from ..convert.engine import compress_host
        from .compressed import CsrMatrix

        numpy_dtype(self.dtype)  # DTypeError for bfloat16
        n, m = self._nrows, self._ncols
        data = self._data.detach().cpu().numpy()
        rows_l, cols_l, vals_l = [], [], []
        for k, o in enumerate(self._offsets):
            i0, length = _diag_span(int(o), n, m)
            r = np.arange(i0, i0 + length, dtype=np.int64)
            rows_l.append(r)
            cols_l.append(r + o)
            vals_l.append(data[k, i0: i0 + length])
        rows = np.concatenate(rows_l) if rows_l else np.empty(0, np.int64)
        cols = np.concatenate(cols_l) if cols_l else np.empty(0, np.int64)
        vals = (np.concatenate(vals_l) if vals_l
                else np.empty(0, data.dtype))
        ptr, minor, values = compress_host(rows, cols, vals, n,
                                           dedup=False, drop_zeros=False)
        return CsrMatrix._from_host(n, m, ptr, minor, values, self.device)

    def to_dense(self) -> torch.Tensor:
        return self.to_csr().to_dense()

    def transpose(self) -> "DiaMatrix":
        """Transpose on the matrix's device: the offsets negate in place
        (order kept) and each diagonal's in-range part shifts to its
        transposed rows (no gathers)."""
        n, m = self._nrows, self._ncols
        new = self._data.new_zeros((self._offsets.size, m))
        for k, o in enumerate(self._offsets):
            i0, length = _diag_span(int(o), n, m)
            # entry (i, i + o) -> row i + o of the transpose, offset -o
            new[k, i0 + o: i0 + o + length] = self._data[k, i0: i0 + length]
        return DiaMatrix(m, n, -self._offsets, new, device=self.device)

    @property
    def T(self) -> "DiaMatrix":
        return self.transpose()

    def __repr__(self) -> str:
        return (f"DiaMatrix(shape={self.shape}, "
                f"n_diags={self._offsets.size}, dtype={self.dtype}, "
                f"device={self.device})")
