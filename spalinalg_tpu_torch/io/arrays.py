"""Carry compressed, BSR, DIA and device-COO matrices between the JAX
package and the port.

The JAX package's ``CsrMatrix``/``CscMatrix`` hold ``(ptr, minor, values)``
device arrays; ``np.asarray`` of each gives host arrays that
:func:`csr_from_arrays` / :func:`csc_from_arrays` turn into the port's
matrix on a named device, and :func:`to_arrays` turns back. A
``BsrMatrix`` crosses the same way as ``(indptr, indices, data)``
(:func:`bsr_from_arrays`); bfloat16 blocks cross as float32 and are cast on
the device, which is exact. A ``DiaMatrix`` crosses as ``(nrows, ncols,
offsets, data)`` (:func:`dia_from_arrays`) and a ``DeviceCoo`` as
``(nrows, ncols, rows, cols, vals)`` (:func:`device_coo_from_arrays`).
Neither side imports the other: the arrays cross as NumPy, onto the
``device`` named, else the default device.

A structure may carry padding (``nse > ptr[-1]``), as matrices produced
under ``jit`` do: the first ``ptr[-1]`` entries are validated like the
constructor's input, and the padding slots must hold in-range indices.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..dtypes import numpy_dtype
from ..errors import StructureError
from ..formats.bsr import BsrMatrix
from ..formats.compressed import CscMatrix, CsrMatrix, _index_tensor, _values_tensor
from ..formats.device import DeviceCoo
from ..formats.dia import DiaMatrix

__all__ = ["csr_from_arrays", "csc_from_arrays", "bsr_from_arrays",
           "dia_from_arrays", "device_coo_from_arrays", "to_arrays"]


def _from_arrays(cls, nrows, ncols, ptr, minor, values, device):
    ptr = np.asarray(ptr, dtype=np.int64)
    minor = np.asarray(minor)
    values = np.asarray(values)
    if ptr.ndim != 1 or ptr.size == 0:
        raise StructureError(f"pointer array must be 1-D, got {ptr.shape}")
    nnz = int(ptr[-1])
    cls._validate(nrows, ncols, ptr, minor[:nnz], values[:nnz])
    if minor.shape != values.shape:
        raise StructureError(
            f"index and value arrays differ in length: {minor.shape} vs "
            f"{values.shape}")
    n_minor = cls._minor_dim(nrows, ncols)
    pad = minor[nnz:]
    if pad.size and (pad.min() < 0 or pad.max() >= n_minor):
        raise StructureError(f"padding indices must be in [0, {n_minor})")
    device = resolve_device(device)
    return cls._from_parts(nrows, ncols, _index_tensor(ptr, device),
                           _index_tensor(minor, device),
                           _values_tensor(values, device))


def csr_from_arrays(nrows, ncols, rowptr, colind, values, *,
                    device=None) -> CsrMatrix:
    """The port's CSR matrix from host arrays (e.g. ``np.asarray`` of a JAX
    ``CsrMatrix``'s ``rowptr``, ``colind`` and ``values``)."""
    return _from_arrays(CsrMatrix, int(nrows), int(ncols), rowptr, colind,
                        values, device)


def csc_from_arrays(nrows, ncols, colptr, rowind, values, *,
                    device=None) -> CscMatrix:
    """The port's CSC matrix from host arrays."""
    return _from_arrays(CscMatrix, int(nrows), int(ncols), colptr, rowind,
                        values, device)


def bsr_from_arrays(nrows, ncols, blocksize, indptr, indices, data, *,
                    device=None) -> BsrMatrix:
    """The port's BSR matrix from host arrays (e.g. ``np.asarray`` of a JAX
    ``BsrMatrix``'s ``indptr``, ``indices`` and ``data``), through the
    validating constructor. A bfloat16 ``data`` array crosses as float32
    and is cast back on ``device``."""
    data = np.asarray(data)
    bf16 = data.dtype.name == "bfloat16"
    mat = BsrMatrix(nrows, ncols, blocksize, indptr, indices,
                    data.astype(np.float32) if bf16 else data, device=device)
    return mat.astype(torch.bfloat16) if bf16 else mat


def dia_from_arrays(nrows, ncols, offsets, data, *,
                    device=None) -> DiaMatrix:
    """The port's DIA matrix from host arrays (e.g. a JAX ``DiaMatrix``'s
    ``offsets`` and ``np.asarray`` of its ``data``), through the validating
    constructor."""
    return DiaMatrix(nrows, ncols, np.asarray(offsets), np.asarray(data),
                     device=device)


def device_coo_from_arrays(nrows, ncols, rows, cols, vals, *,
                           device=None) -> DeviceCoo:
    """The port's ``DeviceCoo`` from host arrays (e.g. ``np.asarray`` of a
    JAX ``DeviceCoo``'s ``rows``, ``cols`` and ``values``), sentinel
    padding included."""
    return DeviceCoo(nrows, ncols, np.asarray(rows), np.asarray(cols),
                     np.asarray(vals), device=device)


def to_arrays(mat):
    """``(nrows, ncols, ptr, minor, values)`` as host NumPy arrays (int32
    indices, padding slots included), ready for the JAX package's
    ``CsrMatrix._from_parts`` / ``CscMatrix._from_parts``; for a
    ``BsrMatrix`` ``(nrows, ncols, (br, bc), indptr, indices, data)``, with
    bfloat16 blocks as float32 (exact), ready for ``BsrMatrix(...)`` or
    ``BsrMatrix._from_parts``; for a ``DiaMatrix`` ``(nrows, ncols,
    offsets, data)``, ready for ``DiaMatrix(...)``; for a ``DeviceCoo``
    ``(nrows, ncols, rows, cols, vals)``, ready for ``DeviceCoo(...)``."""
    if isinstance(mat, DiaMatrix):
        return (mat.nrows, mat.ncols, mat.offsets.copy(),
                mat.data.detach().cpu().numpy())
    if isinstance(mat, DeviceCoo):
        return (mat.nrows, mat.ncols, mat.rows.cpu().numpy(),
                mat.cols.cpu().numpy(), mat.values.detach().cpu().numpy())
    if isinstance(mat, BsrMatrix):
        data = mat.data.detach()
        if data.dtype == torch.bfloat16:
            data = data.float()
        return (mat.nrows, mat.ncols, mat.blocksize, mat.indptr.cpu().numpy(),
                mat.indices.cpu().numpy(), data.cpu().numpy())
    numpy_dtype(mat.dtype)  # DTypeError for bfloat16
    return (mat.nrows, mat.ncols, mat._ptr.cpu().numpy(),
            mat._minor.cpu().numpy(), mat._values.detach().cpu().numpy())
