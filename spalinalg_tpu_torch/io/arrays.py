"""Carry compressed matrices between the JAX package and the port.

The JAX package's ``CsrMatrix``/``CscMatrix`` hold ``(ptr, minor, values)``
device arrays; ``np.asarray`` of each gives host arrays that
:func:`csr_from_arrays` / :func:`csc_from_arrays` turn into the port's
matrix on a named device, and :func:`to_arrays` turns back. Neither side
imports the other: the arrays cross as NumPy.

A structure may carry padding (``nse > ptr[-1]``), as matrices produced
under ``jit`` do: the first ``ptr[-1]`` entries are validated like the
constructor's input, and the padding slots must hold in-range indices.
"""

from __future__ import annotations

import numpy as np

from ..dtypes import numpy_dtype
from ..errors import StructureError
from ..formats.compressed import CscMatrix, CsrMatrix, _index_tensor, _values_tensor

__all__ = ["csr_from_arrays", "csc_from_arrays", "to_arrays"]


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
    return cls._from_parts(nrows, ncols, _index_tensor(ptr, device),
                           _index_tensor(minor, device),
                           _values_tensor(values, device))


def csr_from_arrays(nrows, ncols, rowptr, colind, values, *,
                    device="cpu") -> CsrMatrix:
    """The port's CSR matrix from host arrays (e.g. ``np.asarray`` of a JAX
    ``CsrMatrix``'s ``rowptr``, ``colind`` and ``values``)."""
    return _from_arrays(CsrMatrix, int(nrows), int(ncols), rowptr, colind,
                        values, device)


def csc_from_arrays(nrows, ncols, colptr, rowind, values, *,
                    device="cpu") -> CscMatrix:
    """The port's CSC matrix from host arrays."""
    return _from_arrays(CscMatrix, int(nrows), int(ncols), colptr, rowind,
                        values, device)


def to_arrays(mat):
    """``(nrows, ncols, ptr, minor, values)`` as host NumPy arrays (int32
    indices, padding slots included), ready for the JAX package's
    ``CsrMatrix._from_parts`` / ``CscMatrix._from_parts``."""
    numpy_dtype(mat.dtype)  # DTypeError for bfloat16
    return (mat.nrows, mat.ncols, mat._ptr.cpu().numpy(),
            mat._minor.cpu().numpy(), mat._values.detach().cpu().numpy())
