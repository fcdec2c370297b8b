"""Row/column selection and slicing (counterpart of
``spalinalg_tpu/ops/indexing.py``; the `scipy.sparse` indexing surface).

Index plans are host NumPy, built once; the values move in one gather on
the matrix's device. ``row_slice`` is pointer arithmetic and slicing: the
result's index and value tensors are views of the source's.

Examples
--------
>>> from spalinalg_tpu_torch import CsrMatrix
>>> from spalinalg_tpu_torch.ops.indexing import (row_slice, select_rows,
...                                               submatrix)
>>> a = CsrMatrix(3, 3, [0, 2, 3, 5], [0, 2, 1, 0, 2],
...               [1.0, 2.0, 3.0, 4.0, 5.0], device="cpu")
>>> r = row_slice(a, 1, 3)
>>> r.shape, r.nnz
((2, 3), 3)
>>> select_rows(a, [2, 0]).to_dense().tolist()[0]      # reorder + select
[4.0, 0.0, 5.0]
>>> submatrix(a, [0, 2], [0, 2]).to_dense().tolist()
[[1.0, 2.0], [4.0, 5.0]]
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..dtypes import INDEX_DTYPE
from ..errors import IndexError_, ShapeError

__all__ = ["row_slice", "select_rows", "select_cols", "submatrix",
           "getrow", "getcol"]


def _csr_of(mat):
    from ..formats.compressed import CsrMatrix

    if isinstance(mat, CsrMatrix):
        return mat
    if hasattr(mat, "to_csr"):
        return mat.to_csr()
    raise ShapeError(f"unsupported operand {type(mat).__name__}")


def _host_ptr(csr) -> np.ndarray:
    return csr.rowptr.cpu().numpy().astype(np.int64)


def row_slice(mat, start: int, stop: int):
    """Rows ``[start, stop)`` as a new CSR: pointer arithmetic only."""
    from ..formats.compressed import CsrMatrix

    csr = _csr_of(mat)
    n = csr.nrows
    if not (0 <= start <= stop <= n):
        raise IndexError_(
            f"row slice [{start}, {stop}) out of range for {n} rows")
    ptr = _host_ptr(csr)
    lo, hi = int(ptr[start]), int(ptr[stop])
    new_ptr = torch.as_tensor(ptr[start: stop + 1] - lo, dtype=INDEX_DTYPE,
                              device=csr.device)
    return CsrMatrix._from_parts(stop - start, csr.ncols, new_ptr,
                                 csr.colind[lo:hi], csr.values[lo:hi])


def select_rows(mat, rows: Sequence[int]):
    """Rows in the given order (duplicates allowed): ``A[rows, :]``."""
    from ..formats.compressed import CsrMatrix

    csr = _csr_of(mat)
    rows = np.asarray(rows, dtype=np.int64)
    if rows.ndim != 1:
        raise ShapeError("rows must be a 1-D index sequence")
    if rows.size and (rows.min() < 0 or rows.max() >= csr.nrows):
        raise IndexError_(f"row index out of range for {csr.nrows} rows")
    ptr = _host_ptr(csr)
    lens = np.diff(ptr)[rows]
    new_ptr = np.concatenate([[0], np.cumsum(lens)])
    # each selected row's contiguous slot range
    gather = (np.repeat(ptr[rows] - new_ptr[:-1], lens)
              + np.arange(int(new_ptr[-1]), dtype=np.int64))
    g = torch.as_tensor(gather, device=csr.device)
    return CsrMatrix._from_parts(
        rows.size, csr.ncols,
        torch.as_tensor(new_ptr, dtype=INDEX_DTYPE, device=csr.device),
        csr.colind[g], csr.values[g])


def select_cols(mat, cols: Sequence[int]):
    """Columns in the given order (duplicates allowed): ``A[:, cols]``."""
    return select_rows(_csr_of(mat).transpose(), cols).transpose()


def submatrix(mat, rows: Sequence[int], cols: Sequence[int]):
    """``A[np.ix_(rows, cols)]``: row selection, then column selection."""
    return select_cols(select_rows(mat, rows), cols)


def getrow(mat, i: int):
    """Row ``i`` as a ``1 x ncols`` CSR."""
    return row_slice(mat, i, i + 1)


def getcol(mat, j: int):
    """Column ``j`` as an ``nrows x 1`` CSR."""
    csr = _csr_of(mat)
    if not 0 <= j < csr.ncols:
        raise IndexError_(f"column {j} out of range for {csr.ncols}")
    return select_cols(csr, [j])
