"""Elementwise ops on compressed formats: add and sub (counterpart of
``spalinalg_tpu/ops/elementwise.py``; reference: `src/csr/ops/{add,sub}.rs`,
`src/csc/ops/{add,sub}.rs`). Negation is ``with_values(-values)`` on the
matrix.

Semantics kept from the reference (SURVEY.md §2.1):

- output = structural **union** of the operands' stored entries;
- a sum that cancels to exact zero stays as an explicit stored zero;
- output indices sorted and unique;
- shapes must match (`csr/ops/add.rs:9-10`).

The operands' triplets are concatenated and run through the host
sort/segment engine (:func:`~spalinalg_tpu_torch.convert.engine.compress_host`)
with ``dedup=True, drop_zeros=False``, exactly as the JAX package's eager
path does, so both packages give the same structure and values bit for
bit; the output ``nse`` is the exact union nnz. The result lives on the
operands' device. No gradient flows through the host path. There is no
kernel slot here.

Examples
--------
>>> from spalinalg_tpu_torch import CsrMatrix
>>> a = CsrMatrix.eye(2)
>>> b = CsrMatrix(2, 2, [0, 1, 2], [1, 0], [5.0, -6.0])
>>> (a + b).nnz                    # structural union
4
>>> (a - a).values.tolist()        # cancelled zeros are KEPT
[0.0, 0.0]
"""

from __future__ import annotations

import numpy as np
import torch

from ..convert.engine import compress_host, expand_ptr_host
from ..dtypes import numpy_dtype, result_dtype
from ..errors import ShapeError

__all__ = ["compressed_add"]


def _host_triplets(mat, np_dtype):
    """Host ``(major, minor, values)`` of the first ``ptr[-1]`` slots."""
    ptr = mat._ptr.cpu().numpy().astype(np.int64)
    nnz = int(ptr[-1])
    minor = mat._minor[:nnz].cpu().numpy().astype(np.int64)
    values = mat._values[:nnz].detach()
    if values.dtype == torch.bfloat16:
        values = values.float()
    return (expand_ptr_host(ptr), minor,
            values.cpu().numpy().astype(np_dtype, copy=False))


def compressed_add(a, b, *, sign: int):
    """``a + sign*b`` for CSR/CSC with reference union semantics."""
    if a.shape != b.shape:
        raise ShapeError(
            f"shape mismatch {a.shape} vs {b.shape} "
            "(reference: csr/ops/add.rs:9-10)"
        )
    if a.device != b.device:
        raise ValueError(f"operands on devices {a.device} and {b.device}: "
                         "move one of them first")
    cls = type(a)
    n_major = cls._major_dim(a.nrows, a.ncols)
    out_dtype = result_dtype(a.dtype, b.dtype)
    # bfloat16 has no NumPy dtype: sum in float32 on the host (one rounding
    # per sum, as NumPy's own bfloat16 addition does).
    np_dtype = (np.dtype(np.float32) if out_dtype == torch.bfloat16
                else numpy_dtype(out_dtype))
    maj_a, min_a, val_a = _host_triplets(a, np_dtype)
    maj_b, min_b, val_b = _host_triplets(b, np_dtype)
    ptr, minor, values = compress_host(
        np.concatenate([maj_a, maj_b]), np.concatenate([min_a, min_b]),
        np.concatenate([val_a, sign * val_b]), n_major,
        dedup=True, drop_zeros=False)
    out = cls._from_host(a.nrows, a.ncols, ptr, minor, values, a.device)
    return out if out.dtype == out_dtype else out.astype(out_dtype)
