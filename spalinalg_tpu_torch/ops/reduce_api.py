"""Matrix reductions and the elementwise product: ``sum``, ``mean``,
``norm``, ``diagonal``, ``multiply`` (counterpart of
``spalinalg_tpu/ops/reduce_api.py``; the `scipy.sparse` query surface).

Axis sums are SpMV against a ones vector (the port's SpMV kernel on the
card); ``diagonal`` gathers through an index built on the device;
``multiply`` (Hadamard) intersects the two patterns on the host and
multiplies the matched values on the matrices' device.

Examples
--------
>>> from spalinalg_tpu_torch import CsrMatrix
>>> from spalinalg_tpu_torch.ops.reduce_api import (diagonal, mat_sum,
...                                                 multiply, norm)
>>> a = CsrMatrix(2, 3, [0, 2, 3], [0, 2, 1], [1.0, 2.0, 3.0], device="cpu")
>>> float(mat_sum(a)), mat_sum(a, axis=1).tolist()
(6.0, [3.0, 3.0])
>>> diagonal(a).tolist()
[1.0, 3.0]
>>> b = CsrMatrix(2, 3, [0, 1, 3], [0, 0, 1], [10.0, 5.0, 4.0], device="cpu")
>>> h = multiply(a, b)              # Hadamard: intersection of patterns
>>> h.nnz, h.values.tolist()
(2, [10.0, 12.0])
>>> round(float(norm(a)), 6)        # Frobenius
3.741657
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from ..errors import ShapeError

__all__ = ["mat_sum", "mat_mean", "diagonal", "multiply", "norm"]


def _as_csr(mat):
    from ..convert.conversions import dok_to_csr
    from ..formats.bsr import BsrMatrix
    from ..formats.compressed import CscMatrix, CsrMatrix
    from ..formats.coo import CooMatrix
    from ..formats.dok import DokMatrix

    if isinstance(mat, CsrMatrix):
        return mat
    if isinstance(mat, (CscMatrix, BsrMatrix)):
        return mat.to_csr()
    if isinstance(mat, CooMatrix):
        return CsrMatrix.from_coo(mat)
    if isinstance(mat, DokMatrix):
        return dok_to_csr(mat)
    raise ShapeError(f"unsupported operand {type(mat).__name__}")


def _index(a: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, dtype=np.int64), device=device)


def mat_sum(mat, axis: Optional[int] = None) -> torch.Tensor:
    """``sum(A)`` (axis None), row sums (axis 1) or column sums (axis 0);
    the axis sums are SpMV against ones."""
    csr = _as_csr(mat)
    if axis is None:
        return torch.sum(csr.values[: csr.nnz])
    if axis == 1:
        return csr @ torch.ones(csr.ncols, dtype=csr.dtype, device=csr.device)
    if axis == 0:
        return csr.transpose() @ torch.ones(csr.nrows, dtype=csr.dtype,
                                            device=csr.device)
    raise ShapeError(f"axis must be None, 0 or 1, got {axis}")


def mat_mean(mat, axis: Optional[int] = None) -> torch.Tensor:
    """Mean over all positions (dense denominator, scipy semantics)."""
    csr = _as_csr(mat)
    s = mat_sum(csr, axis)
    if axis is None:
        return s / (csr.nrows * csr.ncols)
    return s / (csr.ncols if axis == 1 else csr.nrows)


def diagonal(mat, k: int = 0) -> torch.Tensor:
    """The ``k``-th diagonal as a dense vector on the matrix's device
    (scipy semantics: absent entries are zeros; of a slot stored twice,
    the last entry counts). Runs on the device without a read back."""
    from ..convert.engine import major_ids

    csr = _as_csr(mat)
    nrows, ncols = csr.shape
    length = min(nrows + min(k, 0), ncols - max(k, 0))
    if length <= 0:
        raise ShapeError(f"diagonal {k} outside a {nrows}x{ncols} matrix")
    nse = csr.nse
    dev = csr.device
    rows = major_ids(csr.rowptr, nse).long()        # padding -> nrows
    hit = (csr.colind.long() - rows == k) & (rows < nrows)
    pos = torch.arange(nse, device=dev)
    # entries off the diagonal scatter a no-op -1, spread over the slots
    # so that no one slot takes all their atomics
    dest = torch.where(hit, rows - max(-k, 0), pos % length)
    slot = torch.full((length,), -1, dtype=torch.int64, device=dev)
    slot.scatter_reduce_(0, dest, torch.where(hit, pos, -1), "amax")
    slot = torch.where(slot < 0, nse, slot)     # nse: the zero appended below
    return torch.cat([csr.values[:nse], csr.values.new_zeros(1)])[slot]


def multiply(a, b):
    """Elementwise (Hadamard) product: the intersection of the patterns,
    as CSR. Note the reference's ``*`` is SpGEMM (`csr/ops/mul.rs`);
    scipy's ``A.multiply(B)`` is this."""
    from ..formats.compressed import CsrMatrix

    ca, cb = _as_csr(a), _as_csr(b)
    if ca.shape != cb.shape:
        raise ShapeError(f"shape mismatch {ca.shape} vs {cb.shape}")

    def keys(c):
        ptr, ind, _ = c._host_arrays()
        rows = np.repeat(np.arange(c.nrows, dtype=np.int64), np.diff(ptr))
        return rows * c.ncols + ind

    common, ia, ib = np.intersect1d(keys(ca), keys(cb), assume_unique=True,
                                    return_indices=True)
    rows = common // ca.ncols
    ptr = np.zeros(ca.nrows + 1, dtype=np.int64)
    np.add.at(ptr, rows + 1, 1)
    np.cumsum(ptr, out=ptr)
    dev = ca.device
    vals = ca.values[_index(ia, dev)] * cb.values[_index(ib, dev)]
    return CsrMatrix._from_parts(
        ca.nrows, ca.ncols, _index(ptr, dev).to(torch.int32),
        _index(common % ca.ncols, dev).to(torch.int32), vals)


def norm(mat, ord: Union[str, int, float] = "fro") -> torch.Tensor:
    """Matrix norm: "fro" (default), 1 (max column abs-sum) or ``inf``
    (max row abs-sum), `scipy.sparse.linalg.norm` semantics."""
    csr = _as_csr(mat)
    if ord in ("fro", "f"):
        vals = csr.values[: csr.nnz]
        return torch.sqrt(torch.sum(vals * vals))
    absmat = csr.with_values(torch.abs(csr.values))
    if ord == 1:
        return torch.max(mat_sum(absmat, axis=0))
    if ord in (np.inf, float("inf"), "inf"):
        return torch.max(mat_sum(absmat, axis=1))
    raise ValueError(f"unsupported norm ord {ord!r}")
