"""SpGEMM: sparse × sparse product (counterpart of
``spalinalg_tpu/ops/spgemm.py``; reference C9/C12: `src/csr/ops/mul.rs`,
`src/csc/ops/mul.rs`).

Reference semantics: ``C = A·B`` stores an entry (i, j) iff some k has
A[i,k] and B[k,j] stored, even when the sum cancels to exact zero. Output
indices are sorted and unique. Shape check ``a.ncols == b.nrows``
(`csr/ops/mul.rs:8`).

Symbolic/numeric split, as in the JAX package:

1. *Symbolic phase* (host, once per structure pair): expand every product
   term (i,k)·(k,j) into gather indices, sort and unique the output
   coordinates, and record each term's output slot. The native library
   (:mod:`spalinalg_tpu_torch.native.lib`) does this when A has more than
   4096 entries, NumPy otherwise; both give the same plan. The plan's
   tensors are int32 on the operands' device.
2. *Numeric phase* (device, differentiable): the SpGEMM kernel
   (``csrc/spgemm_numeric.cu``), a walk of the plan's term list, on CUDA
   tensors, its plain torch version on the term list on CPU tensors
   (:mod:`.kernels.spgemm_numeric`).

Plans are cached per structure pair and live as long as the structures
(:class:`~spalinalg_tpu_torch.utils.plancache.StructureCache`). The path
that ran goes on the metrics recorder: ``spgemm:cuda``/``spgemm:plain`` and
``spgemm_symbolic:native``/``spgemm_symbolic:numpy``.

Examples
--------
>>> from spalinalg_tpu_torch import CsrMatrix
>>> a = CsrMatrix(2, 2, [0, 2, 3], [0, 1, 1], [1.0, 2.0, 3.0])
>>> c = a * a                      # operator* is SpGEMM (csr/ops/mul.rs)
>>> c.shape, c.nnz
((2, 2), 3)
>>> c.values.tolist()              # [[1,8],[0,9]]
[1.0, 8.0, 9.0]
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..dtypes import INDEX_DTYPE, check_nse
from ..errors import ShapeError
from ..utils.metrics import instrument
from ..utils.plancache import StructureCache
from .kernels.csr_spmv import path_for
from .kernels.spgemm_numeric import SpgemmNumeric

__all__ = ["spgemm", "SpgemmPlan", "spgemm_plan", "spgemm_apply"]

# Above this many entries in A the symbolic phase runs natively
# (``spalinalg_tpu/ops/spgemm.py:137``).
NATIVE_MIN_NNZ = 4096


@dataclass(frozen=True, eq=False)
class SpgemmPlan:
    """Precomputed symbolic structure of ``C = A·B`` for fixed sparsity.

    ``a_idx``/``b_idx`` index the operand value arrays per product term;
    ``gid`` maps each term to its output slot (sorted); ``rowptr``/
    ``colind`` are the output CSR structure (exact nnz, cancellation zeros
    kept); ``tptr`` (``n_out + 1``) points at each slot's first term (the
    kernel reads it). ``nnz_a``/``nnz_b`` are the operands' entry counts,
    which the value arrays must cover. All tensors are int32 on the
    operands' device.
    """

    nrows: int
    ncols: int
    a_idx: torch.Tensor
    b_idx: torch.Tensor
    gid: torch.Tensor
    rowptr: torch.Tensor
    colind: torch.Tensor
    n_out: int
    tptr: torch.Tensor
    nnz_a: int
    nnz_b: int

    def num_flops(self) -> int:
        """2 × product-term count (multiply + add)."""
        return 2 * int(self.a_idx.shape[0])


def _csr_host_arrays(mat):
    ptr = mat._ptr.cpu().numpy().astype(np.int64)
    nnz = int(ptr[-1])
    return ptr, mat._minor[:nnz].cpu().numpy().astype(np.int64)


def _symbolic_numpy(aptr, acol, nrows_a, bptr, bcol, ncols_b):
    """The NumPy symbolic phase (``spalinalg_tpu/ops/spgemm.py:155-189``):
    ``(a_idx, b_idx, gid, rowptr, colind)``, int64."""
    nnz_a = acol.size
    arow = np.repeat(np.arange(nrows_a, dtype=np.int64), np.diff(aptr))
    # Term t couples A-entry j with the t-th entry of B-row acol[j].
    counts = bptr[acol + 1] - bptr[acol]
    total = int(counts.sum())
    a_idx = np.repeat(np.arange(nnz_a, dtype=np.int64), counts)
    local = np.arange(total, dtype=np.int64) - np.repeat(
        np.cumsum(counts) - counts, counts)
    b_idx = np.repeat(bptr[acol], counts) + local
    out_row, out_col = arow[a_idx], bcol[b_idx]

    # Sort terms by output coordinate (stable); group into output slots.
    order = np.lexsort((out_col, out_row))
    out_row, out_col = out_row[order], out_col[order]
    a_idx, b_idx = a_idx[order], b_idx[order]
    is_new = np.ones(total, dtype=bool)
    is_new[1:] = (out_row[1:] != out_row[:-1]) | (out_col[1:] != out_col[:-1])
    gid = np.cumsum(is_new) - 1
    rowptr = np.zeros(nrows_a + 1, dtype=np.int64)
    np.add.at(rowptr, out_row[is_new] + 1, 1)
    np.cumsum(rowptr, out=rowptr)
    return a_idx, b_idx, gid, rowptr, out_col[is_new]


def spgemm_plan(a, b) -> SpgemmPlan:
    """Symbolic phase on the host (structure only; values never touched).

    ``a``/``b`` are CSR matrices on one device (CSC pairs are planned on
    their mirrored structure by :func:`spgemm`).
    """
    if a.ncols != b.nrows:
        raise ShapeError(
            f"dimension mismatch: {a.shape} x {b.shape} "
            "(reference: csr/ops/mul.rs:8)"
        )
    if a.device != b.device:
        raise ValueError(f"operands on devices {a.device} and {b.device}: "
                         "move one of them first")
    aptr, acol = _csr_host_arrays(a)
    bptr, bcol = _csr_host_arrays(b)
    if acol.size > NATIVE_MIN_NNZ:
        from ..native import lib as native

        path, symbolic = "native", native.spgemm_symbolic
    else:
        path, symbolic = "numpy", _symbolic_numpy
    arrays = instrument(
        "spgemm_symbolic",
        lambda: symbolic(aptr, acol, a.nrows, bptr, bcol, b.ncols),
        path=path, device=torch.device("cpu"), nnz=int(acol.size))
    check_nse(arrays[0].size)
    # int32 on the host before the copy: half the bytes to move.
    a_idx, b_idx, gid, rowptr, colind = (
        torch.from_numpy(x.astype(np.int32)).to(a.device) for x in arrays)
    n_out = colind.numel()
    tptr = torch.searchsorted(
        gid, torch.arange(n_out + 1, dtype=INDEX_DTYPE, device=a.device),
        out_int32=True)
    return SpgemmPlan(nrows=a.nrows, ncols=b.ncols, a_idx=a_idx, b_idx=b_idx,
                      gid=gid, rowptr=rowptr, colind=colind, n_out=n_out,
                      tptr=tptr, nnz_a=int(acol.size),
                      nnz_b=int(bcol.size))


def spgemm_apply(plan: SpgemmPlan, a_values: torch.Tensor,
                 b_values: torch.Tensor) -> torch.Tensor:
    """Numeric phase: the output CSR value array, on the plan's device,
    with gradients to ``a_values`` and ``b_values``. Its dtype is the
    promoted type of the operands (bfloat16 accumulates in float32)."""
    if (a_values.ndim != 1 or b_values.ndim != 1
            or a_values.shape[0] < plan.nnz_a
            or b_values.shape[0] < plan.nnz_b):
        raise ShapeError(
            f"value arrays {tuple(a_values.shape)} and "
            f"{tuple(b_values.shape)} do not cover the plan's operands "
            f"({plan.nnz_a} and {plan.nnz_b} entries)")
    device = a_values.device
    return instrument(
        "spgemm",
        lambda: SpgemmNumeric.apply(a_values, b_values, plan),
        path=path_for(device), device=device, nnz=plan.n_out,
        flops=plan.num_flops())


# Lives as long as each operand structure does (see utils/plancache.py).
_PLAN_CACHE = StructureCache()


def _cached_plan(a, b) -> SpgemmPlan:
    return _PLAN_CACHE.get((a._ptr, a._minor, b._ptr, b._minor),
                           lambda: spgemm_plan(a, b),
                           a.shape, b.shape, type(a).__name__)


def spgemm(a, b):
    """``C = A·B`` with reference Gustavson semantics (`csr/ops/mul.rs:5-58`).

    CSR×CSR → CSR. CSC×CSC → CSC via the mirror identity: the CSC arrays of
    A·B equal the CSR arrays of BᵀAᵀ computed on the mirrored structures
    (`csc/ops/mul.rs:10-12`), planned symbolically instead of through
    runtime transposes.
    """
    from ..formats.compressed import CscMatrix, CsrMatrix

    if isinstance(a, CscMatrix):
        # CSC storage of A is the CSR storage of Aᵀ. (A·B)ᵀ = Bᵀ·Aᵀ, so the
        # CSC of A·B is the CSR product of (B mirror · A mirror).
        if a.ncols != b.nrows:
            raise ShapeError(
                f"dimension mismatch: {a.shape} x {b.shape} "
                "(reference: csc/ops/mul.rs:8)"
            )
        bm = CsrMatrix._from_parts(b.ncols, b.nrows, b._ptr, b._minor,
                                   b._values)
        am = CsrMatrix._from_parts(a.ncols, a.nrows, a._ptr, a._minor,
                                   a._values)
        plan = _cached_plan(bm, am)
        values = spgemm_apply(plan, b._values, a._values)
        return CscMatrix._from_parts(a.nrows, b.ncols, plan.rowptr,
                                     plan.colind, values)

    plan = _cached_plan(a, b)
    values = spgemm_apply(plan, a._values, b._values)
    return CsrMatrix._from_parts(a.nrows, b.ncols, plan.rowptr, plan.colind,
                                 values)
