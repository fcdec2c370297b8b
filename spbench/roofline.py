"""The yardstick's frozen work counts and peaks.

Compulsory bytes and operations of the products the benchmark times,
counted from shapes alone: each input byte read once, each output byte
written once, whatever a kernel reads again. The formulas are those the
port's bring-up used for its kernel bounds (CSR SpMV and SpMM), frozen here
so that a later change to the program cannot change what a share is
measured against.

Peaks are NVIDIA's published figures for the H100 SXM (80 GB HBM3): 3.35
TB/s of device memory and 67 TFLOP/s in float32 and float64 outside the
tensor cores. The card's power limit is printed beside every share.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {4: 67e12, 8: 67e12}      # by value itemsize: float32, float64
INDEX_BYTES = 4                        # int32 colind and rowptr


def csr_spmv_work(nrows: int, ncols: int, nnz: int, itemsize: int):
    """``(bytes, flops)`` of ``y = A @ x`` for CSR ``A``: values and column
    ids once, ``rowptr`` once, ``x`` and ``y`` once."""
    nbytes = ((itemsize + INDEX_BYTES) * nnz + itemsize * (nrows + ncols)
              + INDEX_BYTES * (nrows + 1))
    return nbytes, 2 * nnz


def csr_spmm_work(nrows: int, ncols: int, nnz: int, k: int, itemsize: int):
    """``(bytes, flops)`` of ``Y = A @ X`` for CSR ``A`` and dense ``X`` of
    ``k`` columns: the SpMV's count with ``itemsize·k`` bytes a row of X
    and of Y. Aᵀ·G is the same function on the transpose, with the same
    count (rows and columns swap)."""
    nbytes = ((itemsize + INDEX_BYTES) * nnz + itemsize * k * (nrows + ncols)
              + INDEX_BYTES * (nrows + 1))
    return nbytes, 2 * nnz * k


def bound_s(nbytes: float, flops: float, itemsize: int) -> float:
    """The least time the card could take: bytes over the published
    bandwidth or operations over the published peak, whichever is
    larger."""
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[itemsize])


def brackets_share(brackets):
    """The roofline share, in %, of timed calls ``(seconds, (bytes, flops,
    itemsize))``: their summed bounds over their summed times; None where
    nothing was timed."""
    if not brackets:
        return None
    bound = sum(bound_s(b, f, i) for _, (b, f, i) in brackets)
    return 100.0 * bound / sum(s for s, _ in brackets)
