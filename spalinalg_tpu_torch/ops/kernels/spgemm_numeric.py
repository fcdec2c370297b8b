"""SpGEMM numeric phase: the Hopper kernel's wrapper, its row plan, its
plain torch version, its launch counts, and the gradient.

The kernel (``spalinalg_tpu_torch/csrc/spgemm_numeric.cu``) replaces the
Pallas kernel of the JAX package's SpGEMM numeric phase,
``spalinalg_tpu/ops/kernels/pair_route.py::_pair_kernel`` (B3). It computes

    out[g] = Σ_{t : gid[t] = g} a[a_idx[t]] · b[b_idx[t]]

in float32 and float64, in one of two variants (``VARIANT_LAUNCHES``
counts them):

- ``terms``, the one every caller gets, walks the plan's slot-sorted term
  list (``tptr``, ``a_idx``, ``b_idx``), a warp 32 slots;
- ``rowwise``, taken only when named (``variant="rowwise"``), walks row by
  row the CSR arrays of A, B and C and reads none of the term list. On the
  H100 it is slower than ``terms`` on config[2]'s product (PERF.md, the
  B3 findings), so no caller dispatches it. A row plan (:func:`spgemm_rows`,
  built on the plan's device once per plan and value size, and cached
  with the plan) gives each row of C its term count and a bin
  (``BIN_LAUNCHES`` counts the grids):

  - ``thread``: at most ``THREAD_SLOTS`` slots and ``THREAD_TERMS`` terms
    and A entries: a thread a row, its column ids in registers;
  - ``warp``: at most ``WARP_TERMS`` terms and A entries: a warp a row;
  - ``cta``: heavier rows whose C row fits ``ROW_BUDGET`` bytes of shared
    memory (:func:`row_bytes`): a block of ``CTA_WARPS`` warps a row;
  - ``wide``: heavier rows past the budget: a block a row that
    accumulates in the output itself.

:func:`spgemm_numeric` is the wrapper. For CUDA tensors it launches the
kernel or raises; for CPU tensors it runs :func:`spgemm_numeric_plain` on
the term list. :class:`SpgemmNumeric` carries the gradient that
``jax.grad`` gives through ``spalinalg_tpu/ops/spgemm.py::_spgemm_numeric``,
in plain torch (a gather and an ``index_add_`` per operand), as it is XLA
code in the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch.autograd.function import once_differentiable

from ...dtypes import INDEX_DTYPE, acc_dtype, result_dtype
from ...errors import DTypeError, ShapeError

__all__ = ["BINS", "BIN_LAUNCHES", "CTA_WARPS", "LAUNCHES", "ROW_BUDGET",
           "SpgemmNumeric", "SpgemmRows", "THREAD_SLOTS", "THREAD_TERMS",
           "VARIANT_LAUNCHES", "WARP_TERMS", "row_bytes", "row_plan",
           "spgemm_numeric", "spgemm_numeric_plain", "spgemm_rows"]

# Kernel launches per instantiation and per variant: plain integers,
# advanced only where the wrapper launches the kernel. A rowwise launch is
# one call of its entry point, which runs one grid per bin and length
# class that has rows (BIN_LAUNCHES counts those grids by bin).
LAUNCHES = {"float32": 0, "float64": 0}
VARIANT_LAUNCHES = {"terms": 0, "rowwise": 0}
BINS = ("thread", "warp", "cta", "wide")
BIN_LAUNCHES = dict.fromkeys(BINS, 0)

# The kernel's constants (csrc/spgemm_numeric.cu): a thread-bin row's
# register slots, the bins' bounds on a row's work (its terms and A
# entries), warps a cta-bin row, and batches of 32 terms a warp takes a
# round.
THREAD_SLOTS = 16
THREAD_TERMS = 64
WARP_TERMS = 512
CTA_WARPS = 8
UNROLL = 2
# Shared memory a cta-bin row may take. Past it a row is wide. Above 48
# KiB the entry point raises the kernel's limit.
ROW_BUDGET = 96 * 1024
# A bin's rows go to one grid per class of C row length (bounds below), so
# that each grid's shared memory fits its own longest row.
CLASS_BOUNDS = (64, 1024, 4096)

_ENTRY = {torch.float32: ("f32", "float32"), torch.float64: ("f64", "float64")}


def row_bytes(length: int, warps: int, itemsize: int) -> int:
    """Shared-memory bytes the ``warps`` warps of one row need for a C row
    of ``length`` slots (``row_bytes`` in the kernel source, with one index
    bucket): the chunk's values and staged products, its prefix sums and B
    row starts, the row's accumulator and column ids, with several warps a
    2-byte tag a slot, and the bucket index."""
    threads = warps * 32
    size = (itemsize * threads * (1 + UNROLL) + 4 * (2 * threads + warps)
            + length * (itemsize + 4))
    if warps > 1:
        size += (2 * length + 3) & ~3
    return size + 8


@dataclass(frozen=True, eq=False)
class SpgemmRows:
    """The row plan of one SpGEMM plan for one value size.

    ``terms`` (int64, a row of C) is the row's product-term count;
    ``bins`` (int8) its bin, an index into :data:`BINS`; ``rows`` (int32)
    the row ids bin after bin (thread, warp, cta, wide), each bin's rows
    longest C row first; ``counts`` the rows of each bin; ``grids`` (int64,
    on the host) one ``(bin, first, rows, longest C row)`` a grid, in launch
    order (wide, cta, warp, thread; longer classes first).
    """

    terms: torch.Tensor
    bins: torch.Tensor
    rows: torch.Tensor
    counts: tuple
    grids: torch.Tensor


def spgemm_rows(a_ptr, a_col, b_ptr, c_ptr, itemsize: int) -> SpgemmRows:
    """Build the row plan from the structures alone, on their device: a
    row's terms are the sum over its A entries of their B rows' lengths."""
    device = a_ptr.device
    nrows = a_ptr.numel() - 1
    nnz_a = int(a_ptr[-1])
    b_len = (b_ptr[1:] - b_ptr[:-1]).long()
    cum = torch.zeros(nnz_a + 1, dtype=torch.int64, device=device)
    torch.cumsum(b_len[a_col[:nnz_a].long()], 0, out=cum[1:])
    a_ptr64 = a_ptr.long()
    terms = cum[a_ptr64[1:]] - cum[a_ptr64[:-1]]
    work = torch.maximum(terms, a_ptr64[1:] - a_ptr64[:-1])
    length = (c_ptr[1:] - c_ptr[:-1]).long()
    # row_bytes(length, CTA_WARPS, itemsize), row by row
    need = (row_bytes(0, CTA_WARPS, itemsize) + (itemsize + 4) * length
            + (2 * length + 3) // 4 * 4)
    bins = torch.full((nrows,), 3, dtype=torch.int8, device=device)
    bins[need <= ROW_BUDGET] = 2
    bins[work <= WARP_TERMS] = 1
    bins[(work <= THREAD_TERMS) & (length <= THREAD_SLOTS)] = 0
    parts, counts, grids = [], [], []
    bounds = torch.tensor(CLASS_BOUNDS, device=device)
    for b in range(len(BINS)):
        ids = torch.nonzero(bins == b).flatten()
        if b > 0:   # longest C row first
            ids = ids[torch.sort(length[ids], descending=True, stable=True)[1]]
        # a grid a run of one length class (the thread and wide bins: one)
        cls = (torch.bucketize(length[ids], bounds) if b in (1, 2)
               else torch.zeros_like(ids))
        start, at = sum(counts), 0
        for m in torch.unique_consecutive(cls, return_counts=True)[1].tolist():
            grids.append((b, start + at, m, int(length[ids[at:at + m]].max())))
            at += m
        parts.append(ids.to(INDEX_DTYPE))
        counts.append(int(ids.numel()))
    grids.sort(key=lambda g: -g[0])      # the heaviest bins first
    return SpgemmRows(terms=terms, bins=bins, rows=torch.cat(parts),
                      counts=tuple(counts),
                      grids=torch.tensor(grids, dtype=torch.int64).reshape(
                          -1, 4))


def row_plan(plan, itemsize: int) -> SpgemmRows:
    """The plan's row plan for values of ``itemsize`` bytes, built at first
    use and cached with the plan."""
    rows = plan.row_plans.get(itemsize)
    if rows is None:
        rows = spgemm_rows(plan.a_ptr, plan.a_col, plan.b_ptr, plan.rowptr,
                           itemsize)
        plan.row_plans[itemsize] = rows
    return rows


def spgemm_numeric_plain(gid, a_idx, b_idx, a_values, b_values,
                         n_out: int) -> torch.Tensor:
    """Plain torch numeric phase: two gathers, a product and ``index_add_``
    into the output slots, in the accumulation dtype. Runs on any device;
    differentiable by autograd."""
    acc = acc_dtype(a_values.dtype, b_values.dtype)
    prod = a_values.to(acc)[a_idx] * b_values.to(acc)[b_idx]
    return torch.zeros(n_out, dtype=acc, device=prod.device).index_add_(
        0, gid, prod)


def _check(plan, a_values, b_values) -> None:
    index = (plan.a_ptr, plan.a_col, plan.b_ptr, plan.b_col, plan.rowptr,
             plan.colind, plan.gid, plan.a_idx, plan.b_idx, plan.tptr)
    devices = {t.device for t in index + (a_values, b_values)}
    if len(devices) != 1:
        raise ValueError(
            f"spgemm_numeric operands on several devices: {devices}")
    if any(t.dtype != INDEX_DTYPE for t in index):
        raise DTypeError(f"plan indices must be {INDEX_DTYPE}")
    if (plan.a_ptr.ndim != 1 or plan.a_ptr.numel() != plan.nrows + 1
            or plan.rowptr.shape != plan.a_ptr.shape
            or plan.colind.ndim != 1 or plan.colind.numel() < plan.n_out
            or plan.b_ptr.ndim != 1 or plan.b_ptr.numel() < 1
            or plan.a_col.numel() < plan.nnz_a
            or plan.b_col.numel() < plan.nnz_b
            or plan.gid.ndim != 1 or plan.a_idx.shape != plan.gid.shape
            or plan.b_idx.shape != plan.gid.shape
            or plan.tptr.ndim != 1 or plan.tptr.numel() != plan.n_out + 1
            or a_values.ndim != 1 or b_values.ndim != 1
            or a_values.numel() < plan.nnz_a
            or b_values.numel() < plan.nnz_b):
        raise ShapeError(
            f"spgemm_numeric shapes: a_ptr {tuple(plan.a_ptr.shape)}, rowptr "
            f"{tuple(plan.rowptr.shape)} for {plan.nrows} rows, colind "
            f"{tuple(plan.colind.shape)} for {plan.n_out} slots, a_col "
            f"{tuple(plan.a_col.shape)}, b_col {tuple(plan.b_col.shape)}, "
            f"gid {tuple(plan.gid.shape)}, a_idx {tuple(plan.a_idx.shape)}, "
            f"b_idx {tuple(plan.b_idx.shape)}, tptr {tuple(plan.tptr.shape)}, "
            f"a {tuple(a_values.shape)} "
            f"({plan.nnz_a} entries), b {tuple(b_values.shape)} "
            f"({plan.nnz_b} entries)")


def spgemm_numeric(plan, a_values, b_values,
                   variant: str = "terms") -> torch.Tensor:
    """The values of ``C = A·B`` on an :class:`~spalinalg_tpu_torch.ops.
    spgemm.SpgemmPlan`: the kernel's ``variant`` on CUDA tensors, the plain
    version on CPU tensors.

    ``rowwise`` reads the plan's operand structures (``a_ptr``, ``a_col``,
    ``b_ptr``, ``b_col``), C's (``rowptr``, ``colind``) and the row plan;
    ``terms`` and the plain version read the term list (``tptr`` or
    ``gid``, ``a_idx``, ``b_idx``). Value arrays may be longer than the
    operands' entry counts; only their first ``nnz`` entries are read. The
    result has the dtype ``result_dtype(a, b)``; bfloat16 accumulates in
    float32. ``n_out == 0`` launches nothing.
    """
    acc = acc_dtype(a_values.dtype, b_values.dtype)
    out_dtype = result_dtype(a_values.dtype, b_values.dtype)
    a_values = a_values.to(acc).contiguous()
    b_values = b_values.to(acc).contiguous()
    _check(plan, a_values, b_values)
    if variant not in VARIANT_LAUNCHES:
        raise ValueError(f"unknown spgemm_numeric variant {variant!r}")
    device = a_values.device
    if device.type == "cpu":
        return spgemm_numeric_plain(plan.gid, plan.a_idx, plan.b_idx,
                                    a_values, b_values,
                                    plan.n_out).to(out_dtype)
    if device.type != "cuda":
        raise ValueError(f"no spgemm_numeric kernel for device {device}")
    if plan.n_out == 0:
        return torch.zeros(0, dtype=out_dtype, device=device)
    from ._build import launch

    suffix, key = _ENTRY[acc]
    out = torch.empty(plan.n_out, dtype=acc, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        if variant == "terms":
            launch(f"spal_spgemm_terms_{suffix}", plan.tptr.data_ptr(),
                   plan.a_idx.data_ptr(), plan.b_idx.data_ptr(),
                   a_values.data_ptr(), b_values.data_ptr(), out.data_ptr(),
                   plan.n_out, stream)
        else:
            rows = row_plan(plan, a_values.element_size())
            index = [t.contiguous() for t in (
                plan.a_ptr, plan.a_col, plan.b_ptr, plan.b_col, plan.rowptr,
                plan.colind)]
            launch(f"spal_spgemm_rowwise_{suffix}", index[0].data_ptr(),
                   index[1].data_ptr(), a_values.data_ptr(),
                   index[2].data_ptr(), index[3].data_ptr(),
                   b_values.data_ptr(), index[4].data_ptr(),
                   index[5].data_ptr(), out.data_ptr(),
                   rows.rows.data_ptr(), rows.grids.data_ptr(),
                   rows.grids.shape[0], ROW_BUDGET, stream)
            for b in rows.grids[:, 0].tolist():
                BIN_LAUNCHES[BINS[b]] += 1
    LAUNCHES[key] += 1
    VARIANT_LAUNCHES[variant] += 1
    return out.to(out_dtype)


class SpgemmNumeric(torch.autograd.Function):
    """The numeric phase with gradients to both value arrays.

    ``SpgemmNumeric.apply(a_values, b_values, plan)``: ``da = Σ_t
    g[gid[t]]·b[b_idx[t]]`` scattered to ``a_idx`` and ``db`` likewise, so
    padding slots of either operand get 0.
    """

    @staticmethod
    def forward(ctx, a_values, b_values, plan):
        ctx.save_for_backward(a_values, b_values)
        ctx.plan = plan
        return spgemm_numeric(plan, a_values, b_values)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        a_values, b_values = ctx.saved_tensors
        plan = ctx.plan
        acc = acc_dtype(a_values.dtype, b_values.dtype)
        gg = g.to(acc)[plan.gid]
        da = db = None
        if ctx.needs_input_grad[0]:
            da = torch.zeros(a_values.shape, dtype=acc, device=g.device
                             ).index_add_(0, plan.a_idx,
                                          gg * b_values.to(acc)[plan.b_idx]
                                          ).to(a_values.dtype)
        if ctx.needs_input_grad[1]:
            db = torch.zeros(b_values.shape, dtype=acc, device=g.device
                             ).index_add_(0, plan.b_idx,
                                          gg * a_values.to(acc)[plan.a_idx]
                                          ).to(b_values.dtype)
        return da, db, None
