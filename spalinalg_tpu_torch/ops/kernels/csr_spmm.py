"""CSR SpMM: the Hopper kernel's wrapper, its plain torch version, its launch
count, and the gradient.

The kernel (``spalinalg_tpu_torch/csrc/csr_spmm.cu``) replaces the two
Pallas kernels on the JAX package's SpMM path:

- ``spalinalg_tpu/ops/kernels/csr_route.py::_route_spmm_kernel`` (B2a),
- ``spalinalg_tpu/ops/kernels/csr_route.py::_route_spmm_kernel_pk`` (B2b,
  packed active pages).

One warp per row reads ``rowptr``/``colind``/``values`` directly and
gathers rows of ``X``, for float32 and float64 and any number of columns.
Where one row would bound the launch (:func:`one_row_bounds`, decided once
per ``rowptr`` by :func:`row_split`), the ``register`` and ``vector``
variants split every row longer than :data:`~.csr_spmv.BUDGET` entries
into pieces of the SpMV's cached long-row plan
(:func:`~.csr_spmv.csr_spmv_plan`): a warp a piece writes a partial row,
and a second kernel adds each long row's partials in piece order
(:func:`row_pieces`). It has three variants, chosen by
:func:`csr_spmm_variant` and passed to the kernel by name: ``staged`` (a
CTA copies the rows of ``X`` its tile of rows reads, the window of
:func:`~.csr_spmv.csr_tile_plan`, into shared memory and runs its rows on
them; it gives the register variant's bits) where the
widest window fits :data:`~.csr_spmv.STAGE_BUDGET` and ``X`` starts on a
16-byte boundary (a banded matrix); ``vector`` (16-byte row gathers, 8
entries' rows in flight a warp at k = 64) for float32 where ``k`` is a
multiple of 4 and ``X`` starts on a 16-byte boundary; ``register`` (the
first design, one element a lane) otherwise. ``csr_spmm(..., variant=...)``
names one on purpose. Each launch adds one to ``LAUNCHES`` (by dtype) and
to ``VARIANT_LAUNCHES``; a launch with pieces adds one more to each
(``VARIANT_LAUNCHES["finish"]``, the second kernel) and counts in
``PIECED`` (launches, and the slots its pieces walked). The metrics path
names the variant, with ``+pieces`` where rows are split, for example
``csr_spmm:cuda:vector+pieces``.

:func:`csr_spmm` is the wrapper. For CUDA tensors it launches the kernel or
raises; for CPU tensors it runs the plain version, which is
:func:`~spalinalg_tpu_torch.ops.kernels.csr_spmv.csr_spmv_plain` on a 2-D
right-hand side. Like ``csr_spmv`` it takes an optional ``perm``.
:class:`CsrSpmm` carries the gradient of
``csr_route.py::_route_spmm_ad_bwd``: ``dX = Aᵀ·G`` runs the same kernel on
the cached transposed structure (no atomics), reading the forward's values
through the transpose's ``perm`` or, on the bucket route
(``ops/kernels/csr_transpose.py``), bucketed by column block, and
``dvals[p] = Σ_c G[row_p, c]·X[col_p, c]`` is the CSR SDDMM kernel
(``ops/kernels/csr_sddmm.py``; XLA code outside any Pallas kernel in the
JAX package).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.autograd.function import once_differentiable

from ...dtypes import INDEX_DTYPE, acc_dtype
from ...errors import DTypeError, ShapeError
from ...utils.plancache import StructureCache
from ...utils.profiling import annotate
from .csr_sddmm import csr_sddmm
from .csr_spmv import (BUDGET, SpmvPlan, aligned16, csr_spmv_plain,
                       csr_spmv_plan, csr_tile_plan, staged_fits,
                       transpose_plan)
from .csr_transpose import ROUTES, transposed_route, transposed_values

__all__ = ["LAUNCHES", "PIECED", "VARIANT_LAUNCHES", "WARPS_PER_SM",
           "CsrSpmm", "RowSplit", "csr_spmm", "csr_spmm_plain",
           "csr_spmm_variant", "kernel_path", "one_row_bounds", "row_pieces",
           "row_split", "row_split_of", "spmm_route", "transposed_spmm"]

# Kernel launches per instantiation and per variant: plain integers,
# advanced only where the wrapper launches the kernel. "finish" counts the
# second kernel of a launch with pieces; PIECED such launches and the slots
# their pieces walked.
LAUNCHES = {"float32": 0, "float64": 0}
VARIANT_LAUNCHES = {"register": 0, "vector": 0, "staged": 0, "finish": 0}
PIECED = {"launches": 0, "slots": 0}

_VARIANT_CODE = {"register": 0, "vector": 1, "staged": 2}

_ENTRY = {torch.float32: ("spal_csr_spmm_f32", "float32"),
          torch.float64: ("spal_csr_spmm_f64", "float64")}

csr_spmm_plain = csr_spmv_plain


def csr_spmm_variant(X, plan=None) -> str:
    """The variant of ``csrc/csr_spmm.cu`` for the operand ``X`` of shape
    ``(ncols, k)`` as the kernel takes it (accumulation type, contiguous;
    the output is a fresh, aligned tensor) and the structure's tile plan
    (:func:`~.csr_spmv.csr_tile_plan`, or None): ``"staged"`` when the
    plan's widest window fits :data:`~.csr_spmv.STAGE_BUDGET` at ``k``
    columns and ``X`` starts on a 16-byte boundary (on the banded matrix it
    ran faster than ``register`` in float64 and ``vector`` in float32 on
    the H100, PERF.md); else ``"vector"`` for float32 when a row of ``X`` is
    a whole number of 16-byte vectors (``k % 4 == 0``) and ``X`` starts on
    a 16-byte boundary; else ``"register"`` (float64 off the staged
    variant: its vector form ran slower on the H100, PERF.md). The plan,
    shapes, dtypes and addresses alone decide.

    >>> csr_spmm_variant(torch.zeros(5, 64))
    'vector'
    >>> csr_spmm_variant(torch.zeros(5, 3))
    'register'
    >>> csr_spmm_variant(torch.zeros(5 * 64 + 1)[1:].reshape(5, 64))
    'register'
    >>> csr_spmm_variant(torch.zeros(5, 64, dtype=torch.float64))
    'register'
    """
    if (plan is not None and aligned16(X)
            and staged_fits(plan, X.shape[1], X.element_size())):
        return "staged"
    if X.dtype == torch.float32 and X.shape[1] % 4 == 0 and aligned16(X):
        return "vector"
    return "register"


def kernel_path(rowptr, colind, values, X) -> str:
    """The metrics path of ``csr_spmm``: ``"plain"`` off the card, else
    ``"cuda:"`` and the variant of :func:`csr_spmm_variant` (with the
    structure's cached tile plan).

    >>> kernel_path(torch.zeros(2, dtype=torch.int32),
    ...             torch.zeros(1, dtype=torch.int32), torch.zeros(1),
    ...             torch.zeros(2, 4))
    'plain'
    """
    if X.device.type != "cuda":
        return "plain"
    acc = acc_dtype(values.dtype, X.dtype)
    plan = csr_tile_plan(rowptr, colind)
    variant = csr_spmm_variant(X.to(acc).contiguous(), plan)
    pieces = variant != "staged" and row_pieces(rowptr) is not None
    return f"cuda:{variant}{'+pieces' if pieces else ''}"


# Warps an SM of the H100 keeps resident (2,048 threads).
WARPS_PER_SM = 64

# Live as long as each structure does (see utils/plancache.py).
_ROW_SPLITS = StructureCache()


def one_row_bounds(longest: int, nnz: int, sms: int) -> bool:
    """Whether one row of ``longest`` entries bounds a launch over ``nnz``
    entries on ``sms`` SMs, were it walked by one warp: it holds more
    entries than a resident warp's share of them. Where it does, the
    wrapper splits the long rows (:func:`row_pieces`). A pure function.

    >>> one_row_bounds(150_001, 8_535_214, 132), one_row_bounds(60, 2**24, 132)
    (True, False)
    """
    return longest * sms * WARPS_PER_SM > nnz


class RowSplit(NamedTuple):
    """How launches on one ``rowptr`` walk its rows (:func:`row_split`):
    ``bounded``, whether its longest row bounds a launch
    (:func:`one_row_bounds`); ``slots``, the slots of its rows longer than
    :data:`~.csr_spmv.BUDGET`, which are walked in pieces where
    ``bounded`` (``pieced``)."""

    bounded: bool
    slots: int

    @property
    def pieced(self) -> bool:
        return self.bounded and self.slots > 0


def row_split_of(rowptr: torch.Tensor, sms: int) -> RowSplit:
    """The :class:`RowSplit` of ``rowptr`` on a card of ``sms`` SMs, with
    one read back. Slots past ``rowptr[-1]`` count for nothing.

    >>> ptr = torch.tensor([0, 3, 303, 304], dtype=torch.int32)
    >>> row_split_of(ptr, 132), row_split_of(ptr, 132).pieced
    (RowSplit(bounded=True, slots=300), True)
    """
    ptr = rowptr.to(torch.int64)
    lens = ptr[1:] - ptr[:-1]
    if lens.numel() == 0:
        return RowSplit(False, 0)
    longest, nnz, slots = torch.stack(
        [lens.max(), ptr[-1], lens[lens > BUDGET].sum()]).tolist()
    return RowSplit(one_row_bounds(longest, nnz, sms), slots)


def row_split(rowptr: torch.Tensor) -> RowSplit:
    """:func:`row_split_of` on the card ``rowptr`` lies on, decided once
    per structure (keyed on the identity and shape of ``rowptr``) and
    dropped with it."""
    return _ROW_SPLITS.get((rowptr,), lambda: row_split_of(
        rowptr, torch.cuda.get_device_properties(
            rowptr.device).multi_processor_count))


def row_pieces(rowptr: torch.Tensor) -> SpmvPlan | None:
    """The pieces the ``register`` and ``vector`` variants walk on
    ``rowptr``: the SpMV's long-row plan (:func:`~.csr_spmv.csr_spmv_plan`:
    every row longer than :data:`~.csr_spmv.BUDGET` entries in pieces of
    ``BUDGET``) where :func:`row_split` is ``pieced``, else None (a warp a
    row). The lookup, and a build on a miss, is the span
    ``spal.spmm.plan``."""
    with annotate("spal.spmm.plan"):
        return csr_spmv_plan(rowptr) if row_split(rowptr).pieced else None


def csr_spmm(rowptr, colind, values, X, nrows: int, perm=None,
             variant=None) -> torch.Tensor:
    """``Y = A @ X`` for CSR ``A`` and dense ``X`` of shape ``(ncols, k)``:
    the kernel on CUDA tensors, the plain version on CPU tensors. With
    ``perm`` the value of slot ``p`` is ``values[perm[p]]``. ``variant``
    names a kernel variant instead of :func:`csr_spmm_variant`'s choice;
    the kernel refuses operands it does not take (no fallback).

    ``values`` and ``X`` are promoted to the accumulation dtype and made
    contiguous. Devices, index dtypes and shapes are checked; anything the
    kernel does not take raises. ``k == 0``, ``nrows == 0`` and a matrix
    with no stored slots launch nothing.
    """
    acc = acc_dtype(values.dtype, X.dtype)
    values = values.to(acc).contiguous()
    X = X.to(acc).contiguous()
    operands = (rowptr, colind, values, X) + (() if perm is None else (perm,))
    devices = {t.device for t in operands}
    if len(devices) != 1:
        raise ValueError(f"csr_spmm operands on several devices: {devices}")
    if rowptr.dtype != INDEX_DTYPE or colind.dtype != INDEX_DTYPE or (
            perm is not None and perm.dtype != INDEX_DTYPE):
        raise DTypeError(
            f"indices must be {INDEX_DTYPE}, got {rowptr.dtype} and "
            f"{colind.dtype}" + ("" if perm is None else f" and {perm.dtype}"))
    if (rowptr.ndim != 1 or rowptr.numel() != nrows + 1 or colind.ndim != 1
            or values.shape != colind.shape or X.ndim != 2
            or (perm is not None and perm.shape != colind.shape)):
        raise ShapeError(
            f"csr_spmm shapes: rowptr {tuple(rowptr.shape)}, colind "
            f"{tuple(colind.shape)}, values {tuple(values.shape)}, X "
            f"{tuple(X.shape)}, nrows {nrows}")
    if variant is not None and variant not in _VARIANT_CODE:
        raise ValueError(f"unknown csr_spmm variant {variant!r}; the "
                         f"variants are {sorted(_VARIANT_CODE)}")
    device = X.device
    if device.type == "cpu":
        if perm is not None:
            values = values[perm]
        return csr_spmm_plain(rowptr, colind, values, X, nrows)
    if device.type != "cuda":
        raise ValueError(f"no csr_spmm kernel for device {device}")
    k = X.shape[1]
    if nrows == 0 or colind.numel() == 0 or k == 0:
        return torch.zeros((nrows, k), dtype=acc, device=device)
    from ._build import launch

    name, key = _ENTRY[acc]
    rowptr, colind = rowptr.contiguous(), colind.contiguous()
    if perm is not None:
        perm = perm.contiguous()
    plan = None
    if variant in (None, "staged"):
        plan = csr_tile_plan(rowptr, colind)
    if variant is None:
        variant = csr_spmm_variant(X, plan)
    staged = variant == "staged"
    pieces = None if staged else row_pieces(rowptr)
    npieces = 0 if pieces is None else pieces.npieces
    Y = torch.empty((nrows, k), dtype=acc, device=device)
    partial = (torch.empty((npieces, k), dtype=acc, device=device)
               if npieces else None)
    with torch.cuda.device(device):
        launch(name, rowptr.data_ptr(), colind.data_ptr(), values.data_ptr(),
               None if perm is None else perm.data_ptr(), X.data_ptr(),
               Y.data_ptr(), nrows, k, _VARIANT_CODE[variant],
               plan.tiles.data_ptr() if staged else None,
               plan.ntiles if staged else 0,
               plan.max_window if staged else 0,
               pieces.parts()[1].data_ptr() if npieces else None, npieces,
               pieces.nlong if npieces else 0, BUDGET,
               None if partial is None else partial.data_ptr(),
               torch.cuda.current_stream(device).cuda_stream)
    finish = int(npieces > 0)
    LAUNCHES[key] += 1 + finish
    VARIANT_LAUNCHES[variant] += 1
    VARIANT_LAUNCHES["finish"] += finish
    if finish:
        PIECED["launches"] += 1
        PIECED["slots"] += row_split(rowptr).slots
    return Y


def spmm_route(rowptr, colind, t, ncols: int, itemsize: int) -> str:
    """The route of the SpMM backward's ``Aᵀ·G``:
    :func:`~.csr_transpose.transposed_route`, with ``"buckets"`` kept
    ``"perm"`` where one row of the transpose bounds the launch
    (:func:`row_split` of ``t.ptr``): while a warp walked that row,
    pass 1 and ``vb`` bought nothing (a column of 150,000 entries: 14.9 /
    70.2 ms against 15.1 / 70.5 through ``perm`` at k = 64 on the H100).
    With the row in pieces buckets ran 3-10 % faster on that column
    (PERF.md §6, PR 18); the exception stays until a graph's Aᵀ·G says
    the same."""
    route = transposed_route(rowptr, colind, t, ncols, itemsize)
    if route != "buckets":
        return route
    return "perm" if row_split(t.ptr).bounded else route


def transposed_spmm(rowptr, colind, t, values, G, ncols: int,
                    route=None) -> torch.Tensor:
    """``Aᵀ·G`` for CSR ``A = (rowptr, colind, values)`` (values in the
    kernel's type) on its cached transpose ``t``, on ``route`` (``"perm"``
    or ``"buckets"``; by default :func:`spmm_route`'s, counted in
    ``csr_transpose.ROUTES``). Both give the same bits."""
    if route is None:
        route = spmm_route(rowptr, colind, t, ncols, values.element_size())
        ROUTES[route] += 1
    vals, perm = transposed_values(rowptr, colind, t, values, ncols, route)
    return csr_spmm(t.ptr, t.minor, vals, G, ncols, perm=perm)


class CsrSpmm(torch.autograd.Function):
    """``Y = A @ X`` with the closed-form gradient of
    ``spalinalg_tpu/ops/kernels/csr_route.py::_route_spmm_ad_bwd``.

    ``CsrSpmm.apply(values, X, rowptr, colind, nrows, ncols)``; gradients
    flow to ``values`` and ``X``.
    """

    @staticmethod
    def forward(ctx, values, X, rowptr, colind, nrows, ncols):
        # The structure tensors are kept as they are (not saved tensors) so
        # that the transpose cache sees the same objects on every call.
        ctx.structure = (rowptr, colind, nrows, ncols)
        ctx.save_for_backward(values, X)
        return csr_spmm(rowptr, colind, values, X, nrows)

    @staticmethod
    @once_differentiable
    def backward(ctx, G):
        values, X = ctx.saved_tensors
        rowptr, colind, nrows, ncols = ctx.structure
        acc = acc_dtype(values.dtype, X.dtype)
        G = G.to(acc)
        t = transpose_plan(rowptr, colind, nrows, ncols)
        dvals = dX = None
        if ctx.needs_input_grad[0]:
            # Padding slots have the sentinel row nrows: 0.
            dvals = csr_sddmm(rowptr, colind, G, X.to(acc), nrows,
                              major=t.major).to(values.dtype)
        if ctx.needs_input_grad[1]:
            dX = transposed_spmm(rowptr, colind, t,
                                 values.to(acc).contiguous(), G,
                                 ncols).to(X.dtype)
        return dvals, dX, None, None, None, None
