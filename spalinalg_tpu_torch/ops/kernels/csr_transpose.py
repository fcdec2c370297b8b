"""The CSR backward's transposed values in column buckets: the plan, the
Hopper kernel's wrapper, its plain torch version, its launch counts, and
the route rule.

Both CSR backward passes compute ``dx = Aᵀ·g`` (``dX = Aᵀ·G``) with the
forward's kernel on the cached transposed structure
(:func:`~.csr_spmv.transpose_plan`), whose slot ``q`` holds ``A``'s value
``values[perm[q]]``. Read through ``perm`` that is one random read a slot
across the whole value array. The ``buckets`` route puts the values where
the transposed walk looks for them first:

- :func:`bucket_plan` (built once per structure on its device, cached like
  the transpose and dropped with it) cuts the columns into blocks of
  ``width`` columns (a power of two: a block's values fill about
  :data:`BUCKET_BYTES`), orders the slots by block, then by slot, and
  keeps ``bperm`` (where ``values[perm[q]]`` lands), ``lpos`` (each slot's
  place in its slab's block order, int16) and the runs (each slab's
  stretch of each block);
- pass 1, :func:`bucket_values` (``csrc/csr_transpose.cu``,
  ``bucket_scatter``), writes the values in that order to a new buffer
  ``vb``, so that ``vb[bperm] == values[perm]`` exactly;
- pass 2 is the forward kernel's ``perm`` path on ``(vb, bperm)``: the same
  terms in the same order as through ``perm``, so the same bits, with the
  reads of a stretch of columns inside one block's ``vb`` region;
- the SpMV's ``products`` route moves ``values[p]·g[row p]`` in pass 1
  instead, and its pass 2 (``csr_spmv.csr_spmv_products``) sums them with
  the vector SpMV's own order and no gather of ``g``: the same bits where
  that kernel stages every product, that is where it splits no row.

:func:`transposed_route` picks the route of a backward pass: ``buckets`` on
the card where the values do not fit its L2 and ``perm`` is not already
local, else ``perm`` (and always ``perm`` on the CPU, where the plain
versions run); the SpMV makes ``buckets`` ``products`` where it can, and
the SpMM keeps ``perm`` where one row of the transpose bounds its launch
(``csr_spmv.spmv_route``, ``csr_spmm.spmm_route``).
:func:`transposed_values` gives the values and index array the transposed
kernel reads on each route.

Each kernel launch adds one to ``LAUNCHES`` (by dtype) and to
``VARIANT_LAUNCHES["scatter"]``; ``ROUTES`` counts the routes the backward
passes took.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ...convert.engine import TransposeStructure
from ...dtypes import INDEX_DTYPE
from ...errors import DTypeError, ShapeError
from ...utils.plancache import StructureCache

__all__ = ["BUCKET_BYTES", "LAUNCHES", "ROUTES", "SLAB", "SPAN_CHUNK",
           "VARIANT_LAUNCHES", "BucketPlan", "bucket_key", "bucket_plan",
           "bucket_values", "bucket_values_plain", "bucket_width",
           "build_bucket_plan", "perm_span", "route_for", "transposed_route",
           "transposed_values"]

# Kernel launches per dtype and per kernel: plain integers, advanced only
# where the wrappers launch the kernels.
LAUNCHES = {"float32": 0, "float64": 0}
VARIANT_LAUNCHES = {"scatter": 0}
# The route each backward pass took (the dispatched transposed products of
# csr_spmv.transposed_spmv and csr_spmm.transposed_spmm), on any device.
ROUTES = {"perm": 0, "buckets": 0, "products": 0}

# Slots a CTA of bucket_scatter stages (kSlab in csrc/csr_transpose.cu):
# lpos fits an int16.
SLAB = 8192

# Bytes of values a column block holds about: a small share of the H100's
# 50 MB L2, so that the few blocks the transposed walk reads at a time stay
# in it.
BUCKET_BYTES = 2 << 20

# Transposed slots over which perm_span measures how far perm reaches:
# what one CTA of the vector SpMV walks (8 warps of 256 entries).
SPAN_CHUNK = 2048

_ENTRY = {torch.float32: ("spal_bucket_scatter_f32", "float32"),
          torch.float64: ("spal_bucket_scatter_f64", "float64")}

# Live as long as each structure does (see utils/plancache.py).
_BUCKET_PLANS = StructureCache()
_ROUTE_CHOICES = StructureCache()


class BucketPlan(NamedTuple):
    """Where each value of a structure goes in the bucketed buffer ``vb``
    (:func:`build_bucket_plan`).

    The slots are ordered by column block (``width`` columns a block; slots
    past the structure's last entry form a last block of their own), then
    by slot. ``bperm`` (int32, one a transposed slot) is where
    ``values[perm[q]]`` lands. ``lpos`` (int16, one a slot) is a slot's
    place among the slots of its slab (``SLAB`` consecutive slots) in that
    order. A run is one slab's slots of one block, contiguous in both:
    ``run_ptr`` (int32, ``nslab + 1``) delimits each slab's runs, and each
    run has its first place in the slab's order (``run_start``) and in
    ``vb`` (``run_goff``), both int32.
    """

    bperm: torch.Tensor
    lpos: torch.Tensor
    run_ptr: torch.Tensor
    run_start: torch.Tensor
    run_goff: torch.Tensor
    width: int
    nblocks: int

    @property
    def nse(self) -> int:
        return self.lpos.numel()

    @property
    def nslab(self) -> int:
        return self.run_ptr.numel() - 1

    @property
    def nbytes(self) -> int:
        """The plan's device bytes."""
        return sum(t.numel() * t.element_size() for t in (
            self.bperm, self.lpos, self.run_ptr, self.run_start,
            self.run_goff))


def bucket_width(nnz: int, ncols: int, itemsize: int) -> int:
    """Columns a block: the largest power of two whose mean share of the
    values (``nnz / ncols`` entries a column of ``itemsize`` bytes) fits
    :data:`BUCKET_BYTES`, at least 1 and at most the power of two that
    covers ``ncols``.

    >>> bucket_width(2**26, 2**21, 4), bucket_width(2**26, 2**21, 8)
    (16384, 8192)
    >>> bucket_width(0, 1000, 8), bucket_width(10, 1000, 8)
    (1024, 1024)
    """
    cover = 1 << max(ncols - 1, 0).bit_length()
    if nnz <= 0:
        return cover
    width = max(1, BUCKET_BYTES * max(ncols, 1) // (nnz * itemsize))
    return min(1 << (width.bit_length() - 1), cover)


def bucket_key(colind: torch.Tensor, nnz: int, width: int,
               nblocks: int) -> torch.Tensor:
    """Each slot's block (int32): ``colind // width``, and ``nblocks``, a
    last block past every column's, for the slots from ``nnz`` on
    (padding).

    >>> bucket_key(torch.tensor([5, 0, 7, 3], dtype=torch.int32), 3, 4,
    ...            2).tolist()
    [1, 0, 1, 2]
    """
    key = colind.to(INDEX_DTYPE) >> (width.bit_length() - 1)
    if nnz < key.numel():
        key = key.clone()
        key[nnz:] = nblocks
    return key


def build_bucket_plan(rowptr: torch.Tensor, colind: torch.Tensor,
                      perm: torch.Tensor, ncols: int,
                      itemsize: int) -> BucketPlan:
    """The :class:`BucketPlan` of a CSR structure whose transpose reads
    slot ``perm[q]`` (the transpose's ``perm``), for values of
    ``itemsize`` bytes, in blocks of :func:`bucket_width` columns, built on
    the structure's device with plain torch (two stable sorts) and reads
    back of the entry count and the run count.

    >>> p = build_bucket_plan(torch.tensor([0, 2, 3], dtype=torch.int32),
    ...                       torch.tensor([3, 0, 1], dtype=torch.int32),
    ...                       torch.tensor([1, 2, 0], dtype=torch.int32), 4, 4)
    >>> p.width, p.bperm.tolist(), p.lpos.tolist(), p.run_start.tolist()
    (4, [1, 2, 0], [0, 1, 2], [0])
    """
    nse = colind.numel()
    device = colind.device
    nnz = int(rowptr[-1]) if rowptr.numel() else 0
    width = bucket_width(nnz, ncols, itemsize)
    nblocks = (max(ncols, 1) + width - 1) // width
    key = bucket_key(colind, nnz, width, nblocks)
    index = torch.arange(nse, dtype=torch.int64, device=device)
    # vb's order: by block, then by slot
    order = torch.sort(key, stable=True).indices
    pos = torch.empty(nse, dtype=INDEX_DTYPE, device=device)
    pos[order] = index.to(INDEX_DTYPE)
    bperm = pos[perm.to(torch.int64)]
    del order
    # each slab's order: by block, then by slot (slabs stay in place)
    slab = index // SLAB
    skey = slab * (nblocks + 1) + key.to(torch.int64)
    sorted_skey, order = torch.sort(skey, stable=True)
    del skey
    lpos = torch.empty(nse, dtype=torch.int16, device=device)
    lpos[order] = (index - slab * SLAB).to(torch.int16)
    first = torch.ones(nse, dtype=torch.bool, device=device)
    first[1:] = sorted_skey[1:] != sorted_skey[:-1]
    first = torch.nonzero(first).flatten()
    run_slab = sorted_skey[first] // (nblocks + 1)
    run_start = (first - run_slab * SLAB).to(INDEX_DTYPE)
    run_goff = pos[order[first]]
    nslab = -(-nse // SLAB)
    run_ptr = torch.searchsorted(
        run_slab, torch.arange(nslab + 1, dtype=torch.int64, device=device)
    ).to(INDEX_DTYPE)
    return BucketPlan(bperm, lpos, run_ptr, run_start, run_goff, width,
                      nblocks)


def bucket_plan(rowptr: torch.Tensor, colind: torch.Tensor,
                t: TransposeStructure, ncols: int,
                itemsize: int) -> BucketPlan:
    """:func:`build_bucket_plan` of the structure and its transpose ``t``,
    built once per structure and value size (keyed on the identity and
    shape of ``rowptr`` and ``colind``, ``ncols`` and ``itemsize``) and
    dropped with it."""
    return _BUCKET_PLANS.get(
        (rowptr, colind),
        lambda: build_bucket_plan(rowptr, colind, t.perm, ncols, itemsize),
        ncols, itemsize)


def _values_checked(values: torch.Tensor, nse: int) -> torch.Tensor:
    if values.dtype not in _ENTRY:
        raise DTypeError(f"no csr_transpose kernel for {values.dtype}")
    if values.ndim != 1 or values.numel() != nse:
        raise ShapeError(f"values of shape {tuple(values.shape)} for a plan "
                         f"of {nse} slots")
    return values.contiguous()


def _moved_plain(values, g, major):
    """What pass 1 moves: ``values``, or with ``g`` each times ``g`` at its
    slot's row (``major``; padding rows, ``major >= g.numel()``, keep the
    value)."""
    if g is None:
        return values
    nrows = g.numel()
    rows = major.to(torch.int64)
    return torch.where(rows < nrows, values * g[rows.clamp(max=max(nrows - 1,
                                                                   0))],
                       values)


def _scale_checked(values, g, major):
    if g is None:
        return None, None
    if major is None or g.dtype != values.dtype or g.ndim != 1 or (
            major.shape != values.shape or major.dtype != INDEX_DTYPE):
        raise ShapeError("pass 1's products need g (1-D, the values' dtype) "
                         "and major (int32, a row a slot)")
    return g.contiguous(), major.contiguous()


def bucket_values_plain(values: torch.Tensor, plan: BucketPlan, g=None,
                        major=None) -> torch.Tensor:
    """Plain torch pass 1: each slot's value (with ``g``: its product with
    ``g[major[p]]``, padding rows kept) at ``run_goff[r] + lpos[p] -
    run_start[r]`` of ``vb``, ``r`` the run that holds its place in its
    slab, as the kernel puts it. Runs on any device."""
    values = _values_checked(values, plan.nse)
    g, major = _scale_checked(values, g, major)
    device = values.device
    index = torch.arange(plan.nse, dtype=torch.int64, device=device)
    slab = index // SLAB
    runs = plan.run_ptr[1:] - plan.run_ptr[:-1]
    run_slab = torch.repeat_interleave(
        torch.arange(plan.nslab, dtype=torch.int64, device=device), runs)
    run_place = run_slab * SLAB + plan.run_start
    place = slab * SLAB + plan.lpos.to(torch.int64)
    r = torch.searchsorted(run_place, place, right=True) - 1
    dest = plan.run_goff[r] + (plan.lpos - plan.run_start[r])
    vb = torch.empty_like(values)
    vb[dest.to(torch.int64)] = _moved_plain(values, g, major)
    return vb


def bucket_values(values: torch.Tensor, plan: BucketPlan, g=None,
                  major=None) -> torch.Tensor:
    """``vb``, the values in the plan's bucket order (pass 1): the
    ``bucket_scatter`` kernel on CUDA tensors, the plain version on CPU
    tensors. ``vb[plan.bperm] == values[perm]`` exactly. With ``g`` and
    ``major`` (the row of each slot, as the transpose's ``major``) it moves
    ``values[p]·g[major[p]]`` instead: the products of ``Aᵀ·g``."""
    values = _values_checked(values, plan.nse)
    g, major = _scale_checked(values, g, major)
    device = values.device
    if plan.lpos.device != device:
        raise ValueError(f"values on {device}, plan on {plan.lpos.device}")
    if device.type == "cpu":
        return bucket_values_plain(values, plan, g, major)
    if device.type != "cuda":
        raise ValueError(f"no csr_transpose kernel for device {device}")
    vb = torch.empty_like(values)
    if plan.nse == 0:
        return vb
    from ._build import launch

    name, key = _ENTRY[values.dtype]
    with torch.cuda.device(device):
        launch(name, values.data_ptr(), plan.lpos.data_ptr(),
               plan.run_ptr.data_ptr(), plan.run_start.data_ptr(),
               plan.run_goff.data_ptr(), vb.data_ptr(), plan.nse, plan.nslab,
               None if g is None else g.data_ptr(),
               None if major is None else major.data_ptr(),
               0 if g is None else g.numel(),
               torch.cuda.current_stream(device).cuda_stream)
    LAUNCHES[key] += 1
    VARIANT_LAUNCHES["scatter"] += 1
    return vb


def perm_span(perm: torch.Tensor, nnz: int) -> float:
    """How far the transposed walk reaches through ``perm``: the mean, over
    runs of :data:`SPAN_CHUNK` transposed slots below ``nnz``, of the slots
    between the least and the greatest they read (one read back).

    >>> perm_span(torch.arange(4096, dtype=torch.int32), 4096)
    2048.0
    """
    if nnz <= 0:
        return 0.0
    p = perm[:nnz]
    nfull = nnz // SPAN_CHUNK
    spans = []
    if nfull:
        chunks = p[:nfull * SPAN_CHUNK].view(nfull, SPAN_CHUNK)
        spans.append((chunks.amax(1) - chunks.amin(1) + 1).to(torch.float64))
    if nnz % SPAN_CHUNK:
        tail = p[nfull * SPAN_CHUNK:]
        spans.append((tail.amax() - tail.amin() + 1).to(torch.float64)[None])
    return float(torch.cat(spans).mean())


def route_for(nnz: int, itemsize: int, span: float, l2_bytes: int) -> str:
    """The route of a transposed product on a card of ``l2_bytes`` of L2:
    ``"buckets"`` where the values (``nnz`` of ``itemsize`` bytes) do not
    fit the L2 and the walk through ``perm`` reaches across more than a
    block's bytes in a chunk (``span`` from :func:`perm_span`); else
    ``"perm"``. Values that fit mostly stay in the L2 through ``perm``:
    34 MB of them gained 1.5 % on the bucket route on the H100, 68 MB 24 %
    (PERF.md). A pure function, testable anywhere.

    >>> l2 = 50 << 20
    >>> route_for(2**26, 4, 2.0**26, l2), route_for(2**26, 4, 3000.0, l2)
    ('buckets', 'perm')
    >>> route_for(10_000, 8, 10_000.0, l2), route_for(2**22, 8, 2.0**22, l2)
    ('perm', 'perm')
    """
    if nnz * itemsize <= l2_bytes:
        return "perm"
    return "buckets" if span * itemsize > BUCKET_BYTES else "perm"


def transposed_route(rowptr: torch.Tensor, colind: torch.Tensor,
                     t: TransposeStructure, ncols: int,
                     itemsize: int) -> str:
    """:func:`route_for` the structure and its transpose ``t`` on the
    structure's card, decided once per structure and value size (the
    card's L2 size, the entry count and :func:`perm_span` read then) and
    cached like the transpose; ``"perm"`` off the card."""
    device = colind.device
    if device.type != "cuda":
        return "perm"

    def decide() -> str:
        l2_bytes = torch.cuda.get_device_properties(device).L2_cache_size
        nnz = int(t.ptr[-1])
        if nnz * itemsize <= l2_bytes:
            return "perm"
        return route_for(nnz, itemsize, perm_span(t.perm, nnz), l2_bytes)

    return _ROUTE_CHOICES.get((rowptr, colind), decide, ncols, itemsize)


def transposed_values(rowptr: torch.Tensor, colind: torch.Tensor,
                      t: TransposeStructure, values: torch.Tensor,
                      ncols: int, route: str, g=None):
    """``(vals, perm)`` for the transposed product on ``route``: the kernel
    on ``(t.ptr, t.minor)`` reading ``vals[perm[q]]`` at slot ``q``.
    ``values`` are ``A``'s, in the kernel's type. ``"perm"``: ``(values,
    t.perm)``; ``"buckets"``: pass 1, then ``(vb, plan.bperm)``;
    ``"products"`` (the SpMV's, with ``g``): pass 1 moving ``values[p]·
    g[row p]``, then ``(vb, plan.bperm)``, for the product-summing kernel
    (``csr_spmv.csr_spmv_products``)."""
    if route == "perm":
        return values, t.perm
    if route not in ("buckets", "products"):
        raise ValueError(f"unknown transposed route {route!r}; the routes "
                         "are 'buckets', 'perm' and 'products'")
    plan = bucket_plan(rowptr, colind, t, ncols, values.element_size())
    if route == "buckets":
        return bucket_values(values, plan), plan.bperm
    if g is None:
        raise ValueError("the products route needs g")
    return bucket_values(values, plan, g=g, major=t.major), plan.bperm
