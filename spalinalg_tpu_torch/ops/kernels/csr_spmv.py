"""CSR SpMV: the Hopper kernel's wrapper, its plain torch version, its launch
count, and the gradient.

The kernel (``spalinalg_tpu_torch/csrc/csr_spmv.cu``) replaces the four
Pallas kernels on the JAX package's SpMV path:

- ``spalinalg_tpu/ops/kernels/csr_route.py::_route_kernel`` (f32),
- ``spalinalg_tpu/ops/kernels/csr_route.py::_route_kernel_pk`` (f32,
  packed active pages),
- ``spalinalg_tpu/ops/kernels/csr_route_df.py::_route_kernel_df`` (f64 as
  double-float),
- ``spalinalg_tpu/ops/kernels/csr_route_df.py::_route_kernel_df_pk``.

Their routing plan, lane-gather network, spill recursion and double-float
arithmetic work around TPU limits that Hopper does not have, so one
source, instantiated for float32 and float64, reads
``rowptr``/``colind``/``values`` directly. It has two variants, chosen by
:func:`csr_spmv_variant` from dtypes and addresses and passed to the kernel
by name: ``vector`` (a warp a window of 256 entries' rows, 16-byte loads,
long rows split over warps by the cached :func:`csr_spmv_plan`) and
``scalar`` (the first design: a lane group a row, one entry a lane a step)
for views off a 16-byte boundary. Each launch adds one to ``LAUNCHES`` (by
dtype) and to ``VARIANT_LAUNCHES`` (by variant); where the plan has long
rows, the vector variant's second kernel (``csr_spmv_finish``, which sums
their pieces) adds one more to ``LAUNCHES`` and one to
``VARIANT_LAUNCHES["finish"]``. The metrics path names the variant, for
example ``csr_spmv:cuda:vector``.

:func:`csr_spmv` is the wrapper. For CUDA tensors it launches the kernel or
raises; for CPU tensors it runs :func:`csr_spmv_plain`. It takes an
optional ``perm``: the values of slot ``p`` are then ``values[perm[p]]``,
read by the kernel itself. :class:`CsrSpmv` carries the gradient of
``csr_route.py::_route_spmv_ad_bwd``: ``dx = Aᵀ·g`` runs the same kernel on
the cached transposed structure (no atomics), reading the forward's values
through the transpose's ``perm``, or (:func:`transposed_spmv`, on the
route :func:`spmv_route` picks) the values bucketed by column block, or
the products ``values·g[row]`` bucketed so and summed by the kernel's
products instance (:func:`csr_spmv_products`; ``ops/kernels/
csr_transpose.py``): the same bits on every route. ``dvals =
g[row]·x[colind]`` is the CSR SDDMM kernel at k = 1
(``ops/kernels/csr_sddmm.py``; XLA code outside any Pallas kernel in the
JAX package).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.autograd.function import once_differentiable

from ...convert.engine import TransposeStructure, major_ids, transpose_structure
from ...dtypes import INDEX_DTYPE, acc_dtype
from ...errors import DTypeError, ShapeError
from ...utils.plancache import StructureCache
from ...utils.profiling import annotate
from .csr_sddmm import csr_sddmm
from .csr_transpose import ROUTES, transposed_route, transposed_values

__all__ = ["BUDGET", "LAUNCHES", "STAGE_BUDGET", "TILE_ROWS",
           "VARIANT_LAUNCHES", "CsrSpmv", "SpmvPlan", "TilePlan", "aligned16",
           "build_tile_plan", "csr_spmv", "csr_spmv_plain", "csr_spmv_plan",
           "csr_spmv_products", "csr_spmv_products_plain", "csr_spmv_variant",
           "csr_tile_plan", "kernel_path", "lanes_for", "path_for",
           "spmv_route", "stage_bytes", "staged_fits", "transpose_plan",
           "transposed_spmv"]

# Kernel launches per instantiation and per variant: plain integers,
# advanced only where the wrapper launches the kernels. "finish" counts
# the vector variant's second kernel, launched where rows were split;
# "products" the vector kernel summing given products
# (csr_spmv_products).
LAUNCHES = {"float32": 0, "float64": 0}
VARIANT_LAUNCHES = {"scalar": 0, "vector": 0, "finish": 0, "products": 0}

# The variant's code in the C entry points.
_VARIANT_CODE = {"scalar": 0, "vector": 1}

# Entries a window or a piece of the vector variant: kBudget in
# csrc/csr_spmv.cu.
BUDGET = 256

# Rows a tile of the staged CSR SpMM and SDDMM (kTileRows in csrc/csr_spmm.cu
# and csrc/csr_sddmm.cu): a CTA's rows.
TILE_ROWS = 64

# Bytes of shared memory a staged CTA may take for its window of X before
# the dispatch leaves the staged variants: 96 KiB keeps at least two CTAs
# on each SM of an H100 (228 KB of shared memory an SM, 227 KB a CTA at
# most). The kernels themselves take any window up to 227 KB.
STAGE_BUDGET = 96 * 1024

# Slots a pass of build_tile_plan: bounds its temporaries (three int64
# arrays of this length).
_TILE_CHUNK = 1 << 24

_ENTRY = {torch.float32: ("spal_csr_spmv_f32", "float32"),
          torch.float64: ("spal_csr_spmv_f64", "float64")}

# Live as long as each structure does (see utils/plancache.py).
_TRANSPOSE_PLANS = StructureCache()
_SPMV_PLANS = StructureCache()
_TILE_PLANS = StructureCache()


class SpmvPlan(NamedTuple):
    """The vector variant's work split of one structure (``csr_spmv_plan``).

    ``plan`` is one int32 tensor: four numbers a window (``nwin`` of them;
    window ``w`` owns the rows whose first entry lies in ``[w·BUDGET, (w +
    1)·BUDGET)``, less a last row longer than ``BUDGET``): its first row,
    the row past its last short row, and their entries' range; then each
    piece's row and first entry (``npieces`` each; a piece is ``BUDGET``
    entries of a row longer than ``BUDGET``); the long rows (``nlong``) and
    the first piece of each (``nlong + 1``).
    """

    plan: torch.Tensor
    nwin: int
    npieces: int
    nlong: int

    def parts(self):
        """``(windows, piece_row, piece_start, long_rows, first_piece)``,
        views of ``plan``; ``windows`` is ``(nwin, 4)``: ``(r0, r1, e0,
        e1)`` a row."""
        windows, *rest = self.plan.split(
            [4 * self.nwin, self.npieces, self.npieces, self.nlong,
             self.nlong + 1])
        return (windows.view(self.nwin, 4), *rest)


class TilePlan(NamedTuple):
    """The column windows of a structure's row tiles (``csr_tile_plan``):
    what the staged CSR SpMM and SDDMM stage in shared memory.

    ``tiles`` is ``(ntiles, 4)`` int32, a row a tile of ``rows`` consecutive
    rows (the last may be shorter): the tile's first slot and the slot past
    its last (``rowptr`` at its first row and past its last row), the first
    column ``c0`` its slots read and the window's width ``w``, so that
    every column the tile reads lies in ``[c0, c0 + w)``; an empty tile has
    ``c0 = w = 0``. ``max_window`` is the largest ``w``, ``max_slots`` the
    most slots a tile holds.
    """

    tiles: torch.Tensor
    rows: int
    max_window: int
    max_slots: int

    @property
    def ntiles(self) -> int:
        return self.tiles.shape[0]


def build_tile_plan(rowptr: torch.Tensor, colind: torch.Tensor,
                    rows_per_tile: int = TILE_ROWS) -> TilePlan:
    """The :class:`TilePlan` of a CSR structure, built on its device in plain
    torch (a segment min and max of ``colind`` over each tile's slots) with
    one read back (the widest window and the most slots). Slots past
    ``rowptr[-1]`` (padding) belong to no tile.

    >>> p = build_tile_plan(
    ...     torch.tensor([0, 2, 2, 3, 3, 3], dtype=torch.int32),
    ...     torch.tensor([4, 1, 7, 0], dtype=torch.int32), 2)
    >>> p.tiles.tolist(), p.max_window, p.max_slots
    ([[0, 2, 1, 4], [2, 3, 7, 1], [3, 3, 0, 0]], 4, 2)
    """
    if rows_per_tile < 1:
        raise ValueError(
            f"rows_per_tile must be positive, got {rows_per_tile}")
    ptr = rowptr.to(torch.int64)
    nrows = ptr.numel() - 1
    ntiles = -(-nrows // rows_per_tile)
    first_rows = torch.arange(ntiles + 1, dtype=torch.int64,
                              device=ptr.device) * rows_per_tile
    bounds = ptr[first_rows.clamp(max=nrows)]
    # one slot past the tiles for the padding slots, dropped at the end
    lo = torch.full((ntiles + 1,), torch.iinfo(torch.int64).max,
                    dtype=torch.int64, device=ptr.device)
    hi = torch.full((ntiles + 1,), -1, dtype=torch.int64, device=ptr.device)
    nse = colind.numel()
    for s in range(0, nse, _TILE_CHUNK):
        slots = torch.arange(s, min(s + _TILE_CHUNK, nse), dtype=torch.int64,
                             device=ptr.device)
        # the last tile whose first slot is at or before the slot: an
        # empty tile shares its first slot with the next one
        tile = torch.searchsorted(bounds, slots, right=True) - 1
        cols = colind[s:s + _TILE_CHUNK].to(torch.int64)
        lo.scatter_reduce_(0, tile, cols, "amin")
        hi.scatter_reduce_(0, tile, cols, "amax")
    lo, hi = lo[:ntiles], hi[:ntiles]
    width = (hi - lo + 1).clamp(min=0)
    c0 = torch.where(width > 0, lo, 0)
    tiles = torch.stack([bounds[:-1], bounds[1:], c0, width], dim=1)
    max_window, max_slots = (torch.stack(
        [width.max(), (bounds[1:] - bounds[:-1]).max()]).tolist()
        if ntiles else (0, 0))
    return TilePlan(tiles.to(INDEX_DTYPE).contiguous(), rows_per_tile,
                    max_window, max_slots)


def csr_tile_plan(rowptr: torch.Tensor, colind: torch.Tensor,
                  rows_per_tile: int = TILE_ROWS) -> TilePlan:
    """:func:`build_tile_plan` of the structure, built once per structure
    (keyed on the identity and shape of ``rowptr`` and ``colind`` and on
    ``rows_per_tile``) and dropped with it."""
    return _TILE_PLANS.get(
        (rowptr, colind),
        lambda: build_tile_plan(rowptr, colind, rows_per_tile), rows_per_tile)


def stage_bytes(plan: TilePlan, k: int, itemsize: int, *,
                with_rows: bool = False) -> int:
    """Bytes a staged CTA copies into shared memory at most, at ``k``
    columns of ``itemsize`` bytes: the widest window of X (the staged
    SpMM); ``with_rows`` adds a tile's rows of G and its column ids (the
    staged SDDMM).

    >>> plan = TilePlan(torch.zeros(1, 4, dtype=torch.int32), TILE_ROWS, 96,
    ...                 2112)
    >>> stage_bytes(plan, 64, 8), stage_bytes(plan, 64, 8, with_rows=True)
    (49152, 90368)
    """
    nbytes = plan.max_window * k * itemsize
    if with_rows:
        nbytes += plan.rows * k * itemsize + 4 * plan.max_slots
    return nbytes


def staged_fits(plan: TilePlan, k: int, itemsize: int, *,
                with_rows: bool = False) -> bool:
    """Whether :func:`stage_bytes` fits :data:`STAGE_BUDGET`: the
    dispatch's test for the staged CSR variants.

    >>> plan = TilePlan(torch.zeros(1, 4, dtype=torch.int32), TILE_ROWS, 192,
    ...                 64)
    >>> staged_fits(plan, 64, 8), staged_fits(plan, 65, 8)
    (True, False)
    """
    return stage_bytes(plan, k, itemsize, with_rows=with_rows) <= STAGE_BUDGET


def path_for(device: torch.device) -> str:
    """The dispatch path the wrapper takes for tensors on ``device``."""
    return "cuda" if device.type == "cuda" else "plain"


def lanes_for(nse: int, nrows: int) -> int:
    """Lanes per row: the power of two from 1 to 32 that covers the mean
    row length."""
    lanes = 1
    while lanes < 32 and lanes * nrows < nse:
        lanes *= 2
    return lanes


def aligned16(t: torch.Tensor) -> bool:
    """Whether ``t``'s first element starts on a 16-byte boundary."""
    return t.data_ptr() % 16 == 0


def csr_spmv_variant(colind, values, perm=None) -> str:
    """The variant of ``csrc/csr_spmv.cu`` for operands as the kernel takes
    them (``values`` in the accumulation type, float32 or float64):
    ``"vector"`` when ``colind`` and the array the values stream from
    (``perm`` if given, else ``values``) start on a 16-byte boundary, else
    ``"scalar"``. Row lengths do not enter: the vector variant's plan
    splits long rows and packs short ones. Dtypes and addresses alone
    decide, so it answers for tensors on any device.

    >>> csr_spmv_variant(torch.zeros(8, dtype=torch.int32), torch.zeros(8))
    'vector'
    >>> csr_spmv_variant(torch.zeros(9, dtype=torch.int32)[1:], torch.zeros(8))
    'scalar'
    """
    if values.dtype not in _ENTRY:
        raise DTypeError(f"no csr_spmv kernel for {values.dtype}")
    streamed = values if perm is None else perm
    return "vector" if aligned16(colind) and aligned16(streamed) \
        else "scalar"


def kernel_path(colind, values, x, *, fresh: bool = False) -> str:
    """The metrics path of ``csr_spmv``: ``"plain"`` off the card, else
    ``"cuda:"`` and the variant :func:`csr_spmv_variant` picks for the
    operands as the kernel takes them. ``fresh`` says that the caller
    passes the kernel a new gather of ``values`` (the CSC mirror's), not
    ``values`` itself. A new tensor, that gather or the wrapper's copy in
    the accumulation type, starts aligned, so nothing is copied here.

    >>> kernel_path(torch.zeros(2, dtype=torch.int32), torch.zeros(2),
    ...             torch.zeros(2))
    'plain'
    """
    if x.device.type != "cuda":
        return "plain"
    acc = acc_dtype(values.dtype, x.dtype)
    if fresh or values.dtype != acc or not values.is_contiguous():
        values = values.new_empty(0, dtype=acc)  # stands for a new tensor
    return f"cuda:{csr_spmv_variant(colind, values)}"


def build_spmv_plan(rowptr: torch.Tensor) -> SpmvPlan:
    """The vector variant's work split of ``rowptr`` (see :class:`SpmvPlan`),
    built on ``rowptr``'s device with two reads back (the entry and piece
    counts). Every slot below ``rowptr[-1]`` lies in exactly one window's
    rows or one piece, in order; slots past it in none.

    >>> p = build_spmv_plan(torch.tensor([0, 2, 2, 600, 601],
    ...                                  dtype=torch.int32))
    >>> p.nwin, p.npieces, p.nlong
    (3, 3, 1)
    >>> [t.tolist() for t in p.parts()]
    [[[0, 2, 0, 2], [3, 3, 600, 600], [3, 4, 600, 601]], [2, 2, 2], [2, 258, 514], [2], [0, 3]]
    """
    ptr = rowptr.to(torch.int64)
    nnz = int(ptr[-1])
    nwin = nnz // BUDGET + 1
    rows = torch.searchsorted(
        ptr[:-1].contiguous(),
        torch.arange(nwin + 1, dtype=torch.int64, device=ptr.device) * BUDGET)
    lens = ptr[1:] - ptr[:-1]
    r0, r1 = rows[:-1], rows[1:]
    # A window's last row can be long (it then runs past the window); its
    # pieces write it instead.
    last_long = (r1 > r0) & (lens[(r1 - 1).clamp(min=0)] > BUDGET)
    r1 = r1 - last_long.to(torch.int64)
    windows = torch.stack([r0, r1, ptr[r0], ptr[r1]], dim=1)
    long_rows = torch.nonzero(lens > BUDGET).flatten()
    pieces = (lens[long_rows] + BUDGET - 1) // BUDGET
    first_piece = torch.cat([pieces.new_zeros(1), torch.cumsum(pieces, 0)])
    npieces = int(first_piece[-1])
    piece_row = torch.repeat_interleave(long_rows, pieces)
    piece_start = ptr[piece_row] + BUDGET * (
        torch.arange(npieces, dtype=torch.int64, device=ptr.device)
        - torch.repeat_interleave(first_piece[:-1], pieces))
    plan = torch.cat([windows.reshape(-1), piece_row, piece_start, long_rows,
                      first_piece]).to(INDEX_DTYPE)
    return SpmvPlan(plan, nwin, npieces, int(long_rows.numel()))


def csr_spmv_plan(rowptr: torch.Tensor) -> SpmvPlan:
    """:func:`build_spmv_plan` of ``rowptr``, built once per structure
    (keyed on the identity and shape of ``rowptr``) and dropped with it.
    The lookup, and a build on a miss, is the span ``spal.spmv.plan``."""
    with annotate("spal.spmv.plan"):
        return _SPMV_PLANS.get((rowptr,), lambda: build_spmv_plan(rowptr))


def transpose_plan(ptr: torch.Tensor, minor: torch.Tensor, n_major: int,
                   n_minor: int) -> TransposeStructure:
    """The transposed structure, built once per structure (keyed on the
    identity and shape of ``ptr`` and ``minor`` and on both dimensions) and
    dropped with it."""
    return _TRANSPOSE_PLANS.get(
        (ptr, minor),
        lambda: transpose_structure(ptr, minor, n_major=n_major,
                                    n_minor=n_minor),
        n_major, n_minor)


def csr_spmv_plain(rowptr, colind, values, x, nrows: int) -> torch.Tensor:
    """Plain torch ``y = A @ x`` (or ``Y = A @ X`` for a 2-D ``x``):
    products scattered into rows with ``index_add_``. Padding slots land in
    a sentinel row that is cut off. Runs on any device; differentiable by
    autograd."""
    acc = acc_dtype(values.dtype, x.dtype)
    rows = major_ids(rowptr, colind.numel())
    v = values.to(acc).reshape((-1,) + (1,) * (x.ndim - 1))
    prod = v * x.to(acc)[colind]
    y = torch.zeros((nrows + 1,) + tuple(x.shape[1:]), dtype=acc,
                    device=x.device)
    y.index_add_(0, rows, prod)
    return y[:nrows]


def csr_spmv(rowptr, colind, values, x, nrows: int, perm=None
             ) -> torch.Tensor:
    """``y = A @ x`` for CSR ``A``: the kernel on CUDA tensors, the plain
    version on CPU tensors. With ``perm`` (int32, one entry a slot) the
    value of slot ``p`` is ``values[perm[p]]``.

    ``values`` and ``x`` are promoted to the accumulation dtype and made
    contiguous. Devices, index dtypes and shapes are checked; anything the
    kernel does not take raises.
    """
    acc = acc_dtype(values.dtype, x.dtype)
    values = values.to(acc).contiguous()
    x = x.to(acc).contiguous()
    operands = (rowptr, colind, values, x) + (() if perm is None else (perm,))
    devices = {t.device for t in operands}
    if len(devices) != 1:
        raise ValueError(f"csr_spmv operands on several devices: {devices}")
    if rowptr.dtype != INDEX_DTYPE or colind.dtype != INDEX_DTYPE or (
            perm is not None and perm.dtype != INDEX_DTYPE):
        raise DTypeError(
            f"indices must be {INDEX_DTYPE}, got {rowptr.dtype} and "
            f"{colind.dtype}" + ("" if perm is None else f" and {perm.dtype}"))
    if (rowptr.ndim != 1 or rowptr.numel() != nrows + 1 or colind.ndim != 1
            or values.shape != colind.shape or x.ndim != 1
            or (perm is not None and perm.shape != colind.shape)):
        raise ShapeError(
            f"csr_spmv shapes: rowptr {tuple(rowptr.shape)}, colind "
            f"{tuple(colind.shape)}, values {tuple(values.shape)}, x "
            f"{tuple(x.shape)}, nrows {nrows}"
            + ("" if perm is None else f", perm {tuple(perm.shape)}"))
    device = x.device
    if device.type == "cpu":
        if perm is not None:
            values = values[perm]
        return csr_spmv_plain(rowptr, colind, values, x, nrows)
    if device.type != "cuda":
        raise ValueError(f"no csr_spmv kernel for device {device}")
    if nrows == 0 or colind.numel() == 0:
        return torch.zeros(nrows, dtype=acc, device=device)
    from ._build import launch

    name, key = _ENTRY[acc]
    rowptr, colind = rowptr.contiguous(), colind.contiguous()
    if perm is not None:
        perm = perm.contiguous()
    variant = csr_spmv_variant(colind, values, perm)
    y = torch.empty(nrows, dtype=acc, device=device)
    plan, partial = None, None
    if variant == "vector":
        plan = csr_spmv_plan(rowptr)
        partial = torch.empty(plan.npieces, dtype=acc, device=device)
    with torch.cuda.device(device):
        launch(name, rowptr.data_ptr(), colind.data_ptr(), values.data_ptr(),
               None if perm is None else perm.data_ptr(), x.data_ptr(),
               y.data_ptr(), nrows, lanes_for(colind.numel(), nrows),
               _VARIANT_CODE[variant],
               None if plan is None else plan.plan.data_ptr(),
               0 if plan is None else plan.nwin,
               0 if plan is None else plan.npieces,
               0 if plan is None else plan.nlong,
               None if partial is None or partial.numel() == 0
               else partial.data_ptr(),
               torch.cuda.current_stream(device).cuda_stream)
    finish = int(plan is not None and plan.nlong > 0)
    LAUNCHES[key] += 1 + finish
    VARIANT_LAUNCHES[variant] += 1
    VARIANT_LAUNCHES["finish"] += finish
    return y


def csr_spmv_products_plain(rowptr, products, nrows: int) -> torch.Tensor:
    """Plain torch ``y[i] = Σ products[p]`` over row ``i``'s slots:
    ``index_add_`` into rows, padding slots into a sentinel row that is cut
    off."""
    rows = major_ids(rowptr, products.numel())
    y = torch.zeros(nrows + 1, dtype=products.dtype, device=products.device)
    y.index_add_(0, rows, products)
    return y[:nrows]


def csr_spmv_products(rowptr, colind, products, nrows: int, perm=None
                      ) -> torch.Tensor:
    """``y[i] = Σ products[q(p)]`` over row ``i``'s slots (``q(p) = perm[p]``
    or ``p``): the vector kernel summing products it is given instead of
    forming ``values·x``, in its own order, so bitwise what :func:`csr_spmv`
    gives where its products are these. On CPU tensors the plain version.
    The structure must split no row (no row past :data:`BUDGET` entries:
    the kernel's split rows fuse their products into the sum), and
    ``colind`` and the streamed array must start on 16 bytes; else it
    raises."""
    if products.dtype not in _ENTRY:
        raise DTypeError(f"no csr_spmv kernel for {products.dtype}")
    if perm is not None and perm.dtype != INDEX_DTYPE:
        raise DTypeError(f"perm must be {INDEX_DTYPE}, got {perm.dtype}")
    operands = (rowptr, colind, products) + (() if perm is None else (perm,))
    if len({t.device for t in operands}) != 1:
        raise ValueError("csr_spmv_products operands on several devices")
    if (rowptr.ndim != 1 or rowptr.numel() != nrows + 1
            or products.shape != colind.shape
            or (perm is not None and perm.shape != colind.shape)):
        raise ShapeError(
            f"csr_spmv_products shapes: rowptr {tuple(rowptr.shape)}, colind "
            f"{tuple(colind.shape)}, products {tuple(products.shape)}")
    products = products.contiguous()
    device = products.device
    if device.type == "cpu":
        return csr_spmv_products_plain(
            rowptr, products if perm is None else products[perm], nrows)
    if device.type != "cuda":
        raise ValueError(f"no csr_spmv kernel for device {device}")
    if nrows == 0 or colind.numel() == 0:
        return torch.zeros(nrows, dtype=products.dtype, device=device)
    plan = csr_spmv_plan(rowptr)
    if plan.npieces or csr_spmv_variant(colind, products, perm) != "vector":
        raise ValueError("csr_spmv_products takes structures that split no "
                         "row, with operands on 16-byte boundaries")
    from ._build import launch

    name, key = _ENTRY[products.dtype]
    y = torch.empty(nrows, dtype=products.dtype, device=device)
    with torch.cuda.device(device):
        launch(name, rowptr.data_ptr(), colind.data_ptr(),
               products.data_ptr(), None if perm is None else perm.data_ptr(),
               None, y.data_ptr(), nrows, 1, _VARIANT_CODE["vector"],
               plan.plan.data_ptr(), plan.nwin, 0, 0, None,
               torch.cuda.current_stream(device).cuda_stream)
    LAUNCHES[key] += 1
    VARIANT_LAUNCHES["products"] += 1
    return y


def spmv_route(rowptr, colind, t, ncols: int, itemsize: int) -> str:
    """The route of the SpMV backward's ``Aᵀ·g``:
    :func:`~.csr_transpose.transposed_route`, with ``"buckets"`` made
    ``"products"`` where the transposed structure splits no row (its
    :func:`csr_spmv_plan`)."""
    route = transposed_route(rowptr, colind, t, ncols, itemsize)
    if route == "buckets" and csr_spmv_plan(t.ptr).npieces == 0:
        return "products"
    return route


def transposed_spmv(rowptr, colind, t, values, g, ncols: int,
                    route=None) -> torch.Tensor:
    """``Aᵀ·g`` for CSR ``A = (rowptr, colind, values)`` (values in the
    kernel's type) on its cached transpose ``t``, on ``route`` (``"perm"``,
    ``"buckets"`` or ``"products"``; by default :func:`spmv_route`'s,
    counted in ``csr_transpose.ROUTES``). Every route gives the same
    bits."""
    if route is None:
        route = spmv_route(rowptr, colind, t, ncols, values.element_size())
        ROUTES[route] += 1
    vals, perm = transposed_values(rowptr, colind, t, values, ncols, route,
                                   g=g)
    if route == "products":
        return csr_spmv_products(t.ptr, t.minor, vals, ncols, perm=perm)
    return csr_spmv(t.ptr, t.minor, vals, g, ncols, perm=perm)


class CsrSpmv(torch.autograd.Function):
    """``y = A @ x`` with the closed-form gradient of
    ``spalinalg_tpu/ops/kernels/csr_route.py::_route_spmv_ad_bwd``.

    ``CsrSpmv.apply(values, x, rowptr, colind, nrows, ncols)``; gradients
    flow to ``values`` and ``x``.
    """

    @staticmethod
    def forward(ctx, values, x, rowptr, colind, nrows, ncols):
        # The structure tensors are kept as they are (not saved tensors) so
        # that the transpose cache sees the same objects on every call.
        ctx.structure = (rowptr, colind, nrows, ncols)
        ctx.save_for_backward(values, x)
        return csr_spmv(rowptr, colind, values, x, nrows)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        values, x = ctx.saved_tensors
        rowptr, colind, nrows, ncols = ctx.structure
        acc = acc_dtype(values.dtype, x.dtype)
        g = g.to(acc)
        # The cached plan also keeps the row of each slot: rebuilding it with
        # a searchsorted on every backward made a forward + backward step
        # about 1.5x slower on an H100 (n = 2**21, 32 entries a row).
        t = transpose_plan(rowptr, colind, nrows, ncols)
        dvals = dx = None
        if ctx.needs_input_grad[0]:
            # Padding slots have the sentinel row nrows: 0.
            dvals = csr_sddmm(rowptr, colind, g, x.to(acc), nrows,
                              major=t.major).to(values.dtype)
        if ctx.needs_input_grad[1]:
            dx = transposed_spmv(rowptr, colind, t,
                                 values.to(acc).contiguous(),
                                 g.contiguous(), ncols).to(x.dtype)
        return dvals, dx, None, None, None, None
