"""CSR SDDMM: the Hopper kernel's wrapper, its plain torch version and its
launch count.

``out[p] = Σ_c G[row_p, c]·X[colind[p], c]`` for every stored slot ``p``
below ``rowptr[nrows]``, and 0 for the padding slots past it: the gradient
of a CSR product with respect to its values (``dvals``), for SpMV (``k =
1``, ``g[row]·x[col]``) and SpMM alike.

The kernel (``spalinalg_tpu_torch/csrc/csr_sddmm.cu``) has no Pallas
counterpart: in the JAX package ``dvals`` is XLA code,
``spalinalg_tpu/ops/kernels/csr_route.py:1093`` (SpMV) and ``:1364``
(SpMM). It has four variants, chosen by :func:`csr_sddmm_variant` and
passed to the kernel by name:

- ``staged``: a CTA stages the rows of ``X`` its tile of rows reads (the
  window of :func:`~.csr_spmv.csr_tile_plan`), the tile's rows of ``G``
  and its column ids in shared memory, where they fit
  :data:`~.csr_spmv.STAGE_BUDGET` and ``X``, ``G`` and ``colind`` start
  on a 16-byte boundary (a banded matrix);
- ``vector`` (16-byte row loads) where ``k·itemsize`` is a multiple of 16
  and ``G`` and ``X`` start on a 16-byte boundary;
- ``rowwalk`` (``k = 1``): a warp walks a window of
  :func:`~.csr_spmv.csr_spmv_plan` and finds each slot's row from
  ``rowptr`` (it ran faster than ``scalar`` on the H100, PERF.md);
- ``scalar`` otherwise.

``scalar`` and ``vector`` read the per-slot row id ``major`` (the cached
transpose plan's ``TransposeStructure.major``, or built here from
``rowptr``); ``staged`` and ``rowwalk`` read ``rowptr`` and their plan.

:func:`csr_sddmm` is the wrapper. For CUDA tensors it launches the kernel
or raises; for CPU tensors it runs :func:`csr_sddmm_plain`.

>>> rowptr = torch.tensor([0, 2, 3], dtype=torch.int32)     # slot 3: padding
>>> colind = torch.tensor([0, 1, 1, 0], dtype=torch.int32)
>>> G = torch.tensor([[1.0, 2.0], [3.0, 4.0]])
>>> X = torch.tensor([[1.0, 0.0], [0.0, 1.0]])
>>> csr_sddmm(rowptr, colind, G, X, 2)
tensor([1., 2., 4., 0.])
"""

from __future__ import annotations

import torch

from ...convert.engine import major_ids
from ...dtypes import INDEX_DTYPE, acc_dtype
from ...errors import DTypeError, ShapeError

__all__ = ["LAUNCHES", "SDDMM_TILE_ROWS", "VARIANT_LAUNCHES", "csr_sddmm",
           "csr_sddmm_plain", "csr_sddmm_variant"]

# Kernel launches per instantiation and per variant: plain integers,
# advanced only where the wrapper launches the kernel.
LAUNCHES = {"float32": 0, "float64": 0}
VARIANT_LAUNCHES = {"scalar": 0, "vector": 0, "staged": 0, "rowwalk": 0}

_VARIANT_CODE = {"scalar": 0, "vector": 1, "staged": 2, "rowwalk": 3}

# Rows a tile of the staged variant (the kernel takes 64 or 32). At 32
# what a CTA stages on the banded matrix at k = 64 in float64 (52 KB)
# leaves room for four CTAs an SM, against two at 64 rows (89 KB), and a
# launch ran faster on the H100 (``tools/bench_csr.py --variants``,
# PERF.md).
SDDMM_TILE_ROWS = 32

_ENTRY = {torch.float32: ("spal_csr_sddmm_f32", "float32"),
          torch.float64: ("spal_csr_sddmm_f64", "float64")}

# Elements per gathered temporary of the plain version: at k = 64 and 17M
# entries an unchunked gather would take 8.9 GB per array in float64.
_CHUNK = 1 << 26


def csr_sddmm_variant(G, X, plan=None, colind=None) -> str:
    """The variant of ``csrc/csr_sddmm.cu`` for 2-D ``G`` and ``X`` as the
    kernel takes them (accumulation type, contiguous) and the structure's
    tile plan (:func:`~.csr_spmv.csr_tile_plan`, or None) and column ids:
    ``"staged"`` when what a CTA stages (the plan's widest window of ``X``,
    a tile's rows of ``G`` and its column ids) fits
    :data:`~.csr_spmv.STAGE_BUDGET` at ``k`` columns and ``X``, ``G`` and
    ``colind`` start on a 16-byte boundary; else ``"vector"`` when a row
    is a whole number of 16-byte vectors (``k·itemsize % 16 == 0``) and
    both start on a 16-byte boundary; else ``"rowwalk"`` for ``k = 1``;
    else ``"scalar"``. The plan, shapes, dtypes and addresses alone
    decide.

    >>> csr_sddmm_variant(torch.zeros(3, 64), torch.zeros(5, 64))
    'vector'
    >>> csr_sddmm_variant(torch.zeros(3, 1), torch.zeros(5, 1))
    'rowwalk'
    >>> csr_sddmm_variant(torch.zeros(3, 3), torch.zeros(5, 3))
    'scalar'
    """
    from .csr_spmv import aligned16, staged_fits

    k, itemsize = G.shape[1], G.element_size()
    if (plan is not None and aligned16(X) and aligned16(G)
            and (colind is None or aligned16(colind))
            and staged_fits(plan, k, itemsize, with_rows=True)):
        return "staged"
    if itemsize * k % 16 == 0 and aligned16(G) and aligned16(X):
        return "vector"
    if k == 1:
        return "rowwalk"
    return "scalar"


def csr_sddmm_plain(major, colind, G, X, nrows: int) -> torch.Tensor:
    """Plain torch SDDMM: the gathered rows multiplied and summed, in
    chunks of slots so that no temporary passes ``_CHUNK`` elements. 1-D
    ``G`` and ``X`` are the ``k = 1`` case. Padding slots give 0."""
    if G.ndim == 1:
        G, X = G[:, None], X[:, None]
    G_ext = torch.cat([G, G.new_zeros(1, G.shape[1])])
    step = max(1, _CHUNK // max(1, X.shape[1]))
    parts = [(G_ext[r] * X[c]).sum(1)
             for r, c in zip(major.split(step), colind.split(step))]
    if not parts:
        return G.new_zeros(0)
    return torch.cat(parts)


def csr_sddmm(rowptr, colind, G, X, nrows: int, *, major=None,
              variant=None) -> torch.Tensor:
    """``out[p] = Σ_c G[row_p, c]·X[colind[p], c]`` (0 for padding slots):
    the kernel on CUDA tensors, the plain version on CPU tensors. ``G``
    (``nrows`` or ``(nrows, k)``) and ``X`` (``ncols`` or ``(ncols, k)``)
    are promoted to the accumulation dtype and made contiguous; the result
    is in that dtype. ``major`` (the per-slot row ids, padding ``nrows``)
    is built from ``rowptr`` where a variant needs it and none is given.
    ``variant`` names a kernel variant instead of
    :func:`csr_sddmm_variant`'s choice; the kernel refuses operands it
    does not take (no fallback)."""
    acc = acc_dtype(G.dtype, X.dtype)
    G = G.to(acc).contiguous()
    X = X.to(acc).contiguous()
    operands = (rowptr, colind, G, X) + (() if major is None else (major,))
    devices = {t.device for t in operands}
    if len(devices) != 1:
        raise ValueError(f"csr_sddmm operands on several devices: {devices}")
    if rowptr.dtype != INDEX_DTYPE or colind.dtype != INDEX_DTYPE or (
            major is not None and major.dtype != INDEX_DTYPE):
        raise DTypeError(
            f"indices must be {INDEX_DTYPE}, got {rowptr.dtype} and "
            f"{colind.dtype}"
            + ("" if major is None else f" and {major.dtype}"))
    if (rowptr.ndim != 1 or rowptr.numel() != nrows + 1 or colind.ndim != 1
            or (major is not None and major.shape != colind.shape)
            or G.ndim != X.ndim or G.ndim not in (1, 2)
            or G.shape[0] != nrows or G.shape[1:] != X.shape[1:]):
        raise ShapeError(
            f"csr_sddmm shapes: rowptr {tuple(rowptr.shape)}, colind "
            f"{tuple(colind.shape)}, G {tuple(G.shape)}, X "
            f"{tuple(X.shape)}, nrows {nrows}"
            + ("" if major is None else f", major {tuple(major.shape)}"))
    if variant is not None and variant not in _VARIANT_CODE:
        raise ValueError(f"unknown csr_sddmm variant {variant!r}; the "
                         f"variants are {sorted(_VARIANT_CODE)}")
    nse = colind.numel()
    device = X.device
    if device.type == "cpu":
        if major is None:
            major = major_ids(rowptr, nse)
        return csr_sddmm_plain(major, colind, G, X, nrows)
    if device.type != "cuda":
        raise ValueError(f"no csr_sddmm kernel for device {device}")
    out = torch.empty(nse, dtype=acc, device=device)
    if G.ndim == 1:
        G, X = G[:, None], X[:, None]
    k = G.shape[1]
    if nse == 0:
        return out
    if k == 0 or nrows == 0:
        return out.zero_()   # no products; every slot of nrows == 0 is padding
    from ._build import launch
    from .csr_spmv import csr_spmv_plan, csr_tile_plan

    name, key = _ENTRY[acc]
    rowptr, colind = rowptr.contiguous(), colind.contiguous()
    tiles = None
    if variant in (None, "staged"):
        tiles = csr_tile_plan(rowptr, colind, SDDMM_TILE_ROWS)
    if variant is None:
        variant = csr_sddmm_variant(G, X, tiles, colind)
    plan, n_a, n_b, n_c = None, 0, 0, 0
    if variant == "staged":
        plan, n_a, n_b, n_c = (tiles.tiles, tiles.rows, tiles.max_window,
                               tiles.max_slots)
    elif variant == "rowwalk":
        spmv = csr_spmv_plan(rowptr)
        plan, n_a, n_b = spmv.plan, spmv.nwin, spmv.npieces
    elif major is None:
        major = major_ids(rowptr, nse)
    with torch.cuda.device(device):
        launch(name, None if major is None else major.contiguous().data_ptr(),
               rowptr.data_ptr(), colind.data_ptr(), G.data_ptr(),
               X.data_ptr(), out.data_ptr(), nse, nrows, k,
               _VARIANT_CODE[variant],
               None if plan is None else plan.data_ptr(), n_a, n_b, n_c,
               torch.cuda.current_stream(device).cuda_stream)
    LAUNCHES[key] += 1
    VARIANT_LAUNCHES[variant] += 1
    return out
