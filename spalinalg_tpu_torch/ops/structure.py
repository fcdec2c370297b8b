"""Structural composition: ``kron``, ``hstack``, ``vstack``, ``block_diag``,
``bmat``, ``tril``, ``triu`` (counterpart of
``spalinalg_tpu/ops/structure.py``; the `scipy.sparse` construction
toolkit, absent from the reference).

All are index arithmetic on host COO views followed by one pass through
``compress_host``: vectorised NumPy, no Python loop per entry. Outputs are
CSR, on the device of the first operand that has one, else on the default
device (``spalinalg_tpu_torch/device.py``).

Examples
--------
>>> from spalinalg_tpu_torch import CsrMatrix, default_device
>>> from spalinalg_tpu_torch.ops.structure import block_diag, hstack, kron, vstack
>>> with default_device("cpu"):
...     a = CsrMatrix.eye(2)
...     b = CsrMatrix(1, 2, [0, 2], [0, 1], [3.0, 4.0])
>>> vstack([a, b]).shape
(3, 2)
>>> hstack([a, a]).shape
(2, 4)
>>> block_diag([a, b]).shape
(3, 4)
>>> k = kron(a, b)                    # I_2 (x) b
>>> k.shape, k.nnz
((2, 4), 4)
>>> k.to_dense()[0].tolist()
[3.0, 4.0, 0.0, 0.0]
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from ..errors import ShapeError

__all__ = ["kron", "hstack", "vstack", "block_diag", "bmat", "tril", "triu"]


def _coo_view(mat):
    """``(rows, cols, vals)`` int64 / NumPy view of the true entries of a
    CSR, CSC, BSR, COO or DOK matrix; ``ShapeError`` for anything else
    (``DiaMatrix`` included, as in the JAX package)."""
    from ..formats.bsr import BsrMatrix
    from ..formats.compressed import CscMatrix, CsrMatrix
    from ..formats.coo import CooMatrix
    from ..formats.dok import DokMatrix

    if isinstance(mat, BsrMatrix):
        mat = mat.to_csr()
    if isinstance(mat, (CsrMatrix, CscMatrix)):
        r, c, v = mat._coo_arrays_host()
    elif isinstance(mat, (CooMatrix, DokMatrix)):
        r, c, v = mat.to_arrays()
    else:
        raise ShapeError(f"unsupported operand {type(mat).__name__}")
    return (np.asarray(r, dtype=np.int64), np.asarray(c, dtype=np.int64),
            np.asarray(v))


def _device_of(mats):
    """The device of the first operand that lives on one (host builders
    do not), else ``None``: the default device."""
    for m in mats:
        dev = getattr(m, "device", None)
        if dev is not None:
            return dev
    return None


def _build_csr(nrows, ncols, rows, cols, vals, device, *, dedup=False):
    from ..convert.engine import compress_host
    from ..formats.compressed import CsrMatrix

    ptr, minor, values = compress_host(
        rows, cols, vals, nrows, dedup=dedup, drop_zeros=False)
    return CsrMatrix._from_host(nrows, ncols, ptr, minor, values, device)


def kron(a, b):
    """Kronecker product ``a ⊗ b`` (CSR output), as `scipy.sparse.kron`.

    nnz = nnz_a · nnz_b; the index arithmetic is an outer sum of scaled
    indices.
    """
    ar, ac, av = _coo_view(a)
    br, bc, bv = _coo_view(b)
    am, an = a.shape
    bm, bn = b.shape
    rows = (ar[:, None] * bm + br[None, :]).ravel()
    cols = (ac[:, None] * bn + bc[None, :]).ravel()
    vals = (av[:, None] * bv[None, :]).ravel()
    # duplicate (row, col) pairs arise only from COO duplicates in a or b;
    # summing them keeps scipy's semantics
    return _build_csr(am * bm, an * bn, rows, cols, vals, _device_of((a, b)),
                      dedup=True)


def vstack(mats: Sequence):
    """Stack matrices vertically (matching column counts)."""
    mats = list(mats)
    if not mats:
        raise ShapeError("vstack needs at least one matrix")
    ncols = mats[0].shape[1]
    rows_l, cols_l, vals_l = [], [], []
    off = 0
    for m in mats:
        if m.shape[1] != ncols:
            raise ShapeError(
                f"vstack column mismatch: {m.shape[1]} != {ncols}")
        r, c, v = _coo_view(m)
        rows_l.append(r + off)
        cols_l.append(c)
        vals_l.append(v)
        off += m.shape[0]
    return _build_csr(off, ncols, np.concatenate(rows_l),
                      np.concatenate(cols_l), np.concatenate(vals_l),
                      _device_of(mats))


def hstack(mats: Sequence):
    """Stack matrices horizontally (matching row counts)."""
    mats = list(mats)
    if not mats:
        raise ShapeError("hstack needs at least one matrix")
    nrows = mats[0].shape[0]
    rows_l, cols_l, vals_l = [], [], []
    off = 0
    for m in mats:
        if m.shape[0] != nrows:
            raise ShapeError(
                f"hstack row mismatch: {m.shape[0]} != {nrows}")
        r, c, v = _coo_view(m)
        rows_l.append(r)
        cols_l.append(c + off)
        vals_l.append(v)
        off += m.shape[1]
    return _build_csr(nrows, off, np.concatenate(rows_l),
                      np.concatenate(cols_l), np.concatenate(vals_l),
                      _device_of(mats))


def block_diag(mats: Sequence):
    """Block-diagonal composition."""
    mats = list(mats)
    if not mats:
        raise ShapeError("block_diag needs at least one matrix")
    rows_l, cols_l, vals_l = [], [], []
    roff = coff = 0
    for m in mats:
        r, c, v = _coo_view(m)
        rows_l.append(r + roff)
        cols_l.append(c + coff)
        vals_l.append(v)
        roff += m.shape[0]
        coff += m.shape[1]
    return _build_csr(roff, coff, np.concatenate(rows_l),
                      np.concatenate(cols_l), np.concatenate(vals_l),
                      _device_of(mats))


def bmat(blocks):
    """Assemble from a 2-D grid of blocks (``None`` = zero block).

    Row heights and column widths are inferred from the present blocks;
    every position must be resolvable (as `scipy.sparse.bmat`).
    """
    grid = [list(row) for row in blocks]
    if not grid or not grid[0]:
        raise ShapeError("bmat needs a non-empty 2-D grid")
    R, C = len(grid), len(grid[0])
    if any(len(row) != C for row in grid):
        raise ShapeError("bmat rows must have equal length")

    heights = [None] * R
    widths = [None] * C
    for i in range(R):
        for j in range(C):
            m = grid[i][j]
            if m is None:
                continue
            h, w = m.shape
            if heights[i] is None:
                heights[i] = h
            elif heights[i] != h:
                raise ShapeError(
                    f"bmat block ({i},{j}) height {h} != {heights[i]}")
            if widths[j] is None:
                widths[j] = w
            elif widths[j] != w:
                raise ShapeError(
                    f"bmat block ({i},{j}) width {w} != {widths[j]}")
    if any(h is None for h in heights) or any(w is None for w in widths):
        raise ShapeError("bmat has an all-None row or column")

    rowoff = np.concatenate([[0], np.cumsum(heights)])
    coloff = np.concatenate([[0], np.cumsum(widths)])
    rows_l, cols_l, vals_l = [], [], []
    present = [m for row in grid for m in row if m is not None]
    for i in range(R):
        for j in range(C):
            m = grid[i][j]
            if m is None:
                continue
            r, c, v = _coo_view(m)
            rows_l.append(r + rowoff[i])
            cols_l.append(c + coloff[j])
            vals_l.append(v)
    return _build_csr(int(rowoff[-1]), int(coloff[-1]),
                      np.concatenate(rows_l), np.concatenate(cols_l),
                      np.concatenate(vals_l), _device_of(present))


def tril(mat, k: int = 0):
    """Lower triangle: entries with ``col <= row + k`` (CSR output), as
    `scipy.sparse.tril`. COO duplicate triplets are summed so that the CSR
    invariants hold.

    >>> from spalinalg_tpu_torch import CsrMatrix
    >>> a = CsrMatrix(2, 2, [0, 2, 4], [0, 1, 0, 1], [1., 2., 3., 4.],
    ...               device="cpu")
    >>> tril(a).to_dense().tolist()
    [[1.0, 0.0], [3.0, 4.0]]
    >>> tril(a, k=-1).to_dense().tolist()
    [[0.0, 0.0], [3.0, 0.0]]
    """
    r, c, v = _coo_view(mat)
    keep = c <= r + int(k)
    return _build_csr(mat.shape[0], mat.shape[1], r[keep], c[keep], v[keep],
                      _device_of((mat,)), dedup=True)


def triu(mat, k: int = 0):
    """Upper triangle: entries with ``col >= row + k`` (CSR output); see
    :func:`tril`.

    >>> from spalinalg_tpu_torch import CsrMatrix
    >>> a = CsrMatrix(2, 2, [0, 2, 4], [0, 1, 0, 1], [1., 2., 3., 4.],
    ...               device="cpu")
    >>> triu(a, k=1).to_dense().tolist()
    [[0.0, 2.0], [0.0, 0.0]]
    """
    r, c, v = _coo_view(mat)
    keep = c >= r + int(k)
    return _build_csr(mat.shape[0], mat.shape[1], r[keep], c[keep], v[keep],
                      _device_of((mat,)), dedup=True)
