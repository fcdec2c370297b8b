"""Constructors ``diags`` and ``sprandom`` (counterpart of
``spalinalg_tpu/ops/construct.py``; `scipy.sparse`-style builders, absent
from the reference).

Both build on the host with NumPy and give CSR on ``device`` (``None``:
the default device, ``spalinalg_tpu_torch/device.py``). ``sprandom`` draws
from NumPy's generator, so one seed gives both packages the same matrix.

Examples
--------
>>> from spalinalg_tpu_torch.ops.construct import diags, sprandom
>>> L = diags([-1.0, 2.0, -1.0], offsets=[-1, 0, 1], shape=(4, 4),
...           device="cpu")
>>> L.to_dense().tolist()[1]
[-1.0, 2.0, -1.0, 0.0]
>>> r = sprandom(100, 80, density=0.05, seed=0, device="cpu")
>>> r.shape, r.nnz
((100, 80), 400)
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import numpy as np

from ..errors import ShapeError
from ..formats.dia import _diagonal_values
from .structure import _build_csr

__all__ = ["diags", "sprandom"]


def diags(diagonals, offsets: Union[int, Sequence[int]] = 0,
          shape: Optional[Tuple[int, int]] = None, *, dtype=np.float64,
          device=None):
    """CSR matrix from diagonals (as `scipy.sparse.diags`).

    ``diagonals``: one array per offset; a scalar broadcasts along its
    diagonal. Without ``shape``, the matrix is the smallest square that
    holds every diagonal.
    """
    if np.isscalar(offsets):
        offsets = [int(offsets)]
        diagonals = [diagonals]
    offsets = [int(o) for o in offsets]
    if len(diagonals) != len(offsets):
        raise ShapeError(
            f"{len(diagonals)} diagonals for {len(offsets)} offsets")
    diagonals = [np.atleast_1d(np.asarray(d, dtype=dtype))
                 for d in diagonals]

    if shape is None:
        n = max(len(d) + abs(o) if d.size > 1 else abs(o) + 1
                for d, o in zip(diagonals, offsets))
        shape = (n, n)
    nrows, ncols = shape
    if nrows <= 0 or ncols <= 0:
        raise ShapeError(f"matrix dimensions must be positive, got {shape}")

    rows_l, cols_l, vals_l = [], [], []
    for d, o in zip(diagonals, offsets):
        i0, values = _diagonal_values(d, o, nrows, ncols, dtype)
        rows = np.arange(i0, i0 + values.size, dtype=np.int64)
        rows_l.append(rows)
        cols_l.append(rows + o)
        vals_l.append(values)
    return _build_csr(nrows, ncols, np.concatenate(rows_l),
                      np.concatenate(cols_l), np.concatenate(vals_l),
                      device, dedup=True)


def sprandom(nrows: int, ncols: int, density: float = 0.01, *,
             seed: Optional[int] = None, rng=None, dtype=np.float64,
             values: str = "normal", device=None):
    """Random sparse CSR matrix (as `scipy.sparse.random`).

    Exactly ``round(density * nrows * ncols)`` distinct positions, sampled
    without replacement; ``values``: "normal" or "uniform".
    """
    if nrows <= 0 or ncols <= 0:
        raise ShapeError(
            f"matrix dimensions must be positive, got {nrows}x{ncols}")
    if not 0 <= density <= 1:
        raise ShapeError(f"density must be in [0, 1], got {density}")
    rng = rng if rng is not None else np.random.default_rng(seed)
    nnz = int(round(density * nrows * ncols))
    flat = rng.choice(nrows * ncols, size=nnz, replace=False)
    rows, cols = np.divmod(flat.astype(np.int64), ncols)
    if values == "normal":
        vals = rng.normal(size=nnz).astype(dtype)
    elif values == "uniform":
        vals = rng.random(size=nnz).astype(dtype)
    else:
        raise ValueError(f"values must be 'normal' or 'uniform', "
                         f"got {values!r}")
    return _build_csr(nrows, ncols, rows, cols, vals, device)
