"""Coordinate-format sparse matrix builder (counterpart of
``spalinalg_tpu/formats/coo.py``; reference: `src/coo.rs`).

COO is the *incremental construction* format. In the reference it is a
``Vec<(usize, usize, T)>`` with amortised push/pop (`coo.rs:53-57`,
`coo.rs:431-468`). Building is sequential host work, so ``CooMatrix`` keeps
growable **host** (NumPy) buffers, float32 or float64, and tensors are made
only when a compressed matrix is built from it, on the device the caller
names. No per-push host-to-device traffic happens.

Semantics preserved from the reference:
- duplicates allowed, insertion order preserved (`coo.rs:28-36`)
- zero-dim shapes rejected (`coo.rs:105-106`)
- out-of-range triplets rejected at push/construction (`coo.rs:434-435`)
- ``transpose`` swaps indices without sorting (`coo.rs:538-546`)
- ``+``/``-`` concatenate entries (duplicates kept, lazy;
  `coo.rs:751-791`), ``-x`` maps negation (`coo.rs:793-804`)
"""

from __future__ import annotations

from typing import Iterable, Iterator, Tuple

import numpy as np

from ..dtypes import numpy_dtype, result_dtype
from ..errors import IndexError_, ShapeError

__all__ = ["CooMatrix"]

_GROW = 2  # Vec-style amortised growth factor.


def _check_shape(nrows: int, ncols: int) -> None:
    if nrows <= 0 or ncols <= 0:
        raise ShapeError(
            f"matrix dimensions must be positive, got {nrows}x{ncols} "
            "(reference: coo.rs:105-106)"
        )


class CooMatrix:
    """Triplet-list sparse matrix (host builder).

    Mirrors the capability surface of ``spalinalg::CooMatrix``
    (`coo.rs:53-804`): incremental build with duplicates allowed and
    insertion order preserved.

    Examples
    --------
    Incremental build, then compress for compute (the canonical pipeline):

    >>> from spalinalg_tpu_torch import CooMatrix, CsrMatrix
    >>> coo = CooMatrix(2, 3)
    >>> coo.push(0, 0, 1.0)
    >>> coo.push(1, 2, 2.0)
    >>> coo.push(0, 0, 0.5)          # duplicates allowed
    >>> coo.length
    3
    >>> csr = CsrMatrix.from_coo(coo)   # duplicates summed here
    >>> csr.nnz
    2

    Vec-like mutation (`coo.rs:431-489`):

    >>> coo.pop()
    (0, 0, 0.5)
    >>> coo.clear(); coo.length
    0

    Concatenation arithmetic (`coo.rs:751-804`):

    >>> a = CooMatrix.with_entries(2, 2, [(0, 0, 1.0)])
    >>> b = CooMatrix.with_entries(2, 2, [(0, 0, 2.0)])
    >>> list(a + b)
    [(0, 0, 1.0), (0, 0, 2.0)]
    """

    __slots__ = ("_nrows", "_ncols", "_rows", "_cols", "_vals", "_len", "_dtype")

    def __init__(self, nrows: int, ncols: int, *, dtype=np.float64):
        # Reference `CooMatrix::new` (coo.rs:104-125): empty matrix, panics on
        # zero dims.
        _check_shape(nrows, ncols)
        self._nrows = int(nrows)
        self._ncols = int(ncols)
        self._dtype = numpy_dtype(dtype)
        self._rows = np.empty(0, dtype=np.int64)
        self._cols = np.empty(0, dtype=np.int64)
        self._vals = np.empty(0, dtype=self._dtype)
        self._len = 0

    # ------------------------------------------------------------------
    # Constructors (coo.rs:104-298)
    # ------------------------------------------------------------------

    @classmethod
    def new(cls, nrows: int, ncols: int, *, dtype=np.float64) -> "CooMatrix":
        """Alias of the constructor, mirroring ``CooMatrix::new`` (coo.rs:104)."""
        return cls(nrows, ncols, dtype=dtype)

    @classmethod
    def eye(cls, size: int, *, dtype=np.float64) -> "CooMatrix":
        """Identity matrix (reference ``eye``, coo.rs:127-160)."""
        out = cls(size, size, dtype=dtype)
        idx = np.arange(size, dtype=np.int64)
        out._rows = idx.copy()
        out._cols = idx
        out._vals = np.ones(size, dtype=out._dtype)
        out._len = size
        return out

    @classmethod
    def with_capacity(
        cls, nrows: int, ncols: int, capacity: int, *, dtype=np.float64
    ) -> "CooMatrix":
        """Empty matrix with pre-allocated capacity (coo.rs:162-202)."""
        out = cls(nrows, ncols, dtype=dtype)
        cap = int(capacity)
        out._rows = np.empty(cap, dtype=np.int64)
        out._cols = np.empty(cap, dtype=np.int64)
        out._vals = np.empty(cap, dtype=out._dtype)
        out._len = 0
        return out

    @classmethod
    def with_entries(
        cls,
        nrows: int,
        ncols: int,
        entries: Iterable[Tuple[int, int, float]],
        *,
        dtype=np.float64,
    ) -> "CooMatrix":
        """Build from an iterable of ``(row, col, value)`` (coo.rs:204-252).

        Rejects out-of-range indices like the reference.
        """
        out = cls(nrows, ncols, dtype=dtype)
        entries = list(entries)
        if entries:
            rows = np.asarray([e[0] for e in entries], dtype=np.int64)
            cols = np.asarray([e[1] for e in entries], dtype=np.int64)
            vals = np.asarray([e[2] for e in entries], dtype=out._dtype)
            out._bulk_append(rows, cols, vals)
        return out

    @classmethod
    def with_triplets(
        cls, nrows: int, ncols: int, rows, cols, values, *, dtype=None
    ) -> "CooMatrix":
        """Build from parallel row/col/value sequences (coo.rs:254-298).

        Panics in the reference when the three sequences have different
        lengths or indices are out of range; we raise accordingly.
        """
        rows = np.asarray(rows, dtype=np.int64).ravel()
        cols = np.asarray(cols, dtype=np.int64).ravel()
        values = np.asarray(values).ravel()
        if dtype is None:
            dtype = values.dtype if values.dtype.kind == "f" else np.float64
        out = cls(nrows, ncols, dtype=dtype)
        if not (len(rows) == len(cols) == len(values)):
            raise ShapeError(
                f"triplet length mismatch: {len(rows)} rows, {len(cols)} cols, "
                f"{len(values)} values (reference: coo.rs:254-298)"
            )
        out._bulk_append(rows, cols, values.astype(out._dtype, copy=False))
        return out

    def _bulk_append(self, rows: np.ndarray, cols: np.ndarray, vals: np.ndarray):
        if rows.size:
            if rows.min(initial=0) < 0 or rows.max(initial=0) >= self._nrows:
                raise IndexError_(
                    f"row index out of range for {self._nrows}x{self._ncols} "
                    "matrix (reference: coo.rs:434)"
                )
            if cols.min(initial=0) < 0 or cols.max(initial=0) >= self._ncols:
                raise IndexError_(
                    f"column index out of range for {self._nrows}x{self._ncols} "
                    "matrix (reference: coo.rs:435)"
                )
        n = self._len
        self._reserve(n + rows.size)
        self._rows[n : n + rows.size] = rows
        self._cols[n : n + cols.size] = cols
        self._vals[n : n + vals.size] = vals
        self._len = n + rows.size

    def _reserve(self, needed: int) -> None:
        cap = self._rows.size
        if needed <= cap:
            return
        new_cap = max(needed, max(4, cap * _GROW))
        for name in ("_rows", "_cols", "_vals"):
            buf = getattr(self, name)
            grown = np.empty(new_cap, dtype=buf.dtype)
            grown[: self._len] = buf[: self._len]
            setattr(self, name, grown)

    # ------------------------------------------------------------------
    # Accessors (coo.rs:300-428)
    # ------------------------------------------------------------------

    @property
    def nrows(self) -> int:
        return self._nrows

    @property
    def ncols(self) -> int:
        return self._ncols

    @property
    def shape(self) -> Tuple[int, int]:
        return (self._nrows, self._ncols)

    @property
    def dtype(self) -> np.dtype:
        return self._dtype

    @property
    def length(self) -> int:
        """Number of stored triplets, duplicates included (coo.rs:349-364)."""
        return self._len

    @property
    def nnz(self) -> int:
        """Alias of :attr:`length` (stored-entry count; duplicates included)."""
        return self._len

    @property
    def capacity(self) -> int:
        """Allocated triplet capacity (coo.rs:366-384)."""
        return self._rows.size

    def get(self, index: int):
        """Triplet at ``index`` or ``None`` (reference ``get``, coo.rs:386-406)."""
        if not 0 <= index < self._len:
            return None
        return (
            int(self._rows[index]),
            int(self._cols[index]),
            float(self._vals[index]),
        )

    def set_value(self, index: int, value) -> None:
        """Overwrite the value of the triplet at ``index``.

        Functional stand-in for the reference's ``get_mut`` returning a
        mutable value reference (coo.rs:408-429).
        """
        if not 0 <= index < self._len:
            raise IndexError_(f"triplet index {index} out of range (len {self._len})")
        self._vals[index] = value

    # ------------------------------------------------------------------
    # Mutation (coo.rs:431-489)
    # ------------------------------------------------------------------

    def push(self, row: int, col: int, value) -> None:
        """Append a triplet (reference ``push``, coo.rs:431-448)."""
        if not 0 <= row < self._nrows:
            raise IndexError_(
                f"row index {row} out of range for {self._nrows}x{self._ncols} "
                "matrix (reference: coo.rs:434)"
            )
        if not 0 <= col < self._ncols:
            raise IndexError_(
                f"column index {col} out of range for {self._nrows}x{self._ncols} "
                "matrix (reference: coo.rs:435)"
            )
        n = self._len
        self._reserve(n + 1)
        self._rows[n] = row
        self._cols[n] = col
        self._vals[n] = value
        self._len = n + 1

    def pop(self):
        """Remove and return the last triplet, or ``None`` (coo.rs:450-468)."""
        if self._len == 0:
            return None
        self._len -= 1
        i = self._len
        return (
            int(self._rows[i]),
            int(self._cols[i]),
            float(self._vals[i]),
        )

    def clear(self) -> None:
        """Remove all triplets, keep capacity (coo.rs:470-489)."""
        self._len = 0

    def extend(self, entries: Iterable[Tuple[int, int, float]]) -> None:
        """Append triplets from an iterable (``Extend`` impl, coo.rs:548-574).

        Bulk path: the iterable is materialised and appended in one
        vectorised step. Divergence from per-entry ``push``: on an
        out-of-range index nothing is appended (all-or-nothing) instead
        of stopping mid-stream.
        """
        if isinstance(entries, CooMatrix):
            rows, cols, vals = entries.to_arrays()
        else:
            ent = list(entries)
            if not ent:
                return
            arr = np.asarray(ent, dtype=object) if len(ent[0]) != 3 else None
            if arr is not None:
                raise ShapeError("extend expects (row, col, value) triplets")
            rows = np.fromiter((e[0] for e in ent), dtype=np.int64, count=len(ent))
            cols = np.fromiter((e[1] for e in ent), dtype=np.int64, count=len(ent))
            vals = np.fromiter(
                (e[2] for e in ent), dtype=self._dtype, count=len(ent))
        self._bulk_append(rows, cols, vals.astype(self._dtype, copy=False))

    # ------------------------------------------------------------------
    # Iteration (coo.rs:491-536, 576-627)
    # ------------------------------------------------------------------

    def iter(self) -> Iterator[Tuple[int, int, float]]:
        """Iterate stored triplets in insertion order (coo.rs:491-512)."""
        for i in range(self._len):
            yield (
                int(self._rows[i]),
                int(self._cols[i]),
                float(self._vals[i]),
            )

    __iter__ = iter

    def map_values(self, fn) -> "CooMatrix":
        """Apply ``fn`` to every stored value, returning a new matrix.

        Functional stand-in for ``iter_mut`` (coo.rs:514-536).
        """
        out = self.copy()
        out._vals[: out._len] = np.asarray(
            [fn(v) for v in out._vals[: out._len]], dtype=out._dtype
        )
        return out

    # ------------------------------------------------------------------
    # Structure ops
    # ------------------------------------------------------------------

    def transpose(self) -> "CooMatrix":
        """Swap row/column indices; entry order unchanged (coo.rs:538-546)."""
        out = CooMatrix(self._ncols, self._nrows, dtype=self._dtype)
        out._rows = self._cols[: self._len].copy()
        out._cols = self._rows[: self._len].copy()
        out._vals = self._vals[: self._len].copy()
        out._len = self._len
        return out

    @property
    def T(self) -> "CooMatrix":
        return self.transpose()

    def copy(self) -> "CooMatrix":
        out = CooMatrix(self._nrows, self._ncols, dtype=self._dtype)
        out._rows = self._rows[: self._len].copy()
        out._cols = self._cols[: self._len].copy()
        out._vals = self._vals[: self._len].copy()
        out._len = self._len
        return out

    # ------------------------------------------------------------------
    # Arithmetic (coo.rs:751-804): concatenation semantics
    # ------------------------------------------------------------------

    def _check_same_shape(self, other: "CooMatrix") -> None:
        if self.shape != other.shape:
            raise ShapeError(
                f"shape mismatch {self.shape} vs {other.shape} "
                "(reference: coo.rs:760-761)"
            )

    def __add__(self, other: "CooMatrix") -> "CooMatrix":
        """Entry concatenation — duplicates kept, lazy (coo.rs:751-770)."""
        if not isinstance(other, CooMatrix):
            return NotImplemented
        self._check_same_shape(other)
        dt = numpy_dtype(result_dtype(self._dtype, other._dtype))
        out = CooMatrix(self._nrows, self._ncols, dtype=dt)
        out._rows = np.concatenate([self._rows[: self._len], other._rows[: other._len]])
        out._cols = np.concatenate([self._cols[: self._len], other._cols[: other._len]])
        out._vals = np.concatenate(
            [self._vals[: self._len], other._vals[: other._len]]
        ).astype(dt, copy=False)
        out._len = self._len + other._len
        return out

    def __sub__(self, other: "CooMatrix") -> "CooMatrix":
        """Concatenation with negated rhs (coo.rs:772-791)."""
        if not isinstance(other, CooMatrix):
            return NotImplemented
        self._check_same_shape(other)
        return self + (-other)

    def __neg__(self) -> "CooMatrix":
        """Negate every stored value (coo.rs:793-804)."""
        out = self.copy()
        out._vals[: out._len] = -out._vals[: out._len]
        return out

    # ------------------------------------------------------------------
    # Export
    # ------------------------------------------------------------------

    def to_arrays(self):
        """Return ``(rows, cols, values)`` host arrays of length :attr:`length`."""
        return (
            self._rows[: self._len].copy(),
            self._cols[: self._len].copy(),
            self._vals[: self._len].copy(),
        )

    def to_dense(self) -> np.ndarray:
        """Dense host array with duplicate entries summed."""
        out = np.zeros(self.shape, dtype=self._dtype)
        np.add.at(out, (self._rows[: self._len], self._cols[: self._len]),
                  self._vals[: self._len])
        return out

    def __repr__(self) -> str:
        return (
            f"CooMatrix(shape={self.shape}, length={self._len}, "
            f"dtype={self._dtype.name})"
        )

    def __eq__(self, other) -> bool:
        if not isinstance(other, CooMatrix):
            return NotImplemented
        return (
            self.shape == other.shape
            and self._len == other._len
            and bool(np.array_equal(self._rows[: self._len], other._rows[: other._len]))
            and bool(np.array_equal(self._cols[: self._len], other._cols[: other._len]))
            and bool(np.array_equal(self._vals[: self._len], other._vals[: other._len]))
        )
