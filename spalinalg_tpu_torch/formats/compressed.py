"""Compressed sparse formats: CSR and CSC (counterpart of
``spalinalg_tpu/formats/compressed.py``; reference: `src/csr.rs`,
`src/csc.rs`).

Both are thin subclasses of one ``_CompressedMatrix`` parameterised by the
compression axis: CSR compresses the **row** (major) axis, CSC the
**column** axis.

- A compressed matrix holds three tensors on one device: ``ptr`` (int32,
  ``n_major + 1``), ``minor`` indices (int32, ``nse``) and ``values``
  (``nse``). It lives on the device it was built for; nothing here moves
  it, and ``A @ x`` with ``x`` elsewhere raises.
- Structure is immutable (as in the reference: no insert/remove on CSR/CSC,
  `csr.rs:20-23`); values are replaced functionally via
  :meth:`with_values` (the reference's ``values_mut``, `csr.rs:270-285`).
- ``nse`` (stored slots) may exceed the logical ``nnz = ptr[-1]``: slots
  at or past ``ptr[-1]`` exist in storage and contribute nothing. Matrices
  built by the validating constructor or from COO/DOK are exact.

Validation mirrors every constructor assert in `csr.rs:144-156` /
`csc.rs:144-156`, raising :class:`StructureError` host-side.
"""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..dtypes import INDEX_DTYPE, canonical_value_dtype, check_nse, numpy_dtype
from ..errors import ShapeError, StructureError

__all__ = ["CsrMatrix", "CscMatrix"]


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _values_tensor(values, device) -> torch.Tensor:
    """Values as a tensor of a supported dtype (non-float input becomes
    float64, as in the JAX package)."""
    if isinstance(values, torch.Tensor):
        dtype = values.dtype if values.is_floating_point() else torch.float64
        return values.to(device=device, dtype=canonical_value_dtype(dtype))
    v = np.asarray(values)
    dtype = canonical_value_dtype(v.dtype if v.dtype.kind == "f"
                                  else np.float64)
    return torch.as_tensor(_writable(v), device=device).to(dtype)


def _index_tensor(a, device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=INDEX_DTYPE).contiguous()
    return torch.as_tensor(_writable(np.asarray(a, dtype=np.int32)),
                           device=device)


def _writable(a: np.ndarray) -> np.ndarray:
    """A copy of a read-only array (e.g. a view of a JAX array), which
    torch cannot wrap; the array itself otherwise."""
    return a if a.flags.writeable else a.copy()


class _CompressedMatrix:
    """Shared implementation of CSR/CSC. ``_MAJOR_AXIS`` = 0 for CSR (rows
    compressed), 1 for CSC (columns compressed)."""

    _MAJOR_AXIS = 0  # overridden in CscMatrix

    __slots__ = ("_ptr", "_minor", "_values", "_nrows", "_ncols")

    def __init__(self, nrows: int, ncols: int, ptr, minor, values, *,
                 device=None):
        """Validating constructor (reference ``new``: `csr.rs:137-177`).

        All eight reference asserts are checked on host copies of the
        inputs; the tensors are then made on ``device`` (``None``: the
        default device, see ``spalinalg_tpu_torch/device.py``).
        """
        nrows, ncols = int(nrows), int(ncols)
        if nrows <= 0 or ncols <= 0:
            raise ShapeError(
                f"matrix dimensions must be positive, got {nrows}x{ncols} "
                "(reference: csr.rs:144-145)"
            )
        self._validate(nrows, ncols, _host(ptr), _host(minor), _host(values))
        device = resolve_device(device)
        self._nrows, self._ncols = nrows, ncols
        self._ptr = _index_tensor(ptr, device)
        self._minor = _index_tensor(minor, device)
        self._values = _values_tensor(values, device)

    @classmethod
    def _major_dim(cls, nrows: int, ncols: int) -> int:
        return nrows if cls._MAJOR_AXIS == 0 else ncols

    @classmethod
    def _minor_dim(cls, nrows: int, ncols: int) -> int:
        return ncols if cls._MAJOR_AXIS == 0 else nrows

    @classmethod
    def _validate(cls, nrows, ncols, ptr, minor, values):
        n_major = cls._major_dim(nrows, ncols)
        n_minor = cls._minor_dim(nrows, ncols)
        what = "rowptr" if cls._MAJOR_AXIS == 0 else "colptr"
        ind = "colind" if cls._MAJOR_AXIS == 0 else "rowind"
        if ptr.ndim != 1 or ptr.size != n_major + 1:
            raise StructureError(
                f"{what} length must be {n_major + 1}, got {ptr.size} "
                "(reference: csr.rs:146)"
            )
        if ptr.size and ptr[0] != 0:
            raise StructureError(
                f"{what}[0] must be 0, got {ptr[0]} (reference: csr.rs:147)"
            )
        nnz = int(ptr[-1])
        check_nse(nnz)
        if minor.ndim != 1 or minor.size != nnz:
            raise StructureError(
                f"{ind} length must equal {what}[-1] ({nnz}), got {minor.size} "
                "(reference: csr.rs:148)"
            )
        if values.ndim != 1 or values.size != nnz:
            raise StructureError(
                f"values length must equal {what}[-1] ({nnz}), got {values.size} "
                "(reference: csr.rs:149)"
            )
        if np.any(np.diff(ptr) < 0):
            raise StructureError(
                f"{what} must be monotonically non-decreasing "
                "(reference: csr.rs:150-151)"
            )
        if minor.size and (minor.min() < 0 or minor.max() >= n_minor):
            raise StructureError(
                f"{ind} entries must be in [0, {n_minor}) "
                "(reference: csr.rs:152-153)"
            )
        # Strictly increasing minor indices within each major slice
        # (reference: csr.rs:154-156).
        if minor.size:
            d = np.diff(minor.astype(np.int64))
            boundary = np.zeros(minor.size - 1, dtype=bool)
            inner_starts = ptr[1:-1]
            boundary[inner_starts[(inner_starts > 0) &
                                  (inner_starts < minor.size)] - 1] = True
            if np.any((d <= 0) & ~boundary):
                raise StructureError(
                    f"{ind} must be strictly increasing within each "
                    f"{'row' if cls._MAJOR_AXIS == 0 else 'column'} "
                    "(reference: csr.rs:154-156)"
                )

    @classmethod
    def _from_parts(cls, nrows, ncols, ptr, minor, values):
        """Trusted constructor: no validation, no dtype coercion. The three
        tensors must already share one device, with int32 indices."""
        obj = object.__new__(cls)
        obj._nrows, obj._ncols = int(nrows), int(ncols)
        obj._ptr, obj._minor, obj._values = ptr, minor, values
        return obj

    @classmethod
    def _from_host(cls, nrows, ncols, ptr, minor, values, device):
        """Trusted constructor from exact host arrays (the engine's output)
        onto ``device`` (``None``: the default device)."""
        check_nse(len(minor))
        device = resolve_device(device)
        return cls._from_parts(
            nrows, ncols,
            _index_tensor(ptr, device), _index_tensor(minor, device),
            _values_tensor(values, device))

    # ------------------------------------------------------------------
    # Constructors
    # ------------------------------------------------------------------

    @classmethod
    def eye(cls, size: int, *, dtype=torch.float64, device=None):
        """Identity matrix (reference ``eye``, csr.rs:179-198)."""
        dtype = canonical_value_dtype(dtype)
        device = resolve_device(device)
        ptr = torch.arange(size + 1, dtype=INDEX_DTYPE, device=device)
        minor = torch.arange(size, dtype=INDEX_DTYPE, device=device)
        values = torch.ones(size, dtype=dtype, device=device)
        return cls._from_parts(size, size, ptr, minor, values)

    @classmethod
    def from_dense(cls, dense, *, drop_zeros: bool = True, device=None):
        """Compress a dense 2-D NumPy array or tensor (exact zeros dropped
        by default) through the host engine, onto ``device`` (``None``:
        the default device).

        >>> from spalinalg_tpu_torch import CsrMatrix
        >>> a = CsrMatrix.from_dense([[0.0, 2.0], [3.0, 0.0]], device="cpu")
        >>> a.rowptr.tolist(), a.colind.tolist(), a.values.tolist()
        ([0, 1, 2], [1, 0], [2.0, 3.0])
        """
        from ..convert.engine import compress_host

        value_dtype = None
        if isinstance(dense, torch.Tensor):
            value_dtype = dense.dtype
            if value_dtype == torch.bfloat16:  # NumPy has no bfloat16
                dense = dense.float()
        d = _host(dense)
        if d.ndim != 2:
            raise ShapeError(f"dense input must be 2-D, got shape {d.shape}")
        rows, cols = (np.nonzero(d) if drop_zeros
                      else np.indices(d.shape).reshape(2, -1))
        vals = d[rows, cols]
        major, minor = (rows, cols) if cls._MAJOR_AXIS == 0 else (cols, rows)
        ptr, minor, values = compress_host(
            major, minor, vals, cls._major_dim(*d.shape), dedup=False,
            drop_zeros=False)
        out = cls._from_host(d.shape[0], d.shape[1], ptr, minor, values,
                             device)
        if value_dtype == torch.bfloat16:
            out = out.astype(torch.bfloat16)
        return out

    # ------------------------------------------------------------------
    # Accessors (csr.rs:200-301)
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
    def dtype(self) -> torch.dtype:
        return self._values.dtype

    @property
    def device(self) -> torch.device:
        return self._values.device

    @property
    def values(self) -> torch.Tensor:
        """Stored values (csr.rs:256-268). Length ``nse``; slots past
        ``nnz`` are padding."""
        return self._values

    @property
    def nse(self) -> int:
        """Number of stored-element slots (>= logical nnz)."""
        return int(self._minor.shape[0])

    @property
    def nnz(self) -> int:
        """Logical number of stored entries, ``ptr[-1]`` (csr.rs:287-301).
        Reads one value back from the device."""
        return int(self._ptr[-1])

    def nnz_device(self) -> torch.Tensor:
        """``ptr[-1]`` as a 0-d tensor on the matrix's device (no read
        back)."""
        return self._ptr[-1]

    def with_values(self, values: torch.Tensor) -> "_CompressedMatrix":
        """Same structure, new values (the reference's ``values_mut``,
        csr.rs:270-285). ``values`` must lie on the matrix's device."""
        if not isinstance(values, torch.Tensor):
            values = _values_tensor(values, self.device)
        if tuple(values.shape) != tuple(self._values.shape):
            raise ShapeError(
                f"values length must stay {self._values.shape[0]}, "
                f"got {tuple(values.shape)}"
            )
        if values.device != self.device:
            raise ValueError(
                f"values on {values.device}, matrix on {self.device}")
        canonical_value_dtype(values.dtype)
        return type(self)._from_parts(
            self._nrows, self._ncols, self._ptr, self._minor, values
        )

    def astype(self, dtype) -> "_CompressedMatrix":
        """Cast stored values to ``dtype`` (same structure); DTypeError
        outside the supported scalar set.

        >>> from spalinalg_tpu_torch import CsrMatrix
        >>> CsrMatrix.eye(2).astype("float32").dtype
        torch.float32
        """
        return self.with_values(self._values.to(canonical_value_dtype(dtype)))

    def map_values(self, fn) -> "_CompressedMatrix":
        """Apply ``fn`` elementwise to stored values (stand-in for
        ``iter_mut``, csr.rs:330-356, without its 0..ncols loop bug)."""
        return self.with_values(fn(self._values))

    # ------------------------------------------------------------------
    # Iteration (csr.rs:303-328) — host-side
    # ------------------------------------------------------------------

    def iter(self) -> Iterator[Tuple[int, int, float]]:
        """Yield ``(row, col, value)`` in major-sorted order (csr.rs:303-328)."""
        ptr = _host(self._ptr)
        minor = _host(self._minor)
        values = _host(self._values.float() if self.dtype == torch.bfloat16
                       else self._values)
        for maj in range(self._major_dim(self._nrows, self._ncols)):
            for k in range(int(ptr[maj]), int(ptr[maj + 1])):
                if self._MAJOR_AXIS == 0:
                    yield (maj, int(minor[k]), values[k].item())
                else:
                    yield (int(minor[k]), maj, values[k].item())

    __iter__ = iter

    # ------------------------------------------------------------------
    # Structure ops
    # ------------------------------------------------------------------

    def transpose(self):
        """Transpose on the matrix's device (replaces the reference's
        2-pass counting sort, csr.rs:358-406). CSR.T is a CSR of the
        transposed matrix (same class, like the reference). The transposed
        structure is cached per structure; values are gathered per call."""
        from ..ops.kernels.csr_spmv import transpose_plan

        n_major = self._major_dim(self._nrows, self._ncols)
        n_minor = self._minor_dim(self._nrows, self._ncols)
        t = transpose_plan(self._ptr, self._minor, n_major, n_minor)
        return type(self)._from_parts(self._ncols, self._nrows, t.ptr,
                                      t.minor, self._values[t.perm])

    @property
    def T(self):
        return self.transpose()

    # ------------------------------------------------------------------
    # Export helpers
    # ------------------------------------------------------------------

    def _coo_arrays_host(self):
        """Host ``(rows, cols, values)`` in major-sorted order, exact nnz."""
        from ..convert.engine import expand_ptr_host

        numpy_dtype(self.dtype)  # DTypeError for bfloat16
        ptr = _host(self._ptr).astype(np.int64)
        nnz = int(ptr[-1])
        major = expand_ptr_host(ptr)
        minor = _host(self._minor[:nnz]).astype(np.int64)
        values = _host(self._values[:nnz])
        if self._MAJOR_AXIS == 0:
            return major, minor, values
        return minor, major, values

    def to_dense(self) -> torch.Tensor:
        """Dense tensor on the matrix's device (padding contributes
        nothing)."""
        from ..convert.engine import major_ids

        n_major = self._major_dim(self._nrows, self._ncols)
        major = major_ids(self._ptr, self.nse)
        dense = torch.zeros(n_major + 1,
                            self._minor_dim(self._nrows, self._ncols),
                            dtype=self.dtype, device=self.device)
        dense.index_put_((major, self._minor), self._values,
                         accumulate=True)
        dense = dense[:n_major]
        return dense if self._MAJOR_AXIS == 0 else dense.T.contiguous()

    def __repr__(self) -> str:
        name = type(self).__name__
        return (f"{name}(shape={self.shape}, nnz={self.nnz}, nse={self.nse}, "
                f"dtype={self.dtype}, device={self.device})")

    # ------------------------------------------------------------------
    # Arithmetic operators (implementations in spalinalg_tpu_torch.ops)
    # ------------------------------------------------------------------

    def __add__(self, other):
        """Union sum with cancelled zeros kept (csr/ops/add.rs)."""
        from ..ops import elementwise

        if isinstance(other, type(self)):
            return elementwise.compressed_add(self, other, sign=+1)
        return NotImplemented

    def __sub__(self, other):
        """Union difference with cancelled zeros kept (csr/ops/sub.rs)."""
        from ..ops import elementwise

        if isinstance(other, type(self)):
            return elementwise.compressed_add(self, other, sign=-1)
        return NotImplemented

    def __neg__(self):
        """Copy structure, negate values (csr/ops/neg.rs:5-18)."""
        return self.with_values(-self._values)

    def __pow__(self, k):
        """Matrix power ``A**k`` by binary exponentiation over SpGEMM (each
        squaring's plan is cached by structure). ``A**0`` is the identity on
        the matrix's device and dtype (scipy semantics); needs a square
        matrix and integer ``k >= 0``.

        >>> from spalinalg_tpu_torch import CsrMatrix
        >>> a = CsrMatrix(2, 2, [0, 2, 3], [0, 1, 1], [1.0, 1.0, 2.0])
        >>> (a ** 3).to_dense().tolist()
        [[1.0, 7.0], [0.0, 8.0]]
        """
        if not isinstance(k, (int, np.integer)) or isinstance(k, bool):
            return NotImplemented
        if self._nrows != self._ncols:
            raise ShapeError(
                f"matrix power needs a square matrix, got {self.shape}")
        if k < 0:
            raise ValueError(f"matrix power needs k >= 0, got {k}")
        if k == 0:
            return type(self).eye(self._nrows, dtype=self.dtype,
                                  device=self.device)
        result = None
        base = self
        while k:
            if k & 1:
                result = base if result is None else result * base
            k >>= 1
            if k:
                base = base * base
        return result

    def __mul__(self, other):
        """SpGEMM for sparse*sparse (the reference's ``Mul``,
        csr/ops/mul.rs / csc/ops/mul.rs); scaling for a number or a 0-d
        tensor or array."""
        if isinstance(other, type(self)):
            from ..ops import spgemm

            return spgemm.spgemm(self, other)
        if isinstance(other, (np.ndarray, np.generic)) and other.ndim == 0:
            other = torch.as_tensor(other)
        if isinstance(other, (int, float)) or (
                isinstance(other, torch.Tensor) and other.ndim == 0):
            return self.with_values(self._values * other)
        return NotImplemented

    def __rmul__(self, other):
        if isinstance(other, (int, float)):
            return self.with_values(other * self._values)
        return NotImplemented

    def __matmul__(self, other):
        """``A @ x`` (SpMV) / ``A @ X`` (SpMM) for a dense tensor or NumPy
        array on the matrix's device; SpGEMM for a sparse matrix of the
        same format."""
        if isinstance(other, type(self)):
            from ..ops import spgemm

            return spgemm.spgemm(self, other)
        if isinstance(other, (torch.Tensor, np.ndarray)):
            from ..ops import matvec

            return matvec.matmul_dense(self, other)
        return NotImplemented


class CsrMatrix(_CompressedMatrix):
    """Compressed sparse row matrix (reference: `src/csr.rs:66-511`).

    Structure tensors: ``rowptr`` (nrows+1), ``colind`` (nse), ``values``
    (nse). Column indices are strictly increasing within each row.

    Examples
    --------
    The 4x4 example from the reference docs (`csr.rs:24-63`):

    >>> import torch
    >>> from spalinalg_tpu_torch import CsrMatrix
    >>> m = CsrMatrix(4, 4, [0, 2, 3, 5, 6], [0, 2, 1, 2, 3, 3],
    ...               [1.0, 2.0, 3.0, 4.0, 5.0, 6.0])
    >>> m.nnz
    6
    >>> list(m)[:2]
    [(0, 0, 1.0), (0, 2, 2.0)]
    >>> (m @ torch.ones(4, dtype=torch.float64)).tolist()
    [3.0, 3.0, 9.0, 6.0]
    >>> type(m.to_csc()).__name__
    'CscMatrix'
    """

    _MAJOR_AXIS = 0
    __slots__ = ()

    def __init__(self, nrows, ncols, rowptr, colind, values, *, device=None):
        super().__init__(nrows, ncols, rowptr, colind, values, device=device)

    @property
    def rowptr(self) -> torch.Tensor:
        """Row pointer array (csr.rs:228-240)."""
        return self._ptr

    @property
    def colind(self) -> torch.Tensor:
        """Column index array (csr.rs:242-254)."""
        return self._minor

    # ---- conversions (implementations in spalinalg_tpu_torch.convert) ----

    @classmethod
    def from_coo(cls, coo, *, device=None) -> "CsrMatrix":
        from ..convert import conversions

        return conversions.coo_to_csr(coo, device=device)

    @classmethod
    def from_dok(cls, dok, *, device=None) -> "CsrMatrix":
        from ..convert import conversions

        return conversions.dok_to_csr(dok, device=device)

    @classmethod
    def from_csc(cls, csc) -> "CsrMatrix":
        from ..convert import conversions

        return conversions.csc_to_csr(csc)

    def to_coo(self):
        from ..convert import conversions

        return conversions.csr_to_coo(self)

    def to_dok(self):
        from ..convert import conversions

        return conversions.csr_to_dok(self)

    def to_csc(self) -> "CscMatrix":
        from ..convert import conversions

        return conversions.csr_to_csc(self)

    def to_bsr(self, blocksize):
        """BSR of this matrix on its device (``BsrMatrix.from_csr``)."""
        from .bsr import BsrMatrix

        return BsrMatrix.from_csr(self, blocksize)


class CscMatrix(_CompressedMatrix):
    """Compressed sparse column matrix (reference: `src/csc.rs:66-511`).

    Structure tensors: ``colptr`` (ncols+1), ``rowind`` (nse), ``values``
    (nse). Row indices are strictly increasing within each column.
    """

    _MAJOR_AXIS = 1
    __slots__ = ()

    def __init__(self, nrows, ncols, colptr, rowind, values, *, device=None):
        super().__init__(nrows, ncols, colptr, rowind, values, device=device)

    @property
    def colptr(self) -> torch.Tensor:
        """Column pointer array (csc.rs:228-240)."""
        return self._ptr

    @property
    def rowind(self) -> torch.Tensor:
        """Row index array (csc.rs:242-254)."""
        return self._minor

    # ---- conversions ----

    @classmethod
    def from_coo(cls, coo, *, device=None) -> "CscMatrix":
        from ..convert import conversions

        return conversions.coo_to_csc(coo, device=device)

    @classmethod
    def from_dok(cls, dok, *, device=None) -> "CscMatrix":
        from ..convert import conversions

        return conversions.dok_to_csc(dok, device=device)

    @classmethod
    def from_csr(cls, csr) -> "CscMatrix":
        from ..convert import conversions

        return conversions.csr_to_csc(csr)

    def to_coo(self):
        from ..convert import conversions

        return conversions.csc_to_coo(self)

    def to_dok(self):
        from ..convert import conversions

        return conversions.csc_to_dok(self)

    def to_csr(self) -> "CsrMatrix":
        from ..convert import conversions

        return conversions.csc_to_csr(self)
