"""BSR: block-sparse-row format (counterpart of
``spalinalg_tpu/formats/bsr.py``; absent from the reference).

Nonzero structure is tracked at the granularity of dense ``(br, bc)``
blocks, the natural format for banded and stencil operators and for
systems with several unknowns per node.

Layout, three tensors on one device:

- ``indptr``  (n_block_rows + 1,) int32: block-row pointer;
- ``indices`` (n_blocks,) int32: block column of each block;
- ``data``    (n_blocks, br, bc): the dense blocks, row-major.

Matrix dimensions must be divisible by the block size. Blocks at or past
``indptr[-1]`` are padding: they exist in storage and contribute nothing.
``data`` may be float32, float64 or bfloat16 (``astype``, a cast on the
device: NumPy has no bfloat16); bfloat16 blocks accumulate and return
float32 in products.

Examples
--------
>>> import torch
>>> from spalinalg_tpu_torch import BsrMatrix, CsrMatrix
>>> csr = CsrMatrix(4, 4, [0, 2, 4, 6, 8],
...                 [0, 1, 0, 1, 2, 3, 2, 3],
...                 [1., 2., 3., 4., 5., 6., 7., 8.])
>>> bsr = csr.to_bsr(2)
>>> bsr.n_blocks
2
>>> bsr.blocksize
(2, 2)
>>> (bsr @ torch.ones(4, dtype=torch.float64)).tolist()
[3.0, 7.0, 11.0, 15.0]
>>> eye = BsrMatrix.eye(4, blocksize=2)
>>> (eye @ torch.arange(4.0, dtype=torch.float64)).tolist()
[0.0, 1.0, 2.0, 3.0]
>>> (bsr.astype(torch.bfloat16) @ torch.ones(4)).dtype
torch.float32
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..dtypes import INDEX_DTYPE, canonical_value_dtype, result_dtype
from ..errors import ShapeError, StructureError
from .compressed import _host, _index_tensor, _values_tensor

__all__ = ["BsrMatrix"]


def _blocksize(blocksize) -> Tuple[int, int]:
    br, bc = (blocksize, blocksize) if np.isscalar(blocksize) else blocksize
    return int(br), int(bc)


class BsrMatrix:
    """Block-sparse-row matrix on one device."""

    __slots__ = ("_indptr", "_indices", "_data", "_nrows", "_ncols", "_br",
                 "_bc")

    def __init__(self, nrows, ncols, blocksize, indptr, indices, data, *,
                 device=None):
        """Validating constructor (``spalinalg_tpu/formats/bsr.py:58-93``):
        the same checks, raising the same errors, on host copies of
        ``indptr`` and ``indices`` and on the shape of ``data``, which is
        not copied to the host. ``blocksize`` is a scalar or ``(br, bc)``;
        ``device`` ``None`` is the default device (``device.py``).
        """
        nrows, ncols = int(nrows), int(ncols)
        br, bc = _blocksize(blocksize)
        if nrows <= 0 or ncols <= 0:
            raise ShapeError(
                f"matrix dimensions must be positive, got {nrows}x{ncols}")
        if nrows % br or ncols % bc:
            raise ShapeError(
                f"shape {nrows}x{ncols} not divisible by block size {br}x{bc}")
        ip, ix = _host(indptr), _host(indices)
        shape = (tuple(data.shape) if isinstance(data, torch.Tensor)
                 else np.shape(data))
        if ip.size != nrows // br + 1 or ip[0] != 0:
            raise StructureError(
                f"indptr must have length {nrows // br + 1} and start at 0")
        if np.any(np.diff(ip) < 0):
            raise StructureError("indptr must be monotonically non-decreasing")
        if ix.size and (ix.min() < 0 or ix.max() >= ncols // bc):
            raise StructureError(
                f"block column indices must be in [0, {ncols // bc})")
        if shape != (ix.size, br, bc):
            raise StructureError(
                f"data must have shape {(ix.size, br, bc)}, got {shape}")
        device = resolve_device(device)
        self._nrows, self._ncols, self._br, self._bc = nrows, ncols, br, bc
        self._indptr = _index_tensor(indptr, device)
        self._indices = _index_tensor(indices, device)
        self._data = _values_tensor(data, device).contiguous()

    @classmethod
    def _from_parts(cls, nrows, ncols, br, bc, indptr, indices, data):
        """Trusted constructor: no validation, no dtype coercion. The three
        tensors must already share one device, with int32 indices."""
        obj = object.__new__(cls)
        obj._nrows, obj._ncols = int(nrows), int(ncols)
        obj._br, obj._bc = int(br), int(bc)
        obj._indptr, obj._indices, obj._data = indptr, indices, data
        return obj

    # ---- accessors ----

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
    def blocksize(self) -> Tuple[int, int]:
        return (self._br, self._bc)

    @property
    def indptr(self) -> torch.Tensor:
        return self._indptr

    @property
    def indices(self) -> torch.Tensor:
        return self._indices

    @property
    def data(self) -> torch.Tensor:
        return self._data

    @property
    def dtype(self) -> torch.dtype:
        return self._data.dtype

    @property
    def device(self) -> torch.device:
        return self._data.device

    @property
    def n_blocks(self) -> int:
        return int(self._indices.shape[0])

    @property
    def nnz(self) -> int:
        """Stored scalar entries (block granularity: n_blocks * br * bc)."""
        return self.n_blocks * self._br * self._bc

    # ---- construction ----

    @classmethod
    def eye(cls, size: int, blocksize: int = 8, *, dtype=torch.float64,
            device=None) -> "BsrMatrix":
        """Identity of ``size`` rows in square blocks (``bsr.py:163``)."""
        if size % blocksize:
            raise ShapeError(
                f"size {size} not divisible by blocksize {blocksize}")
        nb = size // blocksize
        device = resolve_device(device)
        indptr = torch.arange(nb + 1, dtype=INDEX_DTYPE, device=device)
        indices = torch.arange(nb, dtype=INDEX_DTYPE, device=device)
        data = torch.eye(blocksize, dtype=canonical_value_dtype(dtype),
                         device=device).expand(nb, blocksize, blocksize)
        return cls._from_parts(size, size, blocksize, blocksize, indptr,
                               indices, data.contiguous())

    @classmethod
    def from_csr(cls, csr, blocksize) -> "BsrMatrix":
        """CSR -> BSR on the host (structure work, once), onto the CSR
        matrix's device. Blocks within a block row are in column order,
        as in the JAX package."""
        br, bc = _blocksize(blocksize)
        if csr.nrows % br or csr.ncols % bc:
            raise ShapeError(
                f"shape {csr.shape} not divisible by block size {br}x{bc}")
        rows, cols, vals = csr._coo_arrays_host()
        brow, bcol = rows // br, cols // bc
        key = brow * (csr.ncols // bc) + bcol
        uniq = np.unique(key)  # sorted: block rows, then block columns
        block_of = np.searchsorted(uniq, key)  # block slot per entry
        data = np.zeros((uniq.size, br, bc), dtype=np.asarray(vals).dtype)
        data[block_of, rows % br, cols % bc] = vals
        ub_row = (uniq // (csr.ncols // bc)).astype(np.int64)
        ub_col = (uniq % (csr.ncols // bc)).astype(np.int64)
        indptr = np.zeros(csr.nrows // br + 1, dtype=np.int64)
        np.add.at(indptr, ub_row + 1, 1)
        np.cumsum(indptr, out=indptr)
        device = csr.device
        return cls._from_parts(
            csr.nrows, csr.ncols, br, bc, _index_tensor(indptr, device),
            _index_tensor(ub_col, device), torch.from_numpy(data).to(device))

    def to_csr(self):
        """BSR -> CSR on the host. Stored zeros inside blocks stay stored;
        only absent blocks are absent. bfloat16 blocks cross the host as
        float32 and the CSR values are cast back on the device (exact)."""
        from .compressed import CsrMatrix
        from ..convert.engine import compress_host

        ip = _host(self._indptr).astype(np.int64)
        ix = _host(self._indices).astype(np.int64)
        bf16 = self.dtype == torch.bfloat16
        dat = _host(self._data.float() if bf16 else self._data)
        br, bc = self._br, self._bc
        n_blocks = ix.size
        brow = np.repeat(np.arange(ip.size - 1, dtype=np.int64), np.diff(ip))
        rr = (brow[:, None, None] * br
              + np.arange(br, dtype=np.int64)[None, :, None])
        cc = (ix[:, None, None] * bc
              + np.arange(bc, dtype=np.int64)[None, None, :])
        rows = np.broadcast_to(rr, (n_blocks, br, bc)).ravel()
        cols = np.broadcast_to(cc, (n_blocks, br, bc)).ravel()
        ptr, minor, values = compress_host(
            rows, cols, dat.ravel(), self._nrows, dedup=False,
            drop_zeros=False)
        out = CsrMatrix._from_host(self._nrows, self._ncols, ptr, minor,
                                   values, self.device)
        return out.astype(torch.bfloat16) if bf16 else out

    def to_dense(self) -> torch.Tensor:
        """Dense tensor on the matrix's device; padding blocks (at or past
        ``indptr[-1]``) contribute nothing."""
        from ..convert.engine import major_ids

        nbr = self._nrows // self._br
        nbc = self._ncols // self._bc
        brow = major_ids(self._indptr, self.n_blocks)  # padding -> nbr
        dense = torch.zeros((nbr + 1, nbc, self._br, self._bc),
                            dtype=self.dtype, device=self.device)
        dense.index_put_((brow.long(), self._indices.long()), self._data,
                         accumulate=True)
        return dense[:nbr].permute(0, 2, 1, 3).reshape(self._nrows,
                                                        self._ncols)

    # ---- compute ----

    def __matmul__(self, other):
        """``A @ x`` (SpMV, 1-D) or ``A @ X`` (SpMM, 2-D) for a dense
        tensor or NumPy array on the matrix's device."""
        if isinstance(other, (torch.Tensor, np.ndarray)):
            from ..ops import bsr_ops

            if other.ndim == 1:
                return bsr_ops.bsr_matvec(self, other)
            if other.ndim == 2:
                return bsr_ops.bsr_matmat(self, other)
        return NotImplemented

    def with_data(self, data: torch.Tensor) -> "BsrMatrix":
        """Same structure, new blocks on the matrix's device."""
        if tuple(data.shape) != tuple(self._data.shape):
            raise ShapeError(
                f"data shape must stay {tuple(self._data.shape)}, got "
                f"{tuple(data.shape)}")
        if data.device != self.device:
            raise ValueError(f"data on {data.device}, matrix on {self.device}")
        canonical_value_dtype(data.dtype)
        return BsrMatrix._from_parts(self._nrows, self._ncols, self._br,
                                     self._bc, self._indptr, self._indices,
                                     data)

    def transpose(self) -> "BsrMatrix":
        """Block-level transpose on the matrix's device: the block pattern
        transposes through the cached structure (one stable sort, as the
        JAX package's host lexsort orders it) and the data moves with one
        gather that also transposes each block, ``(nb, br, bc) ->
        (nb, bc, br)``."""
        from ..ops.kernels.bsr_spmv import transposed_blocks

        t, data_t = transposed_blocks(self._indptr, self._indices,
                                      self._data, self._ncols)
        return BsrMatrix._from_parts(self._ncols, self._nrows, self._bc,
                                     self._br, t.ptr, t.minor, data_t)

    @property
    def T(self) -> "BsrMatrix":
        return self.transpose()

    def _union_add(self, other: "BsrMatrix", sign: float) -> "BsrMatrix":
        """Block-pattern union merge on the host; the numeric phase is two
        gathers on the device (each union slot pulls its source block or a
        zero pad)."""
        if self.shape != other.shape:
            raise ShapeError(f"shape mismatch {self.shape} vs {other.shape}")
        if self.blocksize != other.blocksize:
            raise ShapeError(
                f"blocksize mismatch {self.blocksize} vs {other.blocksize}")
        if self.device != other.device:
            raise ValueError(
                f"operands on {self.device} and {other.device}")
        nbr = self._nrows // self._br
        nbc = self._ncols // self._bc

        def keys(m):
            ip = _host(m._indptr).astype(np.int64)
            ic = _host(m._indices).astype(np.int64)
            brow = np.repeat(np.arange(nbr, dtype=np.int64), np.diff(ip))
            return brow * nbc + ic

        ka, kb = keys(self), keys(other)
        union = np.union1d(ka, kb)
        # source slot per union key (pad slot = own n_blocks)
        src_a = np.full(union.size, self.n_blocks, dtype=np.int64)
        src_b = np.full(union.size, other.n_blocks, dtype=np.int64)
        src_a[np.searchsorted(union, ka)] = np.arange(ka.size)
        src_b[np.searchsorted(union, kb)] = np.arange(kb.size)
        new_ptr = np.zeros(nbr + 1, dtype=np.int64)
        np.add.at(new_ptr, union // nbc + 1, 1)
        np.cumsum(new_ptr, out=new_ptr)
        device = self.device
        zpad = self._data.new_zeros((1, self._br, self._bc))
        da = torch.cat([self._data, zpad])[_index_tensor(src_a, device)]
        db = torch.cat([other._data.to(self.dtype), zpad])[
            _index_tensor(src_b, device)]
        return BsrMatrix._from_parts(
            self._nrows, self._ncols, self._br, self._bc,
            _index_tensor(new_ptr, device),
            _index_tensor(union % nbc, device), da + sign * db)

    def __add__(self, other):
        if isinstance(other, BsrMatrix):
            return self._union_add(other, +1.0)
        return NotImplemented

    def __sub__(self, other):
        if isinstance(other, BsrMatrix):
            return self._union_add(other, -1.0)
        return NotImplemented

    def __mul__(self, other):
        """Scaling by a number. A NumPy scalar promotes the blocks to the
        common type, as it does in the JAX package (``f32 * np.float64``
        gives float64); a Python number keeps their type."""
        if np.isscalar(other):
            data = self._data
            if isinstance(other, np.generic):
                data = data.to(result_dtype(data.dtype, other.dtype))
                other = other.item()
            return self.with_data(data * other)
        return NotImplemented

    __rmul__ = __mul__

    def astype(self, dtype) -> "BsrMatrix":
        """Cast block storage on the device, e.g. to ``torch.bfloat16`` to
        halve the bytes a product streams; products still accumulate and
        return float32 (``bsr.py:356``)."""
        return self.with_data(self._data.to(canonical_value_dtype(dtype)))

    def __neg__(self) -> "BsrMatrix":
        return self.with_data(-self._data)

    def __repr__(self) -> str:
        return (f"BsrMatrix(shape={self.shape}, blocksize={self.blocksize}, "
                f"n_blocks={self.n_blocks}, dtype={self.dtype}, "
                f"device={self.device})")
