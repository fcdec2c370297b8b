"""Device-resident COO (counterpart of ``spalinalg_tpu/formats/device.py``).

``CooMatrix`` is the host builder (amortised pushes); ``DeviceCoo`` is its
frozen device image: three tensors and a static shape, for triplets that
are converted on the device (``to_csr_device``) instead of on the host.
Padding follows the engine convention: sentinel ``row == nrows``, zero
values. A plain class of tensors; the JAX package's is a pytree so that it
can flow through ``jit``, which the port has no counterpart of.

Examples
--------
>>> from spalinalg_tpu_torch import CooMatrix, DeviceCoo
>>> coo = CooMatrix.with_entries(2, 2, [(0, 0, 1.0), (1, 1, 2.0),
...                                     (0, 0, 3.0)])
>>> dev = DeviceCoo.from_host(coo, device="cpu")
>>> dev.nse
3
>>> csr = dev.to_csr_device()        # dedups: (0,0) -> 4.0
>>> csr.values.tolist()              # static nse keeps a padding slot
[4.0, 2.0, 0.0]
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..errors import ShapeError
from .compressed import _index_tensor, _values_tensor

__all__ = ["DeviceCoo"]


class DeviceCoo:
    """Immutable triplet matrix on one device."""

    __slots__ = ("_rows", "_cols", "_vals", "_nrows", "_ncols")

    def __init__(self, nrows, ncols, rows, cols, vals, *, device=None):
        """Triplets onto ``device`` (``None``: the default device, see
        ``spalinalg_tpu_torch/device.py``): int32 indices, values of a
        supported dtype (non-float input becomes float64)."""
        if int(nrows) <= 0 or int(ncols) <= 0:
            raise ShapeError(
                f"matrix dimensions must be positive, got {nrows}x{ncols}")
        device = resolve_device(device)
        self._nrows, self._ncols = int(nrows), int(ncols)
        self._rows = _index_tensor(rows, device)
        self._cols = _index_tensor(cols, device)
        self._vals = _values_tensor(vals, device)

    @classmethod
    def from_host(cls, coo, *, device=None) -> "DeviceCoo":
        """The triplets of a host ``CooMatrix``, pushed order kept."""
        rows, cols, vals = coo.to_arrays()
        return cls(coo.nrows, coo.ncols, rows, cols, vals, device=device)

    # ---- accessors ----

    @property
    def shape(self) -> Tuple[int, int]:
        return (self._nrows, self._ncols)

    @property
    def nrows(self) -> int:
        return self._nrows

    @property
    def ncols(self) -> int:
        return self._ncols

    @property
    def rows(self) -> torch.Tensor:
        return self._rows

    @property
    def cols(self) -> torch.Tensor:
        return self._cols

    @property
    def values(self) -> torch.Tensor:
        return self._vals

    @property
    def device(self) -> torch.device:
        return self._vals.device

    @property
    def nse(self) -> int:
        return int(self._rows.shape[0])

    def nnz_device(self) -> torch.Tensor:
        """Count of non-sentinel entries, as a 0-d int32 tensor on the
        device (no host synchronisation)."""
        return (self._rows < self._nrows).sum(dtype=torch.int32)

    # ---- conversion ----

    def to_csr_device(self, *, dedup: bool = True, drop_zeros: bool = True):
        """Compress on the device (static nse, sentinel padding): the
        device-side equivalent of ``CsrMatrix.from_coo`` (its semantics when
        ``dedup`` and ``drop_zeros`` are left on). The result is a padded
        ``CsrMatrix`` on this matrix's device."""
        from ..convert.engine import compress_device
        from .compressed import CsrMatrix

        ptr, minor, values = compress_device(
            self._rows, self._cols, self._vals,
            n_major=self._nrows, n_minor=self._ncols,
            dedup=dedup, drop_zeros=drop_zeros)
        return CsrMatrix._from_parts(self._nrows, self._ncols, ptr, minor,
                                     values)

    def to_host(self):
        """The live triplets as a host ``CooMatrix``."""
        from .coo import CooMatrix

        rows = self._rows.cpu().numpy()
        cols = self._cols.cpu().numpy()
        vals = self._vals.detach().cpu().numpy()
        keep = rows < self._nrows
        return CooMatrix.with_triplets(
            self._nrows, self._ncols, rows[keep], cols[keep], vals[keep],
            dtype=vals.dtype)

    def __matmul__(self, x):
        """SpMV/SpMM straight off the triplets (an unsorted ``index_add_``
        scatter; convert to CSR for repeated products). ``x`` must lie on
        this matrix's device."""
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.ascontiguousarray(x))
        if not isinstance(x, torch.Tensor):
            return NotImplemented
        if x.ndim not in (1, 2) or x.shape[0] != self._ncols:
            raise ShapeError(
                f"dimension mismatch: {self.shape} @ {tuple(x.shape)}")
        if x.device != self.device:
            raise ValueError(
                f"operand on device {x.device}, matrix on device "
                f"{self.device}: move one of them first")
        acc = self._vals.dtype
        safe_r = self._rows.clamp(0, self._nrows - 1)
        safe_c = self._cols.clamp(0, self._ncols - 1)
        live = self._rows < self._nrows
        v = torch.where(live, self._vals, 0)
        prod = v.reshape((-1,) + (1,) * (x.ndim - 1)) * x[safe_c]
        out = torch.zeros((self._nrows,) + tuple(x.shape[1:]), dtype=acc,
                          device=x.device)
        return out.index_add_(0, safe_r, prod.to(acc))

    def __repr__(self) -> str:
        return f"DeviceCoo(shape={self.shape}, nse={self.nse})"

