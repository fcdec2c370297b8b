"""``torch.sparse`` bridges (the counterpart of
``spalinalg_tpu/io/jax_interop.py``, which bridges to JAX's BCOO/BCSR).

Ecosystem interop: the port's matrices flow into torch's own sparse
tensors (``torch.sparse_coo``, ``torch.sparse_csr``), and torch's sparse
COO tensors come into the port's kernel and solver tiers. The JAX names
map one to one: ``to_bcoo`` -> :func:`to_sparse_coo`, ``to_bcsr`` ->
:func:`to_sparse_csr`, ``from_bcoo`` -> :func:`from_sparse_coo`. These are
conversions only: no product path of the port calls ``torch.sparse``.

Examples
--------
>>> import torch
>>> from spalinalg_tpu_torch import CsrMatrix
>>> from spalinalg_tpu_torch.io import from_sparse_coo, to_sparse_coo
>>> m = CsrMatrix(2, 3, [0, 2, 3], [0, 2, 1], [1.0, 2.0, 3.0], device="cpu")
>>> t = to_sparse_coo(m)
>>> tuple(t.shape), t._nnz(), t.is_coalesced()
((2, 3), 3, True)
>>> back = from_sparse_coo(t)
>>> type(back).__name__, back.nnz
('CsrMatrix', 3)
>>> bool(torch.equal(back.to_dense(), m.to_dense()))
True
"""

from __future__ import annotations

import torch

from ..device import resolve_device
from ..dtypes import INDEX_DTYPE
from ..errors import ShapeError

__all__ = ["from_sparse_coo", "to_sparse_coo", "to_sparse_csr"]


def to_sparse_coo(mat, *, device=None) -> torch.Tensor:
    """Any format of the port -> a ``torch.sparse_coo`` tensor.

    A raw COO may hold duplicates and is exported as it stands,
    uncoalesced; every other format holds unique indices and is exported
    coalesced (DOK through COO, BSR through CSR, CSC re-sorted to row
    order). A compressed matrix's tensor stays on its device; a host COO
    or DOK goes to ``device`` (``None``: the default device), which a
    compressed matrix ignores."""
    from ..convert.conversions import dok_to_coo
    from ..convert.engine import major_ids
    from ..formats.bsr import BsrMatrix
    from ..formats.compressed import CscMatrix, CsrMatrix
    from ..formats.coo import CooMatrix
    from ..formats.dok import DokMatrix

    if isinstance(mat, DokMatrix):
        coalesce, mat = True, dok_to_coo(mat)
    else:
        coalesce = not isinstance(mat, CooMatrix)
    if isinstance(mat, BsrMatrix):
        mat = mat.to_csr()
    if isinstance(mat, CooMatrix):
        rows, cols, vals = mat.to_arrays()
        dev = resolve_device(device)
        idx = torch.stack([torch.from_numpy(rows), torch.from_numpy(cols)])
        t = torch.sparse_coo_tensor(idx.to(dev), torch.from_numpy(vals).to(dev),
                                    mat.shape, check_invariants=False)
        return t.coalesce() if coalesce else t
    if isinstance(mat, (CsrMatrix, CscMatrix)):
        nnz = mat.nnz
        major = major_ids(mat._ptr, nnz).to(torch.int64)
        minor = mat._minor[:nnz].to(torch.int64)
        rows, cols = ((major, minor) if isinstance(mat, CsrMatrix)
                      else (minor, major))
        t = torch.sparse_coo_tensor(torch.stack([rows, cols]),
                                    mat._values[:nnz], mat.shape,
                                    is_coalesced=isinstance(mat, CsrMatrix),
                                    check_invariants=False)
        return t if isinstance(mat, CsrMatrix) else t.coalesce()
    raise ShapeError(f"cannot export {type(mat).__name__} to a sparse COO "
                     "tensor")


def to_sparse_csr(mat) -> torch.Tensor:
    """CSR -> a ``torch.sparse_csr`` tensor on the matrix's device, reusing
    its index tensors (int32; a padded matrix's trimmed to ``nnz``)."""
    from ..formats.compressed import CsrMatrix

    if not isinstance(mat, CsrMatrix):
        raise ShapeError(
            f"to_sparse_csr takes a CsrMatrix, got {type(mat).__name__} "
            f"(convert first)")
    nnz = mat.nnz
    return torch.sparse_csr_tensor(mat._ptr, mat._minor[:nnz],
                                   mat._values[:nnz], mat.shape,
                                   check_invariants=False)


def from_sparse_coo(t: torch.Tensor, *, dedup: bool = True):
    """A ``torch.sparse_coo`` tensor -> :class:`CsrMatrix` through the
    device conversion engine, on the tensor's device.

    Duplicate indices of an uncoalesced tensor are summed when ``dedup``;
    explicit zeros are kept (DOK -> CSR semantics rather than COO -> CSR,
    since a sparse tensor's stored entries are structural)."""
    from ..convert.engine import compress_device
    from ..formats.compressed import CsrMatrix

    if not (isinstance(t, torch.Tensor) and t.layout == torch.sparse_coo
            and t.ndim == 2 and t.sparse_dim() == 2):
        raise ShapeError(
            "only a plain 2-D sparse COO tensor is supported, got "
            f"{getattr(t, 'layout', type(t).__name__)} of shape "
            f"{tuple(getattr(t, 'shape', ()))}")
    nrows, ncols = t.shape
    idx = t._indices()
    ptr, minor, values = compress_device(
        idx[0].to(INDEX_DTYPE), idx[1].to(INDEX_DTYPE), t._values(),
        n_major=nrows, n_minor=ncols, dedup=dedup, drop_zeros=False)
    return CsrMatrix._from_parts(nrows, ncols, ptr, minor, values)
