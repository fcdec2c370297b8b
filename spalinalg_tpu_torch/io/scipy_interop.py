"""scipy.sparse bridges (counterpart of ``spalinalg_tpu/io/scipy_interop.py``).

Gated: scipy is optional. Importing this module works without it; calling
the functions raises a clear error if scipy is absent.

CSR and CSC keep their format (indices sorted), onto ``device`` (``None``:
the default device, see ``spalinalg_tpu_torch/device.py``); every other
scipy format becomes a host :class:`~spalinalg_tpu_torch.formats.coo.
CooMatrix`, as in the JAX package. :func:`to_scipy` trims a padded
compressed matrix to its ``nnz``.

Examples
--------
>>> import scipy.sparse as sps
>>> from spalinalg_tpu_torch.io import from_scipy, to_scipy
>>> s = sps.csr_matrix([[1.0, 0.0], [0.0, 2.0]])
>>> m = from_scipy(s, device="cpu")
>>> type(m).__name__, m.nnz
('CsrMatrix', 2)
>>> (to_scipy(m) != s).nnz       # round trip: no differing entries
0
"""

from __future__ import annotations

from ..device import resolve_device
from ..errors import SpalinalgError
from ..formats.compressed import (CscMatrix, CsrMatrix, _host,
                                  _index_tensor, _values_tensor)
from ..formats.coo import CooMatrix

__all__ = ["from_scipy", "to_scipy"]


def _scipy_sparse():
    try:
        import scipy.sparse as sps  # noqa: PLC0415
        return sps
    except ImportError as e:  # pragma: no cover
        raise SpalinalgError(
            "scipy is not installed; scipy interop unavailable") from e


def from_scipy(mat, *, device=None):
    """A scipy.sparse matrix as the matching format of the port: CSR and
    CSC on ``device``, anything else as a host COO."""
    sps = _scipy_sparse()
    if not sps.issparse(mat):
        raise SpalinalgError(f"not a scipy sparse matrix: {type(mat)}")
    if mat.format in ("csr", "csc"):
        cls = CsrMatrix if mat.format == "csr" else CscMatrix
        m = mat.sorted_indices()
        dev = resolve_device(device)
        return cls._from_parts(m.shape[0], m.shape[1],
                               _index_tensor(m.indptr, dev),
                               _index_tensor(m.indices, dev),
                               _values_tensor(m.data, dev))
    m = mat.tocoo()
    return CooMatrix.with_triplets(m.shape[0], m.shape[1], m.row, m.col,
                                   m.data, dtype=m.data.dtype)


def to_scipy(mat):
    """A matrix of the port as scipy.sparse: CSR and CSC keep their format
    (trimmed to ``nnz``), a COO becomes ``coo_matrix``, other formats go
    through ``to_coo()`` (BSR and DIA through ``to_csr()``)."""
    sps = _scipy_sparse()
    if isinstance(mat, (CsrMatrix, CscMatrix)):
        nnz = mat.nnz
        build = sps.csr_matrix if isinstance(mat, CsrMatrix) else sps.csc_matrix
        return build((_host(mat._values[:nnz]), _host(mat._minor[:nnz]),
                      _host(mat._ptr)), shape=mat.shape)
    if isinstance(mat, CooMatrix):
        rows, cols, vals = mat.to_arrays()
        return sps.coo_matrix((vals, (rows, cols)), shape=mat.shape)
    if hasattr(mat, "to_coo"):
        return to_scipy(mat.to_coo())
    if hasattr(mat, "to_csr"):
        return to_scipy(mat.to_csr())
    raise SpalinalgError(f"cannot convert {type(mat).__name__} to scipy")
