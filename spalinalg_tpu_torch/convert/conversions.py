"""The full format-conversion graph (counterpart of
``spalinalg_tpu/convert/conversions.py``; reference: `src/{csr,csc}/conv/*`,
`src/coo.rs:629-749`, `src/dok.rs:640-775`).

All 12 directed conversions of the reference, with its exact semantics
(SURVEY.md §2.1 invariants):

- **COO -> CSR/CSC**: duplicates summed, numeric zeros dropped
  (`csr/conv/coo.rs:37-74`).
- **DOK -> CSR/CSC**: keys already unique; explicit zeros kept
  (`csr/conv/dok.rs:4-85`).
- **CSR <-> CSC**: the same entries re-keyed by the other axis; zeros kept
  (`csr/conv/csc.rs:4-64`). Runs on the matrix's device.
- **COO -> DOK**: duplicate triplets summed (`dok.rs:659-661`).
- **compressed -> COO/DOK**: triplet export in major order
  (`coo.rs:629-749`, `dok.rs:676-720`), copied to the host.

Host-builder sources (COO/DOK) run the exact host engine and land on the
``device`` the caller names, else on the default device (``device.py``).
"""

from __future__ import annotations

import numpy as np

from ..formats.compressed import CscMatrix, CsrMatrix
from ..formats.coo import CooMatrix
from ..formats.dok import DokMatrix
from .engine import compress_host, transpose_compressed

__all__ = [
    "coo_to_csr", "coo_to_csc", "coo_to_dok",
    "dok_to_csr", "dok_to_csc", "dok_to_coo",
    "csr_to_csc", "csc_to_csr",
    "csr_to_coo", "csc_to_coo", "csr_to_dok", "csc_to_dok",
]


def _host_compress_to(cls, rows, cols, vals, nrows, ncols, *, dedup,
                      drop_zeros, device):
    if cls._MAJOR_AXIS == 0:
        major, minor, n_major = rows, cols, nrows
    else:
        major, minor, n_major = cols, rows, ncols
    ptr, minor, values = compress_host(
        major, minor, vals, n_major, dedup=dedup, drop_zeros=drop_zeros
    )
    return cls._from_host(nrows, ncols, ptr, minor, values, device)


# ----------------------------------------------------------------------
# Builder -> compressed
# ----------------------------------------------------------------------


def coo_to_csr(coo: CooMatrix, *, device=None) -> CsrMatrix:
    """COO->CSR with duplicate merge + zero drop (`csr/conv/coo.rs:4-124`)."""
    rows, cols, vals = coo.to_arrays()
    return _host_compress_to(
        CsrMatrix, rows, cols, vals, coo.nrows, coo.ncols,
        dedup=True, drop_zeros=True, device=device,
    )


def coo_to_csc(coo: CooMatrix, *, device=None) -> CscMatrix:
    """COO->CSC, mirror of :func:`coo_to_csr` (`csc/conv/coo.rs:4-124`)."""
    rows, cols, vals = coo.to_arrays()
    return _host_compress_to(
        CscMatrix, rows, cols, vals, coo.nrows, coo.ncols,
        dedup=True, drop_zeros=True, device=device,
    )


def dok_to_csr(dok: DokMatrix, *, device=None) -> CsrMatrix:
    """DOK->CSR: unique keys, zeros kept (`csr/conv/dok.rs:4-85`)."""
    rows, cols, vals = dok.to_arrays()
    return _host_compress_to(
        CsrMatrix, rows, cols, vals, dok.nrows, dok.ncols,
        dedup=False, drop_zeros=False, device=device,
    )


def dok_to_csc(dok: DokMatrix, *, device=None) -> CscMatrix:
    """DOK->CSC mirror (`csc/conv/dok.rs:4-85`)."""
    rows, cols, vals = dok.to_arrays()
    return _host_compress_to(
        CscMatrix, rows, cols, vals, dok.nrows, dok.ncols,
        dedup=False, drop_zeros=False, device=device,
    )


# ----------------------------------------------------------------------
# Compressed <-> compressed (on the matrix's device)
# ----------------------------------------------------------------------


def csr_to_csc(csr: CsrMatrix) -> CscMatrix:
    """CSR->CSC: re-key the same entries column-major; zeros kept
    (`csc/conv/csr.rs:4-64`)."""
    ptr, minor, values = transpose_compressed(
        csr.rowptr, csr.colind, csr.values,
        n_major=csr.nrows, n_minor=csr.ncols,
    )
    return CscMatrix._from_parts(csr.nrows, csr.ncols, ptr, minor, values)


def csc_to_csr(csc: CscMatrix) -> CsrMatrix:
    """CSC->CSR mirror (`csr/conv/csc.rs:4-64`)."""
    ptr, minor, values = transpose_compressed(
        csc.colptr, csc.rowind, csc.values,
        n_major=csc.ncols, n_minor=csc.nrows,
    )
    return CsrMatrix._from_parts(csc.nrows, csc.ncols, ptr, minor, values)


# ----------------------------------------------------------------------
# Compressed / builder -> builder (host)
# ----------------------------------------------------------------------


def csr_to_coo(csr: CsrMatrix) -> CooMatrix:
    """CSR->COO: triplets in row-major order (`coo.rs:669-706`)."""
    rows, cols, vals = csr._coo_arrays_host()
    return CooMatrix.with_triplets(
        csr.nrows, csr.ncols, rows, cols, vals, dtype=vals.dtype
    )


def csc_to_coo(csc: CscMatrix) -> CooMatrix:
    """CSC->COO: triplets in column-major order (`coo.rs:629-668`)."""
    rows, cols, vals = csc._coo_arrays_host()
    return CooMatrix.with_triplets(
        csc.nrows, csc.ncols, rows, cols, vals, dtype=vals.dtype
    )


def _dok_from_unique(nrows, ncols, rows, cols, vals) -> DokMatrix:
    """Bulk DOK build for unique keys: one dict() constructor call."""
    out = DokMatrix(nrows, ncols, dtype=np.asarray(vals).dtype)
    vv = np.asarray(vals, dtype=out._dtype)
    t = out._dtype.type  # values stored as numpy scalars (insert parity)
    out._map = {
        (r, c): t(v)
        for r, c, v in zip(np.asarray(rows).tolist(),
                           np.asarray(cols).tolist(), vv.tolist())
    }
    return out


def csr_to_dok(csr: CsrMatrix) -> DokMatrix:
    """CSR->DOK (`dok.rs:702-720`): keys unique by CSR invariant."""
    rows, cols, vals = csr._coo_arrays_host()
    return _dok_from_unique(csr.nrows, csr.ncols, rows, cols, vals)


def csc_to_dok(csc: CscMatrix) -> DokMatrix:
    """CSC->DOK (`dok.rs:676-700`)."""
    rows, cols, vals = csc._coo_arrays_host()
    return _dok_from_unique(csc.nrows, csc.ncols, rows, cols, vals)


def coo_to_dok(coo: CooMatrix) -> DokMatrix:
    """COO->DOK: duplicate triplets are **summed** (`dok.rs:640-668`,
    the ``*map.entry((row, col)).or_default() += value`` merge).

    Duplicates are pre-merged with a vectorised lexsort +
    ``np.add.reduceat`` before the single dict construction.
    """
    out = DokMatrix(coo.nrows, coo.ncols, dtype=coo.dtype)
    rows, cols, vals = coo.to_arrays()
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    vals = np.asarray(vals, dtype=out._dtype)
    if rows.size == 0:
        return out
    order = np.lexsort((cols, rows))
    rs, cs, vs = rows[order], cols[order], vals[order]
    # segment starts where the (row, col) key changes
    new = np.empty(rs.size, dtype=bool)
    new[0] = True
    np.not_equal(rs[1:], rs[:-1], out=new[1:])
    np.logical_or(new[1:], cs[1:] != cs[:-1], out=new[1:])
    starts = np.flatnonzero(new)
    summed = np.add.reduceat(vs, starts).astype(out._dtype, copy=False)
    t = out._dtype.type
    out._map = {k: t(v) for k, v in
                zip(zip(rs[starts].tolist(), cs[starts].tolist()),
                    summed.tolist())}
    return out


def dok_to_coo(dok: DokMatrix) -> CooMatrix:
    """DOK->COO: export entries (unordered, `coo.rs:707-749`)."""
    rows, cols, vals = dok.to_arrays()
    return CooMatrix.with_triplets(
        dok.nrows, dok.ncols, rows, cols, vals, dtype=dok.dtype
    )
