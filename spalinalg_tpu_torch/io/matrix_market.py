"""Matrix Market I/O (counterpart of ``spalinalg_tpu/io/matrix_market.py``).

The interchange format for matrices from CPU tooling and for golden-vector
tests. Reading supports the coordinate format with ``real``, ``integer``
and ``pattern`` fields and ``general``, ``symmetric`` and
``skew-symmetric`` symmetries (the off-diagonal entries are mirrored, with
sign -1 for skew), plain or ``.gz``, and returns a host
:class:`~spalinalg_tpu_torch.formats.coo.CooMatrix`, as the JAX function
does. Writing emits ``general`` coordinate real, one ``%d %d %.17g`` line
an entry, so a file written here is byte for byte the one the JAX package
writes for the same matrix.

Examples
--------
>>> import tempfile, os
>>> from spalinalg_tpu_torch import CooMatrix
>>> from spalinalg_tpu_torch.io import read_matrix_market, write_matrix_market
>>> coo = CooMatrix.with_entries(2, 3, [(0, 2, 1.5), (1, 0, -2.0)])
>>> path = os.path.join(tempfile.mkdtemp(), "m.mtx")
>>> write_matrix_market(path, coo)
>>> back = read_matrix_market(path)
>>> back.shape, sorted(back)
((2, 3), [(0, 2, 1.5), (1, 0, -2.0)])
"""

from __future__ import annotations

import gzip

import numpy as np

from ..errors import SpalinalgError
from ..formats.coo import CooMatrix

__all__ = ["read_matrix_market", "write_matrix_market"]


def _open(path, mode):
    if str(path).endswith(".gz"):
        return gzip.open(path, mode + "t")
    return open(path, mode)


def read_matrix_market(path, *, dtype=np.float64) -> CooMatrix:
    """Parse a Matrix Market coordinate file into a host
    :class:`CooMatrix`."""
    with _open(path, "r") as f:
        header = f.readline().strip().lower().split()
        if len(header) < 4 or header[0] != "%%matrixmarket":
            raise SpalinalgError(f"not a MatrixMarket file: {path}")
        if header[2] != "coordinate":
            raise SpalinalgError("only coordinate (sparse) format supported")
        field = header[3]
        symmetry = header[4] if len(header) > 4 else "general"
        if field not in ("real", "integer", "pattern"):
            raise SpalinalgError(f"unsupported field {field!r}")
        if symmetry not in ("general", "symmetric", "skew-symmetric"):
            raise SpalinalgError(f"unsupported symmetry {symmetry!r}")

        line = f.readline()
        while line.startswith("%"):
            line = f.readline()
        nrows, ncols, nnz = (int(t) for t in line.split())

        data = (np.loadtxt(f, ndmin=2, max_rows=nnz) if nnz
                else np.zeros((0, 3)))

    if nnz and data.shape[0] != nnz:
        raise SpalinalgError(
            f"expected {nnz} entries, file has {data.shape[0]}")
    rows = data[:, 0].astype(np.int64) - 1
    cols = data[:, 1].astype(np.int64) - 1
    vals = (data[:, 2] if data.shape[1] > 2
            else np.ones(data.shape[0])).astype(dtype)

    if symmetry in ("symmetric", "skew-symmetric"):
        sign = -1.0 if symmetry == "skew-symmetric" else 1.0
        off = rows != cols  # mirror the strictly off-diagonal entries
        rows, cols, vals = (
            np.concatenate([rows, cols[off]]),
            np.concatenate([cols, rows[off]]),
            np.concatenate([vals, sign * vals[off]]),
        )

    return CooMatrix.with_triplets(nrows, ncols, rows, cols, vals,
                                   dtype=dtype)


def write_matrix_market(path, mat) -> None:
    """Write any of the port's matrices as general coordinate real: a COO
    as it stands, another format through its ``to_coo()`` (BSR and DIA
    through ``to_csr().to_coo()``), in that format's entry order."""
    if not isinstance(mat, CooMatrix):
        if hasattr(mat, "to_coo"):
            mat = mat.to_coo()
        elif hasattr(mat, "to_csr"):
            mat = mat.to_csr().to_coo()
        else:
            raise SpalinalgError(f"cannot write {type(mat).__name__}")
    rows, cols, vals = mat.to_arrays()
    with _open(path, "w") as f:
        f.write("%%MatrixMarket matrix coordinate real general\n")
        f.write(f"{mat.nrows} {mat.ncols} {len(rows)}\n")
        # one C-level printf a line over Python scalars, one join and one
        # write; %.17g round-trips float64
        if len(rows):
            r1 = (np.asarray(rows, dtype=np.int64) + 1).tolist()
            c1 = (np.asarray(cols, dtype=np.int64) + 1).tolist()
            v = np.asarray(vals, dtype=np.float64).tolist()
            f.write("\n".join(map("%d %d %.17g".__mod__, zip(r1, c1, v))))
            f.write("\n")
