"""Checkpoint and resume (counterpart of ``spalinalg_tpu/io/checkpoint.py``).

``.npz`` files with the JAX package's keys, so a file written by either
package loads in the other: ``kind`` is ``coo`` / ``dok`` (``shape``,
``rows``, ``cols``, ``values``), ``csr`` / ``csc`` (``shape``, ``ptr``,
``minor``, ``values``) or ``bsr`` (``shape``, ``blocksize``, ``indptr``,
``indices``, ``data``). Files are written with ``savez_compressed`` and
read with ``allow_pickle=False``: loading executes nothing.

Beyond the JAX package, which refuses both (although its docstring and
its multihost module name the shard-by-shard checkpoint as the recovery
path):

- ``kind="dia"`` (``shape``, ``offsets``, ``data``);
- a :class:`~spalinalg_tpu_torch.parallel.DistCsr`, shard by shard: each
  rank writes its own block to its own file, ``<path>.rank<r>.npz``
  (``kind="distcsr"``, with the rank and the world size), and
  ``load_npz(path, mesh=mesh)`` reads this rank's file back onto the
  mesh's device. A checkpoint written on another world size raises.

A compressed matrix is saved trimmed to its ``nnz`` (a ``DeviceCoo``
compress pads past ``ptr[-1]``); loading accepts a padded file, as the
JAX package writes one for a padded matrix. BSR blocks in bfloat16 are
saved as float32 (exact) with ``data_dtype="bfloat16"``, and cast back on
load. Factor objects are refused, as in the JAX package. Compressed, BSR
and DIA matrices load onto ``device`` (``None``: the default device, see
``spalinalg_tpu_torch/device.py``); COO and DOK are host formats.

Examples
--------
>>> import tempfile, os
>>> from spalinalg_tpu_torch import CsrMatrix
>>> from spalinalg_tpu_torch.io import save_npz, load_npz
>>> csr = CsrMatrix.eye(3, device="cpu")
>>> path = os.path.join(tempfile.mkdtemp(), "eye.npz")
>>> save_npz(path, csr)
>>> back = load_npz(path, device="cpu")
>>> type(back).__name__, back.shape, back.nnz
('CsrMatrix', (3, 3), 3)
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..device import resolve_device
from ..errors import SpalinalgError
from ..formats.bsr import BsrMatrix
from ..formats.compressed import CscMatrix, CsrMatrix, _host
from ..formats.coo import CooMatrix
from ..formats.dia import DiaMatrix
from ..formats.dok import DokMatrix
from .arrays import csc_from_arrays, csr_from_arrays

__all__ = ["save_npz", "load_npz", "shard_path"]


def shard_path(path, rank: int) -> str:
    """The file rank ``rank`` of a ``DistCsr`` checkpoint at ``path``
    writes: ``path`` without its ``.npz``, then ``.rank<r>.npz``."""
    path = os.fspath(path)
    stem = path[:-4] if path.endswith(".npz") else path
    return f"{stem}.rank{rank}.npz"


def _save_dist(path, mat) -> None:
    n_ent = int(mat.rowptr[-1])
    np.savez_compressed(
        shard_path(path, mat.rank), kind="distcsr",
        shape=np.asarray(mat.shape), rank=np.asarray(mat.rank),
        world=np.asarray(mat.n_shards), nse=np.asarray(mat.nse_per_shard),
        comm=np.asarray(mat.comm), halo_width=np.asarray(mat.halo_width),
        rowptr=_host(mat.rowptr), colind=_host(mat.colind[:n_ent]),
        values=_host(mat.values[:n_ent]))


def save_npz(path, mat) -> None:
    """Serialize a COO, DOK, CSR, CSC, BSR or DIA matrix to ``.npz``; a
    ``DistCsr`` writes this rank's shard (module docstring)."""
    from ..parallel.partition import DistCsr

    if isinstance(mat, (CooMatrix, DokMatrix)):
        rows, cols, vals = mat.to_arrays()
        np.savez_compressed(
            path, kind="coo" if isinstance(mat, CooMatrix) else "dok",
            shape=np.asarray(mat.shape), rows=rows, cols=cols, values=vals)
    elif isinstance(mat, (CsrMatrix, CscMatrix)):
        nnz = mat.nnz
        np.savez_compressed(
            path, kind="csr" if isinstance(mat, CsrMatrix) else "csc",
            shape=np.asarray(mat.shape), ptr=_host(mat._ptr),
            minor=_host(mat._minor[:nnz]), values=_host(mat._values[:nnz]))
    elif isinstance(mat, BsrMatrix):
        data = mat.data
        extra = {}
        if data.dtype == torch.bfloat16:
            data, extra = data.float(), {"data_dtype": "bfloat16"}
        np.savez_compressed(
            path, kind="bsr", shape=np.asarray(mat.shape),
            blocksize=np.asarray(mat.blocksize), indptr=_host(mat.indptr),
            indices=_host(mat.indices), data=_host(data), **extra)
    elif isinstance(mat, DiaMatrix):
        np.savez_compressed(path, kind="dia", shape=np.asarray(mat.shape),
                            offsets=mat.offsets, data=_host(mat.data))
    elif isinstance(mat, DistCsr):
        _save_dist(path, mat)
    else:
        raise SpalinalgError(f"cannot checkpoint {type(mat).__name__}")


def _load_dist(path, mesh):
    from ..parallel.partition import mesh_device, shard_from_parts

    rank, world = mesh.get_local_rank(), mesh.size()
    fname = shard_path(path, rank)
    if not os.path.exists(fname):
        raise SpalinalgError(
            f"no shard file {fname} for rank {rank} of {world}")
    with np.load(fname, allow_pickle=False) as z:
        if str(z["kind"]) != "distcsr":
            raise SpalinalgError(f"{fname} holds a {str(z['kind'])!r} "
                                 "checkpoint, not a DistCsr shard")
        saved_rank, saved_world = int(z["rank"]), int(z["world"])
        if (saved_rank, saved_world) != (rank, world):
            raise SpalinalgError(
                f"{fname} is rank {saved_rank} of a checkpoint written on "
                f"{saved_world} ranks; this is rank {rank} of {world} (load "
                "on the world size that wrote it)")
        nrows, ncols = (int(v) for v in z["shape"])
        nse = int(z["nse"])
        dev = mesh_device(mesh)
        rowptr = torch.from_numpy(z["rowptr"].astype(np.int32)).to(dev)
        colind = torch.zeros(nse, dtype=torch.int32, device=dev)
        values = torch.zeros(nse, dtype=torch.from_numpy(z["values"]).dtype,
                             device=dev)
        n_ent = z["colind"].size
        colind[:n_ent] = torch.from_numpy(z["colind"].astype(np.int32))
        values[:n_ent] = torch.from_numpy(z["values"])
        return shard_from_parts(nrows, ncols, rowptr, colind, values, mesh,
                                mesh.mesh_dim_names[0], str(z["comm"]),
                                int(z["halo_width"]))


def load_npz(path, *, device=None, mesh=None):
    """Restore a matrix saved by :func:`save_npz` (either package's).

    Compressed, BSR and DIA matrices land on ``device`` (``None``: the
    default device); with ``mesh``, ``path`` names a ``DistCsr``
    checkpoint and this rank's shard lands on the mesh's device."""
    if mesh is not None:
        return _load_dist(path, mesh)
    with np.load(path, allow_pickle=False) as z:
        kind = str(z["kind"])
        nrows, ncols = (int(v) for v in z["shape"])
        if kind in ("coo", "dok"):
            cls = CooMatrix if kind == "coo" else DokMatrix
            return cls.with_triplets(nrows, ncols, z["rows"], z["cols"],
                                     z["values"], dtype=z["values"].dtype)
        if kind in ("csr", "csc"):
            build = csr_from_arrays if kind == "csr" else csc_from_arrays
            return build(nrows, ncols, z["ptr"], z["minor"], z["values"],
                         device=device)
        if kind == "bsr":
            bsr = BsrMatrix(nrows, ncols, tuple(int(v) for v in z["blocksize"]),
                            z["indptr"], z["indices"], z["data"],
                            device=resolve_device(device))
            if "data_dtype" in z.files:
                bsr = bsr.astype(getattr(torch, str(z["data_dtype"])))
            return bsr
        if kind == "dia":
            return DiaMatrix(nrows, ncols, z["offsets"], z["data"],
                             device=device)
        if kind == "distcsr":
            raise SpalinalgError(
                f"{path} is a DistCsr shard: load_npz(<checkpoint path>, "
                "mesh=...) reads this rank's shard")
    raise SpalinalgError(f"unknown checkpoint kind {kind!r}")
