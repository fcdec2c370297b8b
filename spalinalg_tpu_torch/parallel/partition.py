"""Row partitioning for multi-card execution (counterpart of
``spalinalg_tpu/parallel/partition.py``).

The JAX package keeps a row-partitioned matrix as stacked per-shard blocks
on a ``jax.sharding.Mesh`` and runs its products under ``shard_map``. Here
the mesh is a 1-D ``torch.distributed`` ``DeviceMesh`` over the ranks of a
process group, one process per card (the ``torchrun`` idiom): NCCL on
CUDA, gloo on the CPU. Every rank runs the same program, and each holds
only its own shard:

- :class:`DistCsr` keeps this rank's row of the JAX package's stacked
  arrays, equal element for element: ``rowptr`` (``rows_per_shard + 1``),
  ``colind`` (global column ids), ``values`` (``nse_per_shard``, padded
  with zeros) and ``brow`` (the local row of each slot, padding slots at
  ``rows_per_shard``). Rows and slots are padded so every shard has the
  same shapes, and so every collective has a fixed shape.
- It also keeps the local block as a port :class:`CsrMatrix`, built once
  here: with columns localised to the halo window in ``"halo"`` mode,
  with global columns in ``"allgather"`` mode. A distributed product is
  then one launch of the port's CSR kernel on that block plus its
  collectives, and the kernel's work plan is cached with the block.

The communication mode is chosen per structure (host work, once):

- ``"allgather"``: every rank all-gathers the operand;
- ``"halo"``: a banded structure reads only its neighbours' entries, and
  ranks exchange fixed-width slabs with their left and right neighbours.

Two faults of the JAX package are repaired here. Its automatic choice
measured the halo against the row blocks but the products read the column
blocks, so a non-square layout could take ``"halo"`` and give wrong
products; here ``"halo"`` is chosen only when the column blocks equal the
row blocks (``cols_per == rows_per``). And a forced ``comm="halo"`` wider
than one shard silently dropped entries; here it raises ``ValueError``.

Examples
--------
>>> import numpy as np
>>> from spalinalg_tpu_torch import CsrMatrix
>>> from spalinalg_tpu_torch.parallel import (make_row_mesh, partition_csr,
...                                           shard_vector, dist_spmv,
...                                           unshard_vector)
>>> mesh = make_row_mesh(device="cpu")      # a one-rank group if none
>>> A = CsrMatrix.eye(8, device="cpu")
>>> dist = partition_csr(A, mesh)
>>> x = shard_vector(np.arange(8.0), dist)
>>> y = unshard_vector(dist_spmv(dist, x), dist)
>>> y.tolist()
[0.0, 1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 7.0]
>>> import torch.distributed
>>> torch.distributed.destroy_process_group()     # the one-rank group
"""

from __future__ import annotations

import os
import warnings
from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..convert.engine import major_ids
from ..device import resolve_device
from ..errors import ShapeError
from ..formats.compressed import CsrMatrix

__all__ = ["DistCsr", "partition_csr", "make_row_mesh"]

_BACKEND = {"cuda": "nccl", "cpu": "gloo"}


def make_row_mesh(n_devices: Optional[int] = None,
                  axis: Optional[str] = None, *, device=None) -> DeviceMesh:
    """A 1-D ``DeviceMesh`` over every rank of the default process group,
    its axis named ``axis`` (default: :func:`config.current_config`'s
    ``partition_axis``).

    The device is ``device``, else the innermost ``default_device`` scope,
    else the card: a ``"cuda"`` mesh on ``cuda:{LOCAL_RANK}`` with NCCL. A
    CPU mesh (gloo) exists only where the caller asks for the CPU. There
    is no fallback: without a card an unscoped call raises.

    With no process group initialised, the group is made here: from the
    launcher's environment (``env://``) where ``WORLD_SIZE`` names more
    than one rank (``torchrun``), else a one-rank group
    (``init_process_group(backend, store=HashStore(), rank=0,
    world_size=1)``), so a single process works the way the JAX package's
    one-device mesh does. ``n_devices`` must equal the group's size: no
    caller of the JAX package takes a sub-mesh, and none is offered.
    """
    if axis is None:
        from ..config import current_config

        axis = current_config().partition_axis
    dev = resolve_device(device)
    if dev.type not in _BACKEND:
        raise ValueError(f"no row mesh for device {dev}")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_row_mesh: no CUDA device; pass device='cpu' (or enter "
                "default_device('cpu')) for a CPU mesh")
        index = dev.index
        if index is None:
            index = int(os.environ.get(
                "LOCAL_RANK", (dist.get_rank() if dist.is_initialized()
                               else 0) % torch.cuda.device_count()))
        torch.cuda.set_device(index)
    backend = _BACKEND[dev.type]
    if not dist.is_initialized():
        kw = ({"device_id": torch.device("cuda", torch.cuda.current_device())}
              if dev.type == "cuda" else {})
        if int(os.environ.get("WORLD_SIZE", "1")) > 1:
            dist.init_process_group(backend, **kw)
        else:
            dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                    world_size=1, **kw)
    elif backend not in dist.get_backend():
        raise ValueError(
            f"the process group's backend {dist.get_backend()!r} runs no "
            f"collectives on {dev.type} tensors (needs {backend!r})")
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"n_devices={n_devices}, but the process group has "
                         f"{world} ranks (one card a rank; no sub-meshes)")
    return init_device_mesh(dev.type, (world,), mesh_dim_names=(axis,))


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank's shards live on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def all_gather(out: torch.Tensor, t: torch.Tensor, group) -> torch.Tensor:
    """``dist.all_gather_into_tensor`` (ranks stacked on dim 0); torch 2.13
    warns that it will be renamed, which this call silences."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        dist.all_gather_into_tensor(out, t.contiguous(), group=group)
    return out


def gather_rows(t: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """Every rank's ``t`` (one shape on all ranks) stacked on dim 0."""
    out = t.new_empty((mesh.size() * t.shape[0],) + tuple(t.shape[1:]))
    return all_gather(out, t, mesh.get_group())


def _padded(t: torch.Tensor, n: int, device) -> torch.Tensor:
    """``t`` on ``device``, zero-padded to length ``n`` (no copy where it
    already is that long and there)."""
    if t.shape[0] == n:
        return t.to(device)
    out = t.new_zeros((n,) + tuple(t.shape[1:]), device=device)
    out[: t.shape[0]] = t
    return out


def _halo_width(minor: torch.Tensor, row_starts, ent_starts) -> int:
    """``max(r0 - min col, max col - (r1 - 1), 0)`` over the shards that
    hold entries: how far a shard's columns reach past its rows."""
    lo, hi = [], []
    for p in range(len(row_starts) - 1):
        e0, e1 = int(ent_starts[p]), int(ent_starts[p + 1])
        if e1 > e0:
            cols = minor[e0:e1]
            lo.append(int(row_starts[p]) - cols.min())
            hi.append(cols.max() - (int(row_starts[p + 1]) - 1))
    if not lo:
        return 0
    reach = torch.stack([torch.stack(lo), torch.stack(hi)]).max()
    return max(int(reach), 0)


@dataclass(frozen=True, eq=False)
class DistCsr:
    """Row-partitioned CSR over a 1-D mesh: this rank's shard."""

    nrows: int              # global logical rows (un-padded)
    ncols: int
    rows_per_shard: int     # padded local row count
    rowptr: torch.Tensor    # (rows_per_shard + 1,) int32
    colind: torch.Tensor    # (nse_per_shard,) int32, GLOBAL column ids
    values: torch.Tensor    # (nse_per_shard,)
    mesh: DeviceMesh
    axis: str
    comm: str               # "allgather" | "halo"
    halo_width: int         # "halo": how far columns reach past the rows
    # the local block as a CsrMatrix: columns localised to the halo window
    # [p·cols_per - h, (p + 1)·cols_per + h) in "halo" mode, global in
    # "allgather" mode; the products run the CSR kernels on it
    local: CsrMatrix = field(repr=False)

    @property
    def n_shards(self) -> int:
        return self.mesh.size()

    @property
    def rank(self) -> int:
        return self.mesh.get_local_rank()

    @property
    def group(self):
        return self.mesh.get_group()

    @property
    def device(self) -> torch.device:
        return self.rowptr.device

    @property
    def nse_per_shard(self) -> int:
        return self.colind.shape[0]

    @property
    def cols_per_shard(self) -> int:
        """Length of this rank's slice of the operand vector."""
        return -(-self.ncols // self.n_shards)

    @property
    def brow(self) -> torch.Tensor:
        """Local row id of each slot (padding slots: ``rows_per_shard``)."""
        return major_ids(self.rowptr, self.nse_per_shard)

    # The operand surface the solver tier reads: logical dims; operand
    # vectors are this rank's padded slices (``shard_vector``).
    @property
    def shape(self) -> Tuple[int, int]:
        return (self.nrows, self.ncols)

    @property
    def dtype(self) -> torch.dtype:
        return self.values.dtype

    @property
    def padded_dim(self) -> int:
        """Length of the padded operand vector over all ranks."""
        return self.n_shards * self.rows_per_shard

    def __matmul__(self, other):
        from .spmv import dist_spmm, dist_spmv

        if getattr(other, "ndim", 1) == 2:
            return dist_spmm(self, other)
        return dist_spmv(self, other)

    def _structure(self):
        """Global ``(ptr, cols, flat)`` on the host, from every rank's
        shard: ``flat`` maps each global entry to its slot in the ranks'
        padded value arrays stacked end to end. Shard-major order with
        rows in order inside a shard is global row-major order."""
        rp = gather_rows(self.rowptr, self.mesh).view(self.n_shards, -1)
        ci = gather_rows(self.colind, self.mesh)
        rp = rp.cpu().numpy().astype(np.int64)
        ci = ci.cpu().numpy().astype(np.int64)
        n_ent = rp[:, -1]
        first = np.repeat(np.arange(self.n_shards, dtype=np.int64)
                          * self.nse_per_shard, n_ent)
        within = np.arange(int(n_ent.sum()), dtype=np.int64) - np.repeat(
            np.cumsum(n_ent) - n_ent, n_ent)
        flat = first + within
        lens = np.diff(rp, axis=1).reshape(-1)[: self.nrows]
        ptr = np.zeros(self.nrows + 1, np.int64)
        np.cumsum(lens, out=ptr[1:])
        return ptr, ci[flat], flat

    def __mul__(self, other):
        """Sparse·sparse product with another ``DistCsr``.

        The symbolic phase runs on the host over the global structure
        (each rank all-gathers the padded ``rowptr``/``colind`` and calls
        :func:`~spalinalg_tpu_torch.ops.spgemm.spgemm_plan`); the numeric
        phase runs on the device: the ranks' values are all-gathered,
        mapped to global order, and one ``spgemm_apply`` (the SpGEMM
        kernel) computes the product's values. The result lands
        row-partitioned on the same mesh, its ``comm`` chosen anew.
        """
        if not isinstance(other, DistCsr):
            return NotImplemented
        if self.ncols != other.nrows:
            raise ShapeError(
                f"matmul dim mismatch {self.shape} x {other.shape}")
        if other.mesh is not self.mesh or other.axis != self.axis:
            raise ValueError(
                "DistCsr * DistCsr needs both operands on the same mesh "
                "and axis (re-partition one operand first); a silent "
                "re-home onto the left operand's mesh is more likely a "
                "caller bug than an intent")
        from ..ops.spgemm import spgemm_apply, spgemm_plan

        dev = self.device

        def shell(d, ptr, cols):
            return CsrMatrix._from_parts(
                d.nrows, d.ncols,
                torch.from_numpy(ptr.astype(np.int32)).to(dev),
                torch.from_numpy(cols.astype(np.int32)).to(dev),
                torch.zeros(cols.size, dtype=d.dtype, device=dev))

        ptr_a, col_a, flat_a = self._structure()
        ptr_b, col_b, flat_b = other._structure()
        plan = spgemm_plan(shell(self, ptr_a, col_a),
                           shell(other, ptr_b, col_b))
        a_vals = gather_rows(self.values, self.mesh)[
            torch.from_numpy(flat_a).to(dev)]
        b_vals = gather_rows(other.values, self.mesh)[
            torch.from_numpy(flat_b).to(dev)]
        c_vals = spgemm_apply(plan, a_vals, b_vals)
        return _partition(plan.rowptr.cpu().numpy().astype(np.int64),
                          plan.colind, c_vals, self.nrows, other.ncols,
                          self.mesh, self.axis, None)

    def to_csr(self) -> CsrMatrix:
        """The whole matrix as one CSR on this rank's device, on every
        rank (all-gathers every shard: O(nnz) traffic, not a hot path)."""
        ptr, cols, flat = self._structure()
        vals = gather_rows(self.values, self.mesh)[
            torch.from_numpy(flat).to(self.device)]
        return CsrMatrix._from_parts(
            self.nrows, self.ncols,
            torch.from_numpy(ptr.astype(np.int32)).to(self.device),
            torch.from_numpy(cols.astype(np.int32)).to(self.device), vals)

    def transpose(self) -> "DistCsr":
        """Distributed transpose through the whole matrix: gather,
        transpose, re-partition on the same mesh (the comm mode is chosen
        anew for the transposed structure)."""
        return partition_csr(self.to_csr().transpose(), self.mesh,
                             axis=self.axis)


def _partition(ptr: np.ndarray, minor: torch.Tensor, values: torch.Tensor,
               nrows: int, ncols: int, mesh: DeviceMesh, axis: str,
               comm: Optional[str]) -> DistCsr:
    """This rank's shard of the CSR ``(ptr, minor, values)``: ``ptr`` on the
    host (int64), ``minor`` and ``values`` on any one device. Slices of
    ``minor`` and ``values`` move to the mesh's device; nothing else of
    the matrix goes through the host."""
    P = mesh.size()
    p = mesh.get_local_rank()
    dev = mesh_device(mesh)
    rows_per = -(-nrows // P)
    cols_per = -(-ncols // P)
    row_starts = np.minimum(np.arange(P + 1) * rows_per, nrows)
    ent_starts = ptr[row_starts]
    local_nse = max(int(np.diff(ent_starts).max()), 1)
    halo = _halo_width(minor, row_starts, ent_starts)

    square = cols_per == rows_per
    if comm is None:
        # Banded enough that two halo slabs beat a full all-gather, and
        # the column blocks are the row blocks the halo was measured on?
        comm = "halo" if square and halo <= rows_per // 2 else "allgather"
    elif comm == "halo":
        if not square:
            raise ValueError(
                f"comm='halo' needs column blocks equal to the row blocks, "
                f"got {cols_per} columns and {rows_per} rows a shard "
                f"({nrows} x {ncols} over {P} ranks); use 'allgather'")
        if halo > cols_per:
            raise ValueError(
                f"comm='halo': the halo width {halo} exceeds the shard width "
                f"{cols_per}, so a neighbour's slab cannot cover it; use "
                "'allgather'")
    elif comm != "allgather":
        raise ValueError(f"comm must be 'halo' or 'allgather', got {comm!r}")

    r0, r1 = int(row_starts[p]), int(row_starts[p + 1])
    e0, e1 = int(ent_starts[p]), int(ent_starts[p + 1])
    rp = np.full(rows_per + 1, e1 - e0, dtype=np.int64)
    rp[: r1 - r0 + 1] = ptr[r0:r1 + 1] - e0
    rowptr = torch.from_numpy(rp.astype(np.int32)).to(dev)
    colind = _padded(minor[e0:e1], local_nse, dev)
    vals = _padded(values[e0:e1], local_nse, dev)
    return shard_from_parts(nrows, ncols, rowptr, colind, vals, mesh, axis,
                            comm, int(halo))


def shard_from_parts(nrows: int, ncols: int, rowptr: torch.Tensor,
                     colind: torch.Tensor, values: torch.Tensor,
                     mesh: DeviceMesh, axis: str, comm: str,
                     halo_width: int) -> DistCsr:
    """This rank's :class:`DistCsr` from its shard's arrays (``rowptr`` of
    ``rows_per_shard + 1``, padded ``colind`` with global column ids and
    ``values``, all on the mesh's device), as :func:`partition_csr` made
    them or a checkpoint holds them: builds the local block."""
    P = mesh.size()
    p = mesh.get_local_rank()
    rows_per = rowptr.shape[0] - 1
    cols_per = -(-ncols // P)
    if comm == "halo":
        offset = p * cols_per - halo_width
        lcol = colind
        if offset:
            n_ent = int(rowptr[-1])
            lcol = colind - offset
            lcol[n_ent:] = 0                    # padding slots stay in range
        local = CsrMatrix._from_parts(rows_per, cols_per + 2 * halo_width,
                                      rowptr, lcol, values)
    else:
        local = CsrMatrix._from_parts(rows_per, P * cols_per, rowptr, colind,
                                      values)
    return DistCsr(nrows=nrows, ncols=ncols, rows_per_shard=rows_per,
                   rowptr=rowptr, colind=colind, values=values, mesh=mesh,
                   axis=axis, comm=comm, halo_width=halo_width, local=local)


def partition_csr(csr, mesh: DeviceMesh, *, axis: Optional[str] = None,
                  comm: Optional[str] = None) -> DistCsr:
    """Partition a CSR matrix row-wise over ``mesh``: every rank passes the
    same matrix and keeps its own shard. ``axis`` defaults to the mesh's
    axis name.

    Structure work, once per matrix: slice rows into ``P`` equal blocks
    (padded), equalise the shards' slot counts with zero padding, and
    choose the comm mode from the structure's reach unless ``comm`` forces
    it (a forced ``"halo"`` the window cannot cover raises
    ``ValueError``). Only ``rowptr`` goes through the host; the shard's
    columns and values are sliced on the matrix's device.
    """
    if axis is None:
        axis = mesh.mesh_dim_names[0]
    ptr = csr.rowptr.cpu().numpy().astype(np.int64)
    nnz = int(ptr[-1])
    return _partition(ptr, csr.colind[:nnz], csr.values[:nnz], csr.nrows,
                      csr.ncols, mesh, axis, comm)
