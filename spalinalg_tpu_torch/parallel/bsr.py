"""Distributed BSR: block-row partitioning over a row mesh (counterpart of
``spalinalg_tpu/parallel/bsr.py``).

Every shard is padded to one block count (zero blocks, a multiple of 16,
as in the JAX package) and one block-row count, so the ranks' shapes are
identical. This rank keeps its row of the JAX package's stacked arrays
(``rows``: local block rows, ``cols``: global block columns, ``data``)
and, built once, its local block as a port :class:`BsrMatrix` over the
gathered operand. :func:`dist_bsr_spmv` all-gathers ``x`` and runs the
port's BSR dispatch on that block: the BSR SpMV kernel on the card.

The JAX package's per-shard path rounds the operand to float32
(``parallel/bsr.py:123``), so float64 blocks lose precision there; here
the accumulation is the port's BSR kernel's (float64 for float64 blocks,
float32 for float32 and bfloat16 ones) and ``x`` is not rounded.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from ..errors import ShapeError
from ..formats.bsr import BsrMatrix
from .partition import _padded, gather_rows, mesh_device
from .spmv import _slice

__all__ = ["DistBsr", "partition_bsr", "dist_bsr_spmv", "shard_bsr_vector"]

# Padded block counts are a multiple of this (the JAX kernel's group).
_BLOCK_GROUP = 16


@dataclass(frozen=True, eq=False)
class DistBsr:
    """Block-row-partitioned BSR over a 1-D mesh: this rank's shard."""

    nrows: int                # global logical rows
    ncols: int
    br: int
    bc: int
    nbr_per_shard: int        # padded block rows a shard
    nblk_per_shard: int       # padded blocks a shard
    rows: torch.Tensor        # (nblk,) int32 LOCAL block-row ids (pads 0)
    cols: torch.Tensor        # (nblk,) int32 GLOBAL block-column ids
    data: torch.Tensor        # (nblk, br, bc)
    mesh: DeviceMesh
    axis: str
    # the shard as a BsrMatrix over the gathered operand
    local: BsrMatrix = field(repr=False)

    @property
    def n_shards(self) -> int:
        return self.mesh.size()

    @property
    def device(self) -> torch.device:
        return self.data.device


def partition_bsr(bsr, mesh: DeviceMesh, *, axis=None) -> DistBsr:
    """Partition a BSR matrix block-row-wise over ``mesh``: every rank
    passes the same matrix and keeps its own shard (contiguous block rows,
    zero blocks padding every shard to the largest). Only ``indptr`` goes
    through the host; blocks are sliced on the matrix's device."""
    if axis is None:
        axis = mesh.mesh_dim_names[0]
    P, p, dev = mesh.size(), mesh.get_local_rank(), mesh_device(mesh)
    br, bc = bsr.blocksize
    nbr = bsr.nrows // br
    ip = bsr.indptr.cpu().numpy().astype(np.int64)
    bl_per = -(-nbr // P)
    if bsr.ncols > P * bl_per * bc:
        raise ShapeError(
            f"{bsr.ncols} columns exceed the padded operand of {P} x "
            f"{bl_per} x {bc}: partition_bsr takes matrices at most as wide "
            "as their block rows' grid")
    starts = ip[np.minimum(np.arange(P + 1) * bl_per, nbr)]
    nblk = max(int(np.diff(starts).max()), 1)
    nblk = -(-nblk // _BLOCK_GROUP) * _BLOCK_GROUP

    lo, hi = int(starts[p]), int(starts[p + 1])
    r0 = min(p * bl_per, nbr)
    r1 = min(r0 + bl_per, nbr)
    local_ptr = np.full(bl_per + 1, hi - lo, dtype=np.int64)
    local_ptr[: r1 - r0 + 1] = ip[r0:r1 + 1] - lo
    rows = np.zeros(nblk, dtype=np.int32)
    rows[: hi - lo] = np.repeat(np.arange(r1 - r0, dtype=np.int32),
                                np.diff(local_ptr[: r1 - r0 + 1]))
    cols = _padded(bsr.indices[lo:hi], nblk, dev)
    data = _padded(bsr.data[lo:hi], nblk, dev)
    indptr = torch.from_numpy(local_ptr.astype(np.int32)).to(dev)
    local = BsrMatrix._from_parts(bl_per * br, P * bl_per * bc, br, bc,
                                  indptr, cols, data)
    return DistBsr(nrows=bsr.nrows, ncols=bsr.ncols, br=br, bc=bc,
                   nbr_per_shard=bl_per, nblk_per_shard=nblk,
                   rows=torch.from_numpy(rows).to(dev), cols=cols, data=data,
                   mesh=mesh, axis=axis, local=local)


def shard_bsr_vector(x, d: DistBsr) -> torch.Tensor:
    """This rank's slice of a global operand vector, padded to the shard
    grid (``nbr_per_shard · bc`` entries a rank)."""
    x = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    n_pad = d.n_shards * d.nbr_per_shard * d.bc
    full = x.new_zeros(n_pad)
    full[: x.shape[0]] = x
    return _slice(full, n_pad, d.mesh, d.device)


def dist_bsr_spmv(d: DistBsr, x_local: torch.Tensor) -> torch.Tensor:
    """``y = A @ x``; ``A`` block-row-partitioned, ``x``/``y`` this rank's
    padded slices (``nbr_per_shard · bc`` and ``nbr_per_shard · br``
    entries). One all-gather and one BSR SpMV kernel launch a call on the
    card; the result type is the BSR product's (float32 for bfloat16
    blocks, else the promotion of blocks and ``x``)."""
    per = d.nbr_per_shard * d.bc
    if x_local.ndim != 1 or x_local.shape[0] != per:
        raise ShapeError(f"operand must be this rank's padded slice of {per} "
                         f"entries (shard_bsr_vector), got "
                         f"{tuple(x_local.shape)}")
    return d.local @ gather_rows(x_local, d.mesh)
