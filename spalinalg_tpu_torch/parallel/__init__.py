"""Distributed tier: row partitioning and collective SpMV/SpMM on
``torch.distributed`` (counterpart of ``spalinalg_tpu/parallel``).

One process a card; the mesh is a 1-D ``DeviceMesh`` over the default
process group (NCCL on the card, gloo on the CPU). :mod:`.multihost`
holds the runtime helpers (``initialize``, ``heartbeat``,
``global_device_summary``).
"""

from .bsr import DistBsr, dist_bsr_spmv, partition_bsr, shard_bsr_vector
from .partition import DistCsr, make_row_mesh, partition_csr
from .spmv import (
    dist_dot,
    dist_spmm,
    dist_spmv,
    shard_matrix_rows,
    shard_vector,
    unshard_vector,
)

__all__ = [
    "DistCsr", "make_row_mesh", "partition_csr",
    "dist_spmv", "dist_spmm", "dist_dot",
    "shard_vector", "shard_matrix_rows", "unshard_vector",
    "DistBsr", "partition_bsr", "dist_bsr_spmv", "shard_bsr_vector",
]
