"""Distributed SpMV and SpMM over a row-partitioned mesh (counterpart of
``spalinalg_tpu/parallel/spmv.py``).

Operand and result vectors are this rank's padded slices: every rank holds
``cols_per = ceil(ncols / P)`` entries of ``x`` and gets ``rows_per``
entries of ``y``, the same row partition as the matrix, so the solvers
chain products with no resharding.

- **all-gather**: the operand is gathered to every rank (one fixed-shape
  ``all_gather_into_tensor``), then the local block's product runs;
- **halo**: each rank sends its first and last ``h`` entries (rows of X)
  to its left and right neighbours and receives theirs, in one
  ``batch_isend_irecv``; edge ranks get zero slabs, as the JAX package's
  non-cyclic ``ppermute`` gives them. The local block's columns are
  already localised to ``[left slab, own slice, right slab]``, a window
  kept on the ``DistCsr`` (one a dtype and row shape) that the slabs are
  received into and the own slice copied into: no allocation a product.
  The exchange and the copy are the span ``spal.halo``.

Either way the local product is one ``local @ x`` through the port's CSR
dispatch: the CSR SpMV kernel for a vector, the CSR SpMM kernel for a
block, on the card. Reductions (:func:`dist_dot`) are an ``all_reduce``,
the span ``spal.allreduce``. Both spans take device time on the operand's
card (``utils/profiling.py``).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from ..errors import ShapeError
from ..utils.profiling import annotate
from .partition import DistCsr, gather_rows

__all__ = ["shard_vector", "unshard_vector", "dist_spmv", "dist_spmm",
           "dist_dot", "shard_matrix_rows"]


def _slice(x, n: int, mesh, device) -> torch.Tensor:
    """This rank's slice of the global array ``x`` (first dim ``n``), padded
    with zeros to ``ceil(n / P)`` rows, on ``device``."""
    x = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    if x.shape[0] != n:
        raise ShapeError(f"expected {n} rows, got {tuple(x.shape)}")
    P, p = mesh.size(), mesh.get_local_rank()
    per = -(-n // P)
    lo, hi = min(p * per, n), min((p + 1) * per, n)
    out = torch.zeros((per,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=device)
    out[: hi - lo] = x[lo:hi].to(device)
    return out


def shard_vector(x, dist_mat: DistCsr, *, by: str = "cols") -> torch.Tensor:
    """This rank's padded slice of a global vector. ``by="cols"`` slices
    the SpMV operand (length ncols), ``by="rows"`` the result layout
    (length nrows)."""
    n = dist_mat.ncols if by == "cols" else dist_mat.nrows
    return _slice(x, n, dist_mat.mesh, dist_mat.device)


def shard_matrix_rows(X, dist_mat: DistCsr, *, by: str = "cols"
                      ) -> torch.Tensor:
    """This rank's padded row slice of a dense ``(n, K)`` operand."""
    n = dist_mat.ncols if by == "cols" else dist_mat.nrows
    return _slice(X, n, dist_mat.mesh, dist_mat.device)


def unshard_vector(y: torch.Tensor, dist_mat) -> torch.Tensor:
    """The global result on every rank: the ranks' slices all-gathered,
    the row padding stripped (a vector, or a block of rows). Takes a
    ``DistCsr`` or a ``DistBsr``."""
    return gather_rows(y, dist_mat.mesh)[: dist_mat.nrows]


def _check_operand(d: DistCsr, x: torch.Tensor, ndim: int) -> None:
    if x.ndim != ndim or x.shape[0] != d.cols_per_shard:
        raise ShapeError(
            f"operand must be this rank's padded slice of {d.cols_per_shard} "
            f"rows ({ndim}-D, from shard_vector / shard_matrix_rows), got "
            f"{tuple(x.shape)}")
    if x.device != d.device:
        raise ValueError(f"operand on {x.device}, shard on {d.device}")


def _window(d: DistCsr, x: torch.Tensor) -> torch.Tensor:
    """``d``'s halo operand ``[left slab | own slice | right slab]`` for
    operands shaped as ``x``: made once, zeroed, and kept on ``d``, so an
    edge rank's missing slab stays zero."""
    key = (x.dtype, tuple(x.shape[1:]))
    w = d.windows.get(key)
    if w is None:
        w = x.new_zeros((x.shape[0] + 2 * d.halo_width,) + key[1])
        d.windows[key] = w
    return w


def _operand(d: DistCsr, x: torch.Tensor) -> torch.Tensor:
    """The part of the operand the local block reads: the whole gathered
    operand (all-gather) or ``[left slab, own slice, right slab]``
    (halo), the neighbours' slabs received into ``d``'s window and the own
    slice copied between them."""
    if d.comm == "allgather":
        return gather_rows(x, d.mesh)
    h = d.halo_width
    if h == 0:
        return x
    if torch.is_grad_enabled() and (x.requires_grad
                                    or d.values.requires_grad):
        raise ValueError(
            "a halo DistCsr product reuses its operand window from call to "
            "call, so it is not differentiable; run it under "
            "torch.no_grad()")
    P, p, group, n = d.n_shards, d.rank, d.group, x.shape[0]
    with annotate("spal.halo", device=x.device):
        w = _window(d, x)
        ops = []
        if p > 0:
            ops += [dist.P2POp(dist.isend, x[:h].contiguous(), p - 1, group),
                    dist.P2POp(dist.irecv, w[:h], p - 1, group)]
        if p < P - 1:
            ops += [dist.P2POp(dist.isend, x[-h:].contiguous(), p + 1,
                               group),
                    dist.P2POp(dist.irecv, w[h + n:], p + 1, group)]
        works = dist.batch_isend_irecv(ops) if ops else []
        w[h:h + n].copy_(x)
        for work in works:
            work.wait()
    return w


def dist_spmv(dist_mat: DistCsr, x_local: torch.Tensor) -> torch.Tensor:
    """``y = A @ x`` with ``A`` row-partitioned and ``x``/``y`` this rank's
    padded slices (:func:`shard_vector`; :func:`unshard_vector` gives the
    logical vector). One CSR SpMV kernel launch a call on the card."""
    _check_operand(dist_mat, x_local, 1)
    return dist_mat.local @ _operand(dist_mat, x_local)


def dist_spmm(dist_mat: DistCsr, X_local: torch.Tensor) -> torch.Tensor:
    """``Y = A @ X`` with ``A`` row-partitioned and ``X``/``Y`` this rank's
    padded row slices ``(rows, K)`` (:func:`shard_matrix_rows`). One CSR
    SpMM kernel launch a call on the card."""
    _check_operand(dist_mat, X_local, 2)
    return dist_mat.local @ _operand(dist_mat, X_local)


def allreduce_sum(t: torch.Tensor, dist_mat) -> torch.Tensor:
    """``t`` summed over the ranks of ``dist_mat``'s mesh, in place (pass
    a temporary); returns ``t``. The span ``spal.allreduce``."""
    with annotate("spal.allreduce", device=t.device):
        dist.all_reduce(t, group=dist_mat.mesh.get_group())
    return t


def is_dist(A) -> bool:
    """Whether ``A`` is a row-partitioned ``DistCsr``."""
    return isinstance(A, DistCsr)


def summed(A) -> Callable[[torch.Tensor], torch.Tensor]:
    """The sum of per-rank partial results (dot products, basis
    projections) over ``A``'s mesh, in place, for a ``DistCsr``; the
    identity for an operand on one device."""
    if is_dist(A):
        return lambda t: allreduce_sum(t, A)
    return lambda t: t


def norms(X, A, keepdim: bool = False) -> torch.Tensor:
    """Euclidean norm of ``X`` (a vector) or of each column (a block),
    summed over the mesh for a ``DistCsr``."""
    if not is_dist(A):
        return torch.linalg.vector_norm(X, dim=0, keepdim=keepdim)
    return torch.sqrt(summed(A)((X * X).sum(dim=0, keepdim=keepdim)))


def dist_dot(a: torch.Tensor, b: torch.Tensor, dist_mat) -> torch.Tensor:
    """Global dot product of two sharded vectors (an ``all_reduce``),
    as a 0-d tensor on every rank."""
    return allreduce_sum(torch.dot(a, b), dist_mat)
