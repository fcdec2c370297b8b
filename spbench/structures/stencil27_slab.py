"""HPCG's 27-point operator on a grid whose z-planes are dealt out to ranks
in contiguous slabs (a ``1 x 1 x P`` process grid): one rank's block of
rows as triplets built on its device, with row ids local to the slab and
column ids of the whole grid.

The operator is ``stencil27``'s (diagonal 26, every neighbour -1), rows
numbered ``(z·ny + y)·nx + x`` over the whole ``nx x ny x nz`` grid; rank
``r`` of ``P`` holds planes ``[r·nz/P, (r + 1)·nz/P)``, so its rows are a
contiguous range and its columns reach ``nx·ny`` rows (a plane) past them.
"""

from __future__ import annotations

import torch

from .stencil27 import OFFSETS, _span


def planes(nz: int, rank: int, world: int):
    """``[z0, z1)``: the z-planes of ``rank``'s slab."""
    if nz % world:
        raise ValueError(f"{nz} z-planes do not split over {world} ranks")
    per = nz // world
    return rank * per, (rank + 1) * per


def _z_span(nz: int, dz: int, z0: int, z1: int):
    """The planes of ``[z0, z1)`` whose neighbour at ``+dz`` is inside the
    grid."""
    za, zb = _span(nz, dz)
    return max(za, z0), min(zb, z1)


def nnz(nx: int, ny: int, nz: int, z0: int, z1: int) -> int:
    """Stored entries of the rows of planes ``[z0, z1)``."""
    total = 0
    for dz, dy, dx in OFFSETS:
        za, zb = _z_span(nz, dz, z0, z1)
        total += max(zb - za, 0) * (ny - abs(dy)) * (nx - abs(dx))
    return total


def triplets(nx: int, ny: int, nz: int, z0: int, z1: int, *,
             dtype=torch.float64, device="cpu"):
    """``(rows, cols, vals)`` of the rows of planes ``[z0, z1)``: int32
    rows counted from the slab's first row, int32 columns of the whole
    grid, values in ``dtype``; grouped by offset, rows ascending inside
    each group."""
    count = nnz(nx, ny, nz, z0, z1)
    rows = torch.empty(count, dtype=torch.int32, device=device)
    cols = torch.empty(count, dtype=torch.int32, device=device)
    vals = torch.full((count,), -1.0, dtype=dtype, device=device)
    plane = nx * ny
    at = 0
    for dz, dy, dx in OFFSETS:
        za, zb = _z_span(nz, dz, z0, z1)
        ya, yb = _span(ny, dy)
        xa, xb = _span(nx, dx)
        if zb <= za:
            continue
        ids = ((torch.arange(za - z0, zb - z0, dtype=torch.int32,
                             device=device).view(-1, 1, 1) * plane)
               + torch.arange(ya, yb, dtype=torch.int32, device=device)
               .view(1, -1, 1) * nx
               + torch.arange(xa, xb, dtype=torch.int32, device=device)
               .view(1, 1, -1)).reshape(-1)
        m = ids.numel()
        rows[at:at + m] = ids
        cols[at:at + m] = ids + (z0 * plane + dz * plane + dy * nx + dx)
        if (dz, dy, dx) == (0, 0, 0):
            vals[at:at + m] = 26.0
        at += m
    assert at == count
    return rows, cols, vals
