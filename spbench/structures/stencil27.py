"""HPCG's operator: the 27-point stencil on a 3-D grid, diagonal 26 and
every neighbour -1 (HPCG 3.1, ``GenerateProblem``), as triplets built on
the device, and the same operator applied without a matrix (the plain
reference's product).

Rows are numbered ``(z·ny + y)·nx + x``.
"""

from __future__ import annotations

import itertools

import torch
import torch.nn.functional as F

OFFSETS = tuple(itertools.product((-1, 0, 1), repeat=3))   # (dz, dy, dx)


def _span(n: int, d: int):
    """``[a, b)``: the coordinates whose neighbour at ``+d`` lies inside
    ``[0, n)``."""
    return max(0, -d), min(n, n - d)


def nnz(nx: int, ny: int, nz: int) -> int:
    """Stored entries of the operator."""
    return sum((nz - abs(dz)) * (ny - abs(dy)) * (nx - abs(dx))
               for dz, dy, dx in OFFSETS)


def triplets(nx: int, ny: int, nz: int, *, dtype=torch.float64,
             device="cpu"):
    """``(rows, cols, vals)``: int32 rows and columns, values in ``dtype``;
    grouped by offset, rows ascending inside each group."""
    count = nnz(nx, ny, nz)
    rows = torch.empty(count, dtype=torch.int32, device=device)
    cols = torch.empty(count, dtype=torch.int32, device=device)
    vals = torch.full((count,), -1.0, dtype=dtype, device=device)
    plane = nx * ny
    at = 0
    for dz, dy, dx in OFFSETS:
        za, zb = _span(nz, dz)
        ya, yb = _span(ny, dy)
        xa, xb = _span(nx, dx)
        if zb <= za:
            continue
        ids = ((torch.arange(za, zb, dtype=torch.int32, device=device)
                .view(-1, 1, 1) * plane)
               + torch.arange(ya, yb, dtype=torch.int32, device=device)
               .view(1, -1, 1) * nx
               + torch.arange(xa, xb, dtype=torch.int32, device=device)
               .view(1, 1, -1)).reshape(-1)
        m = ids.numel()
        rows[at:at + m] = ids
        cols[at:at + m] = ids + (dz * plane + dy * nx + dx)
        if (dz, dy, dx) == (0, 0, 0):
            vals[at:at + m] = 26.0
        at += m
    assert at == count
    return rows, cols, vals


def apply(x: torch.Tensor, nx: int, ny: int, nz: int) -> torch.Tensor:
    """``A @ x`` of the whole grid's operator without a matrix: ``27·x``
    less the sum of each point's 3 x 3 x 3 box, zero outside the grid."""
    g = F.pad(x.view(nz, ny, nx), (1, 1, 1, 1, 1, 1))
    s = g[:, :, :-2] + g[:, :, 1:-1] + g[:, :, 2:]
    s = s[:, :-2] + s[:, 1:-1] + s[:, 2:]
    s = s[:-2] + s[1:-1] + s[2:]
    return (27 * x.view(nz, ny, nx) - s).reshape(-1)
