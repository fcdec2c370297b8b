"""The plain reference of the ``cg`` loop: Jacobi-preconditioned CG in
plain PyTorch on the stencil operator applied without a matrix.

It imports nothing of the program: the operator is the 27-point formula
(``structures/stencil27.apply``) and the Jacobi scaling its diagonal, 26,
on every row. The recurrence is the textbook one, run for exactly
``maxiter`` steps.
"""

from __future__ import annotations

import torch

from ..structures import stencil27

DIAGONAL = 26.0


def solve(b: torch.Tensor, grid, maxiter: int, dtype=None):
    """``(x, ||r||)`` after ``maxiter`` Jacobi-CG steps from ``x0 = 0`` on
    ``A x = b``, ``A`` the 27-point operator of ``grid = (nx, ny, nz)``,
    computed in ``dtype`` (default: ``b``'s)."""
    nx, ny, nz = grid
    b = b.to(dtype or b.dtype)
    inv = 1.0 / DIAGONAL

    def apply(v):
        return stencil27.apply(v, nx, ny, nz)

    x = torch.zeros_like(b)
    r = b - apply(x)
    z = inv * r
    p = z
    rz = torch.dot(r, z)
    rr = torch.dot(r, r)
    for _ in range(maxiter):
        ap = apply(p)
        alpha = rz / torch.dot(p, ap)
        x = x + alpha * p
        r = r - alpha * ap
        z = inv * r
        rz_new = torch.dot(r, z)
        rr = torch.dot(r, r)
        p = z + (rz_new / rz) * p
        rz = rz_new
    return x, torch.sqrt(rr)
