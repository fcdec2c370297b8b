"""The plain reference of the ``cg_dist`` loop: Jacobi-preconditioned CG in
plain PyTorch on the whole grid's stencil operator, applied without a
matrix and without ranks.

It imports nothing of the program: each answer is ``cg_ref.solve`` (the
27-point formula, the Jacobi scaling by its diagonal 26, the textbook
recurrence for exactly ``maxiter`` steps) on the global grid, however many
ranks the program's run was dealt out to.
"""

from __future__ import annotations

from . import cg_ref


def reference(bs, picks, grid, maxiter: int, dtype=None):
    """``(x, ||r||, maxiter)`` of the whole grid's Jacobi-CG for each of the
    global right-hand sides ``bs[j]``, ``j`` in ``picks``, computed in
    ``dtype`` (default: the right-hand side's)."""
    out = []
    for j in picks:
        x, r = cg_ref.solve(bs[j], tuple(grid), maxiter, dtype)
        out.append((x, r, maxiter))
    return out
