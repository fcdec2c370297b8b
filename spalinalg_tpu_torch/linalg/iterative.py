"""Krylov solvers for general square systems: GMRES and BiCGSTAB
(counterpart of ``spalinalg_tpu/linalg/iterative.py``).

Together with :mod:`.cg` they cover the standard Krylov triangle: CG for
SPD, restarted GMRES(m) for general nonsymmetric systems, BiCGSTAB at two
SpMV a step and constant memory.

- GMRES keeps the Krylov basis as one dense ``(m+1, n)`` tensor; the
  Arnoldi step orthogonalises against the whole basis twice (rows past
  the current step are zero), so it needs no read back. The small
  ``(m+1) x m`` least-squares problem of a cycle is solved on the host in
  float64 with an SVD-based solver, which takes the rank-deficient
  Hessenberg matrix of a happy breakdown: one read back a cycle.
- BiCGSTAB is a vector recurrence; its convergence test reads ``||r||``
  back each step.

On a row-partitioned :class:`~spalinalg_tpu_torch.parallel.DistCsr` the
vectors are this rank's padded slices, each product is ``dist_spmv`` and
each reduction (dot products, the basis projections ``V @ w``) an
``all_reduce`` over the mesh; the host least-squares solve sees the same
numbers on every rank.

The stopping tests are the JAX package's (``||r|| > max(tol·||b||,
tol)``, in the vectors' dtype), so both packages take the same number of
steps. ``iterations`` counts matvecs, as there.

Examples
--------
>>> import torch
>>> from spalinalg_tpu_torch import CsrMatrix
>>> A = CsrMatrix(2, 2, [0, 2, 4], [0, 1, 0, 1], [4.0, 1.0, -1.0, 3.0],
...               device="cpu")
>>> b = torch.tensor([1.0, 2.0], dtype=torch.float64)
>>> [round(float(v), 6) for v in gmres(A, b, tol=1e-10).x]
[0.076923, 0.692308]
>>> bool(bicgstab(A, b, tol=1e-10).residual < 1e-8)
True
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..parallel.spmv import is_dist, summed
from .cg import _vector, resolve_precond

__all__ = ["gmres", "bicgstab", "IterResult"]


class IterResult(NamedTuple):
    x: torch.Tensor
    iterations: int         # matvec count
    residual: torch.Tensor  # final ||r|| (0-d)


def _setup(A, b, x0, maxiter, tol):
    """``(b, x, maxiter, atol, total, dot)``: ``total`` sums per-rank
    partial results (:func:`~spalinalg_tpu_torch.parallel.spmv.summed`), ``dot`` is the global dot
    product."""
    b = _vector(b, A)
    total = summed(A)

    def dot(u, v):
        return total(torch.dot(u, v))

    if is_dist(A):
        n = A.nrows
        x = torch.zeros_like(b) if x0 is None else _vector(x0, A)
    else:
        n = A.ncols
        x = (torch.zeros(n, dtype=b.dtype, device=b.device) if x0 is None
             else _vector(x0, A))
    maxiter = maxiter if maxiter is not None else 10 * n
    bnorm = torch.sqrt(dot(b, b))
    atol = torch.maximum(tol * bnorm, torch.tensor(tol, dtype=b.dtype,
                                                   device=b.device))
    return b, x, maxiter, atol, total, dot


def gmres(
    A,
    b,
    x0=None,
    *,
    tol: float = 1e-8,
    restart: int = 32,
    maxiter: Optional[int] = None,
    M=None,
) -> IterResult:
    """Restarted GMRES(m) for a general square system ``A x = b``.

    ``restart`` is the cycle length m (basis memory ``(m+1)·n``);
    ``maxiter`` bounds the matvec count (default ``10·n``). ``M``
    right-preconditions (``A M⁻¹ u = b``, ``x = M⁻¹u``; the reported
    residual stays the true one): a callable ``r -> M⁻¹r`` or an object
    with ``.solve`` (:func:`~.precond.ilu0`).
    """
    b, x, maxiter, atol, total, dot = _setup(A, b, x0, maxiter, tol)
    psolve = resolve_precond(M, A, jacobi=False)

    def norm(v):
        return torch.sqrt(dot(v, v))

    def matvec(v):
        return A @ v

    def inner_matvec(v):
        return matvec(psolve(v)) if psolve is not None else matvec(v)

    m = max(1, min(int(restart), maxiter))
    dtype = b.dtype

    def cycle(x):
        """One restart cycle: m Arnoldi steps and the small LS solve."""
        r = b - matvec(x)
        beta = norm(r)
        V = torch.zeros((m + 1,) + tuple(r.shape), dtype=dtype,
                        device=r.device)
        H = torch.zeros((m + 1, m), dtype=dtype, device=r.device)
        V[0] = torch.where(beta > 0, 1.0 / torch.clamp(beta, min=1e-300),
                           0.0) * r
        for i in range(m):
            w = inner_matvec(V[i])
            # rows > i of V are zero: full-basis products suffice; one
            # re-orthogonalisation pass (classical Gram-Schmidt twice)
            h = total(V @ w)
            w = w - V.T @ h
            h2 = total(V @ w)
            w = w - V.T @ h2
            wnorm = norm(w)
            H[:, i] = h + h2
            H[i + 1, i] = wnorm
            V[i + 1] = torch.where(wnorm > 1e-300,
                                   1.0 / torch.clamp(wnorm, min=1e-300),
                                   0.0) * w
        # min_y || beta e1 - H y ||, rank-deficient after a breakdown
        e1 = np.zeros(m + 1)
        e1[0] = float(beta)
        y = np.linalg.lstsq(H.cpu().double().numpy(), e1, rcond=None)[0]
        corr = torch.as_tensor(y, dtype=dtype, device=r.device) @ V[:m]
        if psolve is not None:
            corr = psolve(corr)           # right precond: x += M⁻¹ V y
        return x + corr

    with torch.no_grad():
        res = norm(b - matvec(x))
        it = 0
        while bool(res > atol) and it < maxiter:
            x = cycle(x)
            res = norm(b - matvec(x))
            it += m + 1
    return IterResult(x=x, iterations=it, residual=res)


def bicgstab(
    A,
    b,
    x0=None,
    *,
    tol: float = 1e-8,
    maxiter: Optional[int] = None,
    M=None,
) -> IterResult:
    """BiCGSTAB for a general square system (two SpMV a step). ``M``
    right-preconditions (the reported residual stays the true one): a
    callable or an object with ``.solve`` (:func:`~.precond.ilu0`)."""
    b, x, maxiter, atol, _, dot = _setup(A, b, x0, maxiter, tol)
    psolve = resolve_precond(M, A, jacobi=False) or (lambda r: r)
    dtype = b.dtype
    # 1e-300 in the vectors' dtype (0 in float32, as in the JAX package)
    eps = torch.tensor(1e-300, dtype=dtype, device=b.device)

    def nonzero(d):
        return torch.where(torch.abs(d) > 0, d, eps)

    with torch.no_grad():
        r = b - (A @ x)
        rhat = r
        p = v = torch.zeros_like(b)
        rho = alpha = omega = torch.ones((), dtype=dtype, device=b.device)
        res = torch.sqrt(dot(r, r))
        it = 0
        while bool(res > atol) and it < maxiter:
            rho_new = dot(rhat, r)
            beta = (rho_new / nonzero(rho)) * (alpha / nonzero(omega))
            p = r + beta * (p - omega * v)
            phat = psolve(p)
            v = A @ phat
            alpha = rho_new / nonzero(dot(rhat, v))
            s = r - alpha * v
            shat = psolve(s)
            t = A @ shat
            omega = dot(t, s) / nonzero(dot(t, t))
            x = x + alpha * phat + omega * shat
            r = s - omega * t
            res = torch.sqrt(dot(r, r))
            rho = rho_new
            it += 2
    return IterResult(x=x, iterations=it, residual=res)
