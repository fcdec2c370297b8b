"""Conjugate gradients, the canonical SpMV consumer (counterpart of
``spalinalg_tpu/linalg/cg.py``).

The JAX package runs the whole iteration inside one ``lax.while_loop``
with the convergence test on the device; here the loop is Python and the
test reads ``r·r`` back each iteration (one synchronisation with the card
a step), with the same test (``r·r > tol²``, in the vectors' dtype) and so
the same iteration count. Every ``A @ v`` is the operand's own product:
on a ``CsrMatrix`` the CSR SpMV kernel, on a ``BsrMatrix`` the BSR one.
The preconditioner's set-up (the Jacobi diagonal, rebuilt on every call)
is the span ``spal.precond``, with device time (``utils/profiling.py``).

On a row-partitioned :class:`~spalinalg_tpu_torch.parallel.DistCsr` the
vectors are this rank's padded slices (``shard_vector``), each product is
``dist_spmv`` (one CSR SpMV kernel launch and its collectives) and the
dot products are summed over the mesh, ``r·z`` and ``r·r`` in one
``all_reduce``, so every rank takes the same steps.

Examples
--------
>>> import torch
>>> from spalinalg_tpu_torch import CsrMatrix
>>> A = CsrMatrix(2, 2, [0, 2, 4], [0, 1, 0, 1], [4.0, 1.0, 1.0, 3.0],
...               device="cpu")
>>> res = cg(A, torch.tensor([1.0, 2.0], dtype=torch.float64), tol=1e-10)
>>> bool(res.residual < 1e-10), res.iterations
(True, 2)
>>> [round(float(v), 6) for v in res.x]
[0.090909, 0.636364]
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from ..device import resolve_device
from ..ops.reduce_api import diagonal
from ..parallel.spmv import is_dist, summed
from ..utils.profiling import annotate

__all__ = ["cg", "CgResult"]


class CgResult(NamedTuple):
    x: torch.Tensor
    iterations: int         # CG steps taken
    residual: torch.Tensor  # final ||r|| of the recurrence (0-d)


def _vector(v, A) -> torch.Tensor:
    """``v`` as a tensor on the operand's device (a NumPy array or a
    tensor elsewhere is placed there); an operand with no device (a bare
    ``@`` object) takes the default device (``device.py``)."""
    if isinstance(v, torch.Tensor) and not hasattr(A, "device"):
        return v
    dev = A.device if hasattr(A, "device") else resolve_device()
    return torch.as_tensor(v, device=dev)


def _dots(A):
    """``pairs -> [u·v for each pair]``: global dot products, those of one
    call summed over ``A``'s mesh in one ``all_reduce`` for a
    ``DistCsr``."""
    if not is_dist(A):
        return lambda pairs: [torch.dot(u, v) for u, v in pairs]
    total = summed(A)
    return lambda pairs: total(torch.stack(
        [torch.dot(u, v) for u, v in pairs])).unbind()


def _cg_loop(matvec, b, x0, tol, maxiter, psolve, dots) -> CgResult:
    """(Preconditioned) CG; stops when ``r·r <= tol²`` or after
    ``maxiter`` steps. ``dots`` is :func:`_dots` of the operand."""
    psolve = psolve if psolve is not None else (lambda r: r)
    x = x0
    r = b - matvec(x)
    z = psolve(r)
    p = z
    rz, rr = dots([(r, z), (r, r)])
    k = 0
    while k < maxiter and bool(rr > tol * tol):
        ap = matvec(p)
        (pap,) = dots([(p, ap)])
        alpha = rz / pap
        x = x + alpha * p
        r = r - alpha * ap
        z = psolve(r)
        rz_new, rr = dots([(r, z), (r, r)])
        p = z + (rz_new / rz) * p
        rz = rz_new
        k += 1
    return CgResult(x=x, iterations=k, residual=torch.sqrt(rr))


def _jacobi_precond(A) -> Callable[[torch.Tensor], torch.Tensor]:
    """Inverse-diagonal preconditioner of a CSR/BSR matrix, or of this
    rank's rows of a ``DistCsr``, built on its device (a zero or missing
    diagonal entry counts as 1)."""
    if is_dist(A):
        rows = A.brow.long()
        on_diag = (A.colind.long() == rows + A.rank * A.rows_per_shard) & (
            rows < A.rows_per_shard)
        d = torch.ones(A.rows_per_shard, dtype=A.dtype, device=A.device)
        d[rows[on_diag]] = A.values[on_diag]
    else:
        d = diagonal(A.to_csr() if hasattr(A, "to_csr") else A)
    inv = torch.where(d != 0, 1 / torch.where(d != 0, d, 1), 1)
    return lambda r: inv * r


def resolve_precond(M, A, *, jacobi: bool = True, error=ValueError):
    """``M`` as a callable ``r -> M⁻¹r``: None stays None, ``"jacobi"``
    (where ``jacobi``) builds :func:`_jacobi_precond` of ``A``, an object
    with ``.solve`` gives that method (on a ``DistCsr`` only where it
    ``supports_dist``), a callable itself; anything else raises ``error``
    (the JAX package's type: ``ValueError`` from the Krylov solvers,
    ``TypeError`` from ``lobpcg``)."""
    if M is None:
        return None
    if jacobi and isinstance(M, str) and M == "jacobi":
        return _jacobi_precond(A)
    if hasattr(M, "solve"):
        if is_dist(A) and not getattr(M, "supports_dist", False):
            raise ValueError(
                "this preconditioner is single-chip; build it on the "
                "DistCsr operand (chebyshev) or pass a sharding-aware "
                "callable")
        return M.solve
    if callable(M):
        return M
    names = "'jacobi', a callable" if jacobi else "a callable"
    raise error(f"a preconditioner must be {names} or an object with "
                f".solve, got {M!r}")


def cg(
    A,
    b,
    x0=None,
    *,
    tol: float = 1e-10,
    maxiter: Optional[int] = None,
    precondition=None,
) -> CgResult:
    """Solve SPD ``A x = b`` by (optionally preconditioned) CG.

    ``A``: a ``CsrMatrix``, ``BsrMatrix`` or anything with ``@`` and
    ``ncols``; or a ``DistCsr``, when ``b`` (and ``x0``) are this rank's
    padded slices and so is the result. ``b`` and ``x0`` are placed on
    ``A``'s device. ``tol`` is absolute on ``||r||``; ``maxiter`` defaults
    to ``10·n``. ``precondition``: ``"jacobi"``, a callable ``r ->
    M⁻¹r``, or an object with a ``.solve`` method (:func:`~.precond.ic0`,
    :func:`~.precond.chebyshev`; on a ``DistCsr`` only a Chebyshev
    preconditioner built on it).
    """
    b = _vector(b, A)
    n = A.nrows if is_dist(A) else A.ncols
    maxiter = maxiter if maxiter is not None else 10 * n
    if x0 is not None:
        x0 = _vector(x0, A)
    elif is_dist(A):
        x0 = torch.zeros_like(b)
    else:
        x0 = torch.zeros(n, dtype=b.dtype, device=b.device)
    with annotate("spal.precond", device=b.device):
        psolve = resolve_precond(precondition, A)
    with torch.no_grad():
        return _cg_loop(lambda v: A @ v, b, x0, tol, maxiter, psolve,
                        _dots(A))
