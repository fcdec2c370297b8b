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
``all_reduce``, so every rank takes the same steps. There the loop runs
``AHEAD`` steps ahead of its test (:func:`_cg_loop`'s ``ahead``): each
read-back of ``r·r`` waits for the slowest rank's host, and the cards keep
the next steps' work meanwhile.

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

from collections import deque
from typing import Callable, NamedTuple, Optional

import torch

from ..device import resolve_device
from ..formats.bsr import BsrMatrix
from ..ops.kernels.diagonal import diagonal as stored_diagonal
from ..ops.reduce_api import _diagonal
from ..parallel.spmv import is_dist, summed
from ..utils.profiling import annotate

__all__ = ["cg", "CgResult"]


# Steps a CG on a DistCsr runs ahead of its convergence test: two steps of
# card work (about 8.6 ms a step pair at 256^3 a rank in f64 on H100s)
# cover a host that is late by more than one step's worth.
AHEAD = 2


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


def _above(rr: torch.Tensor, tol: float, now: bool) -> Callable[[], bool]:
    """``r·r > tol²`` as a callable that reads it. With ``now`` the test
    is enqueued here, behind ``rr``, and copied to pinned host memory on
    ``rr``'s card, so that reading it waits for ``rr`` alone and not for
    the work enqueued since; else it is enqueued when read. The copy and
    its event go on ``rr``'s card's stream, whichever card is current."""
    if not now:
        return lambda: bool(rr > tol * tol)
    flag = rr > tol * tol
    if not flag.is_cuda:
        return lambda: bool(flag)
    host = torch.empty((), dtype=torch.bool, pin_memory=True)
    host.copy_(flag, non_blocking=True)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(flag.device))

    def read() -> bool:
        done.synchronize()
        return bool(host)
    return read


def _cg_loop(matvec, b, x0, tol, maxiter, psolve, dots,
             ahead: int = 0) -> CgResult:
    """(Preconditioned) CG; stops when ``r·r <= tol²`` or after
    ``maxiter`` steps. ``dots`` is :func:`_dots` of the operand.

    With ``ahead`` > 0, up to ``ahead`` steps are enqueued past the last
    step whose test has been read, so the cards keep that much work queued
    while the hosts wait on ``r·r``: on a mesh every read-back waits for
    the slowest rank's host, and each step's halo exchange and product are
    host work the cards would otherwise idle through. Steps past the one
    the test stops at are dropped: the same answer and iteration count, at
    most ``ahead`` products more.

    :func:`cg` runs ahead on a ``DistCsr`` alone. On one card no peer's
    host holds the read-back, and running ahead there is not measured
    yet: it would add up to ``ahead`` products to every solve stopped by
    its tolerance, and a one-card solve stays at one product a step and
    one for the first residual."""
    psolve = psolve if psolve is not None else (lambda r: r)
    x = x0
    r = b - matvec(x)
    z = psolve(r)
    p = z
    rz, rr = dots([(r, z), (r, r)])
    # (x, rr, its test) after each step enqueued and not yet known taken
    steps = deque([(x, rr, _above(rr, tol, ahead > 0))])
    k = 0
    while True:
        while len(steps) <= ahead and k + len(steps) <= maxiter:
            ap = matvec(p)
            (pap,) = dots([(p, ap)])
            alpha = rz / pap
            x = x + alpha * p
            r = r - alpha * ap
            z = psolve(r)
            rz_next, rr = dots([(r, z), (r, r)])
            steps.append((x, rr, _above(rr, tol, ahead > 0)))
            p = z + (rz_next / rz) * p
            rz = rz_next
        x_k, rr_k, going = steps.popleft()
        if k == maxiter or not going():
            return CgResult(x=x_k, iterations=k, residual=torch.sqrt(rr_k))
        k += 1


def _jacobi_precond(A) -> Callable[[torch.Tensor], torch.Tensor]:
    """Inverse-diagonal preconditioner of a CSR/BSR matrix, or of this
    rank's rows of a ``DistCsr``, built on its device (a zero or missing
    diagonal entry counts as 1). A ``BsrMatrix``, or what another
    operand's ``to_csr`` hands back, gives its diagonal from its own
    blocks (``ops/reduce_api.py::diagonal``). On the card the diagonal
    and its inverse are one kernel launch (``ops/kernels/diagonal.py``);
    a ``DistCsr``'s rows, whose columns are global ids, read the diagonal
    ``k = rank·rows_per_shard`` of its shard."""
    if is_dist(A):
        inv = stored_diagonal(A.rowptr, A.colind, A.values, A.rows_per_shard,
                              k=A.rank * A.rows_per_shard, invert=True)
    else:
        if hasattr(A, "to_csr") and not isinstance(A, BsrMatrix):
            A = A.to_csr()         # a BsrMatrix keeps its blocks
        inv = _diagonal(A, invert=True)
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
                        _dots(A), ahead=AHEAD if is_dist(A) else 0)
