"""Krylov matrix functions: ``expm_multiply``, the action of the matrix
exponential (counterpart of ``spalinalg_tpu/linalg/funm.py``).

``exp(tA) b`` is approximated on an m-dimensional Krylov space: one
Arnoldi sweep (full-basis classical Gram-Schmidt, as ``gmres``'s), then a
small dense exponential (``torch.linalg.matrix_exp``) of the projected
``(m, m)`` Hessenberg matrix on the device:

    exp(tA) b  ≈  β · V_mᵀ · expm(t H_m) e₁,   β = ||b||.

The SpMVs dominate: one ``A @ v`` a step, the CSR SpMV kernel on the card
for a CSR operand. The loop is a Python loop of ``m`` steps with no read
back; a breakdown (a zero new direction) is guarded by ``1e-300`` floors,
as in the JAX package, not by a test on the host. On a row-partitioned
``DistCsr`` the vectors are this rank's padded slices and the norms and
basis projections are summed over the mesh (``all_reduce``).

Examples
--------
>>> import torch
>>> from spalinalg_tpu_torch import CooMatrix, CsrMatrix
>>> n = 16
>>> ent = [(i, i, -2.0) for i in range(n)]
>>> ent += [(i, (i + 1) % n, 1.0) for i in range(n)]
>>> ent += [((i + 1) % n, i, 1.0) for i in range(n)]
>>> L = CsrMatrix.from_coo(CooMatrix.with_entries(n, n, ent), device="cpu")
>>> b = torch.zeros(n, dtype=torch.float64); b[n // 2] = 1.0
>>> u = expm_multiply(L, b, t=0.5)
>>> bool(abs(float(u.sum()) - 1.0) < 1e-8)    # mass conserved
True
>>> bool(float(u[n // 2]) < 1.0)               # spike diffused
True
"""

from __future__ import annotations

from typing import Optional

import torch

from ..device import resolve_device
from ..errors import ShapeError
from ..parallel.spmv import norms, summed

__all__ = ["expm_multiply", "arnoldi"]


def _operand(A, v) -> torch.Tensor:
    """``v`` as a tensor on ``A``'s device (the scoped default where ``A``
    names none)."""
    return torch.as_tensor(v, device=resolve_device(getattr(A, "device",
                                                            None)))


def arnoldi(A, v0, m: int):
    """``m``-step Arnoldi: ``(V, H)`` with ``V`` ((m+1, n)) orthonormal and
    ``H`` ((m+1, m)) upper Hessenberg, ``A V_mᵀ = Vᵀ H``.

    Full-basis classical Gram-Schmidt with one re-orthogonalisation pass
    (rows not yet filled are zero, so the unmasked products are exact):
    two GEMVs a step.
    """
    v0 = _operand(A, v0)
    dtype = v0.dtype
    total = summed(A)
    with torch.no_grad():
        beta = norms(v0, A)
        V = v0.new_zeros((m + 1,) + tuple(v0.shape))
        V[0] = v0 / beta.clamp_min(1e-300)
        H = v0.new_zeros((m + 1, m))
        for i in range(m):
            w = (A @ V[i]).to(dtype)
            h = total(V @ w)
            w = w - V.mT @ h
            h2 = total(V @ w)
            w = w - V.mT @ h2
            h = h + h2
            wnorm = norms(w, A)
            H[:, i] = h
            H[i + 1, i] = wnorm
            V[i + 1] = (torch.where(wnorm > 1e-300, 1.0, 0.0).to(dtype) * w
                        / wnorm.clamp_min(1e-300))
    return V, H


def expm_multiply(A, b, *, t: float = 1.0, m: Optional[int] = None
                  ) -> torch.Tensor:
    """``exp(t A) @ b`` through an m-dimensional Krylov projection.

    ``m`` defaults to ``min(n, 32)``; raise it when ``||tA||`` is large
    (``m`` of about ``||tA||`` or more, or split ``t`` into steps). Any
    square operand with ``A @ v`` works, a ``DistCsr`` with ``b`` this
    rank's padded slice (``shard_vector``; the result is sliced alike).
    """
    b = _operand(A, b)
    n = A.shape[0]
    if A.shape[0] != A.shape[1]:
        raise ShapeError(f"expm_multiply needs a square operator, "
                         f"got {A.shape}")
    m = int(m) if m is not None else min(n, 32)
    with torch.no_grad():
        beta = norms(b, A)
        V, H = arnoldi(A, b, m)
        Hm = H[:m, :m] * t
        y = torch.linalg.matrix_exp(Hm)[:, 0]     # expm(t H_m) e₁
        return beta * (V[:m].mT @ y)
