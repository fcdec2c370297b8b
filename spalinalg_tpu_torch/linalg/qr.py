"""Sparse QR and least squares (counterpart of
``spalinalg_tpu/linalg/qr.py``).

The factorization is the corrected seminormal equations form (Björck
1987), as in the JAX package:

1. ``AᵀA`` through the SpGEMM tier (one structure plan on the host, the
   SpGEMM numeric kernel on the card);
2. ``AᵀA = RᵀR`` through the sparse Cholesky (:mod:`.cholesky`): the same
   ``R`` as in ``A = QR``;
3. ``Q`` stays implicit: ``Qᵀb = R (AᵀA)⁻¹ Aᵀb`` and ``Qy = A R⁻¹ y`` are
   applied through SpMV (SpMM for several right-hand sides) and the
   factor's triangular sweeps.

Least-squares solves run ``refine`` steps of refinement on the seminormal
equations (``RᵀR dx = Aᵀ(b - Ax)``); one step gives QR-grade accuracy on
well-scaled systems. ``method="dense"`` is Householder QR
(``torch.linalg.qr``) of the densified matrix.

:func:`qr_r_dense` densifies the ``n x n`` Gram matrix, and
:func:`qr_qt_apply` calls it on every call on the sparse path: keep that
to small ``n``.

Examples
--------
>>> import torch
>>> from spalinalg_tpu_torch import CooMatrix, CsrMatrix
>>> A = CsrMatrix.from_coo(CooMatrix.with_entries(4, 2, [
...     (0, 0, 1.0), (1, 0, 1.0), (1, 1, 1.0),
...     (2, 1, 2.0), (3, 0, 3.0)]), device="cpu")
>>> b = torch.tensor([1.0, 2.0, 2.0, 3.0], dtype=torch.float64)
>>> x = lstsq(A, b)
>>> ref = torch.linalg.lstsq(A.to_dense(), b[:, None]).solution[:, 0]
>>> bool(torch.allclose(x, ref))
True
>>> fac = qr(A)
>>> fac.shape
(4, 2)
>>> r = qr_r_dense(fac)                  # R of A = QR (up to signs)
>>> bool(torch.allclose(r.abs(), torch.linalg.qr(A.to_dense())[1].abs()))
True
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from ..errors import ShapeError
from .cholesky import CholeskyFactor, cholesky, cholesky_solve

__all__ = ["QrFactor", "qr", "qr_solve", "qr_q_apply", "qr_qt_apply",
           "qr_r_dense", "lstsq"]


@dataclass(frozen=True, eq=False)
class QrFactor:
    """Implicit sparse QR: ``R`` held as the Cholesky factor of ``AᵀA``.

    ``a`` is kept (no copy) because the implicit ``Q = A R⁻¹`` is applied
    through it; ``gram`` (the sparse ``AᵀA``) for an explicit ``R`` on
    request.
    """

    m: int
    n: int
    a: object                                # CsrMatrix (or format peer)
    chol: Optional[CholeskyFactor]           # RᵀR = AᵀA  (sparse path)
    at: Optional[object] = None              # cached Aᵀ (plan reuse)
    gram: Optional[object] = None            # sparse AᵀA
    dense_q: Optional[torch.Tensor] = None   # dense fallback factors
    dense_r: Optional[torch.Tensor] = None

    @property
    def shape(self):
        return (self.m, self.n)

    @property
    def is_dense(self) -> bool:
        return self.dense_r is not None


def qr(a, *, method: str = "auto", dense_threshold: int = 1024) -> QrFactor:
    """Factor ``A = QR`` (``m >= n``) with implicit ``Q``, on the matrix's
    device.

    ``method``: ``"auto"`` takes the sparse seminormal path above
    ``dense_threshold`` columns and dense Householder at or below it;
    ``"sparse"`` / ``"dense"`` force a path. Raises :class:`ShapeError`
    for ``m < n`` (factor ``Aᵀ`` for minimum-norm solves).
    """
    m, n = a.shape
    if m < n:
        raise ShapeError(
            f"qr needs m >= n, got {m}x{n}; factor the transpose for "
            f"minimum-norm underdetermined solves"
        )
    if method not in ("auto", "sparse", "dense"):
        raise ValueError(f"unknown qr method {method!r}")
    if method == "dense" or (method == "auto" and n <= dense_threshold):
        with torch.no_grad():
            q, r = torch.linalg.qr(a.to_dense(), mode="reduced")
        return QrFactor(m=m, n=n, a=a, chol=None, dense_q=q, dense_r=r)
    at = a.transpose()
    gram = at * a                            # SpGEMM tier (ops/spgemm.py)
    return QrFactor(m=m, n=n, a=a, chol=cholesky(gram), at=at, gram=gram)


def _operand(fac: QrFactor, b) -> torch.Tensor:
    """``b`` on the matrix's device; in the dense factors' dtype on the
    dense path (the sparse products promote it themselves)."""
    b = torch.as_tensor(b, device=fac.a.device)
    return b.to(fac.dense_r.dtype) if fac.is_dense else b


def _chol_solve(fac: CholeskyFactor, b: torch.Tensor) -> torch.Tensor:
    """``(RᵀR)⁻¹ b`` for 1-D or column-stacked 2-D ``b``."""
    if b.ndim == 1:
        return cholesky_solve(fac, b)
    return torch.stack([cholesky_solve(fac, b[:, j])
                        for j in range(b.shape[1])], dim=1)


def qr_r_dense(fac: QrFactor) -> torch.Tensor:
    """The ``n x n`` upper-triangular ``R`` of ``A = QR`` (dense, on the
    device).

    Sparse path: one dense Cholesky of the kept sparse Gram matrix,
    ``R = chol(AᵀA)ᵀ``, unique given a positive diagonal; ``O(n²)``
    memory, made only on request.
    """
    if fac.is_dense:
        return fac.dense_r
    with torch.no_grad():
        return torch.linalg.cholesky(fac.gram.to_dense()).mT


def qr_qt_apply(fac: QrFactor, b) -> torch.Tensor:
    """``Qᵀ b``, the projection coefficients, of shape ``(n,)`` or
    ``(n, k)``.

    Sparse path: ``Qᵀb = R (RᵀR)⁻¹ Aᵀb`` (one SpMV or SpMM, the factor's
    solves, one dense triangular product)."""
    b = _operand(fac, b)
    if fac.is_dense:
        return fac.dense_q.mT @ b
    x = _chol_solve(fac.chol, fac.at @ b)
    return qr_r_dense(fac) @ x


def qr_q_apply(fac: QrFactor, y) -> torch.Tensor:
    """``Q y`` for coefficients ``y`` of shape ``(n,)`` / ``(n, k)``: an
    ``(m,)`` / ``(m, k)`` result."""
    y = _operand(fac, y)
    if fac.is_dense:
        return fac.dense_q @ y
    rhs = y.unsqueeze(-1) if y.ndim == 1 else y
    x = torch.linalg.solve_triangular(qr_r_dense(fac), rhs.to(fac.a.dtype),
                                      upper=True)                 # R⁻¹ y
    return fac.a @ (x[:, 0] if y.ndim == 1 else x)


def qr_solve(fac: QrFactor, b, *, refine: int = 1) -> torch.Tensor:
    """Least-squares solve ``min ||Ax - b||₂`` from a :func:`qr` factor.

    ``refine`` steps of corrected seminormal refinement (``RᵀR dx =
    Aᵀ(b - Ax)``, two SpMVs each) on the sparse path; the dense path
    solves ``Rx = Qᵀb`` directly.
    """
    b = _operand(fac, b)
    if fac.is_dense:
        rhs = fac.dense_q.mT @ b
        x = torch.linalg.solve_triangular(
            fac.dense_r, rhs.unsqueeze(-1) if b.ndim == 1 else rhs,
            upper=True)
        return x[:, 0] if b.ndim == 1 else x
    at = fac.at
    x = _chol_solve(fac.chol, at @ b)
    for _ in range(max(0, refine)):
        resid = b - fac.a @ x
        x = x + _chol_solve(fac.chol, at @ resid)
    return x


def lstsq(a, b, *, refine: int = 1) -> torch.Tensor:
    """One-shot least squares: ``qr_solve(qr(a), b)``."""
    return qr_solve(qr(a), b, refine=refine)
