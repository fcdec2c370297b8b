"""Blocked banded factorizations (counterpart of
``spalinalg_tpu/linalg/banded.py``).

After a bandwidth-reducing ordering (RCM, :mod:`.ordering`), a banded
matrix of half-bandwidth ``b`` factors panel by panel: each step is a
dense ``nb x nb`` Cholesky (or unpivoted LU) of the diagonal block, a
triangular solve of the ``b x nb`` sub-panel and a ``b x b`` Schur
update, all dense products on the matrix's device, so the sequential
depth is ``n / nb`` rather than ``n``.

Window invariant: when panel columns ``[j, j + nb)`` are factored, every
entry they touch lies in the ``m x m`` window at ``j`` (``m = nb + b``);
band fill never escapes it. The loop carries the window's Schur
complement, and each panel's fresh border slab of the matrix is built on
the host once (``_band_slabs``). A diagonal block that is not positive
definite gives a panel of NaNs and no exception, as in the JAX package.

>>> import torch
>>> from spalinalg_tpu_torch import diags
>>> A = diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(6, 6), device="cpu")
>>> fac = band_cholesky_factor(A, bandwidth=1, panel=4)
>>> x = band_cholesky_solve(fac, torch.ones(6, dtype=torch.float64))
>>> [round(float(v), 6) for v in x]
[3.0, 5.0, 6.0, 6.0, 5.0, 3.0]
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..utils.metrics import instrument

__all__ = [
    "BandCholeskyFactor",
    "BandLuFactor",
    "band_cholesky_factor",
    "band_cholesky_solve",
    "band_lu_factor",
    "band_lu_solve",
]


def _band_slabs(csr, b: int, nb: int):
    """Host: the per-panel ``(m, m)`` border slabs and the padded size.

    Slab ``p`` holds the window ``A[j:j+m, j:j+m]`` (``j = p·nb``) with the
    part the previous window already covered (rows and columns both
    ``< m - nb``) zeroed; slab 0 is the whole first window. Padding rows
    get a unit diagonal, so the factor stays defined.
    """
    n = csr.nrows
    m = nb + b
    P = -(-n // nb)
    n_pad = P * nb
    ptr, ind, val = csr._host_arrays()
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(ptr))

    slabs = np.zeros((P, m, m), dtype=val.dtype)
    # entry (i, j) lies in window p iff p·nb <= i, j < p·nb + m
    p_lo = np.maximum(0, (np.maximum(rows, ind) - m) // nb + 1)
    p_hi = np.minimum(P - 1, np.minimum(rows, ind) // nb)
    for p in range(P):
        sel = (p_lo <= p) & (p <= p_hi)
        r = rows[sel] - p * nb
        c = ind[sel] - p * nb
        v = val[sel]
        if p > 0:
            new = (r >= m - nb) | (c >= m - nb)
            r, c, v = r[new], c[new], v[new]
        slabs[p, r, c] = v
    # a unit diagonal on padding rows (>= n), each added once: window 0
    # owns [0, m), window p >= 1 its fresh [m - nb, m)
    local = np.arange(m)
    for p in range(P):
        is_pad = local + p * nb >= n
        if p > 0:
            is_pad &= local >= m - nb
        slabs[p, local[is_pad], local[is_pad]] = 1.0
    return slabs, P, n_pad, m


def _cholesky_nan(a: torch.Tensor):
    """``(L, info)``: the lower Cholesky factor of a (batch of) matrices,
    reading their lower triangles; a matrix that is not positive definite
    gives NaNs (``info`` nonzero), with no exception and no read back."""
    L, info = torch.linalg.cholesky_ex(a)
    bad = (info != 0).reshape(info.shape + (1, 1))
    return torch.where(bad, torch.full_like(L, float("nan")), L), info


@dataclass(frozen=True, eq=False)
class BandCholeskyFactor:
    """Panelled banded Cholesky factor: ``panels[p] = [L11; L21]``."""

    panels: torch.Tensor  # (P, m, nb)
    n: int
    n_pad: int
    nb: int
    b: int

    @property
    def m(self) -> int:
        return self.nb + self.b


def band_cholesky_factor(csr, *, bandwidth: int, panel: int = 64
                         ) -> BandCholeskyFactor:
    """Factor a banded SPD CSR matrix ``A = L Lᵀ`` (L banded), on the
    matrix's device."""
    nb = max(1, min(panel, csr.nrows))
    b = max(int(bandwidth), 1)
    slabs, P, n_pad, m = _band_slabs(csr, b, nb)
    slabs = torch.as_tensor(slabs, device=csr.device)
    panels = torch.empty((P, m, nb), dtype=slabs.dtype, device=csr.device)
    S = torch.zeros((m, m), dtype=slabs.dtype, device=csr.device)
    with torch.no_grad():
        for p in range(P):
            S = S + slabs[p]
            L11, _ = _cholesky_nan(S[:nb, :nb])
            L21 = torch.linalg.solve_triangular(L11.mT, S[nb:, :nb],
                                                upper=True, left=False)
            panels[p, :nb] = L11
            panels[p, nb:] = L21
            S22 = S[nb:, nb:] - L21 @ L21.mT
            S = torch.zeros_like(S)
            S[:b, :b] = S22
    return BandCholeskyFactor(panels=panels, n=csr.nrows, n_pad=n_pad,
                              nb=nb, b=b)


def _padded_rhs(n_pad: int, rhs, panels: torch.Tensor) -> torch.Tensor:
    rhs = torch.as_tensor(rhs, device=panels.device).to(panels.dtype)
    out = torch.zeros(n_pad, dtype=panels.dtype, device=panels.device)
    out[: rhs.shape[0]] = rhs
    return out


def _forward(panels, rhs, nb: int, b: int, unit: bool):
    """``L y = rhs`` over the panels (``unit``: L11's diagonal is 1). The
    carry ``acc`` holds what earlier panels subtract from the window."""
    y = torch.empty_like(rhs).view(-1, nb)
    acc = torch.zeros(nb + b, dtype=rhs.dtype, device=rhs.device)
    for p, r in enumerate(rhs.view(-1, nb)):
        y1 = torch.linalg.solve_triangular(panels[p, :nb],
                                           (r - acc[:nb])[:, None],
                                           upper=False, unitriangular=unit)
        y[p] = y1[:, 0]
        acc = torch.cat([acc[nb:] + panels[p, nb:] @ y1[:, 0],
                         acc.new_zeros(nb)])
    return y.view(-1)


def _backward(y, nb: int, b: int, upper, strip):
    """``U x = y`` over the panels, last first: ``upper(p)`` is panel p's
    upper-triangular diagonal block, ``strip(p)`` its ``(nb, b)`` coupling
    to the next ``b`` unknowns."""
    y = y.view(-1, nb)
    x = torch.empty_like(y)
    xnext = y.new_zeros(b)
    for p in range(y.shape[0] - 1, -1, -1):
        x1 = torch.linalg.solve_triangular(
            upper(p), (y[p] - strip(p) @ xnext)[:, None], upper=True)[:, 0]
        x[p] = x1
        xnext = torch.cat([x1, xnext])[:b]
    return x.view(-1)


def band_cholesky_solve(fac: BandCholeskyFactor, rhs) -> torch.Tensor:
    """Solve ``A x = rhs`` from a banded Cholesky factor: a forward and a
    backward sweep over the panels."""
    nb, b, panels = fac.nb, fac.b, fac.panels
    with torch.no_grad():
        y = _forward(panels, _padded_rhs(fac.n_pad, rhs, panels), nb, b,
                     unit=False)
        x = _backward(y, nb, b, lambda p: panels[p, :nb].mT,
                      lambda p: panels[p, nb:].mT)
    return x[: fac.n]


# ----------------------------------------------------------------------
# Banded LU (no pivoting: diagonally dominant or RCM-ordered systems)
# ----------------------------------------------------------------------


@dataclass(frozen=True, eq=False)
class BandLuFactor:
    """Panelled banded LU (no pivoting): per panel ``[L11\\U11; L21]`` and
    the ``U12`` strip right of the diagonal block."""

    panels: torch.Tensor  # (P, m, nb): rows [:nb] unit L11 and U11, [nb:] L21
    u12: torch.Tensor     # (P, nb, b)
    n: int
    n_pad: int
    nb: int
    b: int


def _lu_nopivot(M: torch.Tensor) -> torch.Tensor:
    """Dense LU without pivoting by Doolittle steps (packed: unit L below
    the diagonal, U on and above it)."""
    nb = M.shape[0]
    ar = torch.arange(nb, device=M.device)
    for k in range(nb):
        factors = torch.where(ar > k, M[:, k] / M[k, k], 0.0)
        M = M - torch.outer(factors, torch.where(ar >= k, M[k, :], 0.0))
        M[:, k] = torch.where(ar > k, factors, M[:, k])
    return M


def band_lu_factor(csr, *, bandwidth: int, panel: int = 64) -> BandLuFactor:
    """Factor a banded CSR matrix ``A = L U`` (no pivoting), on the
    matrix's device. The host slab build is recorded as ``lu_band_slabs``
    when the metrics recorder is on."""
    nb = max(1, min(panel, csr.nrows))
    b = max(int(bandwidth), 1)
    slabs, P, n_pad, m = instrument(
        "lu_band_slabs", lambda: _band_slabs(csr, b, nb), path="host",
        device=torch.device("cpu"))
    slabs = torch.as_tensor(slabs, device=csr.device)
    panels = torch.empty((P, m, nb), dtype=slabs.dtype, device=csr.device)
    u12 = torch.empty((P, nb, b), dtype=slabs.dtype, device=csr.device)
    S = torch.zeros((m, m), dtype=slabs.dtype, device=csr.device)
    with torch.no_grad():
        for p in range(P):
            S = S + slabs[p]
            LU11 = _lu_nopivot(S[:nb, :nb].clone())
            L21 = torch.linalg.solve_triangular(LU11, S[nb:, :nb],
                                                upper=True, left=False)
            U12 = torch.linalg.solve_triangular(LU11, S[:nb, nb:],
                                                upper=False,
                                                unitriangular=True)
            panels[p, :nb] = LU11
            panels[p, nb:] = L21
            u12[p] = U12
            S22 = S[nb:, nb:] - L21 @ U12
            S = torch.zeros_like(S)
            S[:b, :b] = S22
    return BandLuFactor(panels=panels, u12=u12, n=csr.nrows, n_pad=n_pad,
                        nb=nb, b=b)


def band_lu_solve(fac: BandLuFactor, rhs) -> torch.Tensor:
    """Solve ``A x = rhs`` from a banded LU factor."""
    nb, b, panels = fac.nb, fac.b, fac.panels
    with torch.no_grad():
        y = _forward(panels, _padded_rhs(fac.n_pad, rhs, panels), nb, b,
                     unit=True)
        x = _backward(y, nb, b, lambda p: panels[p, :nb],
                      lambda p: fac.u12[p])
    return x[: fac.n]
