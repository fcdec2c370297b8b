"""Preconditioners for the Krylov solvers: ILU(0), IC(0) and Chebyshev
(counterpart of ``spalinalg_tpu/linalg/precond.py``).

The incomplete factorizations are host setup, once per structure and
values: the numeric sweep runs in the port's native library
(``spal_ilu0`` / ``spal_ic0``, in float64). Their application is two
level-scheduled triangular solves (:mod:`.triangular`) on the matrix's
device, through plans built once. The Chebyshev preconditioner applies a
polynomial in ``A``: ``degree`` products with the operand's own SpMV and
vector updates, no triangular solves.

Examples
--------
>>> import numpy as np, torch
>>> from spalinalg_tpu_torch import CooMatrix, CsrMatrix
>>> from spalinalg_tpu_torch.linalg import cg
>>> n = 16
>>> ent = [(i, i, 4.0) for i in range(n)]
>>> ent += [(i, i + 1, -1.0) for i in range(n - 1)]
>>> ent += [(i + 1, i, -1.0) for i in range(n - 1)]
>>> A = CsrMatrix.from_coo(CooMatrix.with_entries(n, n, ent), device="cpu")
>>> res = cg(A, np.ones(n), precondition=ic0(A), tol=1e-12)
>>> bool(res.residual < 1e-10)
True
>>> tuple(ilu0(A).solve(torch.ones(n, dtype=torch.float64)).shape)
(16,)
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..errors import ShapeError, StructureError
from ..native import lib as native
from ..parallel.spmv import is_dist
from .cg import _vector
from .triangular import (TriangularPlan, _solve_device, _solve_host,
                         plan_triangular)

__all__ = ["Ilu0Precond", "ilu0", "ic0", "chebyshev", "ChebyshevPrecond"]


def _apply(plan: TriangularPlan, mat, r: torch.Tensor) -> torch.Tensor:
    if plan.use_device:
        return _solve_device(plan, mat.values, r)
    return _solve_host(plan, mat, r)


@dataclass(frozen=True, eq=False)
class Ilu0Precond:
    """``M⁻¹ r = U⁻¹ (L⁻¹ r)`` by two level-scheduled solves (a structure
    deeper than the device cap is swept on the host)."""

    n: int
    l_mat: object               # CsrMatrix, unit lower (diagonal stored)
    u_mat: object               # CsrMatrix, upper with its diagonal
    l_plan: TriangularPlan
    u_plan: TriangularPlan
    kind: str = "ilu0"

    def solve(self, r) -> torch.Tensor:
        r = torch.as_tensor(r, device=self.l_mat.device)
        with torch.no_grad():
            return _apply(self.u_plan, self.u_mat,
                          _apply(self.l_plan, self.l_mat, r))

    __call__ = solve


def _csr_on(n, ptr_rows, cols, vals, dtype, device):
    """CSR from row-sorted host triplets, onto ``device``."""
    from ..formats.compressed import CsrMatrix

    ptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(ptr, ptr_rows + 1, 1)
    np.cumsum(ptr, out=ptr)
    return CsrMatrix._from_parts(
        n, n, torch.as_tensor(ptr, dtype=torch.int32, device=device),
        torch.as_tensor(cols, dtype=torch.int32, device=device),
        torch.as_tensor(vals, device=device).to(dtype))


def _split_lu(n, ptr, ind, val, dtype, device):
    """Split factored values into unit-L and U CSR matrices."""
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(ptr))
    lower = ind < rows
    r = np.concatenate([rows[lower], np.arange(n)])
    c = np.concatenate([ind[lower], np.arange(n)])
    v = np.concatenate([val[lower], np.ones(n, dtype=val.dtype)])
    o = np.lexsort((c, r))
    upper = ~lower                     # includes the diagonal
    return (_csr_on(n, r[o], c[o], v[o], dtype, device),
            _csr_on(n, rows[upper], ind[upper], val[upper], dtype, device))


def ilu0(csr) -> Ilu0Precond:
    """ILU(0): incomplete LU restricted to A's sparsity pattern (IKJ
    sweep, Saad Alg. 10.4). Raises :class:`StructureError` on a zero
    pivot or a missing diagonal entry (no pivoting: permute first, e.g.
    with :func:`~.ordering.rcm_ordering`)."""
    if csr.nrows != csr.ncols:
        raise ShapeError(f"ilu0 needs a square matrix, got {csr.shape}")
    n = csr.nrows
    ptr, ind, val = csr._host_arrays()
    new_val, bad = native.ilu0_values(ptr, ind, val, n)
    if bad >= 0:
        has_diag = np.any(ind[ptr[bad]: ptr[bad + 1]] == bad)
        raise StructureError(
            f"ilu0 zero pivot at row {bad}" if has_diag
            else "ilu0 needs every diagonal entry present")
    l_mat, u_mat = _split_lu(n, ptr, ind, new_val.astype(val.dtype),
                             csr.dtype, csr.device)
    return Ilu0Precond(
        n=n, l_mat=l_mat, u_mat=u_mat,
        l_plan=plan_triangular(l_mat, lower=True, unit_diag=True),
        u_plan=plan_triangular(u_mat, lower=False))


def ic0(csr) -> Ilu0Precond:
    """IC(0): incomplete Cholesky on the lower pattern of an SPD matrix,
    ``M = L Lᵀ``, applied as a forward and a backward solve. Raises
    :class:`StructureError` when a pivot goes non-positive (not SPD under
    zero fill: shift the diagonal or use :func:`ilu0`)."""
    if csr.nrows != csr.ncols:
        raise ShapeError(f"ic0 needs a square matrix, got {csr.shape}")
    n = csr.nrows
    ptr, ind, val = csr._host_arrays()
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(ptr))
    keep = ind <= rows
    lr, lc = rows[keep], ind[keep]
    lptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(lptr, lr + 1, 1)
    np.cumsum(lptr, out=lptr)
    lv, bad = native.ic0_values(lptr, lc, val[keep], n)
    if bad >= 0:
        hi = int(lptr[bad + 1])
        has_diag = hi > int(lptr[bad]) and int(lc[hi - 1]) == bad
        raise StructureError(
            f"ic0 non-positive pivot at row {bad} (matrix not SPD under "
            f"zero fill)" if has_diag
            else "ic0 needs every diagonal entry present")
    l_mat = _csr_on(n, lr, lc, lv.astype(val.dtype), csr.dtype, csr.device)
    lt_mat = l_mat.transpose()
    return Ilu0Precond(
        n=n, l_mat=l_mat, u_mat=lt_mat,
        l_plan=plan_triangular(l_mat, lower=True),
        u_plan=plan_triangular(lt_mat, lower=False),
        kind="ic0")


@dataclass(frozen=True, eq=False)
class ChebyshevPrecond:
    """Polynomial preconditioner ``M⁻¹r = p_k(A) r ≈ A⁻¹r``: ``degree``
    products with the operand's own SpMV, no triangular solves, so it
    composes with any operand: CSR, BSR, or a ``DistCsr`` (``dist_spmv``
    on this rank's slices). The spectrum bounds ``(lmin, lmax)`` must
    bracket A's eigenvalues (SPD).
    """

    lmin: float
    lmax: float
    degree: int
    a: object

    @property
    def supports_dist(self) -> bool:
        """Products only: sharding-aware exactly when its operand is."""
        return is_dist(self.a)

    def solve(self, r) -> torch.Tensor:
        """Chebyshev iteration for ``A z = r`` from ``z0 = 0`` (Saad
        §12.3)."""
        theta = (self.lmax + self.lmin) / 2.0
        delta = (self.lmax - self.lmin) / 2.0
        r = _vector(r, self.a)
        with torch.no_grad():
            z = r / theta                  # first step
            if self.degree == 1:
                return z
            rho_prev = delta / theta
            resid = r - self.a @ z
            d = z                          # z_k - z_{k-1}
            for _ in range(self.degree - 1):
                rho = 1.0 / (2.0 * theta / delta - rho_prev)
                d = rho * rho_prev * d + (2.0 * rho / delta) * resid
                z = z + d
                resid = resid - self.a @ d
                rho_prev = rho
            return z

    __call__ = solve


def chebyshev(A, *, degree: int = 8, lmin: float = None,
              lmax: float = None, power_iters: int = 20) -> ChebyshevPrecond:
    """Build a Chebyshev preconditioner for an SPD operand.

    Missing bounds are estimated once: ``lmax`` by ``power_iters`` steps
    of power iteration from NumPy's ``default_rng(0)`` (a float64 start
    vector on the operand's device, as in the JAX package), inflated 5 %;
    ``lmin`` defaults to ``lmax / 30``. A ``DistCsr`` operand needs
    explicit ``(lmin, lmax)``.
    """
    shape = A.shape
    if shape[0] != shape[1]:
        raise ShapeError(f"chebyshev needs a square operand, got {shape}")
    if degree < 1:
        raise ValueError(f"degree must be >= 1, got {degree}")
    if lmax is None:
        if is_dist(A):
            raise ValueError(
                "pass explicit (lmin, lmax) for DistCsr operands — the "
                "setup-time power iteration is single-chip only")
        rng = np.random.default_rng(0)
        with torch.no_grad():
            v = _vector(rng.normal(size=shape[0]), A)
            v = v / torch.linalg.vector_norm(v)
            for _ in range(power_iters):
                w = A @ v
                v = w / torch.clamp(torch.linalg.vector_norm(w), min=1e-300)
            lmax = 1.05 * float(torch.dot(v, A @ v))
    if lmin is None:
        lmin = lmax / 30.0
    if not 0 < lmin < lmax:
        raise ValueError(f"need 0 < lmin < lmax, got {lmin}, {lmax}")
    return ChebyshevPrecond(lmin=float(lmin), lmax=float(lmax),
                            degree=int(degree), a=A)
