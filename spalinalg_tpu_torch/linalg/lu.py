"""Sparse LU factorization with triangular solve (counterpart of
``spalinalg_tpu/linalg/lu.py``).

Three paths, chosen by the JAX package's rules with one repair:

- **banded** (:mod:`.banded`): RCM, then a panelled band LU with no
  pivoting, for diagonally dominant stencils with a tight RCM band;
- **supernodal** (:mod:`.supernodal_lu`): AMD on the symmetrized
  structure ``struct(A + Aᵀ)``, elimination tree and postorder, batched
  multifrontal LU with restricted partial pivoting inside each
  supernode's diagonal block;
- **dense** (``torch.linalg.lu_factor_ex``): partial pivoting, for tiny
  systems or on request (``pivot=True``).

The repair: ``method="auto"`` leaves the banded path when its ``(P, m,
m)`` slab stack passes ``cholesky.SLAB_LIMIT_BYTES``, as the port's
``cholesky`` does. The JAX ``lu`` has no such guard and builds a 10.9 GB
float64 stack on the host for a 512 x 512 grid.

The supernodal path's host work (symmetrize, AMD, etree and postorder,
symbolic analysis, plan) is cached per structure, as ``cholesky``'s is,
and recorded on the metrics recorder (``lu_symmetrize``, ``lu_ordering``,
``lu_etree``, ``lu_symbolic``, ``lu_plan``, path ``host``) when it is on;
the banded path's host slab build is recorded as ``lu_band_slabs``.
:func:`lu_solve` refines against the original matrix: each step is one
``fac.a @ x``, the CSR SpMV kernel on the card.

Examples
--------
>>> import torch
>>> from spalinalg_tpu_torch import CsrMatrix
>>> A = CsrMatrix(3, 3, [0, 2, 4, 6], [0, 1, 0, 1, 1, 2],
...               [4.0, 1.0, 1.0, 3.0, 1.0, 2.0], device="cpu")
>>> fac = lu(A)
>>> fac.path
'banded'
>>> x = lu_solve(fac, torch.tensor([5.0, 4.0, 3.0], dtype=torch.float64))
>>> bool(torch.allclose(A @ x, torch.tensor([5.0, 4.0, 3.0],
...                                          dtype=torch.float64)))
True
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..errors import ShapeError
from ..utils.metrics import instrument
from ..utils.plancache import StructureCache
from .banded import BandLuFactor, band_lu_factor, band_lu_solve
from .cholesky import _permuted_structure, band_too_costly, permute_csr
from .ordering import bandwidth as _bandwidth, rcm_ordering

__all__ = ["LuFactor", "lu", "lu_solve"]

_HOST = torch.device("cpu")
_SYMBOLIC = StructureCache()


@dataclass(frozen=True, eq=False)
class LuFactor:
    """Factorization result: ordering + banded, supernodal or dense
    factor; ``a`` (the original matrix) for refinement."""

    n: int
    perm: Optional[np.ndarray]
    band: Optional[BandLuFactor]
    dense_lu: Optional[tuple]      # (LU, pivots) of torch.linalg.lu_factor_ex
    snlu: Optional[object] = None  # SupernodalLuFactor (general case)
    a: Optional[object] = None     # original CsrMatrix (for refinement)
    # the supernodal factor's input: A's values on the symmetrized
    # structure (a re-factor is supernodal_lu_factor(snlu.plan, values))
    values: Optional[torch.Tensor] = None

    @property
    def path(self) -> str:
        """Which factorization ran: ``banded``, ``supernodal`` or
        ``dense``."""
        if self.snlu is not None:
            return "supernodal"
        return "dense" if self.dense_lu is not None else "banded"


@dataclass(frozen=True, eq=False)
class _Symbolic:
    """The supernodal LU path's host work for one structure."""

    perm: np.ndarray          # fill-reducing order, postordered
    plan: object              # SupernodalLuPlan
    n_struct: int             # entries of the symmetrized structure
    value_dst: torch.Tensor   # slot of each of A's permuted entries in it
    value_src: torch.Tensor   # A.values index of each permuted entry


def _supernodal_symbolic(csr, reorder: bool) -> _Symbolic:
    """Symmetrized structure, ordering, symbolic analysis and plan of
    ``csr``'s structure, built on the host once per structure and kept
    while the structure lives."""
    from .supernodal_lu import (build_supernodal_lu_plan,
                                map_values_to_structure, symmetrize_structure)
    from .symbolic import chol_symbolic, etree, postorder
    from ..native import lib as native

    n = csr.nrows

    def build():
        ptr, ind, _ = csr._host_arrays()
        s_ptr, s_ind = instrument(
            "lu_symmetrize", lambda: symmetrize_structure(ptr, ind, n),
            path="host", device=_HOST)
        p1 = instrument(
            "lu_ordering",
            lambda: (native.amd(s_ptr, s_ind, n) if reorder
                     else np.arange(n, dtype=np.int64)),
            path="host", device=_HOST)

        def elimination():
            ptr1, ind1, _ = _permuted_structure(s_ptr, s_ind, p1)
            return p1[postorder(etree(ptr1, ind1, n))]

        perm = instrument("lu_etree", elimination, path="host",
                          device=_HOST)

        def symbolic():
            sptr, sind, _ = _permuted_structure(s_ptr, s_ind, perm)
            return sptr, sind, chol_symbolic(sptr, sind, n)

        sptr, sind, sym = instrument("lu_symbolic", symbolic, path="host",
                                     device=_HOST)

        def plan_and_map():
            plan = build_supernodal_lu_plan(sym, sptr, sind)
            aptr, aind, src = _permuted_structure(ptr, ind, perm)
            dst = map_values_to_structure(aptr, aind, sptr, sind, n)
            return plan, dst, src

        plan, dst, src = instrument("lu_plan", plan_and_map, path="host",
                                    device=_HOST)
        return _Symbolic(
            perm=perm, plan=plan, n_struct=int(sind.size),
            value_dst=torch.as_tensor(dst, device=csr.device),
            value_src=torch.as_tensor(src, device=csr.device))

    return _SYMBOLIC.get((csr.rowptr, csr.colind), build, n, bool(reorder))


def symmetrized_values(sym: _Symbolic, values: torch.Tensor
                       ) -> torch.Tensor:
    """The numeric phase's input: ``values`` (A's, in its CSR order)
    scattered onto the postordered symmetrized structure, zeros where A
    has no entry; one gather and one ``index_copy_`` on their device."""
    return values.new_zeros(sym.n_struct).index_copy_(
        0, sym.value_dst, values[sym.value_src])


def _supernodal_lu(csr, *, reorder: bool, perturb: bool) -> LuFactor:
    """General-sparsity path: AMD + postorder on struct(A+Aᵀ), batched
    multifrontal LU with restricted pivoting (:mod:`.supernodal_lu`)."""
    from .supernodal_lu import supernodal_lu_factor

    sym = _supernodal_symbolic(csr, reorder)
    values = symmetrized_values(sym, csr.values)
    fac = supernodal_lu_factor(sym.plan, values, perturb=perturb)
    return LuFactor(n=csr.nrows, perm=sym.perm, band=None, dense_lu=None,
                    snlu=fac, a=csr, values=values)


def lu(csr, *, reorder: bool = True, panel: int = 64,
       band_threshold: float = 0.12, pivot: bool = False,
       method: str = "auto", perturb: bool = True) -> LuFactor:
    """Factor ``A = L U`` on the matrix's device.

    ``method``: ``"auto"`` takes the banded panel path when an RCM band is
    tight and its slab stack fits in ``cholesky.SLAB_LIMIT_BYTES``, the
    supernodal path (AMD on struct(A+Aᵀ), restricted partial pivoting per
    supernode block) otherwise; ``"banded"`` / ``"supernodal"`` /
    ``"dense"`` force a path. ``pivot=True`` forces full dense partial
    pivoting, the safest choice for small ill-conditioned systems; the
    supernodal path pivots within supernode diagonal blocks and, with
    ``perturb`` (default on), lifts near-zero pivots SuperLU-DIST-style:
    pair it with iterative refinement for hard cases.
    """
    if csr.nrows != csr.ncols:
        raise ShapeError(f"LU needs a square matrix, got {csr.shape}")
    n = csr.nrows

    if method not in ("auto", "banded", "supernodal", "dense"):
        raise ValueError(f"unknown lu method {method!r}")
    if method == "supernodal":
        if pivot:
            raise ValueError(
                "pivot=True requests full partial pivoting (GEPP), which "
                "the supernodal path does not provide (it pivots within "
                "supernode blocks); drop pivot=True or use method='dense'")
        return _supernodal_lu(csr, reorder=reorder, perturb=perturb)
    if pivot or n <= 2 or method == "dense":
        with torch.no_grad():
            lu_, piv, _ = torch.linalg.lu_factor_ex(csr.to_dense())
        return LuFactor(n=n, perm=None, band=None, dense_lu=(lu_, piv))

    perm = None
    mat = csr
    bw = _bandwidth(csr)
    if reorder:
        p = rcm_ordering(csr)
        pm = permute_csr(csr, p)
        pbw = _bandwidth(pm)
        if pbw < bw:
            perm, mat, bw = p, pm, pbw

    if method == "auto" and band_too_costly(n, bw, panel, mat.dtype,
                                            band_threshold):
        return _supernodal_lu(csr, reorder=reorder, perturb=perturb)

    fac = band_lu_factor(mat, bandwidth=bw, panel=panel)
    return LuFactor(n=n, perm=perm, band=fac, dense_lu=None)


def _device(fac: LuFactor) -> torch.device:
    if fac.snlu is not None:
        return next(iter(fac.snlu.lu11.values())).device
    if fac.dense_lu is not None:
        return fac.dense_lu[0].device
    return fac.band.panels.device


def _lu_solve_once(fac: LuFactor, b: torch.Tensor) -> torch.Tensor:
    if fac.snlu is not None:
        from .supernodal_lu import supernodal_lu_solve

        return supernodal_lu_solve(fac.snlu, b, perm=fac.perm)
    perm = (None if fac.perm is None
            else torch.as_tensor(fac.perm, device=b.device))
    bp = b[perm] if perm is not None else b
    with torch.no_grad():
        if fac.dense_lu is not None:
            lu_, piv = fac.dense_lu
            xp = torch.linalg.lu_solve(lu_, piv,
                                       bp.to(lu_.dtype).unsqueeze(-1))[:, 0]
        else:
            xp = band_lu_solve(fac.band, bp)
    if perm is None:
        return xp
    return torch.empty_like(xp).index_copy_(0, perm, xp)


def lu_solve(fac: LuFactor, b, *, refine: Optional[int] = None
             ) -> torch.Tensor:
    """Solve ``A x = b`` given an :func:`lu` factor, on its device.

    ``refine``: iterative-refinement steps against the original matrix,
    each one SpMV ``fac.a @ x``. Defaults to 1 for the supernodal path
    (it pivots only within supernode diagonal blocks, plus the static
    perturbation, so a refinement sweep restores accuracy on inputs that
    are not diagonally dominant) and 0 for the fully pivoted paths."""
    b = torch.as_tensor(b, device=_device(fac))
    x = _lu_solve_once(fac, b)
    steps = refine if refine is not None else (
        1 if (fac.snlu is not None and fac.a is not None) else 0)
    if steps and fac.a is not None:
        for _ in range(steps):
            r = b - fac.a @ x.to(fac.a.dtype)
            x = x + _lu_solve_once(fac, r)
    return x
