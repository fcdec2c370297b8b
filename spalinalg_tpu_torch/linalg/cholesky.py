"""Sparse Cholesky factorization (counterpart of
``spalinalg_tpu/linalg/cholesky.py``; BASELINE config[3]).

Three paths, chosen by the JAX package's rules, so a matrix takes the
same path in both packages:

- **banded** (:mod:`.banded`): an RCM ordering compresses the band, and
  the factor is dense panels of the band, when the band is tight
  (``b < band_threshold·n``) and the ``(P, m, m)`` slab stack stays under
  1.5 GB;
- **supernodal** (:mod:`.supernodal`) otherwise: AMD ordering, elimination
  tree and postorder, relaxed supernodes, batched dense fronts;
- **dense** for ``n <= 2`` or on request.

The supernodal path's host work (ordering, symbolic analysis, index
plans) is cached in memory per structure, as ``transpose_plan`` is, so a
re-factor of a matrix with the same structure and new values runs only
the numeric phase: a gather of the values into the permuted order and the
per-bucket launches. The host phases are recorded on the metrics
recorder (``chol_ordering``, ``chol_symbolic``, ``chol_plan``, path
``host``) when it is on. The factor lives on the matrix's device.

Examples
--------
>>> import torch
>>> from spalinalg_tpu_torch import diags
>>> A = diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(8, 8), device="cpu")
>>> fac = cholesky(A)
>>> fac.path
'banded'
>>> x = cholesky_solve(fac, torch.ones(8, dtype=torch.float64))
>>> bool(torch.allclose(A @ x, torch.ones(8, dtype=torch.float64)))
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
from ..utils.plandisk import load_or_build
from .banded import (BandCholeskyFactor, _cholesky_nan, band_cholesky_factor,
                     band_cholesky_solve)
from .ordering import bandwidth as _bandwidth, rcm_ordering

__all__ = ["CholeskyFactor", "cholesky", "cholesky_solve", "permute_csr"]

SLAB_LIMIT_BYTES = 1_500_000_000

_HOST = torch.device("cpu")
_SYMBOLIC = StructureCache()


def _permuted_structure(ptr, ind, perm):
    """Host: the structure of ``A[perm][:, perm]`` and, for each of its
    entries, the index of the entry of ``A`` it holds."""
    n = ptr.size - 1
    iperm = np.empty(n, dtype=np.int64)
    iperm[perm] = np.arange(n)
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(ptr))
    new_rows, new_ind = iperm[rows], iperm[ind]
    src = np.lexsort((new_ind, new_rows))
    new_ptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(new_ptr, new_rows + 1, 1)
    np.cumsum(new_ptr, out=new_ptr)
    return new_ptr, new_ind[src], src


def permute_csr(csr, perm: np.ndarray):
    """Symmetric permutation ``A[perm][:, perm]`` (host structure work;
    the values move in one gather on the matrix's device)."""
    from ..formats.compressed import CsrMatrix

    perm = np.asarray(perm, dtype=np.int64)
    n = csr.nrows
    if perm.shape != (n,):
        raise ShapeError(f"permutation must have length {n}")
    ptr, ind, _ = csr._host_arrays()
    new_ptr, new_ind, src = _permuted_structure(ptr, ind, perm)
    dev = csr.device
    return CsrMatrix._from_parts(
        n, csr.ncols, torch.as_tensor(new_ptr, dtype=torch.int32, device=dev),
        torch.as_tensor(new_ind, dtype=torch.int32, device=dev),
        csr.values[torch.as_tensor(src, device=dev)])


def band_too_costly(n: int, bw: int, panel: int, dtype,
                    band_threshold: float) -> bool:
    """Whether ``auto`` leaves the banded path for the supernodal one: the
    band is too wide for the ``O(n·b²)`` panel work, or the ``(P, m, m)``
    slab stack that ``banded.py`` builds on the host passes
    ``SLAB_LIMIT_BYTES`` (``cholesky`` and ``lu`` both ask)."""
    nb = max(1, min(panel, n))
    slab_bytes = -(-n // nb) * (nb + bw) ** 2 * dtype.itemsize
    return (bw >= max(2, int(band_threshold * n))
            or slab_bytes > SLAB_LIMIT_BYTES)


@dataclass(frozen=True, eq=False)
class CholeskyFactor:
    """Factorization result: ordering + banded, supernodal or dense
    factor."""

    n: int
    perm: Optional[np.ndarray]            # None: natural order
    band: Optional[BandCholeskyFactor]    # panelled banded factor
    dense_l: Optional[torch.Tensor]       # dense factor
    snf: Optional[object] = None          # SupernodalFactor

    @property
    def is_dense(self) -> bool:
        return self.dense_l is not None

    @property
    def path(self) -> str:
        """Which factorization ran: ``banded``, ``supernodal`` or
        ``dense``."""
        if self.snf is not None:
            return "supernodal"
        return "dense" if self.is_dense else "banded"


@dataclass(frozen=True, eq=False)
class _Symbolic:
    """The supernodal path's host work for one structure."""

    perm: np.ndarray                 # fill-reducing order, postordered
    plan: object                     # SupernodalPlan
    value_src: torch.Tensor          # A.values index of each permuted entry


def _supernodal_symbolic(csr, reorder: bool) -> _Symbolic:
    """Ordering, symbolic analysis and plan of ``csr``'s structure, built
    on the host once per structure and kept while the structure lives;
    the host plan (``perm``, the value gather and the
    ``SupernodalPlan`` with its ``SupernodalSymbolic``) is also kept on
    disk across processes (:mod:`..utils.plandisk`)."""
    from .supernodal import build_supernodal_plan
    from .symbolic import amd_ordering, chol_symbolic, etree, postorder

    n = csr.nrows

    def build():
        ptr0, ind0, _ = csr._host_arrays()
        perm, src, plan = load_or_build(
            "snchol", (ptr0, ind0), (n, int(bool(reorder))),
            lambda: host_plan(ptr0, ind0),
            on_load=lambda load: instrument("chol_plan", load, path="disk",
                                            device=_HOST))
        return _Symbolic(perm=perm, plan=plan,
                         value_src=torch.as_tensor(src, device=csr.device))

    def host_plan(ptr0, ind0):
        def ordering():
            p1 = (amd_ordering(csr) if reorder
                  else np.arange(n, dtype=np.int64))
            ptr, ind, _ = _permuted_structure(ptr0, ind0, p1)
            return p1[postorder(etree(ptr, ind, n))]

        perm = instrument("chol_ordering", ordering, path="host",
                          device=_HOST)

        def symbolic():
            ptr, ind, src = _permuted_structure(ptr0, ind0, perm)
            return ptr, ind, src, chol_symbolic(ptr, ind, n)

        ptr, ind, src, sym = instrument("chol_symbolic", symbolic,
                                        path="host", device=_HOST)
        plan = instrument("chol_plan",
                          lambda: build_supernodal_plan(sym, ptr, ind),
                          path="host", device=_HOST)
        return perm, src, plan

    return _SYMBOLIC.get((csr.rowptr, csr.colind), build, n, bool(reorder))


def _supernodal_cholesky(csr, *, reorder: bool) -> CholeskyFactor:
    from .supernodal import supernodal_factor

    sym = _supernodal_symbolic(csr, reorder)
    snf = supernodal_factor(sym.plan, csr.values[sym.value_src])
    return CholeskyFactor(n=csr.nrows, perm=sym.perm, band=None,
                          dense_l=None, snf=snf)


def cholesky(csr, *, reorder: bool = True, panel: int = 64,
             band_threshold: float = 0.12,
             method: str = "auto") -> CholeskyFactor:
    """Factor an SPD CSR matrix ``A = L Lᵀ`` on its device.

    ``method``: ``"auto"`` takes the banded panel path when an RCM band
    is tight (band work ``n·b²`` near the true fill) and its slab stack
    fits in 1.5 GB, the supernodal multifrontal path otherwise;
    ``"banded"``, ``"supernodal"`` and ``"dense"`` force a path.
    ``reorder=False`` keeps the natural ordering.
    """
    if csr.nrows != csr.ncols:
        raise ShapeError(f"Cholesky needs a square matrix, got {csr.shape}")
    n = csr.nrows
    if method not in ("auto", "banded", "supernodal", "dense"):
        raise ValueError(f"unknown cholesky method {method!r}")
    if method == "supernodal":
        return _supernodal_cholesky(csr, reorder=reorder)

    perm = None
    mat = csr
    bw = _bandwidth(csr)
    if reorder:
        p = rcm_ordering(csr)
        pm = permute_csr(csr, p)
        pbw = _bandwidth(pm)
        if pbw < bw:
            perm, mat, bw = p, pm, pbw

    if n <= 2 or method == "dense":
        with torch.no_grad():
            dense_l, _ = _cholesky_nan(mat.to_dense())
        return CholeskyFactor(n=n, perm=perm, band=None, dense_l=dense_l)

    if method == "auto" and band_too_costly(n, bw, panel, mat.dtype,
                                            band_threshold):
        return _supernodal_cholesky(csr, reorder=reorder)

    fac = band_cholesky_factor(mat, bandwidth=bw, panel=panel)
    return CholeskyFactor(n=n, perm=perm, band=fac, dense_l=None)


def cholesky_solve(fac: CholeskyFactor, b) -> torch.Tensor:
    """Solve ``A x = b`` from a :func:`cholesky` factor, on its device."""
    if fac.snf is not None:
        from .supernodal import supernodal_solve

        return supernodal_solve(fac.snf, b, perm=fac.perm)
    dev = (fac.dense_l if fac.is_dense else fac.band.panels).device
    b = torch.as_tensor(b, device=dev)
    perm = (None if fac.perm is None
            else torch.as_tensor(fac.perm, device=dev))
    bp = b[perm] if perm is not None else b
    with torch.no_grad():
        if fac.is_dense:
            L = fac.dense_l
            y = torch.linalg.solve_triangular(L, bp.to(L.dtype)[:, None],
                                              upper=False)
            xp = torch.linalg.solve_triangular(L.mT, y, upper=True)[:, 0]
        else:
            xp = band_cholesky_solve(fac.band, bp)
        if perm is None:
            return xp
        return torch.empty_like(xp).index_copy_(0, perm, xp)
