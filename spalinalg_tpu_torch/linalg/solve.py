"""Direct-solve front door: ``spsolve`` / ``factorized``, the
``scipy.sparse.linalg`` entry points (counterpart of
``spalinalg_tpu/linalg/solve.py``), dispatching into the factorization
tier: banded or supernodal Cholesky for SPD matrices, banded, supernodal
or dense LU otherwise.

``assume_a="auto"`` keeps the JAX package's SPD test: a symmetric matrix
is factored by Cholesky, then one probe solve and one read back of
whether it is finite decide. The port's Cholesky gives NaNs on a matrix
that is not positive definite, with no exception, so nothing is caught
here: an error raised by a factorization reaches the caller.

Examples
--------
>>> import torch
>>> from spalinalg_tpu_torch import CsrMatrix
>>> A = CsrMatrix(3, 3, [0, 2, 4, 6], [0, 1, 0, 1, 1, 2],
...               [4.0, 1.0, 1.0, 3.0, 1.0, 2.0], device="cpu")
>>> b = torch.tensor([5.0, 4.0, 3.0], dtype=torch.float64)
>>> bool(torch.allclose(A @ spsolve(A, b), b))
True
>>> solve = factorized(A)              # factor once, solve many
>>> e0 = torch.tensor([1.0, 0.0, 0.0], dtype=torch.float64)
>>> bool(torch.allclose(A @ solve(e0), e0))
True
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..errors import ShapeError

__all__ = ["spsolve", "factorized", "is_symmetric"]


def is_symmetric(csr, tol: float = 0.0) -> bool:
    """Host structure + values symmetry check (``O(nnz log nnz)``)."""
    if csr.nrows != csr.ncols:
        return False
    r, c, v = csr._coo_arrays_host()
    r = np.asarray(r, dtype=np.int64)
    c = np.asarray(c, dtype=np.int64)
    v = np.asarray(v)
    # canonical order of A and of A^T must agree
    ka = np.lexsort((c, r))
    kt = np.lexsort((r, c))
    if not (np.array_equal(r[ka], c[kt]) and np.array_equal(c[ka], r[kt])):
        return False
    return bool(np.max(np.abs(v[ka] - v[kt]), initial=0.0) <= tol)


def factorized(A, *, assume_a: str = "auto") -> Callable:
    """Factor once, return a ``solve(b)`` closure on the matrix's device.

    ``assume_a``: ``"pos"`` (SPD: Cholesky), ``"gen"`` (LU), ``"auto"``
    (a symmetry check, then Cholesky validated by a probe solve, with LU
    where the probe is not finite).
    """
    from .cholesky import cholesky, cholesky_solve
    from .lu import lu, lu_solve

    if A.shape[0] != A.shape[1]:
        raise ShapeError(f"spsolve needs a square matrix, got {A.shape}")
    if assume_a not in ("auto", "pos", "gen"):
        raise ValueError(f"assume_a must be auto|pos|gen, got {assume_a!r}")

    if assume_a == "pos":
        fac = cholesky(A)
        return lambda b: cholesky_solve(fac, b)
    if assume_a == "gen" or not is_symmetric(A, tol=0.0):
        fac = lu(A)
        return lambda b: lu_solve(fac, b)
    fac = cholesky(A)
    probe = cholesky_solve(fac, torch.ones(A.shape[0], dtype=A.dtype,
                                           device=A.device))
    if bool(torch.isfinite(probe).all()):
        return lambda b: cholesky_solve(fac, b)
    fac = lu(A)
    return lambda b: lu_solve(fac, b)


def spsolve(A, b, *, assume_a: str = "auto") -> torch.Tensor:
    """Solve ``A x = b`` directly (factor + solve in one call)."""
    return factorized(A, assume_a=assume_a)(b)
