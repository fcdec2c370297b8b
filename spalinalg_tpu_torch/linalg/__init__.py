"""Solver tier of the port (counterpart of ``spalinalg_tpu/linalg``): the
Krylov solvers CG, GMRES and BiCGSTAB with Jacobi, IC(0), ILU(0) and
Chebyshev preconditioners; the level-scheduled sparse triangular solve;
orderings; banded and supernodal Cholesky, and the banded LU.

Every sparse product on these paths is the operand's own ``@``: the
port's CSR or BSR SpMV kernel on the card. Dense work on fronts and
panels (batched Cholesky, triangular solves, Schur updates) is torch's.
"""

from .banded import (
    BandCholeskyFactor,
    BandLuFactor,
    band_cholesky_factor,
    band_cholesky_solve,
    band_lu_factor,
    band_lu_solve,
)
from .cg import CgResult, cg
from .cholesky import CholeskyFactor, cholesky, cholesky_solve, permute_csr
from .iterative import IterResult, bicgstab, gmres
from .ordering import bandwidth, level_schedule, rcm_ordering
from .precond import ChebyshevPrecond, Ilu0Precond, chebyshev, ic0, ilu0
from .triangular import TriangularPlan, plan_triangular, solve_triangular_csr

__all__ = [
    "cg", "CgResult", "gmres", "bicgstab", "IterResult",
    "ilu0", "ic0", "Ilu0Precond", "chebyshev", "ChebyshevPrecond",
    "cholesky", "cholesky_solve", "CholeskyFactor", "permute_csr",
    "rcm_ordering", "bandwidth", "level_schedule",
    "solve_triangular_csr", "plan_triangular", "TriangularPlan",
    "band_cholesky_factor", "band_cholesky_solve", "BandCholeskyFactor",
    "band_lu_factor", "band_lu_solve", "BandLuFactor",
]
