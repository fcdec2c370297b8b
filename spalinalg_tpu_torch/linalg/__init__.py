"""Solver tier of the port (counterpart of ``spalinalg_tpu/linalg``): the
Krylov solvers CG, GMRES and BiCGSTAB with Jacobi, IC(0), ILU(0) and
Chebyshev preconditioners; the level-scheduled sparse triangular solve;
orderings; banded and supernodal Cholesky; banded, supernodal and dense
LU, and ``spsolve``/``factorized`` over them; sparse QR by the corrected
seminormal equations and ``lstsq``; Lanczos and block-Lanczos ``eigsh``
(with shift-invert through LU), LOBPCG and ``svds``; Arnoldi and
``expm_multiply``.

Every sparse product on these paths is the operand's own ``@`` or ``*``:
the port's CSR or BSR SpMV kernel, its CSR SpMM kernel for a block of
vectors, and its SpGEMM kernel for ``AᵀA``, on the card. Dense work on
fronts, panels and small projected problems (batched Cholesky and LU,
triangular solves, Schur updates, QR, ``eigh``, ``matrix_exp``) is
torch's. ``cg``, ``gmres``, ``bicgstab``, ``chebyshev``, ``lanczos``,
``eigsh`` and ``lobpcg`` also take a row-partitioned ``DistCsr``
(:mod:`spalinalg_tpu_torch.parallel`), and
:func:`~.supernodal.supernodal_factor_sharded` spreads the supernodal
Cholesky's buckets over a row mesh.
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
from .eigen import block_lanczos, eigsh, lanczos, lobpcg, svds
from .funm import arnoldi, expm_multiply
from .iterative import IterResult, bicgstab, gmres
from .lu import LuFactor, lu, lu_solve
from .ordering import bandwidth, level_schedule, rcm_ordering
from .precond import ChebyshevPrecond, Ilu0Precond, chebyshev, ic0, ilu0
from .qr import (
    QrFactor,
    lstsq,
    qr,
    qr_q_apply,
    qr_qt_apply,
    qr_r_dense,
    qr_solve,
)
from .solve import factorized, is_symmetric, spsolve
from .triangular import TriangularPlan, plan_triangular, solve_triangular_csr

__all__ = [
    "cg", "CgResult", "gmres", "bicgstab", "IterResult",
    "eigsh", "svds", "lanczos", "block_lanczos", "lobpcg",
    "ilu0", "ic0", "Ilu0Precond", "chebyshev", "ChebyshevPrecond",
    "expm_multiply", "arnoldi",
    "cholesky", "cholesky_solve", "CholeskyFactor", "permute_csr",
    "lu", "lu_solve", "LuFactor",
    "qr", "qr_solve", "qr_q_apply", "qr_qt_apply", "qr_r_dense",
    "lstsq", "QrFactor",
    "spsolve", "factorized", "is_symmetric",
    "rcm_ordering", "bandwidth", "level_schedule",
    "solve_triangular_csr", "plan_triangular", "TriangularPlan",
    "band_cholesky_factor", "band_cholesky_solve", "BandCholeskyFactor",
    "band_lu_factor", "band_lu_solve", "BandLuFactor",
]
