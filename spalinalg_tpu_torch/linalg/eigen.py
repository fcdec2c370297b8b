"""Sparse eigensolvers and singular values: Lanczos ``eigsh``, block
Lanczos, LOBPCG and ``svds`` (counterpart of
``spalinalg_tpu/linalg/eigen.py``).

The Lanczos basis lives as one dense ``(m+1, n)`` tensor and each step's
full reorthogonalisation is two full-basis GEMVs (rows not yet filled are
zero, so no masking), as ``gmres``'s. The loops are Python loops of a
fixed count with no read back; the small projected eigenproblems are
``torch.linalg.eigh`` on the device. Every product with a CSR operand is
the port's SpMV kernel (``A @ v``) or SpMM kernel (``A @ X``, for a block
of vectors) on the card; the SpMM wrapper takes transposed views and
column slices and makes them contiguous.

**Start vectors.** Where the caller gives none, they are drawn from a
``torch.Generator`` on the operand's device seeded with ``seed``: the
port's draws differ from the JAX package's ``jax.random`` ones, so Ritz
values agree with the JAX package's only as far as both converged, and
Ritz vectors only as subspaces.

**Row-partitioned operands.** :func:`lanczos`, :func:`eigsh` (its
single-vector path) and :func:`lobpcg` take a
:class:`~spalinalg_tpu_torch.parallel.DistCsr`: vectors and blocks are
then this rank's padded row slices (pad rows start zero and stay zero, so
the Ritz values are exact), each product is ``dist_spmv``/``dist_spmm``,
each reduction (dot products, basis projections, Gram matrices) an
``all_reduce`` over the mesh, and the thin QR of a tall block is a TSQR
(local QR, then one QR of the ranks' gathered ``R`` factors). ``svds`` and
the block and shift-invert paths of ``eigsh`` refuse one.

Examples
--------
>>> import math, torch
>>> from spalinalg_tpu_torch import diags
>>> n = 32
>>> A = diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(n, n), device="cpu")
>>> w, v = eigsh(A, k=3, which="LA")
>>> ref = [2 - 2 * math.cos(j * math.pi / (n + 1)) for j in (30, 31, 32)]
>>> bool(torch.allclose(w, torch.tensor(ref, dtype=torch.float64)))
True
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..device import resolve_device
from ..errors import ShapeError
from ..parallel.spmv import is_dist, norms, summed
from .cg import resolve_precond

__all__ = ["eigsh", "svds", "lanczos", "block_lanczos", "lobpcg"]


def _device(A) -> torch.device:
    """The operand's device (the scoped default where it names none)."""
    return resolve_device(getattr(A, "device", None))


def _dtype(A) -> torch.dtype:
    """float64 for a float64 operand, else float32 (the JAX package's
    ``_wants_x64``)."""
    return (torch.float64 if getattr(A, "dtype", None) == torch.float64
            else torch.float32)


def _normal(shape, seed: int, dtype, device) -> torch.Tensor:
    """Standard normal draws from a generator on ``device`` seeded with
    ``seed`` (not the JAX package's draws)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(shape, generator=gen, dtype=dtype, device=device)


def _shard_rows(X, A):
    """This rank's padded row slice of ``X`` for a ``DistCsr`` ``A``; ``X``
    itself otherwise."""
    if is_dist(A):
        from ..parallel.spmv import shard_matrix_rows, shard_vector

        return (shard_vector if X.ndim == 1 else shard_matrix_rows)(X, A)
    return X


def _qr(S, A):
    """Thin QR ``(Q, R)`` of a tall block: ``torch.linalg.qr``, or for a
    ``DistCsr`` a TSQR: each rank factors its rows, the ranks' ``R``
    factors are all-gathered and factored again (the same on every rank),
    and each rank keeps its rows of ``Q``."""
    Q1, R1 = torch.linalg.qr(S, mode="reduced")
    if not is_dist(A):
        return Q1, R1
    from ..parallel.partition import gather_rows

    r = R1.shape[0]
    Q2, R = torch.linalg.qr(gather_rows(R1, A.mesh), mode="reduced")
    return Q1 @ Q2[A.rank * r:(A.rank + 1) * r], R


def _refuse_dist(A, what: str) -> None:
    if is_dist(A):
        raise ValueError(
            f"{what} on DistCsr is unsupported — gather with A.to_csr() "
            "first, or use the single-vector eigsh or lobpcg")


def block_lanczos(A, m: int, b: int, *, seed: int = 0) -> torch.Tensor:
    """``m``-step block Lanczos with block size ``b`` and full
    reorthogonalisation: an orthonormal basis ``V`` of shape ``(m*b, n)``
    spanning the block-Krylov space.

    Block size ``b`` resolves eigenvalue clusters of multiplicity up to
    ``b``. Each step is one SpMM (``A`` on an ``(n, b)`` block), two
    full-basis GEMM orthogonalisations and one thin QR.
    """
    _refuse_dist(A, "block_lanczos")
    n = A.shape[1]
    dev, dt = _device(A), _dtype(A)
    with torch.no_grad():
        q0, _ = torch.linalg.qr(_normal((n, b), seed, dt, dev),
                                mode="reduced")               # (n, b)
        M = m * b
        V = q0.new_zeros((M + b, n))
        V[:b] = q0.mT
        for i in range(m):
            lo = i * b
            W = (A @ V[lo:lo + b].mT).to(dt)                  # (n, b) SpMM
            # full reorthogonalisation, twice (rows past lo + b are zero)
            W = W - V.mT @ (V @ W)
            W = W - V.mT @ (V @ W)
            Q, _ = torch.linalg.qr(W, mode="reduced")
            V[lo + b:lo + 2 * b] = Q.mT
    return V[:M]


def lanczos(A, m: int, *, v0=None, seed: int = 0):
    """``m``-step Lanczos with full reorthogonalisation.

    Returns ``(alpha, beta, V)``: the tridiagonal coefficients (``alpha``
    (m,), ``beta`` (m-1,)) and the orthonormal basis ``V`` ((m, n)).
    ``A`` is any operand with ``A @ v`` (CSR, CSC, BSR, dense tensor, an
    operator object with ``shape``), or a ``DistCsr``: ``v0`` and the
    basis are then this rank's padded slices (``shard_vector``), and a
    drawn start vector is the same global draw, sliced.
    """
    n = A.shape[1]
    dev = _device(A)
    total = summed(A)
    if v0 is None:
        v0 = _shard_rows(_normal((n,), seed, _dtype(A), dev), A)
    v0 = torch.as_tensor(v0, device=dev)
    dtype = v0.dtype
    with torch.no_grad():
        V = v0.new_zeros((m + 1, v0.shape[0]))
        V[0] = v0 / norms(v0, A)
        alpha = v0.new_zeros(m)
        beta = v0.new_zeros(m)
        for i in range(m):
            w = (A @ V[i]).to(dtype)
            a = total(torch.dot(V[i], w))
            # full reorthogonalisation: project out the whole current
            # basis (rows past i are zero, so plain products are safe),
            # twice
            h = total(V @ w)
            w = w - V.mT @ h
            h2 = total(V @ w)
            w = w - V.mT @ h2
            bn = norms(w, A)
            V[i + 1] = (torch.where(bn > 1e-12, 1.0, 0.0).to(dtype) * w
                        / bn.clamp_min(1e-300))
            alpha[i] = a
            beta[i] = bn
    return alpha, beta[: m - 1], V[:m]


def _tridiagonal(alpha, beta) -> torch.Tensor:
    return torch.diag(alpha) + torch.diag(beta, 1) + torch.diag(beta, -1)


def _unit_columns(v: torch.Tensor, A=None) -> torch.Tensor:
    return v / norms(v, A, keepdim=True)


class _ShiftInvertOp:
    """``(A - σI)⁻¹`` as a matvec operator through the factorization tier
    (:func:`~.lu.lu`; each product is one ``lu_solve`` a column)."""

    def __init__(self, A, sigma: float):
        from ..dtypes import numpy_dtype
        from ..ops.construct import diags
        from .lu import lu

        n = A.shape[0]
        if sigma != 0.0:
            shift = diags([float(sigma)], offsets=[0], shape=(n, n),
                          dtype=numpy_dtype(A.dtype), device=A.device)
            mat = A - shift
        else:
            mat = A
        self._fac = lu(mat)
        self.shape = A.shape
        self.dtype = A.dtype
        self.device = A.device

    def __matmul__(self, v):
        from .lu import lu_solve

        if v.ndim == 2:
            return torch.stack([lu_solve(self._fac, v[:, j])
                                for j in range(v.shape[1])], dim=1)
        return lu_solve(self._fac, v)


def _check_square(A, what: str) -> None:
    if A.shape[0] != A.shape[1]:
        raise ShapeError(f"{what} needs a square operator, got "
                         f"{tuple(A.shape)}")


def eigsh(A, k: int = 6, *, which: str = "LA", m: Optional[int] = None,
          v0=None, seed: int = 0, block: int = 1,
          sigma: Optional[float] = None
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top or bottom ``k`` eigenpairs of a symmetric sparse operator.

    ``which``: ``"LA"`` (largest algebraic) or ``"SA"`` (smallest). ``m``
    is the Krylov size (default ``min(n, max(2k + 8, 32))``). Returns
    ``(w, v)``, ``w`` ascending and ``v`` of shape ``(n, k)``.

    Single-vector Lanczos finds a degenerate eigenvalue of multiplicity
    ``d > 1`` only once; ``block=b >= d`` resolves such clusters
    (:func:`block_lanczos` + Rayleigh-Ritz, one SpMM a step). ``sigma``
    runs shift-invert on ``(A - σI)⁻¹`` through :func:`~.lu.lu`: the
    eigenvalues nearest ``σ``. A ``DistCsr`` takes the single-vector path
    only; ``v`` is then this rank's padded rows.
    """
    if sigma is not None or block > 1:
        _refuse_dist(A, "eigsh with sigma or block > 1")
    if sigma is not None:
        return _eigsh_shift_invert(A, k, sigma=sigma, m=m, seed=seed,
                                   block=block)
    if block > 1:
        return _eigsh_block(A, k, which=which, m=m, b=block, seed=seed)
    if which not in ("LA", "SA"):
        raise ValueError(f"which must be 'LA' or 'SA', got {which!r}")
    n = A.shape[0]
    _check_square(A, "eigsh")
    if not 0 < k < n:
        raise ValueError(f"need 0 < k < n, got k={k}, n={n}")
    m = int(m) if m is not None else min(n, max(2 * k + 8, 32))
    m = max(m, k + 1)

    alpha, beta, V = lanczos(A, m, v0=v0, seed=seed)
    w, y = torch.linalg.eigh(_tridiagonal(alpha, beta))      # ascending
    if which == "LA":
        w_k, y_k = w[-k:], y[:, -k:]
    else:
        w_k, y_k = w[:k], y[:, :k]
    # Ritz vectors, renormalised (unit up to a breakdown)
    return w_k, _unit_columns(V.mT @ y_k, A)


def _eigsh_shift_invert(A, k, *, sigma, m, seed, block=1):
    """Shift-invert mode: the eigenvalues of ``A`` nearest ``σ``.

    Lanczos runs on ``(A - σI)⁻¹`` (one LU at setup, one ``lu_solve`` a
    step and column); Ritz values θ map back as ``λ = σ + 1/θ``, chosen by
    the largest ``|θ|``.
    """
    n = A.shape[0]
    if not 0 < k < n:
        raise ValueError(f"need 0 < k < n, got k={k}, n={n}")
    op = _ShiftInvertOp(A, float(sigma))
    with torch.no_grad():
        if block > 1:
            mb = int(m) if m is not None else max(2, -(-max(2 * k + 8, 24)
                                                       // block))
            V = block_lanczos(op, mb, block, seed=seed)
            T = V @ (op @ V.mT)
            theta, y = torch.linalg.eigh((T + T.mT) / 2.0)
        else:
            mm = int(m) if m is not None else min(n, max(2 * k + 8, 24))
            mm = max(mm, k + 1)
            alpha, beta, V = lanczos(op, mm, seed=seed)
            theta, y = torch.linalg.eigh(_tridiagonal(alpha, beta))
        idx = torch.argsort(theta.abs())[-k:]                # nearest sigma
        lam = sigma + 1.0 / theta[idx]
        order = torch.argsort(lam)
        return lam[order], _unit_columns(V.mT @ y[:, idx][:, order])


def _eigsh_block(A, k, *, which, m, b, seed):
    """Block-Lanczos Rayleigh-Ritz path of :func:`eigsh`."""
    n = A.shape[0]
    _check_square(A, "eigsh")
    if not 0 < k < n:
        raise ValueError(f"need 0 < k < n, got k={k}, n={n}")
    m_blocks = (int(m) if m is not None
                else max(2, -(-max(2 * k + 8, 32) // b)))
    m_blocks = max(m_blocks, -(-(k + 1) // b))
    if m_blocks * b > n:
        m_blocks = max(1, n // b)
    V = block_lanczos(A, m_blocks, b, seed=seed)        # (M, n)
    with torch.no_grad():
        T = V @ (A @ V.mT).to(V.dtype)                  # (n, M) SpMM
        w, y = torch.linalg.eigh((T + T.mT) / 2.0)
        if which == "LA":
            w_k, y_k = w[-k:], y[:, -k:]
        else:
            w_k, y_k = w[:k], y[:, :k]
        return w_k, _unit_columns(V.mT @ y_k)


def lobpcg(A, X0=None, k: Optional[int] = None, *, which: str = "SA",
           maxiter: int = 40, M=None, seed: int = 0
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Locally Optimal Block Preconditioned Conjugate Gradient (Knyazev
    2001): the ``k`` extreme eigenpairs of a symmetric operator with no
    factorization.

    Each step is one SpMM on the ``(n, k)`` block (``A @ X``), one thin
    QR of the ``(n, 3k)`` trial block, one SpMM on it (``A @ Q``) and one
    ``(3k, 3k)`` dense ``eigh``, for ``maxiter`` steps (a fixed count, no
    test on the host); then a final Rayleigh-Ritz with one more ``A @ X``.

    ``A``: an operand with ``A @ X`` for ``(n, k)`` blocks. ``X0``: an
    optional ``(n, k)`` start block, random (``seed``) if omitted, when
    ``k`` must be given. ``which``: ``"SA"`` (default) or ``"LA"``. ``M``:
    an optional preconditioner, a callable ``r -> M⁻¹r`` or an object with
    ``.solve`` (:func:`~.precond.ic0`, :func:`~.precond.chebyshev`),
    applied column by column to the residual block.

    Returns ``(w, X, resid)``: Ritz values (ascending), Ritz vectors
    ``(n, k)`` and the residual norms ``||A x - θ x||``.

    ``A`` may be a ``DistCsr``: ``X0`` is still the global ``(n, k)``
    block (sliced here, as the drawn blocks are), the returned ``X`` is
    this rank's padded rows, each SpMM runs ``dist_spmm``, and ``M`` must
    then be sharding-aware (:func:`~.precond.chebyshev` on the operand).

    >>> import math
    >>> from spalinalg_tpu_torch import diags
    >>> n = 64
    >>> A = diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(n, n), device="cpu")
    >>> w, X, r = lobpcg(A, k=3, maxiter=60, seed=1)
    >>> ref = [2 - 2 * math.cos(j * math.pi / (n + 1)) for j in (1, 2, 3)]
    >>> bool(torch.allclose(w, torch.tensor(ref, dtype=torch.float64),
    ...                     atol=1e-5))
    True
    """
    if which not in ("SA", "LA"):
        raise ValueError(f"which must be 'SA' or 'LA', got {which!r}")
    n = A.shape[0]
    _check_square(A, "lobpcg")
    dev, dt = _device(A), _dtype(A)
    if X0 is None:
        if k is None:
            raise ValueError("lobpcg needs X0 or k")
        X0 = _normal((n, k), seed, dt, dev)
    X0 = torch.as_tensor(X0, device=dev).to(dt)
    if X0.ndim != 2 or X0.shape[0] != n:
        raise ValueError(f"X0 must be (n, k) = ({n}, k), got "
                         f"{tuple(X0.shape)}")
    if k is not None and X0.shape[1] != k:
        raise ValueError(
            f"k={k} conflicts with X0.shape[1]={X0.shape[1]}; "
            "pass one or make them agree")
    k = X0.shape[1]
    if 3 * k > n:
        raise ValueError(
            f"lobpcg needs n ≥ 3k for its trial space, got n={n}, k={k} "
            "(use eigsh or a dense eigh at this size)")
    # Padded row slices for a DistCsr: pad rows start zero and every step
    # keeps them zero, so the padded operator's zero modes never enter.
    X0 = _shard_rows(X0, A)
    total = summed(A)

    psolve = resolve_precond(M, A, jacobi=False, error=TypeError)

    def precond_block(R):
        if psolve is None:
            return R
        return torch.stack([psolve(R[:, j]).to(dt) for j in range(k)],
                           dim=1)

    lo = 0 if which == "SA" else 2 * k
    hi = k if which == "SA" else 3 * k
    with torch.no_grad():
        X, _ = _qr(X0, A)
        # P starts as a random orthonormal block: a zero P would hand QR a
        # rank-deficient trial block on step one. Its directions are
        # harmless (Rayleigh-Ritz ignores them) and are replaced after one
        # step by true conjugate directions.
        P0 = _shard_rows(_normal((n, k), seed + 1, dt, dev), A)
        P, _ = _qr(P0 - X @ total(X.mT @ P0), A)
        for _ in range(maxiter):
            AX = (A @ X).to(dt)                            # (n, k) SpMM
            H = total(X.mT @ AX)
            R = AX - X @ H                                 # block residual
            S = torch.cat([X, precond_block(R), P], dim=1)  # (n, 3k)
            Q, _ = _qr(S, A)
            T = total(Q.mT @ (A @ Q).to(dt))               # (n, 3k) SpMM
            theta, Z = torch.linalg.eigh((T + T.mT) / 2.0)  # ascending
            Xn = Q @ Z[:, lo:hi]                           # (n, k)
            # conjugate direction: the part of the update outside
            # span(X), re-orthonormalised (kept from the last step where
            # it breaks down at convergence)
            Qp, Rp = _qr(Xn - X @ total(X.mT @ Xn), A)
            good = torch.diagonal(Rp).abs() > 1e-10
            P = torch.where(good[None, :], Qp, P)
            X = Xn

        # final Rayleigh-Ritz on the converged block
        AX = (A @ X).to(dt)
        T = total(X.mT @ AX)
        w, Z = torch.linalg.eigh((T + T.mT) / 2.0)
        X = X @ Z
        AX = AX @ Z
        resid = norms(AX - X * w[None, :], A)
    return w, X, resid


class _Gram:
    """Matrix-free symmetric operator of the smaller Gram side of ``a``:
    ``aᵀ(a v)`` (``right``) or ``a(aᵀ v)`` (``left``), two SpMVs a
    product, no SpGEMM."""

    def __init__(self, a, side: str):
        self._a = a
        self._at = a.transpose()
        self._side = side
        s = a.shape[1] if side == "right" else a.shape[0]
        self.shape = (s, s)
        self.dtype = a.dtype
        self.device = a.device

    def __matmul__(self, v):
        if self._side == "right":
            return self._at @ (self._a @ v)
        return self._a @ (self._at @ v)


def svds(A, k: int = 6, *, m: Optional[int] = None, seed: int = 0):
    """Top ``k`` singular triplets ``(u, s, vt)`` of a sparse matrix.

    Runs :func:`eigsh` on the Gram operator of the smaller side
    (``AᵀA`` or ``AAᵀ``, matrix-free: two SpMVs a Lanczos step), then
    recovers the other factor by one product with ``A`` (an SpMM).
    A ``DistCsr`` raises ``ValueError`` (the operand spaces of ``A`` and
    ``Aᵀ`` shard differently for a rectangular operand).
    """
    if is_dist(A):
        raise ValueError(
            "svds on DistCsr is unsupported (the A / Aᵀ operand vector "
            "spaces shard differently for rectangular operands) — gather "
            "with A.to_csr() first, or use eigsh on a pre-formed Gram "
            "operator")
    mm, nn = A.shape
    if not 0 < k < min(mm, nn):
        raise ValueError(f"need 0 < k < min(shape), got k={k}, "
                         f"{tuple(A.shape)}")
    side = "right" if nn <= mm else "left"
    w, vecs = eigsh(_Gram(A, side), k=k, which="LA", m=m, seed=seed)
    with torch.no_grad():
        s = torch.flip(torch.sqrt(w.clamp_min(0.0)), (0,))   # descending
        vecs = torch.flip(vecs, (1,))
        inv_s = torch.where(s > 0, 1.0 / s.clamp_min(1e-300), 0.0)
        if side == "right":
            v = vecs                                          # (n, k)
            u = (A @ v).to(v.dtype) * inv_s[None, :]          # (m, k)
        else:
            u = vecs                                          # (m, k)
            v = (A.transpose() @ u).to(u.dtype) * inv_s[None, :]
    return u, s, v.mT
