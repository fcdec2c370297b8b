"""The port's distributed tier against the JAX package's, on a 4-rank gloo
gang.

One gang of 4 processes (``spawn``) runs for the whole file: each rank
joins through ``multihost.initialize`` (a ``file://`` rendezvous), builds
the same NumPy inputs from fixed seeds, runs every case below on the CPU
and sends its results back. The parent runs the JAX package's
``spalinalg_tpu.parallel`` on ``make_row_mesh(4)`` of the 8-device CPU
mesh on the same inputs, and each test compares one case:

- the partition arrays, exactly, rank by rank (``rowptr``, ``colind``,
  ``values``, ``brow``, ``comm``, ``halo_width``), for random, banded and
  102-row matrices, and for BSR shards;
- ``dist_spmv`` / ``dist_spmm`` (K = 3) in both comm modes within rtol
  1e-12 (float64) / 1e-5 (float32); ``dist_dot``, ``shard_vector``,
  ``unshard_vector``, ``shard_matrix_rows``; ``dist_bsr_spmv``;
- ``to_csr`` and ``transpose``; ``DistCsr * DistCsr`` (structure exactly,
  values within 1e-12) and its ``ShapeError`` / ``ValueError``;
- ``cg`` (plain, Jacobi, Chebyshev), ``gmres`` and ``bicgstab``: equal
  iteration counts, solutions within the JAX tests' tolerances; a
  single-chip preconditioner refused; ``lanczos`` / ``eigsh`` /
  ``lobpcg`` eigenvalues within 1e-8; ``svds`` refused;
- ``expm_multiply`` on a ``DistCsr``;
- ``supernodal_factor_sharded``: its solve within 1e-10;
- a ``DistCsr`` checkpoint, shard by shard (``save_npz`` / ``load_npz``
  with ``mesh``): the same shards and products back, and a checkpoint of
  4 ranks refused on one;
- ``initialize`` (the gang itself; a no-op at one process),
  ``heartbeat``, ``global_device_summary``;
- the three JAX faults the port repairs, each against the dense product;
- the port's own rank-local entry, ``shard_from_rows`` (each rank's rows
  give ``partition_csr``'s shard bit for bit; the halo width agreed; the
  same errors), the ``DistCsr`` Jacobi against the torch chain it
  replaced, bit for bit, CG on HPCG's 27-point stencil against a
  matrix-free reference, and the spans ``spal.halo`` and
  ``spal.allreduce``.

Every wait has a timeout: the process group's (60 s), the parent's (180
s), after which the children are killed and the tests fail.
"""

import multiprocessing
import os
import queue
import time
import traceback

import numpy as np
import pytest
import scipy.sparse as sps
import torch

P = 4                      # ranks of the gang
PG_TIMEOUT_S = 60          # the process group's timeout
GANG_TIMEOUT_S = 180       # the parent's wait for the gang's results
TOL = {"float64": 1e-12, "float32": 1e-5}
NP = {"float64": np.float64, "float32": np.float32}


# ---------------------------------------------------------------------------
# inputs: scipy CSR matrices from fixed seeds, built alike in every process
# ---------------------------------------------------------------------------

def random_csr(n, m, density, seed):
    rng = np.random.default_rng(seed)
    d = np.where(rng.random((n, m)) < density, rng.normal(size=(n, m)), 0)
    return sps.csr_matrix(d)


def banded_csr(n, bw, seed):
    rng = np.random.default_rng(seed)
    d = np.zeros((n, n))
    for i in range(n):
        lo, hi = max(0, i - bw), min(n, i + bw + 1)
        d[i, lo:hi] = rng.normal(size=hi - lo)
    return sps.csr_matrix(d)


def lap1d(n):
    return sps.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(n, n)).tocsr()


def lap2d(k):
    T = sps.diags([-1.0, 4.0, -1.0], [-1, 0, 1], shape=(k, k))
    D = sps.diags([-1.0, -1.0], [-1, 1], shape=(k, k))
    return (sps.kron(sps.eye(k), T) + sps.kron(D, sps.eye(k))).tocsr()


def convdiff2d(k, c=0.6):
    T = sps.diags([-1.0 - c, 4.0 + 2 * c, -1.0], [-1, 0, 1], shape=(k, k))
    D = sps.diags([-1.0 - c, -1.0], [-1, 1], shape=(k, k))
    return (sps.kron(sps.eye(k), T) + sps.kron(D, sps.eye(k))).tocsr()


def block_banded(nbr, bs, seed):
    """Block-tridiagonal BSR parts ``(indptr, indices, data)``."""
    rng = np.random.default_rng(seed)
    indptr, indices = [0], []
    for i in range(nbr):
        indices.extend(j for j in (i - 1, i, i + 1) if 0 <= j < nbr)
        indptr.append(len(indices))
    data = rng.normal(size=(len(indices), bs, bs))
    return np.asarray(indptr), np.asarray(indices), data


def fault1_csr():
    """40 x 80 with a diagonal: the JAX package picks "halo" for it."""
    return sps.csr_matrix((np.arange(1.0, 41.0),
                           (np.arange(40), np.arange(40))), shape=(40, 80))


def fault2_csr():
    """40 x 40, the diagonal and A[i, i + 15]: a halo of 15 over shards of
    10 rows."""
    i, j = np.arange(40), np.arange(25)
    vals = np.concatenate([np.full(40, 2.0), np.ones(25)])
    rows, cols = np.concatenate([i, j]), np.concatenate([i, j + 15])
    return sps.csr_matrix((vals, (rows, cols)), shape=(40, 40))


def stencil27(nx, ny, nz):
    """HPCG's 27-point operator (diagonal 26, every neighbour -1), rows
    numbered ``(z·ny + y)·nx + x``: 27·I less the 3 x 3 x 3 box sum."""
    def ones3(n):
        return sps.diags([1.0, 1.0, 1.0], [-1, 0, 1], shape=(n, n))

    box = sps.kron(ones3(nz), sps.kron(ones3(ny), ones3(nx)))
    return (27.0 * sps.eye(nx * ny * nz) - box).tocsr()


def stencil27_apply(x, grid):
    """The same operator applied without a matrix (torch, any dtype)."""
    import torch.nn.functional as F

    nx, ny, nz = grid
    g = F.pad(x.view(nz, ny, nx), (1, 1, 1, 1, 1, 1))
    s = g[:, :, :-2] + g[:, :, 1:-1] + g[:, :, 2:]
    s = s[:, :-2] + s[:, 1:-1] + s[:, 2:]
    s = s[:-2] + s[1:-1] + s[2:]
    return (27 * x.view(nz, ny, nx) - s).reshape(-1)


def reach_csr():
    """``banded_csr(96, 3, 12)`` and one entry ``A[70, 80]``: rank 2 of 4
    (rows 48-71) reaches 9 columns past its rows, the others 3."""
    S = banded_csr(96, 3, 12).tolil()
    S[70, 80] = 0.5
    return S.tocsr()


def zero_diag_csr():
    """``lap1d(96)`` with the diagonal of rows 5, 50 and 90 stored as 0 and
    the diagonal entry of row 30 left out."""
    S = lap1d(96).tocoo()
    d = (S.row == S.col)
    vals = np.where(d & np.isin(S.row, [5, 50, 90]), 0.0, S.data)
    keep = ~(d & (S.row == 30))
    return sps.csr_matrix((vals[keep], (S.row[keep], S.col[keep])),
                          shape=S.shape)


STENCIL = (8, 8, 32)       # 2048 rows: 512 a rank, a halo of 8·8


def rank_rows(S, rank):
    """Rank ``rank``'s block of rows of ``S`` (global columns), as
    ``partition_csr`` cuts them."""
    n = S.shape[0]
    per = -(-n // P)
    return S[min(rank * per, n):min((rank + 1) * per, n)]


MATS = {"random": lambda: random_csr(100, 100, 0.05, 11),
        "banded": lambda: banded_csr(96, 3, 12),
        "nondiv": lambda: random_csr(102, 102, 0.08, 13)}
SPMV_CASES = [("banded", "halo"), ("banded", "allgather"),
              ("nondiv", None)]
K = 3


def vec(n, seed, shape=None):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n,) if shape is None else shape)


def sorted_csr(S, dtype=np.float64):
    S = S.tocsr().astype(dtype)
    S.sort_indices()
    return S


def port_csr(S, dtype=np.float64):
    import spalinalg_tpu_torch as tsp

    S = sorted_csr(S, dtype)
    return tsp.CsrMatrix(S.shape[0], S.shape[1], S.indptr, S.indices,
                         S.data, device="cpu")


def jax_csr(S, dtype=np.float64):
    import spalinalg_tpu as jsp

    S = sorted_csr(S, dtype)
    return jsp.CsrMatrix(S.shape[0], S.shape[1], S.indptr, S.indices, S.data)


# ---------------------------------------------------------------------------
# the gang: every case, run on each rank
# ---------------------------------------------------------------------------

def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else t


def _shard_arrays(d):
    return {"rowptr": _np(d.rowptr), "colind": _np(d.colind),
            "values": _np(d.values), "brow": _np(d.brow), "comm": d.comm,
            "halo_width": d.halo_width, "rows_per_shard": d.rows_per_shard}


def _cases(mesh, workdir):
    """``{name: fn}``: each fn runs on every rank and returns NumPy
    results (or raises); files go under ``workdir``."""
    import spalinalg_tpu_torch as tsp
    import spalinalg_tpu_torch.linalg as tla
    import spalinalg_tpu_torch.linalg.supernodal as sn
    from spalinalg_tpu_torch.errors import ShapeError
    from spalinalg_tpu_torch.parallel import (dist_bsr_spmv, dist_dot,
                                              dist_spmm, dist_spmv,
                                              make_row_mesh, partition_bsr,
                                              partition_csr,
                                              shard_bsr_vector,
                                              shard_matrix_rows,
                                              shard_vector, unshard_vector)
    from spalinalg_tpu_torch.parallel import multihost

    cases = {}

    def case(name):
        def deco(fn):
            cases[name] = fn
            return fn
        return deco

    for mname, build in MATS.items():
        @case(f"partition/{mname}")
        def _(build=build):
            return _shard_arrays(partition_csr(port_csr(build()), mesh))

    for (mname, comm) in SPMV_CASES:
        for dname in TOL:
            @case(f"spmv/{mname}/{comm}/{dname}")
            def _(mname=mname, comm=comm, dname=dname):
                S = MATS[mname]()
                d = partition_csr(port_csr(S, NP[dname]), mesh, comm=comm)
                x = vec(S.shape[1], 5).astype(NP[dname])
                X = vec(S.shape[1], 6, (S.shape[1], K)).astype(NP[dname])
                y = unshard_vector(dist_spmv(d, shard_vector(x, d)), d)
                Y = unshard_vector(dist_spmm(d, shard_matrix_rows(X, d)), d)
                return {"comm": d.comm, "y": _np(y), "Y": _np(Y),
                        "y_local_len": d.rows_per_shard}

    @case("vectors")
    def _():
        d = partition_csr(port_csr(MATS["random"]()), mesh)
        u, v = vec(100, 7), vec(100, 8)
        us, vs = shard_vector(u, d, by="rows"), shard_vector(v, d, by="rows")
        X = vec(100, 9, (100, K))
        return {"dot": float(dist_dot(us, vs, d)), "u_local": _np(us),
                "X_local": _np(shard_matrix_rows(X, d)),
                "u_back": _np(unshard_vector(us, d))}

    for dname in ("float32", "float64"):
        @case(f"bsr/{dname}")
        def _(dname=dname):
            indptr, indices, data = block_banded(10, 8, 3)
            bsr = tsp.BsrMatrix(80, 80, 8, indptr, indices,
                                data.astype(NP[dname]), device="cpu")
            d = partition_bsr(bsr, mesh)
            x = vec(80, 7).astype(NP[dname])
            y = dist_bsr_spmv(d, shard_bsr_vector(x, d))
            return {"rows": _np(d.rows), "cols": _np(d.cols),
                    "data": _np(d.data), "nbr": d.nbr_per_shard,
                    "nblk": d.nblk_per_shard, "x_local": _np(
                        shard_bsr_vector(x, d)),
                    "y": _np(unshard_vector(y, d)), "dtype": str(y.dtype)}

    @case("to_csr_transpose")
    def _():
        S = random_csr(64, 64, 0.1, 14)
        d = partition_csr(port_csr(S), mesh)
        dt = d.transpose()
        x = vec(64, 15)
        return {"dense": _np(d.to_csr().to_dense()),
                "y_t": _np(unshard_vector(dist_spmv(dt, shard_vector(x, dt)),
                                          dt)),
                "t": _shard_arrays(dt)}

    @case("spgemm")
    def _():
        da = partition_csr(port_csr(random_csr(80, 96, 0.1, 21)), mesh)
        db = partition_csr(port_csr(random_csr(96, 72, 0.1, 22)), mesh)
        return _shard_arrays(da * db)

    @case("spgemm_errors")
    def _():
        a = partition_csr(tsp.CsrMatrix.eye(10, device="cpu"), mesh)
        b = partition_csr(tsp.CsrMatrix.eye(12, device="cpu"), mesh)
        out = {}
        try:
            a * b
        except ShapeError as e:
            out["shape"] = str(e)
        other = make_row_mesh(device="cpu")
        c = partition_csr(tsp.CsrMatrix.eye(10, device="cpu"), other)
        try:
            a * c
        except ValueError as e:
            out["mesh"] = str(e)
        return out

    def solve(name, build, solver, seed, **kw):
        @case(f"solver/{name}")
        def _():
            S = build()
            d = partition_csr(port_csr(S), mesh)
            b = shard_vector(vec(S.shape[0], seed), d, by="rows")
            res = getattr(tla, solver)(d, b, **kw)
            return {"x": _np(unshard_vector(res.x, d)),
                    "iterations": int(res.iterations)}

    solve("cg", lambda: lap1d(96), "cg", 5, tol=1e-12)
    solve("cg_jacobi", lambda: lap1d(96), "cg", 8, tol=1e-12,
          precondition="jacobi")
    solve("gmres", lambda: convdiff2d(10), "gmres", 17, tol=1e-10)
    solve("bicgstab", lambda: convdiff2d(10), "bicgstab", 17, tol=1e-10)

    @case("solver/cg_chebyshev")
    def _():
        S = lap2d(8)
        d = partition_csr(port_csr(S), mesh)
        M = tla.chebyshev(d, degree=6, lmin=0.2, lmax=8.0)
        res = tla.cg(d, shard_vector(vec(64, 16), d), tol=1e-10,
                     precondition=M)
        return {"x": _np(unshard_vector(res.x, d)),
                "iterations": int(res.iterations),
                "supports_dist": M.supports_dist}

    @case("solver_refusals")
    def _():
        S = lap2d(8)
        A = port_csr(S)
        d = partition_csr(A, mesh)
        b = shard_vector(np.ones(64), d)
        out = {}
        for what, fn in (
                ("cg_ic0", lambda: tla.cg(d, b, precondition=tla.ic0(A))),
                ("gmres_ilu0", lambda: tla.gmres(d, b, M=tla.ilu0(A))),
                ("bicgstab_ilu0", lambda: tla.bicgstab(d, b, M=tla.ilu0(A))),
                ("lobpcg_ic0", lambda: tla.lobpcg(d, k=2, M=tla.ic0(A))),
                ("chebyshev_bounds", lambda: tla.chebyshev(d)),
                ("svds", lambda: tla.svds(d, k=2)),
                ("eigsh_block", lambda: tla.eigsh(d, k=2, block=2))):
            try:
                fn()
                out[what] = None
            except ValueError as e:
                out[what] = str(e)
        return out

    @case("eigen/lanczos")
    def _():
        S = lap2d(10)
        d = partition_csr(port_csr(S), mesh)
        v0 = shard_vector(vec(100, 31), d)
        alpha, beta, V = tla.lanczos(d, 30, v0=v0)
        w, v = tla.eigsh(d, k=3, which="LA", m=60, v0=v0)
        ws, _ = tla.eigsh(d, k=3, which="SA", m=60, v0=v0)
        return {"alpha": _np(alpha), "beta": _np(beta), "w": _np(w),
                "ws": _np(ws), "v": _np(unshard_vector(v, d)),
                "V_rows": V.shape[1]}

    @case("eigen/lobpcg")
    def _():
        S = lap2d(12)
        d = partition_csr(port_csr(S), mesh)
        X0 = vec(144, 32, (144, 3))
        w, X, r = tla.lobpcg(d, X0=X0, maxiter=80, seed=4)
        Mc = tla.chebyshev(d, degree=4, lmin=0.1, lmax=8.0)
        wm, _, rm = tla.lobpcg(d, X0=X0, maxiter=40, M=Mc, seed=4)
        return {"w": _np(w), "X": _np(unshard_vector(X, d)), "r": _np(r),
                "wm": _np(wm), "rm": _np(rm), "X_local": _np(X)}

    @case("funm/expm")
    def _():
        d = partition_csr(port_csr(0.1 * lap2d(8)), mesh)
        u = tla.expm_multiply(d, shard_vector(vec(64, 81), d), t=1.0, m=40)
        return {"u": _np(unshard_vector(u, d))}

    @case("supernodal_sharded")
    def _():
        from spalinalg_tpu_torch.linalg.cholesky import permute_csr

        A = port_csr(lap2d(14))
        fac = tla.cholesky(A, method="supernodal")
        plan = fac.snf.plan
        pm = permute_csr(A, fac.perm) if fac.perm is not None else A
        f1 = sn.supernodal_factor(plan, pm.values)
        f2 = sn.supernodal_factor_sharded(plan, pm.values, mesh)
        b = torch.from_numpy(vec(196, 41))
        split = [bk.sids.size for lv in plan.levels for bk in lv
                 if bk.sids.size % P == 0]
        return {"x1": _np(sn.supernodal_solve(f1, b, perm=fac.perm)),
                "x2": _np(sn.supernodal_solve(f2, b, perm=fac.perm)),
                "ok": f2.ok, "split_buckets": split,
                "panel_gap": max(float((f1.panels[k] - f2.panels[k])
                                       .abs().max()) for k in f1.panels)}

    @case("multihost")
    def _():
        multihost.initialize(num_processes=1)     # a no-op
        return {"heartbeat": multihost.heartbeat(),
                "summary": multihost.global_device_summary()}

    @case("checkpoint")
    def _():
        """Each rank saves its shard to its own file and loads it back,
        in both comm modes."""
        from spalinalg_tpu_torch.io import load_npz, save_npz
        from spalinalg_tpu_torch.io.checkpoint import shard_path

        out = {}
        for mname, comm in (("banded", "halo"), ("nondiv", None)):
            d = partition_csr(port_csr(MATS[mname]()), mesh, comm=comm)
            path = os.path.join(workdir, f"ckpt_{mname}.npz")
            save_npz(path, d)
            back = load_npz(path, mesh=mesh)
            x = shard_vector(vec(d.ncols, 91), d)
            out[mname] = {
                "file": os.path.exists(shard_path(path, d.rank)),
                "orig": _shard_arrays(d), "back": _shard_arrays(back),
                "local": [_np(t) for t in (back.local.rowptr,
                                           back.local.colind,
                                           back.local.values)],
                "local_orig": [_np(t) for t in (d.local.rowptr,
                                                d.local.colind,
                                                d.local.values)],
                "local_shape": [back.local.shape, d.local.shape],
                "y": _np(dist_spmv(back, x)), "y_orig": _np(dist_spmv(d, x)),
                "path": path}
        return out

    from_rows = dict(MATS, stencil=lambda: stencil27(*STENCIL),
                     reach=reach_csr)
    for mname, build in from_rows.items():
        @case(f"from_rows/{mname}")
        def _(build=build):
            """This rank's rows through ``shard_from_rows`` beside the
            whole matrix through ``partition_csr``."""
            from spalinalg_tpu_torch.parallel.partition import shard_from_rows

            S = build()
            rank = mesh.get_local_rank()
            mine = shard_from_rows(port_csr(rank_rows(S, rank)), *S.shape,
                                   mesh)
            whole = partition_csr(port_csr(S), mesh)
            return {"rows": _shard_arrays(mine),
                    "whole": _shard_arrays(whole),
                    "local": [_np(t) for t in (mine.local.rowptr,
                                               mine.local.colind,
                                               mine.local.values)],
                    "local_whole": [_np(t) for t in (whole.local.rowptr,
                                                     whole.local.colind,
                                                     whole.local.values)],
                    "local_shape": [mine.local.shape, whole.local.shape]}

    @case("from_rows_errors")
    def _():
        from spalinalg_tpu_torch.parallel.partition import shard_from_rows

        S = fault2_csr()
        rank = mesh.get_local_rank()
        out = {}
        for key, fn in (
                ("rows", lambda: shard_from_rows(
                    port_csr(rank_rows(S, rank)), 40, 40, mesh,
                    comm="halo")),
                ("whole", lambda: partition_csr(port_csr(S), mesh,
                                                comm="halo")),
                ("mode", lambda: shard_from_rows(
                    port_csr(rank_rows(S, rank)), 40, 40, mesh,
                    comm="ring"))):
            try:
                fn()
                out[key] = None
            except ValueError as e:
                out[key] = str(e)
        try:
            shard_from_rows(port_csr(S[:3]), 40, 40, mesh)
            out["shape"] = None
        except ShapeError as e:
            out["shape"] = str(e)
        return out

    jacobi_mats = {"stencil": lambda: stencil27(*STENCIL),
                   "zero_diag": zero_diag_csr,
                   "random": MATS["random"], "nondiv": MATS["nondiv"]}
    for mname, build in jacobi_mats.items():
        @case(f"jacobi/{mname}")
        def _(build=build):
            """The Jacobi inverse ``cg`` builds on a ``DistCsr``, and the
            torch chain it replaced, recomputed here from the shard."""
            from spalinalg_tpu_torch.linalg.cg import _jacobi_precond

            d = partition_csr(port_csr(build()), mesh)
            ones = torch.ones(d.rows_per_shard, dtype=d.dtype)
            rows = d.brow.long()
            on_diag = (d.colind.long() == rows + d.rank * d.rows_per_shard
                       ) & (rows < d.rows_per_shard)
            diag = torch.ones(d.rows_per_shard, dtype=d.dtype)
            diag[rows[on_diag]] = d.values[on_diag]
            chain = torch.where(diag != 0,
                                1 / torch.where(diag != 0, diag, 1), 1)
            return {"kernel": _np(_jacobi_precond(d)(ones)),
                    "chain": _np(chain)}

    @case("solver/cg_stencil")
    def _():
        from spalinalg_tpu_torch.parallel.partition import shard_from_rows

        S = stencil27(*STENCIL)
        rank = mesh.get_local_rank()
        d = shard_from_rows(port_csr(rank_rows(S, rank)), *S.shape, mesh,
                            comm="halo")
        b = shard_vector(vec(S.shape[0], 77), d)
        res = tla.cg(d, b, tol=0.0, maxiter=12, precondition="jacobi")
        return {"x": _np(unshard_vector(res.x, d)),
                "residual": float(res.residual),
                "iterations": int(res.iterations)}

    @case("spans")
    def _():
        """The distributed spans' counts in the registry: on under
        ``tracing()``, nothing recorded off."""
        from spalinalg_tpu_torch.parallel.partition import shard_from_rows
        from spalinalg_tpu_torch.utils import profiling

        S = stencil27(*STENCIL)
        rank = mesh.get_local_rank()
        d = shard_from_rows(port_csr(rank_rows(S, rank)), *S.shape, mesh,
                            comm="halo")
        x = shard_vector(vec(S.shape[0], 78), d)
        names = ("spal.halo", "spal.allreduce", "spal.precond")
        profiling.reset()
        with profiling.tracing():
            dist_spmv(d, x)
            dist_dot(x, x, d)
            tla.cg(d, x, tol=0.0, maxiter=3, precondition="jacobi")
        on = {k: v["count"] for k, v in profiling.span_totals().items()
              if k in names}
        profiling.reset()
        with profiling.tracing():
            res = tla.cg(d, x, tol=1e-3 * float(dist_dot(x, x, d)) ** 0.5,
                         precondition="jacobi")
        from spalinalg_tpu_torch.linalg.cg import AHEAD

        converged = {"iterations": int(res.iterations), "ahead": AHEAD,
                     "halo": profiling.span_totals()["spal.halo"]["count"]}
        profiling.reset()
        dist_spmv(d, x)
        dist_dot(x, x, d)
        off = dict(profiling.span_totals())
        return {"on": on, "off": off, "halo_width": d.halo_width,
                "converged": converged}

    @case("window")
    def _():
        """Products on one halo ``DistCsr`` in turn, vectors and a block:
        each reads the window kept on the shard, refilled every call."""
        from spalinalg_tpu_torch.parallel.partition import shard_from_rows
        from spalinalg_tpu_torch.parallel.spmv import _operand

        S = stencil27(*STENCIL)
        n = S.shape[0]
        rank = mesh.get_local_rank()
        d = shard_from_rows(port_csr(rank_rows(S, rank)), *S.shape, mesh,
                            comm="halo")
        x1, x2 = shard_vector(vec(n, 81), d), shard_vector(vec(n, 82), d)
        X = shard_matrix_rows(vec(n, 83, (n, K)), d)
        ys = [unshard_vector(dist_spmv(d, x), d) for x in (x1, x2)]
        Y = unshard_vector(dist_spmm(d, X), d)
        ys.append(unshard_vector(dist_spmv(d, x1), d))
        w = _operand(d, x2)
        h = d.halo_width
        out = {"y": [_np(y) for y in ys], "Y": _np(Y),
               "windows": len(d.windows),
               "same": w.data_ptr() == _operand(d, x1).data_ptr(),
               "left": _np(w[:h]), "right": _np(w[-h:]), "grad": None}
        try:
            dist_spmv(d, x1.clone().requires_grad_())
        except ValueError as e:
            out["grad"] = str(e)
        return out

    @case("fault1")
    def _():
        S = fault1_csr()
        d = partition_csr(port_csr(S), mesh)
        x, X = vec(80, 51), vec(80, 52, (80, K))
        return {"comm": d.comm,
                "y": _np(unshard_vector(dist_spmv(d, shard_vector(x, d)), d)),
                "Y": _np(unshard_vector(
                    dist_spmm(d, shard_matrix_rows(X, d)), d))}

    @case("fault2")
    def _():
        S = fault2_csr()
        A = port_csr(S)
        out = {}
        try:
            partition_csr(A, mesh, comm="halo")
        except ValueError as e:
            out["halo_error"] = str(e)
        d = partition_csr(A, mesh)
        x, X = vec(40, 53), vec(40, 54, (40, K))
        out.update(comm=d.comm, y=_np(unshard_vector(
            dist_spmv(d, shard_vector(x, d)), d)), Y=_np(unshard_vector(
                dist_spmm(d, shard_matrix_rows(X, d)), d)))
        return out

    @case("fault3")
    def _():
        indptr, indices, data = block_banded(8, 8, 61)
        bsr = tsp.BsrMatrix(64, 64, 8, indptr, indices, data, device="cpu")
        d = partition_bsr(bsr, mesh)
        x = vec(64, 62)
        y = dist_bsr_spmv(d, shard_bsr_vector(x, d))
        return {"y": _np(unshard_vector(y, d)), "dtype": str(y.dtype)}

    return cases


def _worker(rank, init_file, results):
    """One rank of the gang: join, run every case, send the results."""
    out = {}
    workdir = os.path.dirname(init_file)
    # the Cholesky plans of this gang go to its own directory
    os.environ["SPALINALG_PLAN_CACHE"] = os.path.join(workdir, "plans")
    try:
        torch.set_num_threads(1)
        import spalinalg_tpu_torch as tsp
        from spalinalg_tpu_torch.parallel import make_row_mesh, multihost

        multihost.initialize(f"file://{init_file}", P, rank,
                             timeout_s=PG_TIMEOUT_S, device="cpu")
        with tsp.default_device("cpu"):
            mesh = make_row_mesh(P)
            for name, fn in _cases(mesh, workdir).items():
                try:
                    out[name] = fn()
                except Exception:
                    out[name] = {"__error__": traceback.format_exc()}
    except Exception:
        out["__fatal__"] = traceback.format_exc()
    finally:
        results.put((rank, out))
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()


class Gang:
    """The 4 ranks, started at once; :meth:`results` waits for their
    answers on first use (the JAX references are computed meanwhile)."""

    def __init__(self, init_file):
        ctx = multiprocessing.get_context("spawn")
        self._queue = ctx.Queue()
        self._deadline = time.monotonic() + GANG_TIMEOUT_S
        self._procs = [ctx.Process(target=_worker,
                                   args=(r, init_file, self._queue),
                                   daemon=True) for r in range(P)]
        for p in self._procs:
            p.start()
        self._got = None

    def results(self):
        """``{rank: {case: result}}``."""
        if self._got is None:
            got = {}
            try:
                while len(got) < P:
                    rank, out = self._queue.get(timeout=max(
                        self._deadline - time.monotonic(), 0.1))
                    got[rank] = out
            except queue.Empty:
                pass
            finally:
                self.stop()
            if len(got) < P:
                pytest.fail(f"the gang did not answer within "
                            f"{GANG_TIMEOUT_S} s (ranks {sorted(got)} did)")
            for rank, out in got.items():
                if "__fatal__" in out:
                    pytest.fail(f"rank {rank}: {out['__fatal__']}")
            self._got = got
        return self._got

    def stop(self):
        """Drain what the ranks still send (a rank exits only once its
        results are read), then join them, killing any that hang."""
        deadline = time.monotonic() + 10
        for p in self._procs:
            while p.is_alive() and time.monotonic() < deadline:
                try:
                    self._queue.get(timeout=0.1)
                except queue.Empty:
                    pass
            if p.is_alive():
                p.kill()
            p.join(timeout=10)


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    from spalinalg_tpu_torch.native import lib

    lib.load_library()          # built once here, not by four ranks at once
    g = Gang(str(tmp_path_factory.mktemp("gang") / "rendezvous"))
    yield g
    g.stop()


def result(gang, name, rank=0):
    out = gang.results()[rank][name]
    if isinstance(out, dict) and "__error__" in out:
        pytest.fail(f"rank {rank}, case {name}:\n{out['__error__']}")
    return out


def replicated(gang, name, key):
    """``key`` of a case's result, equal on every rank."""
    vals = [result(gang, name, r)[key] for r in range(P)]
    for v in vals[1:]:
        np.testing.assert_array_equal(v, vals[0])
    return vals[0]


# ---------------------------------------------------------------------------
# the JAX reference, in the parent
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jmesh():
    from spalinalg_tpu.parallel import make_row_mesh

    return make_row_mesh(P)


def jax_shard(arrays, rank):
    return {k: np.asarray(v)[rank] for k, v in arrays.items()}


def jax_partition(S, jmesh, comm=None, dtype=np.float64):
    from spalinalg_tpu.parallel import partition_csr

    d = partition_csr(jax_csr(S, dtype), jmesh, comm=comm)
    return d, {"rowptr": d.rowptr, "colind": d.colind, "values": d.values,
               "brow": d.brow}


def check_shard(got, d, arrays, rank, exact_values=True):
    want = jax_shard(arrays, rank)
    for key in ("rowptr", "colind", "brow"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    if exact_values:
        np.testing.assert_array_equal(got["values"], want["values"])
    else:
        np.testing.assert_allclose(got["values"], want["values"],
                                   rtol=1e-12, atol=1e-14)
    assert got["comm"] == d.comm
    assert got["halo_width"] == d.halo_width
    assert got["rows_per_shard"] == d.rows_per_shard


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mname", list(MATS))
@pytest.mark.parametrize("rank", range(P))
def test_partition_arrays(gang, jmesh, mname, rank):
    d, arrays = jax_partition(MATS[mname](), jmesh)
    check_shard(result(gang, f"partition/{mname}", rank), d, arrays, rank)


def test_partition_comm_choice(gang):
    assert result(gang, "partition/banded")["comm"] == "halo"
    assert result(gang, "partition/banded")["halo_width"] <= 3
    assert result(gang, "partition/random")["comm"] == "allgather"


@pytest.mark.parametrize("dname", list(TOL))
@pytest.mark.parametrize("mname,comm", SPMV_CASES)
def test_dist_spmv_spmm(gang, jmesh, mname, comm, dname):
    from spalinalg_tpu.parallel import (dist_spmm, dist_spmv,
                                        shard_matrix_rows, shard_vector,
                                        unshard_vector)

    S = MATS[mname]()
    d, _ = jax_partition(S, jmesh, comm, NP[dname])
    x = vec(S.shape[1], 5).astype(NP[dname])
    X = vec(S.shape[1], 6, (S.shape[1], K)).astype(NP[dname])
    jy = np.asarray(unshard_vector(dist_spmv(d, shard_vector(x, d)), d))
    jY = np.asarray(dist_spmm(d, shard_matrix_rows(X, d)))[: S.shape[0]]
    name = f"spmv/{mname}/{comm}/{dname}"
    assert replicated(gang, name, "comm") == d.comm
    tol = TOL[dname]
    y, Y = replicated(gang, name, "y"), replicated(gang, name, "Y")
    assert y.dtype == jy.dtype and Y.dtype == jY.dtype
    np.testing.assert_allclose(y, jy, rtol=tol, atol=tol)
    np.testing.assert_allclose(Y, jY, rtol=tol, atol=tol)
    dense = S.toarray()
    scale = np.abs(dense) @ np.abs(x.astype(np.float64))
    assert np.all(np.abs(y - dense @ x) <= 10 * tol * scale + tol)


@pytest.mark.parametrize("rank", range(P))
def test_shard_unshard_dot(gang, jmesh, rank):
    from spalinalg_tpu.parallel import (dist_dot, shard_matrix_rows,
                                        shard_vector)

    d, _ = jax_partition(MATS["random"](), jmesh)
    u, v, X = vec(100, 7), vec(100, 8), vec(100, 9, (100, K))
    us = np.asarray(shard_vector(u, d, by="rows"))
    Xs = np.asarray(shard_matrix_rows(X, d))
    per = d.rows_per_shard
    got = result(gang, "vectors", rank)
    np.testing.assert_array_equal(got["u_local"],
                                  us[rank * per:(rank + 1) * per])
    np.testing.assert_array_equal(got["X_local"],
                                  Xs[rank * per:(rank + 1) * per])
    np.testing.assert_array_equal(got["u_back"], u)
    jdot = float(dist_dot(shard_vector(u, d, by="rows"),
                          shard_vector(v, d, by="rows"), d))
    np.testing.assert_allclose(got["dot"], jdot, rtol=1e-12)
    np.testing.assert_allclose(got["dot"], u @ v, rtol=1e-12)


@pytest.mark.parametrize("rank", range(P))
def test_dist_bsr_partition_and_spmv(gang, jmesh, rank):
    import jax.numpy as jnp

    import spalinalg_tpu as jsp
    from spalinalg_tpu.parallel import (dist_bsr_spmv, partition_bsr,
                                        shard_bsr_vector)

    indptr, indices, data = block_banded(10, 8, 3)
    data32 = data.astype(np.float32)
    bsr = jsp.BsrMatrix._from_parts(80, 80, 8, 8, jnp.asarray(indptr),
                                    jnp.asarray(indices),
                                    jnp.asarray(data32))
    d = partition_bsr(bsr, jmesh)
    got = result(gang, "bsr/float32", rank)
    assert got["nbr"] == d.nbr_per_shard and got["nblk"] == d.nblk_per_shard
    np.testing.assert_array_equal(got["rows"], np.asarray(d.rows)[rank])
    np.testing.assert_array_equal(got["cols"], np.asarray(d.cols)[rank])
    np.testing.assert_array_equal(got["data"], np.asarray(d.data)[rank])
    x = vec(80, 7).astype(np.float32)
    xs = np.asarray(shard_bsr_vector(x, d))
    per = d.nbr_per_shard * 8
    np.testing.assert_array_equal(got["x_local"],
                                  xs[rank * per:(rank + 1) * per])
    jy = np.asarray(dist_bsr_spmv(d, shard_bsr_vector(x, d)))[:80]
    assert got["dtype"] == "torch.float32"
    np.testing.assert_allclose(got["y"], jy, rtol=2e-5, atol=2e-5)
    dense = sps.bsr_matrix((data32, indices, indptr), shape=(80, 80)).toarray()
    np.testing.assert_allclose(got["y"], dense @ x, rtol=2e-4, atol=2e-4)


def test_to_csr_and_transpose(gang, jmesh):
    S = random_csr(64, 64, 0.1, 14)
    np.testing.assert_array_equal(replicated(gang, "to_csr_transpose",
                                             "dense"), S.toarray())
    x = vec(64, 15)
    np.testing.assert_allclose(replicated(gang, "to_csr_transpose", "y_t"),
                               S.toarray().T @ x, rtol=1e-12, atol=1e-12)
    d, arrays = jax_partition(S, jmesh)
    jt = d.transpose()
    for rank in range(P):
        check_shard(result(gang, "to_csr_transpose", rank)["t"], jt,
                    {"rowptr": jt.rowptr, "colind": jt.colind,
                     "values": jt.values, "brow": jt.brow}, rank)


@pytest.mark.parametrize("rank", range(P))
def test_dist_spgemm(gang, jmesh, rank):
    from spalinalg_tpu.parallel import partition_csr

    a, b = random_csr(80, 96, 0.1, 21), random_csr(96, 72, 0.1, 22)
    jc = partition_csr(jax_csr(a), jmesh) * partition_csr(jax_csr(b), jmesh)
    check_shard(result(gang, "spgemm", rank), jc,
                {"rowptr": jc.rowptr, "colind": jc.colind,
                 "values": jc.values, "brow": jc.brow}, rank,
                exact_values=False)


def test_dist_spgemm_product(gang):
    a, b = random_csr(80, 96, 0.1, 21), random_csr(96, 72, 0.1, 22)
    c = (a @ b).toarray()
    out = [result(gang, "spgemm", r) for r in range(P)]
    per = out[0]["rows_per_shard"]
    got = np.zeros((P * per, 72))
    for r, o in enumerate(out):
        rows = np.repeat(np.arange(per), np.diff(o["rowptr"]))
        n = o["rowptr"][-1]
        got[r * per + rows, o["colind"][:n]] = o["values"][:n]
    np.testing.assert_allclose(got[:80], c, rtol=1e-12, atol=1e-13)


@pytest.mark.parametrize("what", ["shape", "mesh"])
def test_dist_spgemm_errors(gang, what):
    msg = replicated(gang, "spgemm_errors", what)
    assert ("dim mismatch" in msg) if what == "shape" else ("same mesh" in msg)


SOLVERS = {"cg": (lambda: lap1d(96), 5, dict(tol=1e-12)),
           "cg_jacobi": (lambda: lap1d(96), 8,
                         dict(tol=1e-12, precondition="jacobi")),
           "gmres": (lambda: convdiff2d(10), 17, dict(tol=1e-10)),
           "bicgstab": (lambda: convdiff2d(10), 17, dict(tol=1e-10))}


@pytest.mark.parametrize("name", list(SOLVERS))
def test_dist_solvers(gang, jmesh, name):
    import spalinalg_tpu.linalg as jla
    from spalinalg_tpu.parallel import shard_vector, unshard_vector

    build, seed, kw = SOLVERS[name]
    S = build()
    d, _ = jax_partition(S, jmesh)
    b = vec(S.shape[0], seed)
    jres = getattr(jla, name.split("_")[0])(d, shard_vector(b, d, by="rows"),
                                            **kw)
    jx = np.asarray(unshard_vector(jres.x, d))
    x = replicated(gang, f"solver/{name}", "x")
    assert replicated(gang, f"solver/{name}", "iterations") == int(
        jres.iterations)
    np.testing.assert_allclose(x, jx, rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(S @ x, b, rtol=0, atol=1e-6 * np.abs(b).max())


def test_dist_cg_chebyshev(gang):
    """Against the JAX package's single-chip run, as its own distributed
    Chebyshev test does (its sharded run of this case compiles for 15 s
    on the CPU mesh)."""
    import spalinalg_tpu.linalg as jla

    A = jax_csr(lap2d(8))
    M = jla.chebyshev(A, degree=6, lmin=0.2, lmax=8.0)
    jres = jla.cg(A, vec(64, 16), tol=1e-10, precondition=M)
    assert replicated(gang, "solver/cg_chebyshev", "supports_dist")
    assert replicated(gang, "solver/cg_chebyshev", "iterations") == int(
        jres.iterations)
    np.testing.assert_allclose(replicated(gang, "solver/cg_chebyshev", "x"),
                               np.asarray(jres.x), atol=1e-6)


@pytest.mark.parametrize("what", ["cg_ic0", "gmres_ilu0", "bicgstab_ilu0",
                                  "lobpcg_ic0", "chebyshev_bounds", "svds",
                                  "eigsh_block"])
def test_dist_refusals(gang, what):
    msg = replicated(gang, "solver_refusals", what)
    assert msg is not None, f"{what} on a DistCsr did not raise"
    assert "DistCsr" in msg


def test_dist_lanczos_eigsh(gang, jmesh):
    import spalinalg_tpu.linalg as jla
    from spalinalg_tpu.parallel import shard_vector

    S = lap2d(10)
    d, _ = jax_partition(S, jmesh)
    v0 = shard_vector(vec(100, 31), d)
    alpha, beta, _ = jla.lanczos(d, 30, v0=v0)
    w, _ = jla.eigsh(d, k=3, which="LA", m=60, v0=v0)
    ws, _ = jla.eigsh(d, k=3, which="SA", m=60, v0=v0)
    np.testing.assert_allclose(replicated(gang, "eigen/lanczos", "alpha"),
                               np.asarray(alpha), atol=1e-8)
    np.testing.assert_allclose(replicated(gang, "eigen/lanczos", "beta"),
                               np.asarray(beta), atol=1e-8)
    np.testing.assert_allclose(replicated(gang, "eigen/lanczos", "w"),
                               np.asarray(w), atol=1e-8)
    np.testing.assert_allclose(replicated(gang, "eigen/lanczos", "ws"),
                               np.asarray(ws), atol=1e-8)
    exact = np.linalg.eigvalsh(S.toarray())
    np.testing.assert_allclose(replicated(gang, "eigen/lanczos", "w"),
                               exact[-3:], atol=1e-8)
    v = replicated(gang, "eigen/lanczos", "v")
    w_port = replicated(gang, "eigen/lanczos", "w")
    assert np.abs(S @ v - v * w_port).max() < 1e-6


def test_dist_lobpcg(gang, jmesh):
    import spalinalg_tpu.linalg as jla

    S = lap2d(12)
    d, _ = jax_partition(S, jmesh)
    X0 = vec(144, 32, (144, 3))
    jw, _, _ = jla.lobpcg(d, X0=X0, maxiter=80, seed=4)
    w = replicated(gang, "eigen/lobpcg", "w")
    np.testing.assert_allclose(w, np.asarray(jw), atol=1e-8)
    np.testing.assert_allclose(w, np.linalg.eigvalsh(S.toarray())[:3],
                               atol=1e-8)
    assert np.all(replicated(gang, "eigen/lobpcg", "r") < 1e-4)
    # pad rows of the last rank's Ritz block stay exactly zero
    local = result(gang, "eigen/lobpcg", P - 1)["X_local"]
    assert np.all(local[144 - (P - 1) * local.shape[0]:] == 0.0)
    # with a sharding-aware (Chebyshev) preconditioner
    np.testing.assert_allclose(replicated(gang, "eigen/lobpcg", "wm"),
                               np.linalg.eigvalsh(S.toarray())[:3],
                               atol=1e-8)


def test_dist_expm_multiply(gang):
    """Against the JAX package's single-chip run, as its own distributed
    ``expm_multiply`` test does, and against SciPy."""
    import scipy.sparse.linalg as spla

    import spalinalg_tpu.linalg as jla

    S, b = 0.1 * lap2d(8), vec(64, 81)
    u = replicated(gang, "funm/expm", "u")
    ref = np.asarray(jla.expm_multiply(jax_csr(S), b, t=1.0, m=40))
    np.testing.assert_allclose(u, ref, rtol=0, atol=1e-10)
    np.testing.assert_allclose(u, spla.expm_multiply(S.tocsc(), b),
                               rtol=0, atol=1e-8)


def test_supernodal_factor_sharded(gang):
    out = result(gang, "supernodal_sharded")
    assert out["ok"] and out["split_buckets"], out["split_buckets"]
    x1 = replicated(gang, "supernodal_sharded", "x1")
    x2 = replicated(gang, "supernodal_sharded", "x2")
    np.testing.assert_allclose(x2, x1, rtol=0, atol=1e-10 * np.abs(x1).max())
    ref = np.linalg.solve(lap2d(14).toarray(), vec(196, 41))
    np.testing.assert_allclose(x2, ref, rtol=0, atol=1e-10 * np.abs(ref).max())
    assert out["panel_gap"] < 1e-12


def test_supernodal_factor_sharded_matches_jax(gang):
    import jax.numpy as jnp

    import spalinalg_tpu.linalg as jla
    import spalinalg_tpu.linalg.supernodal as jsn
    from spalinalg_tpu.linalg.cholesky import permute_csr
    from spalinalg_tpu.parallel import make_row_mesh

    A = jax_csr(lap2d(14))
    fac = jla.cholesky(A, method="supernodal")
    pm = permute_csr(A, fac.perm) if fac.perm is not None else A
    f = jsn.supernodal_factor_sharded(fac.snf.plan, pm.values,
                                      make_row_mesh(P))
    jx = np.asarray(jsn.supernodal_solve(f, jnp.asarray(vec(196, 41)),
                                         perm=fac.perm))
    x2 = replicated(gang, "supernodal_sharded", "x2")
    np.testing.assert_allclose(x2, jx, rtol=0, atol=1e-10 * np.abs(jx).max())


@pytest.mark.parametrize("rank", range(P))
def test_multihost(gang, rank):
    out = result(gang, "multihost", rank)
    assert out["heartbeat"] >= 0
    assert out["summary"] == {"process_index": rank, "process_count": P,
                              "local_devices": ["cpu"],
                              "global_device_count": P}


@pytest.mark.parametrize("mname", ["banded", "nondiv"])
@pytest.mark.parametrize("rank", range(P))
def test_dist_checkpoint_round_trip(gang, rank, mname):
    """A ``DistCsr`` saved shard by shard (one file a rank) loads back to
    the same shard arrays, local block and products (bitwise)."""
    out = result(gang, "checkpoint", rank)[mname]
    assert out["file"]
    for key in ("rowptr", "colind", "values", "brow"):
        np.testing.assert_array_equal(out["back"][key], out["orig"][key])
    assert (out["back"]["comm"], out["back"]["halo_width"]) == (
        out["orig"]["comm"], out["orig"]["halo_width"])
    assert out["back"]["comm"] == ("halo" if mname == "banded"
                                   else "allgather")
    for got, want in zip(out["local"], out["local_orig"]):
        np.testing.assert_array_equal(got, want)
    assert out["local_shape"][0] == out["local_shape"][1]
    np.testing.assert_array_equal(out["y"], out["y_orig"])


def test_dist_checkpoint_refuses_another_world_size(gang):
    """The gang's 4-rank checkpoint, loaded on a one-rank group, raises
    (rank 0's file says it is rank 0 of 4)."""
    import torch.distributed as dist

    import spalinalg_tpu_torch as tsp
    from spalinalg_tpu_torch.errors import SpalinalgError
    from spalinalg_tpu_torch.io import load_npz
    from spalinalg_tpu_torch.parallel import make_row_mesh

    path = result(gang, "checkpoint", 0)["banded"]["path"]
    assert not dist.is_initialized()
    try:
        with tsp.default_device("cpu"):
            mesh = make_row_mesh()
            with pytest.raises(SpalinalgError, match="written on 4 ranks"):
                load_npz(path, mesh=mesh)
            with pytest.raises(SpalinalgError, match="no shard file"):
                load_npz(os.path.join(os.path.dirname(path), "none.npz"),
                         mesh=mesh)
    finally:
        dist.destroy_process_group()


def test_fault1_nonsquare_auto_halo(gang, jmesh):
    """JAX picks "halo" for a 40 x 80 diagonal and gets wrong products;
    the port all-gathers and gets the dense product."""
    S = fault1_csr()
    d, _ = jax_partition(S, jmesh)
    assert d.comm == "halo"                   # the fault's trigger in JAX
    assert replicated(gang, "fault1", "comm") == "allgather"
    dense = S.toarray()
    np.testing.assert_allclose(replicated(gang, "fault1", "y"),
                               dense @ vec(80, 51), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(replicated(gang, "fault1", "Y"),
                               dense @ vec(80, 52, (80, K)), rtol=1e-12,
                               atol=1e-12)


def test_fault2_forced_halo_wider_than_shard(gang):
    msg = replicated(gang, "fault2", "halo_error")
    assert "15" in msg and "10" in msg
    assert replicated(gang, "fault2", "comm") == "allgather"
    dense = fault2_csr().toarray()
    np.testing.assert_allclose(replicated(gang, "fault2", "y"),
                               dense @ vec(40, 53), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(replicated(gang, "fault2", "Y"),
                               dense @ vec(40, 54, (40, K)), rtol=1e-12,
                               atol=1e-12)


def test_fault3_bsr_keeps_float64(gang):
    indptr, indices, data = block_banded(8, 8, 61)
    dense = sps.bsr_matrix((data, indices, indptr), shape=(64, 64)).toarray()
    x = vec(64, 62)
    assert replicated(gang, "fault3", "dtype") == "torch.float64"
    y = replicated(gang, "fault3", "y")
    scale = np.abs(dense) @ np.abs(x)
    assert np.all(np.abs(y - dense @ x) <= 1e-12 * scale)


@pytest.mark.parametrize("mname", ["random", "banded", "nondiv", "stencil",
                                   "reach"])
@pytest.mark.parametrize("rank", range(P))
def test_shard_from_rows_matches_partition(gang, mname, rank):
    """Each rank's own rows through ``shard_from_rows`` give the shard that
    ``partition_csr`` cuts from the whole matrix, bit for bit: arrays,
    comm mode, halo width and the local block."""
    out = result(gang, f"from_rows/{mname}", rank)
    got, want = out["rows"], out["whole"]
    for key in ("rowptr", "colind", "values", "brow"):
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    for key in ("comm", "halo_width", "rows_per_shard"):
        assert got[key] == want[key], key
    for a, b in zip(out["local"], out["local_whole"]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert out["local_shape"][0] == out["local_shape"][1]


def test_shard_from_rows_halo_is_agreed(gang):
    """The halo width is the widest rank's reach, on every rank: a plane,
    8·8, for the stencil's z-slabs (a slab's first row that has the
    neighbour ``-nx·ny - nx - 1`` lies ``nx + 1`` rows into it); 9 for
    ``reach_csr``, whose rank 2 alone reaches past 3."""
    stencil = [result(gang, "from_rows/stencil", r)["rows"]
               for r in range(P)]
    assert {(o["comm"], o["halo_width"]) for o in stencil} == {("halo", 64)}
    reach = [result(gang, "from_rows/reach", r)["rows"] for r in range(P)]
    assert {(o["comm"], o["halo_width"]) for o in reach} == {("halo", 9)}


@pytest.mark.parametrize("what", ["rows", "mode", "shape"])
def test_shard_from_rows_errors(gang, what):
    """A forced halo wider than a shard raises ``partition_csr``'s own
    ``ValueError`` on every rank; an unknown mode and a block of the wrong
    rows raise too."""
    if what == "shape":            # each rank names its own rows
        for rank in range(P):
            msg = result(gang, "from_rows_errors", rank)["shape"]
            assert msg is not None and f"rank {rank} holds rows [" in msg
            assert "expected a 10 x 40 block, got (3, 40)" in msg
        return
    msg = replicated(gang, "from_rows_errors", what)
    assert msg is not None, f"{what}: shard_from_rows did not raise"
    if what == "rows":
        assert msg == replicated(gang, "from_rows_errors", "whole")
        assert "15" in msg and "10" in msg
    else:
        assert "'ring'" in msg


@pytest.mark.parametrize("mname", ["stencil", "zero_diag", "random",
                                   "nondiv"])
@pytest.mark.parametrize("rank", range(P))
def test_dist_jacobi_bitwise(gang, mname, rank):
    """The ``DistCsr`` Jacobi through ``ops/kernels/diagonal.py`` equals
    the torch chain it replaced, bit for bit: stored zeros, a missing
    diagonal entry and the last rank's padding rows give 1."""
    out = result(gang, f"jacobi/{mname}", rank)
    assert out["kernel"].dtype == out["chain"].dtype
    np.testing.assert_array_equal(out["kernel"], out["chain"])


def test_dist_cg_stencil_against_reference(gang):
    """CG with Jacobi on the stencil's ``DistCsr`` (each rank's rows through
    ``shard_from_rows``, halo mode) against Jacobi-CG on the operator
    applied without a matrix on the whole grid, in float64: the same
    iteration count, ``x`` and the residual within 1e-12 relative."""
    b = torch.from_numpy(vec(int(np.prod(STENCIL)), 77))
    inv = 1.0 / 26.0
    x = torch.zeros_like(b)
    r = b.clone()
    z = inv * r
    p = z
    rz, rr = torch.dot(r, z), torch.dot(r, r)
    for _ in range(12):
        ap = stencil27_apply(p, STENCIL)
        alpha = rz / torch.dot(p, ap)
        x = x + alpha * p
        r = r - alpha * ap
        z = inv * r
        rz_new, rr = torch.dot(r, z), torch.dot(r, r)
        p = z + (rz_new / rz) * p
        rz = rz_new
    res = float(torch.sqrt(rr))
    assert replicated(gang, "solver/cg_stencil", "iterations") == 12
    got = replicated(gang, "solver/cg_stencil", "x")
    assert np.abs(got - x.numpy()).max() <= 1e-12 * np.abs(x.numpy()).max()
    got_res = replicated(gang, "solver/cg_stencil", "residual")
    assert abs(got_res - res) <= 1e-12 * res
    assert res < 0.5 * float(torch.linalg.vector_norm(b))   # it moved


@pytest.mark.parametrize("rank", range(P))
def test_dist_spans(gang, rank):
    """Under ``profiling.tracing()`` every rank opens ``spal.halo`` once a
    product (one ``dist_spmv`` and a 3-step CG's 4) and
    ``spal.allreduce`` once a sum (one ``dist_dot`` and the CG's 1 + 2·3);
    a CG stopped by its tolerance runs ``AHEAD`` products more than its
    steps need; off, nothing is recorded."""
    out = result(gang, "spans", rank)
    assert out["halo_width"] > 0
    assert out["on"] == {"spal.halo": 5, "spal.allreduce": 8,
                         "spal.precond": 1}
    assert out["off"] == {}
    # a solve stopped by its tolerance: the first residual's product, one
    # a step, and the steps run ahead of the test and dropped
    conv = out["converged"]
    assert 0 < conv["iterations"] < 100 and conv["ahead"] >= 1
    assert conv["halo"] == conv["iterations"] + 1 + conv["ahead"]


@pytest.mark.parametrize("rank", range(P))
def test_halo_window_is_reused(gang, rank):
    """Halo products in turn on one ``DistCsr`` (two vectors, a block, the
    first vector again) each give ``A·x``: the slabs are received into one
    window a (dtype, row shape), kept on the shard, whose edge slabs stay
    zero; a product that would need gradients is refused."""
    out = result(gang, "window", rank)
    S = stencil27(*STENCIL)
    n = S.shape[0]
    x1, x2 = vec(n, 81), vec(n, 82)
    for got, x in zip(out["y"], (x1, x2, x1)):
        np.testing.assert_allclose(got, S @ x, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(out["Y"], S @ vec(n, 83, (n, K)),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(out["y"][0], out["y"][2])
    assert out["windows"] == 2 and out["same"]
    if rank == 0:
        assert not out["left"].any()
    if rank == P - 1:
        assert not out["right"].any()
    assert out["grad"] is not None and "torch.no_grad()" in out["grad"]


@pytest.mark.parametrize("ahead", [1, 2, 3])
@pytest.mark.parametrize("tol,maxiter", [(0.0, 7), (1e-8, 500), (1e-8, 9),
                                         (1e9, 5)])
def test_cg_loop_ahead_gives_the_same_steps(ahead, tol, maxiter):
    """``_cg_loop`` run ``ahead`` steps ahead of its test returns the bits,
    iteration count and residual of the loop that tests before each step:
    stopped by ``maxiter``, by the tolerance, and at once; the products it
    runs past the stop are at most ``ahead``."""
    from spalinalg_tpu_torch.linalg.cg import _cg_loop

    import spalinalg_tpu_torch as tsp

    A = port_csr(lap2d(12))
    b = torch.from_numpy(vec(144, 90))
    inv = 1.0 / torch.from_numpy(lap2d(12).diagonal())
    runs = []
    for lead in (0, ahead):
        products = []

        class Counted:
            def __matmul__(self, v):
                products.append(1)
                return A @ v

        with tsp.default_device("cpu"):
            res = _cg_loop(Counted(), b, torch.zeros_like(b), tol, maxiter,
                           lambda r: inv * r, ahead=lead)
        runs.append((res, len(products)))
    (want, n0), (got, n) = runs
    assert got.iterations == want.iterations
    assert torch.equal(got.x, want.x)
    assert torch.equal(got.residual, want.residual)
    assert n0 == want.iterations + 1
    assert n - n0 == min(ahead, maxiter - want.iterations)


@pytest.mark.card
def test_dist_cg_with_another_card_current():
    """CG on a ``DistCsr`` on card 1 (a one-rank NCCL mesh) while card 0
    is current: the run-ahead's test is read from card 1's stream, so the
    solve takes the steps, and reaches the answer, that it takes with
    card 1 current and that the CPU takes."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    import torch.distributed as dist

    import spalinalg_tpu_torch.linalg as tla
    from spalinalg_tpu_torch.parallel import (make_row_mesh, partition_csr,
                                              shard_vector, unshard_vector)

    assert not dist.is_initialized()
    S = lap2d(40)
    b = vec(S.shape[0], 91)
    want = tla.cg(port_csr(S), torch.from_numpy(b), tol=1e-9,
                  precondition="jacobi")
    try:
        mesh = make_row_mesh(device="cuda:1")
        d = partition_csr(port_csr(S), mesh)
        runs = []
        for current in (0, 1):
            with torch.cuda.device(current):
                res = tla.cg(d, shard_vector(b, d), tol=1e-9,
                             precondition="jacobi")
                runs.append((int(res.iterations),
                             unshard_vector(res.x, d).cpu()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    for its, x in runs:
        assert its == want.iterations
        np.testing.assert_allclose(x.numpy(), want.x.numpy(), rtol=1e-9,
                                   atol=1e-12)


def test_one_rank_mesh_in_process():
    """With no process group, ``make_row_mesh`` makes a one-rank group (a
    ``HashStore``), and the tier runs on it; the group is destroyed
    afterwards."""
    import torch.distributed as dist

    import spalinalg_tpu_torch as tsp
    from spalinalg_tpu_torch.parallel import (dist_spmv, make_row_mesh,
                                              partition_csr, shard_vector,
                                              unshard_vector)
    from spalinalg_tpu_torch.parallel import multihost

    assert not dist.is_initialized()
    try:
        with tsp.default_device("cpu"):
            mesh = make_row_mesh()
            assert dist.get_world_size() == 1 and mesh.size() == 1
            assert mesh.mesh_dim_names == ("rows",)
            with pytest.raises(ValueError):
                make_row_mesh(2)
            S = banded_csr(30, 2, 71)
            d = partition_csr(port_csr(S), mesh)
            x = vec(30, 72)
            y = unshard_vector(dist_spmv(d, shard_vector(x, d)), d)
            np.testing.assert_allclose(y.numpy(), S @ x, rtol=1e-12,
                                       atol=1e-12)
            assert multihost.heartbeat() >= 0
            assert multihost.global_device_summary()["process_count"] == 1
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
