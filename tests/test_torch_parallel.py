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
- the three JAX faults the port repairs, each against the dense product.

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
