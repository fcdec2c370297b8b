"""The native host entry points of the solver tier, bound by the port
from its own copy of the C++ source (``spalinalg_tpu_torch/native``),
against the JAX package's bindings of the same functions on the same
arrays: equal exactly. The port's functions that keep a NumPy twin for
small structures (RCM, the level schedule, the elimination tree, the
supernodal symbolic phase) give the same answer on both paths."""

import importlib

import numpy as np
import pytest
import scipy.sparse as sps

from spalinalg_tpu.convert import engine as jengine
from spalinalg_tpu.native import lib as jnative
from spalinalg_tpu_torch import CsrMatrix
from spalinalg_tpu_torch.convert import engine as tengine
from spalinalg_tpu_torch.native import lib as tnative

ordering = importlib.import_module("spalinalg_tpu_torch.linalg.ordering")
symbolic = importlib.import_module("spalinalg_tpu_torch.linalg.symbolic")


def lap2d(k):
    T = sps.diags([-1.0, 4.0, -1.0], [-1, 0, 1], shape=(k, k))
    D = sps.diags([-1.0, -1.0], [-1, 1], shape=(k, k))
    return (sps.kron(sps.eye(k), T) + sps.kron(D, sps.eye(k))).tocsr()


def scrambled(A, seed):
    p = np.random.default_rng(seed).permutation(A.shape[0])
    return A[p][:, p].tocsr()


def random_spd(n, density, seed):
    B = sps.random(n, n, density, random_state=seed)
    return (B @ B.T + n * density * 4 * sps.eye(n)).tocsr()


def convdiff(k, c=0.7):
    T = sps.diags([-1.0 - c, 4.0 + 2 * c, -1.0], [-1, 0, 1], shape=(k, k))
    D = sps.diags([-1.0 - c, -1.0], [-1, 1], shape=(k, k))
    return (sps.kron(sps.eye(k), T) + sps.kron(D, sps.eye(k))).tocsr()


CASES = {
    "lap2d_30": lambda: lap2d(30),
    "scrambled_lap2d_25": lambda: scrambled(lap2d(25), 3),
    "random_spd_400": lambda: random_spd(400, 0.015, 2),
    "convdiff_20": lambda: convdiff(20),
}


def arrays(A):
    A = A.tocsr()
    A.sort_indices()
    return (A.indptr.astype(np.int64), A.indices.astype(np.int64),
            A.data.astype(np.float64), A.shape[0])


def lower_pattern(ptr, ind, val, n):
    rows = np.repeat(np.arange(n), np.diff(ptr))
    keep = ind <= rows
    lptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(lptr, rows[keep] + 1, 1)
    return np.cumsum(lptr), ind[keep], val[keep]


@pytest.fixture(scope="module", autouse=True)
def _both_libraries():
    assert jnative.available()
    tnative.load_library()


@pytest.fixture(autouse=True)
def _plan_cache(tmp_path, monkeypatch):
    """A fresh on-disk plan cache a test: a plan written by an earlier
    test or process would turn a cold factor warm and take its
    ``chol_*`` host phases off the metrics recorder."""
    monkeypatch.setenv("SPALINALG_PLAN_CACHE", str(tmp_path / "plans"))


def triplets(n, seed):
    """``n`` float64 triplets on a 300 x 300 grid: duplicates (some
    cancelling), explicit zeros, a lone ``-0.0`` and a duplicate pair of
    ``-0.0``."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, 300, size=n)
    cols = rng.integers(0, 300, size=n)
    vals = rng.normal(size=n)
    vals[rng.random(n) < 0.05] = 0.0
    k = n // 10
    rows[-k:], cols[-k:], vals[-k:] = rows[:k], cols[:k], -vals[:k]
    # slots off the grid's random cells: a lone -0.0 and a pair of them
    rows[k:k + 3] = [299, 298, 298]
    cols[k:k + 3] = [299, 297, 297]
    vals[k:k + 3] = -0.0
    keep = ~(((rows == 299) & (cols == 299)) | ((rows == 298)
                                                 & (cols == 297)))
    keep[k:k + 3] = True
    return rows[keep], cols[keep], vals[keep]


def assert_bitwise(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(np.signbit(got[2]), np.signbit(want[2]))


@pytest.mark.parametrize("drop_zeros", [False, True])
@pytest.mark.parametrize("dedup", [False, True])
@pytest.mark.parametrize("n", [4000, 100_000])
def test_compress_host_matches_jax(n, dedup, drop_zeros):
    """Bitwise, sign of zero included: 4000 entries take NumPy in both
    packages, 100,000 the native sort and merge in both."""
    rows, cols, vals = triplets(n, 31)
    got = tengine.compress_host(rows, cols, vals, 300, dedup=dedup,
                                drop_zeros=drop_zeros)
    want = jengine.compress_host(rows, cols, vals, 300, dedup=dedup,
                                 drop_zeros=drop_zeros)
    assert_bitwise(got, want)
    if dedup and not drop_zeros:
        # the lone -0.0 (last row): the native merge keeps its sign,
        # np.add.at into zeros does not
        assert got[2][-1] == 0 and np.signbit(got[2][-1]) == (n > 4096)


@pytest.mark.parametrize("drop_zeros", [False, True])
@pytest.mark.parametrize("dedup", [False, True])
def test_compress_native_and_numpy_paths_agree(dedup, drop_zeros,
                                               monkeypatch):
    """At 100,000 entries the native path against the NumPy path
    directly: equal arrays; the values' bits differ only where a group
    of ``-0.0`` entries alone is merged (``dedup`` without
    ``drop_zeros``): the lone one and the pair."""
    rows, cols, vals = triplets(100_000, 32)
    nat = tengine.compress_host(rows, cols, vals, 300, dedup=dedup,
                                drop_zeros=drop_zeros)
    monkeypatch.setattr(tengine, "NATIVE_ABOVE", np.iinfo(np.int64).max)
    py = tengine.compress_host(rows, cols, vals, 300, dedup=dedup,
                               drop_zeros=drop_zeros)
    for g, w in zip(nat, py):
        np.testing.assert_array_equal(g, w)
    flips = np.flatnonzero(np.signbit(nat[2]) != np.signbit(py[2]))
    if dedup and not drop_zeros:
        negzero = np.flatnonzero((nat[2] == 0) & np.signbit(nat[2]))
        assert flips.tolist() == negzero.tolist() and flips.size == 2
    else:
        assert flips.size == 0


def test_compress_float32_stays_on_numpy(monkeypatch):
    """Only float64 values take the native path (the JAX gate)."""
    def refuse(*args, **kwargs):
        raise AssertionError("native compress called")

    monkeypatch.setattr(tnative, "compress", refuse)
    rows, cols, vals = triplets(100_000, 33)
    got = tengine.compress_host(rows, cols, vals.astype(np.float32), 300,
                                dedup=True, drop_zeros=True)
    want = jengine.compress_host(rows, cols, vals.astype(np.float32), 300,
                                 dedup=True, drop_zeros=True)
    assert_bitwise(got, want)


@pytest.mark.parametrize("name", list(CASES))
def test_orderings_and_trees(name):
    ptr, ind, _, n = arrays(CASES[name]())
    np.testing.assert_array_equal(tnative.rcm(ptr, ind, n),
                                  jnative.rcm(ptr, ind, n))
    np.testing.assert_array_equal(tnative.amd(ptr, ind, n),
                                  jnative.amd(ptr, ind, n))
    np.testing.assert_array_equal(tnative.etree(ptr, ind, n),
                                  jnative.etree(ptr, ind, n))
    for lower in (True, False):
        tl, jl = (tnative.level_schedule(ptr, ind, n, lower=lower),
                  jnative.level_schedule(ptr, ind, n, lower=lower))
        assert tl[0] == jl[0]
        np.testing.assert_array_equal(tl[1], jl[1])


@pytest.mark.parametrize("name", list(CASES))
def test_chol_symbolic(name):
    A = CASES[name]()
    if name == "convdiff_20":
        A = (A + A.T).tocsr()          # a symmetric structure
    ptr, ind, _, n = arrays(A)
    post = jnative.amd(ptr, ind, n)
    B = A[post][:, post].tocsr()
    ptr, ind, _, n = arrays(B)
    for got, want in zip(tnative.chol_symbolic(ptr, ind, n),
                         jnative.chol_symbolic(ptr, ind, n)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", list(CASES))
def test_incomplete_factorizations(name):
    ptr, ind, val, n = arrays(CASES[name]())
    tv, tbad = tnative.ilu0_values(ptr, ind, val, n)
    jv, jbad = jnative.ilu0_values(ptr, ind, val, n)
    assert tbad == jbad == -1
    np.testing.assert_array_equal(tv, jv)
    if name != "convdiff_20":
        args = lower_pattern(ptr, ind, val, n) + (n,)
        tv, tbad = tnative.ic0_values(*args)
        jv, jbad = jnative.ic0_values(*args)
        assert tbad == jbad == -1
        np.testing.assert_array_equal(tv, jv)


def test_library_is_built_with_the_jax_flags(monkeypatch):
    """The JAX package's flags, and a library name that changes with the
    host's resolved ``-march=native`` target (a ``build/`` carried to
    another CPU rebuilds)."""
    assert tnative.FLAGS == ("-O3", "-march=native", "-fPIC", "-std=c++17",
                             "-shared")
    assert "-march=" in tnative.native_target()
    here = tnative.library_path()
    monkeypatch.setattr(tnative, "native_target", lambda: "another cpu")
    assert tnative.library_path() != here
    assert tnative.library_path().parent == here.parent


def test_failures_name_the_same_row():
    ptr, ind, val, n = arrays(lap2d(6) - 5 * sps.eye(36))
    assert tnative.ilu0_values(ptr, ind, val, n)[1] == \
        jnative.ilu0_values(ptr, ind, val, n)[1]
    args = lower_pattern(ptr, ind, val, n) + (n,)
    tbad, jbad = tnative.ic0_values(*args)[1], jnative.ic0_values(*args)[1]
    assert tbad == jbad >= 0
    nodiag = sps.csr_matrix(np.array([[0.0, 1.0], [1.0, 2.0]]))
    ptr, ind, val, n = arrays(nodiag)
    assert tnative.ilu0_values(ptr, ind, val, n)[1] == 0
    with pytest.raises(ValueError, match="inconsistent"):
        tnative.rcm(ptr, ind + 5, n)


def postordered(A):
    """``A`` symmetrised, AMD-ordered and postordered, as ``cholesky``
    hands it to the symbolic phase."""
    A = (A + A.T).tocsr()
    ptr, ind, _, n = arrays(A)
    A = A[tnative.amd(ptr, ind, n)][:, tnative.amd(ptr, ind, n)].tocsr()
    ptr, ind, _, n = arrays(A)
    post = symbolic.postorder(tnative.etree(ptr, ind, n))
    return A[post][:, post].tocsr()


def both_paths(monkeypatch, module, fn):
    """``fn()`` with ``module`` below its native threshold (NumPy), then
    above it (native)."""
    out = []
    for threshold in (np.iinfo(np.int64).max, -1):
        monkeypatch.setattr(module, "NATIVE_ABOVE", threshold)
        out.append(fn())
    return out


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("what", ["rcm_ordering", "level_schedule", "etree",
                                  "chol_symbolic"])
def test_numpy_and_native_paths_agree(name, what, monkeypatch):
    A = CASES[name]()
    if what == "chol_symbolic":
        A = postordered(A)
    elif what == "etree":
        A = (A + A.T).tocsr()
    ptr, ind, val, n = arrays(A)
    if what == "rcm_ordering":
        csr = CsrMatrix(n, n, ptr, ind, val, device="cpu")
        py, nat = both_paths(monkeypatch, ordering,
                             lambda: ordering.rcm_ordering(csr))
        np.testing.assert_array_equal(py, nat)
    elif what == "level_schedule":
        for lower in (True, False):
            py, nat = both_paths(
                monkeypatch, ordering,
                lambda: ordering.level_schedule(ptr, ind, n, lower=lower))
            for got, want in zip(py, nat):
                np.testing.assert_array_equal(got, want)
    elif what == "etree":
        py, nat = both_paths(monkeypatch, symbolic,
                             lambda: symbolic.etree(ptr, ind, n))
        np.testing.assert_array_equal(py, nat)
    else:
        py, nat = both_paths(monkeypatch, symbolic,
                             lambda: symbolic.chol_symbolic(ptr, ind, n))
        for field in ("snode_ptr", "rows_ptr", "rows_idx", "sn_parent"):
            np.testing.assert_array_equal(getattr(py, field),
                                          getattr(nat, field))
        assert len(py.levels) == len(nat.levels)
        for got, want in zip(py.levels, nat.levels):
            np.testing.assert_array_equal(got, want)
