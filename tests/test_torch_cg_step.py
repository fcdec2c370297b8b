"""The CG step's kernels (``csrc/cg_step.cu``), their wrappers and plain
versions (``ops/kernels/cg_step.py``) and the loop that picks them
(``linalg/cg.py``). No JAX at import, so the tests marked ``card`` also run
on a card: ``python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_cg_step.py -m card``.

On the CPU: the loop's torch step gives the bits of the loop as it was
written before the kernels (kept here, :func:`_cg_loop_before`), in
float32 and float64, with Jacobi and with none, run ahead 0 and 2 steps;
the loop's fused path, run with the passes replaced by torch versions
written here (:func:`_cpu_passes`), gives those bits too; the dispatch
takes the fused step only for a CSR, BSR or DistCsr operand, the built-in
Jacobi or no preconditioner, and contiguous float32 or float64 vectors on
the card; ``cg`` still matches the JAX package; the wrappers refuse CPU
tensors; the C entry points take pointers and 64-bit integers.

On the card: x', r and p are bitwise the torch step's when it is fed the
kernels' own dots, with 16-byte packs and with vectors off a 16-byte
boundary, at lengths with a tail past the last pack; the dots lie within a
stated tolerance of ``torch.dot`` and give the same bits launch after
launch; a 50-step Jacobi solve on the 27-point stencil and on PETSc ex56's
operator lies within the benchmark's ``x_gap`` limit of the torch step's
solve, with three launches a step and the metrics path
``cg_step:cuda:fused``.
"""

import ctypes
import doctest
import importlib
from collections import deque

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import spalinalg_tpu_torch as tsp
import spalinalg_tpu_torch.linalg as tla
from spalinalg_tpu_torch import BsrMatrix, CsrMatrix
from spalinalg_tpu_torch.errors import DTypeError
from spalinalg_tpu_torch.ops.kernels import _build
from spalinalg_tpu_torch.ops.kernels import cg_step as step_mod
from spalinalg_tpu_torch.ops.kernels.cg_step import (cg_step_plain, direction,
                                                     dots, pap, update,
                                                     workspace)
from spalinalg_tpu_torch.utils import metrics

cg_mod = importlib.import_module("spalinalg_tpu_torch.linalg.cg")

DTYPES = {"float32": torch.float32, "float64": torch.float64}
# The benchmark's x_gap limits (spbench/limits): hpcg-256.cg50 for the
# stencil, ex56-160.bsrcg50 for ex56's operator.
X_GAP = {"stencil": 1e-11, "ex56": 1e-9}


@pytest.fixture(autouse=True)
def _cpu_scope():
    """The port's entry points place data on the card unless told
    otherwise; these tests run on the CPU unless they name the card."""
    with tsp.default_device("cpu"):
        yield


@pytest.fixture
def card():
    """The first CUDA card; skips the test where there is none (decided
    when the test runs, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _cpu_takes(*vectors):
    """``cg_step.takes`` with the CPU in place of the card."""
    v0 = vectors[0]
    return (v0.device.type == "cpu" and v0.dtype in DTYPES.values()
            and all(v.ndim == 1 and v.is_contiguous() and v.dtype == v0.dtype
                    and v.shape == v0.shape for v in vectors))


def _residual_dots(r, inv):
    z = r if inv is None else inv * r
    return torch.stack([torch.dot(r, z), torch.dot(r, r)])


def _cpu_update(r, ap, inv, rz, pap_, ws):
    r.copy_(r - (rz.reshape(()) / pap_.reshape(())) * ap)
    return _residual_dots(r, inv)


def _cpu_direction(x, r, p, inv, rz, pap_, rz_next):
    x = x + (rz.reshape(()) / pap_.reshape(())) * p
    z = r if inv is None else inv * r
    p.copy_(z + (rz_next.reshape(()) / rz.reshape(())) * p)
    return x


def _cpu_passes(mp):
    """The fused step on CPU tensors: ``takes`` accepts them and each pass
    is a torch version with the kernel's signature and in-place effects;
    the calls of each pass are counted in the dict returned."""
    calls = dict.fromkeys(step_mod.PASS_LAUNCHES, 0)

    def counted(name, fn):
        def run(*args):
            calls[name] += 1
            return fn(*args)
        return run

    mp.setattr(step_mod, "takes", _cpu_takes)
    for name, fn in (("dots", lambda r, inv, ws: _residual_dots(r, inv)),
                     ("pap", lambda p, ap, ws: torch.dot(p, ap).reshape(1)),
                     ("update", _cpu_update), ("direction", _cpu_direction)):
        mp.setattr(step_mod, name, counted(name, fn))
    return calls


@pytest.fixture
def cpu_kernels(monkeypatch):
    """The fused step on CPU tensors (:func:`_cpu_passes`)."""
    return _cpu_passes(monkeypatch)


def lap2d(k, shift=0.05):
    T = sps.diags([-1.0, 4.0 + shift, -1.0], [-1, 0, 1], shape=(k, k))
    D = sps.diags([-1.0, -1.0], [-1, 1], shape=(k, k))
    return (sps.kron(sps.eye(k), T) + sps.kron(D, sps.eye(k))).tocsr()


def port_csr(a, dtype=np.float64, device="cpu"):
    a = a.tocsr()
    a.sort_indices()
    return CsrMatrix(a.shape[0], a.shape[1], a.indptr, a.indices,
                     a.data.astype(dtype), device=device)


def rhs(n, dtype=torch.float64, seed=3, device="cpu"):
    gen = np.random.default_rng(seed)
    return torch.from_numpy(gen.normal(size=n)).to(dtype).to(device)


def _cg_loop_before(matvec, b, x0, tol, maxiter, psolve, dots_,
                    ahead=0):
    """``linalg/cg.py::_cg_loop`` as it was before the fused step: the
    torch arithmetic every plain solve must keep, bit for bit."""
    psolve = psolve if psolve is not None else (lambda r: r)
    x = x0
    r = b - matvec(x)
    z = psolve(r)
    p = z
    rz, rr = dots_([(r, z), (r, r)])
    steps = deque([(x, rr, cg_mod._above(rr, tol, ahead > 0))])
    k = 0
    while True:
        while len(steps) <= ahead and k + len(steps) <= maxiter:
            ap = matvec(p)
            (pap_,) = dots_([(p, ap)])
            alpha = rz / pap_
            x = x + alpha * p
            r = r - alpha * ap
            z = psolve(r)
            rz_next, rr = dots_([(r, z), (r, r)])
            steps.append((x, rr, cg_mod._above(rr, tol, ahead > 0)))
            p = z + (rz_next / rz) * p
            rz = rz_next
        x_k, rr_k, going = steps.popleft()
        if k == maxiter or not going():
            return cg_mod.CgResult(x=x_k, iterations=k,
                                   residual=torch.sqrt(rr_k))
        k += 1


def _solves(dtype, precond, ahead):
    """``(loop before, loop now)`` on a 2-D Laplacian: 7 steps at
    ``tol = 0`` and a solve stopped by its tolerance."""
    A = port_csr(lap2d(12), np.float64 if dtype == torch.float64
                 else np.float32)
    b = rhs(A.nrows, dtype)
    psolve = cg_mod.resolve_precond(precond, A)
    out = []
    for tol, maxiter in ((0.0, 7), (1e-5, 500)):
        args = (b, torch.zeros_like(b), tol, maxiter, psolve)
        out.append((_cg_loop_before(lambda v: A @ v, *args, cg_mod._dots(A),
                                    ahead=ahead),
                    cg_mod._cg_loop(A, *args, ahead=ahead)))
    return out


def _same(want, got):
    assert got.iterations == want.iterations
    assert torch.equal(got.x, want.x)
    assert torch.equal(got.residual, want.residual)


@pytest.mark.parametrize("ahead", [0, 2])
@pytest.mark.parametrize("precond", [None, "jacobi"], ids=["none", "jacobi"])
@pytest.mark.parametrize("dtype", list(DTYPES.values()), ids=list(DTYPES))
def test_plain_step_keeps_the_loops_bits(dtype, precond, ahead):
    """On the CPU ``cg``'s loop takes the torch step, whose bits are the
    loop's before the kernels."""
    for want, got in _solves(dtype, precond, ahead):
        _same(want, got)


@pytest.mark.parametrize("ahead", [0, 2])
@pytest.mark.parametrize("precond", [None, "jacobi"], ids=["none", "jacobi"])
@pytest.mark.parametrize("dtype", list(DTYPES.values()), ids=list(DTYPES))
def test_fused_path_through_plain_passes(cpu_kernels, dtype, precond,
                                         ahead):
    """The fused path (x out of place, r and p in place, every dot through
    the passes), each pass a torch version, gives the torch step's bits:
    the passes are wired as the torch step computes."""
    for want, got in _solves(dtype, precond, ahead):
        _same(want, got)
    steps = cpu_kernels["pap"]
    assert steps > 7 and cpu_kernels == {"dots": 2, "pap": steps,
                                         "update": steps,
                                         "direction": steps}


def test_fused_path_on_a_dist_csr():
    """On a one-rank ``DistCsr`` (gloo), run ``AHEAD`` steps ahead, each
    dot summed over the mesh between the passes: the torch step's bits."""
    import torch.distributed as dist

    from spalinalg_tpu_torch.parallel import (make_row_mesh, partition_csr,
                                              shard_vector)

    assert not dist.is_initialized()
    try:
        d = partition_csr(port_csr(lap2d(12)), make_row_mesh(device="cpu"))
        b = shard_vector(rhs(144), d)
        runs = {}
        for fused in (False, True):
            with pytest.MonkeyPatch.context() as mp:
                if fused:
                    _cpu_passes(mp)
                rec = metrics.enable()
                try:
                    rec.records.clear()
                    res = tla.cg(d, b, tol=1e-6, precondition="jacobi")
                    paths = {r.path for r in rec.records
                             if r.op == "cg_step"}
                finally:
                    metrics.disable()
                    rec.records.clear()
            runs[fused] = res, paths
    finally:
        dist.destroy_process_group()
    (want, plain), (got, fused) = runs[False], runs[True]
    assert plain == {"cg_step:plain"} and fused == {"cg_step:cpu:fused"}
    assert want.iterations > 5
    _same(want, got)


def test_plain_step_function_is_the_loops_step():
    """``cg_step_plain`` is one step of the loop before the kernels."""
    A = port_csr(lap2d(6))
    inv = 1.0 / torch.from_numpy(lap2d(6).diagonal())
    b = rhs(A.nrows)
    ds = cg_mod._dots(A)
    r = b.clone()
    z = inv * r
    rz, _ = ds([(r, z), (r, r)])
    ap = A @ z
    x, r1, p1, rz1, rr1 = cg_step_plain(torch.zeros_like(b), r, z, ap, rz,
                                        lambda v: inv * v, ds)
    want = _cg_loop_before(lambda v: A @ v, b, torch.zeros_like(b), 0.0, 1,
                           lambda v: inv * v, ds)
    assert torch.equal(x, want.x)
    assert torch.equal(torch.sqrt(rr1), want.residual)


def _predicate_case(name):
    """``(operand, psolve, vectors)`` for the dispatch case ``name``."""
    A = port_csr(lap2d(4))
    n = A.nrows
    v = torch.ones(n, dtype=torch.float64)
    jac = cg_mod.resolve_precond("jacobi", A)
    cases = {
        "jacobi": (A, jac, (v, v)),
        "none": (A, None, (v, v)),
        "float32": (port_csr(lap2d(4), np.float32), None,
                    (v.float(), v.float())),
        "bsr": (A.to_bsr(4), cg_mod.resolve_precond("jacobi", A.to_bsr(4)),
                (v, v)),
        "callable": (A, cg_mod.resolve_precond(lambda r: 0.25 * r, A),
                     (v, v)),
        "ic0": (A, cg_mod.resolve_precond(tla.ic0(A), A), (v, v)),
        "chebyshev": (A, cg_mod.resolve_precond(tla.chebyshev(A, degree=2),
                                                A), (v, v)),
        "bfloat16": (A, None, (v.bfloat16(), v.bfloat16())),
        "float16": (A, None, (v.half(), v.half())),
        "non-contiguous": (A, None,
                           (torch.ones(2 * n, dtype=torch.float64)[::2], v)),
        "two dtypes": (A, None, (v, v.float())),
        "jacobi of another dtype": (A, cg_mod.Jacobi(v.float()), (v, v)),
        "bare operand": (_Bare(A), None, (v, v)),
    }
    return cases[name]


class _Bare:
    """An operand with ``@`` alone: not one the fused step takes."""

    def __init__(self, A):
        self.A = A

    def __matmul__(self, v):
        return self.A @ v


FUSES = {"jacobi": True, "none": True, "float32": True, "bsr": True,
         "callable": False, "ic0": False, "chebyshev": False,
         "bfloat16": False, "float16": False, "non-contiguous": False,
         "two dtypes": False, "jacobi of another dtype": False,
         "bare operand": False}


@pytest.mark.parametrize("name", list(FUSES))
def test_dispatch_predicate(cpu_kernels, name):
    """With ``takes`` accepting CPU tensors, the predicate is the rest of
    the rule: operand, preconditioner, dtype, layout."""
    assert cg_mod._fuses(*_predicate_case(name)) is FUSES[name]


@pytest.mark.parametrize("name", ["jacobi", "none", "float32", "bsr"])
def test_cpu_tensors_take_the_torch_step(name):
    """On CPU tensors no case fuses, and ``cg`` records ``cg_step:plain``
    for each step."""
    assert cg_mod._fuses(*_predicate_case(name)) is False
    A = port_csr(lap2d(4))
    rec = metrics.enable()
    try:
        rec.records.clear()
        res = tla.cg(A, torch.ones(A.nrows, dtype=torch.float64),
                     tol=0.0, maxiter=5, precondition="jacobi")
        paths = [r.path for r in rec.records if r.op == "cg_step"]
    finally:
        metrics.disable()
        rec.records.clear()
    assert res.iterations == 5 and paths == ["cg_step:plain"] * 5


def test_fused_path_records_its_path(cpu_kernels):
    A = port_csr(lap2d(4))
    rec = metrics.enable()
    try:
        rec.records.clear()
        tla.cg(A, torch.ones(A.nrows, dtype=torch.float64), tol=0.0,
               maxiter=3, precondition="jacobi")
        paths = [r.path for r in rec.records if r.op == "cg_step"]
    finally:
        metrics.disable()
        rec.records.clear()
    assert paths == ["cg_step:cpu:fused"] * 3


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("precond", [None, "jacobi"], ids=["none", "jacobi"])
def test_cg_matches_jax(dtype, precond):
    """``cg`` against the JAX package, as ``test_torch_krylov.py`` holds
    it: the torch step, and the fused path through torch passes."""
    import spalinalg_tpu as jsp
    import spalinalg_tpu.linalg as jla

    a = lap2d(10)
    a.sort_indices()
    args = (a.shape[0], a.shape[1], a.indptr, a.indices, a.data.astype(dtype))
    b = np.random.default_rng(3).normal(size=a.shape[0]).astype(dtype)
    tol = 1e-9 if dtype == np.float64 else 1e-4
    jres = jla.cg(jsp.CsrMatrix(*args), b, tol=tol, precondition=precond)
    jx = np.asarray(jres.x)
    for fused in (False, True):
        with pytest.MonkeyPatch.context() as mp:
            if fused:
                _cpu_passes(mp)
            tres = tla.cg(CsrMatrix(*args), b, tol=tol, precondition=precond)
        tx = tres.x.numpy()
        assert tx.dtype == jx.dtype
        if dtype == np.float64:
            assert tres.iterations == int(jres.iterations)
            np.testing.assert_allclose(tx, jx, rtol=0, atol=1e-8)
        else:
            np.testing.assert_allclose(tx, jx, rtol=1e-4,
                                       atol=1e-4 * np.abs(jx).max())
        assert float(tres.residual) <= tol


def test_wrappers_refuse_what_the_kernels_do_not_take():
    """The wrappers take CUDA tensors alone (CPU ones take the torch
    step) and refuse aliased operands."""
    v = torch.ones(4, dtype=torch.float64)
    ws = workspace(v)
    meta = torch.ones(4, dtype=torch.float64, device="meta")
    for vec in (v, meta):
        with pytest.raises(DTypeError):
            pap(vec, vec.clone(), ws)
        with pytest.raises(DTypeError):
            dots(vec, None, ws)
    r = v.clone()
    with pytest.raises(DTypeError):
        update(r, v, None, v[:1], v[:1], ws)
    with pytest.raises(DTypeError):
        direction(v, r, v.clone(), None, v[:1], v[:1], v[:1])
    with pytest.raises(ValueError):
        update(r, r, None, v[:1], v[:1], ws)
    with pytest.raises(ValueError):
        direction(v, r, r, None, v[:1], v[:1], v[:1])
    with pytest.raises(ValueError):
        direction(r, v, r, None, v[:1], v[:1], v[:1])


def test_entry_points_take_pointers_and_64_bit_integers():
    for t in ("f32", "f64"):
        for name in ("pap", "dots"):
            types = _build._ENTRIES[f"spal_cg_{name}_{t}"]
            assert types == [ctypes.c_void_p] * 3 + [
                ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p]
        assert _build._ENTRIES[f"spal_cg_update_{t}"] == (
            [ctypes.c_void_p] * 6 + [ctypes.c_longlong, ctypes.c_void_p,
                                     ctypes.c_void_p, ctypes.c_longlong,
                                     ctypes.c_longlong, ctypes.c_void_p])
        assert _build._ENTRIES[f"spal_cg_direction_{t}"] == (
            [ctypes.c_void_p] * 8 + [ctypes.c_longlong] * 2
            + [ctypes.c_void_p])


@pytest.mark.parametrize("module", ["spalinalg_tpu_torch.ops.kernels.cg_step",
                                    "spalinalg_tpu_torch.linalg.cg"])
def test_doctests(module):
    result = doctest.testmod(importlib.import_module(module))
    assert result.attempted > 0 and result.failed == 0


# ---- on the card ------------------------------------------------------

# Lengths: a tail past the last 16-byte pack in both types, one pack, none.
LENGTHS = [1_000_003, 4, 0]


def _vectors(card, n, dtype, jacobi, offset, seed=5):
    """``(x, r, p, ap, inv, rz)`` of length ``n`` on the card; with
    ``offset`` each vector is a view one value past a 16-byte boundary."""
    gen = torch.Generator(device=card).manual_seed(seed)

    def draw(lo=-1.0, hi=1.0):
        store = torch.empty(n + 1, dtype=dtype, device=card)
        v = store[1:] if offset else store[:n]
        v.uniform_(lo, hi, generator=gen)
        return v

    x, r, p, ap = draw(), draw(), draw(), draw()
    inv = draw(0.5, 2.0) if jacobi else None
    rz = torch.rand(1, generator=gen, dtype=dtype, device=card) + 0.5
    return x, r, p, ap, inv, rz


def _fed(values):
    """A ``dots`` for ``cg_step_plain`` that hands back the kernels' dots:
    ``[pap]``, then ``[rz', rr]``."""
    queue = [list(values[:1]), list(values[1:])]
    return lambda pairs: [v.reshape(()) for v in queue.pop(0)]


@pytest.mark.card
@pytest.mark.parametrize("offset", [False, True], ids=["pack", "value"])
@pytest.mark.parametrize("jacobi", [True, False], ids=["jacobi", "none"])
@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("dtype", list(DTYPES.values()), ids=list(DTYPES))
def test_passes_equal_the_torch_step_given_their_dots(card, dtype, n, jacobi,
                                                      offset):
    x, r, p, ap, inv, rz = _vectors(card, n, dtype, jacobi, offset)
    ws = workspace(x)
    launches = dict(step_mod.PASS_LAUNCHES)
    r_k, p_k = r.clone(), p.clone()
    pap_k = pap(p_k, ap, ws)
    sums = update(r_k, ap, inv, rz, pap_k, ws)
    x_k = direction(x, r_k, p_k, inv, rz, pap_k, sums[0])
    assert {k: v - launches[k] for k, v in step_mod.PASS_LAUNCHES.items()
            } == {"dots": 0, "pap": 1, "update": 1, "direction": 1}
    psolve = (lambda v: v) if inv is None else (lambda v: inv * v)
    x_w, r_w, p_w, rz_w, rr_w = cg_step_plain(
        x, r, p, ap, rz.reshape(()), psolve,
        _fed(torch.cat([pap_k, sums])))
    for got, want in ((x_k, x_w), (r_k, r_w), (p_k, p_w)):
        assert got.dtype == want.dtype and got.shape == want.shape
        assert torch.equal(got, want), (got != want).nonzero()[:5]


# Relative to Σ|u_i·v_i|: sums of up to 10^6 products in another order.
# The card read at most 1.8e-16 (float64) and 8.6e-8 (float32) at 2^24
# values; a sum that drops a tenth of its blocks is off by about 0.3.
DOT_TOL = {torch.float64: 1e-12, torch.float32: 1e-6}


@pytest.mark.card
@pytest.mark.parametrize("offset", [False, True], ids=["pack", "value"])
@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("dtype", list(DTYPES.values()), ids=list(DTYPES))
def test_dots_near_torch_dot_and_repeatable(card, dtype, n, offset):
    x, r, p, ap, inv, rz = _vectors(card, n, dtype, True, offset)
    ws = workspace(x)
    tol = DOT_TOL[dtype]

    def near(got, u, v):
        want = torch.dot(u.double(), v.double())
        scale = torch.dot(u.double().abs(), v.double().abs())
        assert float((got.double() - want).abs()) <= tol * float(scale)

    runs = []
    for _ in range(3):
        d0 = dots(r, inv, ws)
        p0 = pap(p, ap, ws)
        r1 = r.clone()
        s1 = update(r1, ap, inv, rz, p0, ws)
        runs.append(torch.cat([d0, p0, s1]))
        near(d0[0], r, inv * r)
        near(d0[1], r, r)
        near(p0[0], p, ap)
        near(s1[0], r1, inv * r1)
        near(s1[1], r1, r1)
    assert all(torch.equal(runs[0], other) for other in runs[1:])
    assert int(ws.ticket[0]) == 0


def _stencil(card, m):
    """The 27-point stencil of an ``m^3`` grid with HPCG's values (26 on
    the diagonal, -1 off it), float64 CSR on the card."""
    from spalinalg_tpu_torch.tools.bench_bsr import grid27_pattern

    indptr, indices = grid27_pattern(m, card)
    n = m ** 3
    rows = torch.repeat_interleave(
        torch.arange(n, device=card), (indptr[1:] - indptr[:-1]).long())
    values = torch.where(indices.long() == rows, 26.0, -1.0).double()
    return CsrMatrix._from_parts(n, n, indptr, indices, values)


def _ex56(card, ne=12):
    from spbench.structures import hex8_elasticity

    m = hex8_elasticity.counts(ne)["rows"]
    return BsrMatrix.from_block_triplets(
        m, m, *hex8_elasticity.triplets(ne, device=card))


@pytest.mark.card
@pytest.mark.parametrize("matrix", ["stencil", "ex56"])
def test_fifty_steps_within_the_cells_x_gap(card, matrix):
    """A 50-step Jacobi solve at ``tol = 0`` (the benchmark's units) on
    the card's kernels against the torch step on the same card: within
    ``x_gap``'s limit, three launches a step and one for the first
    residual's dots, every step recorded as ``cg_step:cuda:fused``; a
    second solve gives the same bits."""
    A = _stencil(card, 48) if matrix == "stencil" else _ex56(card)
    gen = torch.Generator(device=card).manual_seed(9)
    b = A @ (torch.rand(A.nrows, generator=gen, dtype=torch.float64,
                        device=card) + 0.5)
    before = dict(step_mod.PASS_LAUNCHES)
    rec = metrics.enable()
    try:
        rec.records.clear()
        got = tla.cg(A, b, tol=0.0, maxiter=50, precondition="jacobi")
        torch.cuda.synchronize()
        paths = {r.path for r in rec.records if r.op == "cg_step"}
    finally:
        metrics.disable()
        rec.records.clear()
    assert paths == {"cg_step:cuda:fused"}
    assert {k: v - before[k] for k, v in step_mod.PASS_LAUNCHES.items()} == {
        "dots": 1, "pap": 50, "update": 50, "direction": 50}
    inv = cg_mod.resolve_precond("jacobi", A).inv
    # a callable preconditioner: the torch step, the same arithmetic
    want = tla.cg(A, b, tol=0.0, maxiter=50, precondition=lambda r: inv * r)
    assert got.iterations == want.iterations == 50
    gap = float((got.x - want.x).abs().max() / want.x.abs().max())
    assert gap <= X_GAP[matrix], gap
    again = tla.cg(A, b, tol=0.0, maxiter=50, precondition="jacobi")
    assert torch.equal(again.x, got.x)
    assert torch.equal(again.residual, got.residual)
