"""The ``cg`` loop: HPCG's timed sets of CG iterations.

Set-up builds the 27-point operator of the configuration's grid as
triplets on the card and compresses it with the port's device path
(``DeviceCoo.to_csr_device``). The right-hand sides are ``b = A·x*`` with ``x*``
drawn from the seed. A unit is one call ``linalg.cg(A, b, tol=0.0,
maxiter=N, precondition="jacobi")``, the right-hand sides taken in turn.

The check solves the same systems with the plain reference
(``cg_ref.py``) and compares the solution and the residual that the timed
calls returned, on a sample of the calls drawn from the seed.
"""

from __future__ import annotations

import gc
import time
from types import SimpleNamespace

import torch

from .. import roofline
from ..harness import Reservoir
from ..structures import stencil27
from . import cg_ref


LOWER = {torch.float64: torch.float32}     # the control's precision


def flops_per_iteration(n: int, nnz: int) -> int:
    """HPCG's kind of count: ``2·nnz`` for the SpMV, ``2n`` for each of
    the three dot products and three vector updates, ``n`` for the Jacobi
    scaling."""
    return 2 * nnz + 13 * n


def inputs(ctx, n_rhs: int, dtype):
    """The right-hand sides, ``b_j = A·x*_j`` with ``x*_j`` uniform in
    ``[0.5, 1.5)``, drawn from the seed on the card."""
    nx, ny, nz = ctx.cell.config["grid"]
    gen = torch.Generator(device=ctx.device)
    gen.manual_seed(int(ctx.seed))
    out = []
    for _ in range(n_rhs):
        xs = torch.rand(nx * ny * nz, generator=gen, device=ctx.device,
                        dtype=dtype) + 0.5
        out.append(stencil27.apply(xs, nx, ny, nz))
        del xs
    return out


def _timed_operand(A, tracer, work):
    """``A`` with each ``@`` bracketed by CUDA events under ``spmv``: the
    surface ``linalg.cg`` reads (``device``, ``ncols``, and ``to_csr``,
    which hands the Jacobi set-up ``A`` itself, as it gets it unwrapped)."""

    class Timed:
        device = A.device
        ncols = A.ncols
        nrows = A.nrows

        @staticmethod
        def to_csr():
            return A

        def __matmul__(self, v):
            with tracer.timed("spmv", work):
                return A @ v

    return Timed()


def _build(ctx, dtype):
    """The operator as the port holds it: a ``CsrMatrix``, compressed from
    triplets on the card."""
    from spalinalg_tpu_torch import DeviceCoo

    nx, ny, nz = ctx.cell.config["grid"]
    n = nx * ny * nz
    rows, cols, vals = stencil27.triplets(nx, ny, nz, dtype=dtype,
                                          device=ctx.device)
    _sync(ctx.device)
    t0 = time.perf_counter()
    csr = DeviceCoo(n, n, rows, cols, vals, device=ctx.device).to_csr_device()
    _sync(ctx.device)
    ctx.timings["csr_build_s"] = time.perf_counter() - t0
    return csr


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def setup(ctx):
    cfg, tr = ctx.cell.config, ctx.cell.traffic
    dtype = getattr(torch, cfg["dtype"])
    nx, ny, nz = cfg["grid"]
    t0 = time.perf_counter()
    bs = inputs(ctx, int(tr["rhs"]), dtype)
    _sync(ctx.device)
    ctx.timings["inputs_s"] = time.perf_counter() - t0
    A = _build(ctx, dtype)
    itemsize = torch.empty(0, dtype=dtype).element_size()
    n, nnz = nx * ny * nz, stencil27.nnz(nx, ny, nz)
    work = (*roofline.csr_spmv_work(n, n, nnz, itemsize), itemsize)
    st = SimpleNamespace(
        ctx=ctx, A=A, bs=bs, maxiter=int(tr["maxiter"]),
        precondition=tr["precondition"],
        count=0, iterations=0, flops=0,
        per_iter=flops_per_iteration(n, nnz),
        samples=Reservoir(int(tr["check_samples"]), ctx.seed),
        timed_op=_timed_operand(A, ctx.tracer, work))
    t0 = time.perf_counter()
    unit(st)                       # the warm-up: every shape of the window
    sync(st)
    ctx.timings["warmup_s"] = time.perf_counter() - t0
    st.count = st.iterations = st.flops = 0
    st.samples = Reservoir(int(tr["check_samples"]), ctx.seed)
    return st


def unit(st) -> None:
    import spalinalg_tpu_torch.linalg as linalg

    j = st.count % len(st.bs)
    op = st.timed_op if st.ctx.tracer.events else st.A
    with st.ctx.tracer.span("cg.solve"):
        res = linalg.cg(op, st.bs[j], tol=0.0, maxiter=st.maxiter,
                        precondition=st.precondition)
    st.iterations += res.iterations
    st.flops += res.iterations * st.per_iter
    st.samples.offer(lambda: (j, res.x, res.residual, res.iterations))
    st.count += 1


def sync(st) -> None:
    _sync(st.ctx.device)


def end_to_end(st, units: int, seconds: float) -> dict:
    return {"cg_gflops": st.flops / seconds / 1e9}


def compare(answers, refs) -> dict:
    """The worst, over the compared calls, of ``max|x - x_ref| /
    max|x_ref|``, of ``|‖r‖ - ‖r‖_ref| / ‖r‖_ref`` and of the iterations
    short of the reference's."""
    x_gap = res_gap = short = 0.0
    for (x, res, its), (xr, rr, its_r) in zip(answers, refs):
        x = x.to(xr.dtype)
        x_gap = max(x_gap, float((x - xr).abs().max() / xr.abs().max()))
        res_gap = max(res_gap, float((res.to(rr.dtype) - rr).abs() / rr))
        short = max(short, float(its_r - its))
    return {"x_gap": x_gap, "residual_gap": res_gap, "iterations_short": short}


def reference(bs, picks, grid, maxiter: int, dtype=None):
    """The reference's answers for the right-hand sides ``picks``."""
    out = []
    for j in picks:
        x, r = cg_ref.solve(bs[j], grid, maxiter, dtype)
        out.append((x, r, maxiter))
    return out


def check(st, limits: dict) -> dict:
    """Frees the program's state, then holds the sampled answers against
    the reference."""
    ctx = st.ctx
    grid = tuple(ctx.cell.config["grid"])
    picked = list(st.samples.items)
    bs = st.bs
    st.A = st.timed_op = st.bs = None
    st.samples = None
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    refs = reference(bs, [j for j, *_ in picked], grid, st.maxiter)
    nums = compare([(x, r, its) for _, x, r, its in picked], refs)
    return {k: {"value": v, "limit": limits[k]} for k, v in nums.items()}


def control(ctx) -> dict:
    """The control: the reference computed one precision down (float32
    for float64) in the program's place, held against the reference as
    the check holds the program."""
    cfg, tr = ctx.cell.config, ctx.cell.traffic
    dtype = getattr(torch, cfg["dtype"])
    grid = tuple(cfg["grid"])
    bs = inputs(ctx, int(tr["rhs"]), dtype)
    picks = range(min(int(tr["check_samples"]), len(bs)))
    refs = reference(bs, picks, grid, int(tr["maxiter"]))
    low = reference(bs, picks, grid, int(tr["maxiter"]), LOWER[dtype])
    return compare(low, refs)
