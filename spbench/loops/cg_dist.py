"""The ``cg_dist`` loop: HPCG's timed sets of CG iterations on a gang of
ranks, one card a rank (weak scaling: the grid's z-planes dealt out in
slabs, the same slab size on every rank).

Set-up: each rank builds the triplets of its own slab's rows, with the
whole grid's column ids (``structures/stencil27_slab.py``), compresses
them with the port's device path (``DeviceCoo.to_csr_device``) and enters
the port's distributed tier through its rank-local entry
(``parallel.partition.shard_from_rows``) with ``comm="halo"``: no rank
ever holds another rank's rows. The right-hand
sides are ``b = A·x*`` on the whole grid with ``x*`` drawn from the seed
(``cg.inputs``: the same vectors whatever the number of ranks); each rank
keeps its slice.

A unit is one call ``linalg.cg(D, b, tol=0.0, maxiter=N,
precondition="jacobi")`` on the ``DistCsr`` itself, the right-hand sides
taken in turn: every product a halo ``dist_spmv``, every dot product an
``all_reduce`` over the ranks. Its work is the whole gang's.

The check gathers the sampled calls' solutions to every rank once the
program's matrix is freed, and rank 0 holds them and their residuals
against the plain reference on the whole grid (``cg_dist_ref.py``), as
``cg.compare`` does for one card.
"""

from __future__ import annotations

import gc
import time
from types import SimpleNamespace

import torch

from ..harness import BenchError, Reservoir
from ..structures import stencil27, stencil27_slab
from . import cg_dist_ref
# the right-hand sides, the comparison, sync and end_to_end (cg_gflops, the
# whole gang's work) are this loop's as they are cg's
from .cg import (LOWER, _sync, compare, end_to_end, flops_per_iteration,
                 inputs, sync)


def _build(ctx, dtype):
    """This rank's ``DistCsr``: its slab's triplets compressed on the card
    (``csr_build_s``, a host bracket to a synchronise), then the port's
    rank-local entry (``dist_entry_s``: the agreement over the ranks and
    the halo window's local block)."""
    # the port's rank-local entry first: a program without it fails here,
    # on every rank, before any work
    from spalinalg_tpu_torch import DeviceCoo
    from spalinalg_tpu_torch.parallel import make_row_mesh
    from spalinalg_tpu_torch.parallel.partition import shard_from_rows

    mesh = make_row_mesh(device=ctx.device)
    nx, ny, nz = ctx.cell.config["grid"]
    n = nx * ny * nz
    z0, z1 = stencil27_slab.planes(nz, ctx.rank, ctx.world)
    rows, cols, vals = stencil27_slab.triplets(nx, ny, nz, z0, z1,
                                               dtype=dtype, device=ctx.device)
    _sync(ctx.device)
    t0 = time.perf_counter()
    csr = DeviceCoo(nx * ny * (z1 - z0), n, rows, cols, vals,
                    device=ctx.device).to_csr_device()
    _sync(ctx.device)
    ctx.timings["csr_build_s"] = time.perf_counter() - t0
    del rows, cols, vals
    t0 = time.perf_counter()
    D = shard_from_rows(csr, n, n, mesh, comm="halo")
    del csr
    _sync(ctx.device)
    ctx.timings["dist_entry_s"] = time.perf_counter() - t0
    return D


def setup(ctx):
    cfg, tr = ctx.cell.config, ctx.cell.traffic
    if int(cfg["ranks"]) != ctx.world:
        raise BenchError(f"{ctx.cell.name} runs on {cfg['ranks']} ranks, "
                         f"this gang has {ctx.world}")
    dtype = getattr(torch, cfg["dtype"])
    nx, ny, nz = cfg["grid"]
    D = _build(ctx, dtype)
    t0 = time.perf_counter()
    lo = D.rank * D.rows_per_shard
    bs = [b[lo:lo + D.rows_per_shard].clone()
          for b in inputs(ctx, int(tr["rhs"]), dtype)]
    _sync(ctx.device)
    ctx.timings["inputs_s"] = time.perf_counter() - t0
    st = SimpleNamespace(
        ctx=ctx, D=D, bs=bs, maxiter=int(tr["maxiter"]),
        precondition=tr["precondition"],
        count=0, iterations=0, flops=0,
        per_iter=flops_per_iteration(nx * ny * nz, stencil27.nnz(nx, ny, nz)),
        samples=Reservoir(int(tr["check_samples"]), ctx.seed))
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
    with st.ctx.tracer.span("cg_dist.solve"):
        res = linalg.cg(st.D, st.bs[j], tol=0.0, maxiter=st.maxiter,
                        precondition=st.precondition)
    st.iterations += res.iterations
    st.flops += res.iterations * st.per_iter
    st.samples.offer(lambda: (j, res.x, res.residual, res.iterations))
    st.count += 1


def check(st, limits: dict) -> dict:
    """Frees the program's matrix, gathers each sampled call's solution
    from every rank, and on rank 0 holds the answers against the
    reference (every rank draws the same samples: the same units, the
    same seed). Other ranks return no numbers."""
    from spalinalg_tpu_torch.parallel import unshard_vector

    ctx = st.ctx
    layout = SimpleNamespace(mesh=st.D.mesh, nrows=st.D.nrows)
    picked = list(st.samples.items)
    st.D = st.bs = st.samples = None
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    picks, answers = [], []
    for j, x, r, its in picked:
        x = unshard_vector(x, layout)
        if ctx.rank == 0:
            picks.append(j)
            answers.append((x, r, its))
    del picked
    if ctx.rank != 0:
        return {}
    cfg, tr = ctx.cell.config, ctx.cell.traffic
    bs = inputs(ctx, int(tr["rhs"]), getattr(torch, cfg["dtype"]))
    refs = cg_dist_ref.reference(bs, picks, cfg["grid"], st.maxiter)
    nums = compare(answers, refs)
    return {k: {"value": v, "limit": limits[k]} for k, v in nums.items()}


def control(ctx) -> dict:
    """The control: the reference computed one precision down (float32
    for float64) in the program's place, held against the reference as
    the check holds the program; on rank 0 (no other rank computes)."""
    if ctx.rank != 0:
        return {}
    cfg, tr = ctx.cell.config, ctx.cell.traffic
    dtype = getattr(torch, cfg["dtype"])
    bs = inputs(ctx, int(tr["rhs"]), dtype)
    picks = range(min(int(tr["check_samples"]), len(bs)))
    refs = cg_dist_ref.reference(bs, picks, cfg["grid"], int(tr["maxiter"]))
    low = cg_dist_ref.reference(bs, picks, cfg["grid"], int(tr["maxiter"]),
                                LOWER[dtype])
    return compare(low, refs)
