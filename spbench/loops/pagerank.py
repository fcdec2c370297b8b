"""The ``pagerank`` loop: GAP's PageRank (damping 0.85, an L1 change read
back each iteration as GAP's convergence test), always the traffic's
number of iterations, so the work does not depend on rounding.

Set-up draws the configuration's graph from the seed and builds
``P = A·D⁻¹`` (both directions of every undirected edge, each entry
``1 / deg`` of its column, no self-loops) as triplets on the card,
compressed by the port's device path. An iteration is one ``P @ x``
through the port's ``CsrMatrix``, the teleport and dangling terms, and
the read-back. A unit is one solve from the uniform vector.

The check runs the plain reference (``pagerank_ref.py``) in float64 on
the same edges and compares the final ranks of a sample of the solves.
"""

from __future__ import annotations

import gc
import time
from types import SimpleNamespace

import torch

from .. import roofline
from ..harness import Reservoir
from ..structures import kronecker
from . import pagerank_ref


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _build(ctx, u, v, nodes: int, dtype):
    from spalinalg_tpu_torch import DeviceCoo

    deg = kronecker.degrees(u, v, nodes)
    rows = torch.cat([v, u])
    cols = torch.cat([u, v])
    vals = (1.0 / deg.to(torch.float64))[cols].to(dtype)
    _sync(ctx.device)
    t0 = time.perf_counter()
    csr = DeviceCoo(nodes, nodes, rows, cols, vals,
                    device=ctx.device).to_csr_device()
    _sync(ctx.device)
    ctx.timings["csr_build_s"] = time.perf_counter() - t0
    return csr, torch.nonzero(deg == 0).flatten()


def setup(ctx):
    cfg, tr = ctx.cell.config, ctx.cell.traffic
    dtype = getattr(torch, cfg["dtype"])
    nodes = int(cfg["nodes"])
    t0 = time.perf_counter()
    u, v = kronecker.from_config(cfg, ctx.seed, ctx.device,
                                 renumber=bool(tr["renumber"]))
    _sync(ctx.device)
    ctx.timings["graph_s"] = time.perf_counter() - t0
    P, dangling = _build(ctx, u, v, nodes, dtype)
    itemsize = torch.empty(0, dtype=dtype).element_size()
    st = SimpleNamespace(
        ctx=ctx, P=P, dangling=dangling, u=u, v=v, nodes=nodes, dtype=dtype,
        iters=int(tr["iterations"]), damping=float(tr["damping"]),
        count=0, iterations=0, last_error=None,
        work=(*roofline.csr_spmv_work(nodes, nodes, 2 * u.numel(), itemsize),
              itemsize),
        samples=Reservoir(int(tr["check_samples"]), ctx.seed))
    ctx.timings["nnz"] = 2 * u.numel()
    ctx.timings["longest_row"] = int(
        (P.rowptr[1:] - P.rowptr[:-1]).max())
    ctx.timings["dangling"] = int(dangling.numel())
    t0 = time.perf_counter()
    unit(st)                       # the warm-up: every shape of the window
    sync(st)
    ctx.timings["warmup_s"] = time.perf_counter() - t0
    st.count = st.iterations = 0
    st.samples = Reservoir(int(tr["check_samples"]), ctx.seed)
    return st


def unit(st) -> None:
    tracer, n, d = st.ctx.tracer, st.nodes, st.damping
    x = torch.full((n,), 1.0 / n, dtype=st.dtype, device=st.ctx.device)
    for _ in range(st.iters):
        with tracer.span("pagerank.spmv"):
            with tracer.timed("spmv", st.work):
                y = st.P @ x
        with tracer.span("pagerank.update"):
            dang = x[st.dangling].sum()
            x_new = d * y + (d * dang + (1.0 - d)) / n
            err = (x_new - x).abs().sum()
            x = x_new
        with tracer.span("pagerank.readback"):
            st.last_error = float(err)
    st.iterations += st.iters
    st.samples.offer(lambda: x)
    st.count += 1


def sync(st) -> None:
    _sync(st.ctx.device)


def end_to_end(st, units: int, seconds: float) -> dict:
    return {"pagerank_ms": 1e3 * seconds / units}


def compare(answers, ref: torch.Tensor) -> dict:
    """The worst, over the compared solves, of ``Σ|x - x_ref| /
    Σ|x_ref|`` (GAP's L1 measure)."""
    gap = 0.0
    for x in answers:
        x = x.to(ref.dtype)
        gap = max(gap, float((x - ref).abs().sum() / ref.abs().sum()))
    return {"rank_gap": gap}


def reference(st_or_inputs, dtype=torch.float64) -> torch.Tensor:
    s = st_or_inputs
    return pagerank_ref.solve(s.u, s.v, s.nodes, s.iters, s.damping, dtype)


def check(st, limits: dict) -> dict:
    picked = list(st.samples.items)
    st.P = st.dangling = None
    st.samples = None
    gc.collect()
    if st.ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    nums = compare(picked, reference(st))
    return {k: {"value": v, "limit": limits[k]} for k, v in nums.items()}


def control(ctx) -> dict:
    """The control: the reference computed in bfloat16 (the step below the
    configuration's float32) in the program's place."""
    cfg, tr = ctx.cell.config, ctx.cell.traffic
    u, v = kronecker.from_config(cfg, ctx.seed, ctx.device,
                                 renumber=bool(tr["renumber"]))
    inp = SimpleNamespace(u=u, v=v, nodes=int(cfg["nodes"]),
                          iters=int(tr["iterations"]),
                          damping=float(tr["damping"]))
    return compare([reference(inp, torch.bfloat16)], reference(inp))
