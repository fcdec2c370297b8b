"""The ``gcn`` loop: full-batch training steps of OGB's products GCN
baseline (hidden width and depth from the traffic file), each layer
``Â @ (H·W) + b`` through the port's ``CsrMatrix @`` with autograd.

Set-up draws the configuration's graph, features, labels, training nodes
and initial weights (Glorot, zero biases) from the seed on the card,
builds ``Â = D^-1/2 (A + I) D^-1/2`` as triplets compressed by the port's
device path, and runs the first three training steps through the
window's own step: they are the warm-up, and the check follows them. A
unit is one step: forward, cross-entropy on the training nodes,
backward, ``torch.optim.Adam``, the loss read back. Dense products run in
float32 with TF32 off; dropout is left out, so a step is deterministic.

The check holds the first three steps against the plain reference
(``gcn_ref.py``, float64): the first step's loss and logits, the norm of
each parameter's first gradient as Adam got it (from its state after step
1), and the norm of each parameter's change over the three steps. These
are the steps that set-up drives through the window's own ``unit`` on the
object the window then runs, so the window's step is the step checked.
"""

from __future__ import annotations

import gc
import math
import statistics
import time
from types import SimpleNamespace

import torch
import torch.nn.functional as F

from .. import roofline
from ..structures import kronecker
from . import gcn_ref

CHECKED_STEPS = 3
QUIET_LEAF = 1e-3     # leaves whose reference gradient is under this share
                      # of the median leaf's move by round-off alone


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def widths(cfg: dict, tr: dict):
    return ([int(cfg["features"])] + [int(tr["hidden"])] * (int(tr["layers"]) - 1)
            + [int(cfg["classes"])])


def inputs(ctx):
    """The benchmark's inputs on the card: the configuration's graph
    (renumbered by the seed where the traffic says so), and features,
    labels, training nodes and initial weights drawn from the seed."""
    cfg, tr = ctx.cell.config, ctx.cell.traffic
    dtype = getattr(torch, cfg["dtype"])
    nodes, dev = int(cfg["nodes"]), ctx.device
    t0 = time.perf_counter()
    u, v = kronecker.from_config(cfg, ctx.seed, dev,
                                 renumber=bool(tr["renumber"]))
    _sync(dev)
    ctx.timings["graph_s"] = time.perf_counter() - t0
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(ctx.seed) + 1)
    feats = torch.randn(nodes, int(cfg["features"]), generator=gen,
                        device=dev, dtype=dtype)
    labels = torch.randint(0, int(cfg["classes"]), (nodes,), generator=gen,
                           device=dev)
    train = torch.sort(torch.randperm(nodes, generator=gen, device=dev)
                       [: int(cfg["train_nodes"])]).values
    params = []
    w = widths(cfg, tr)
    for fan_in, fan_out in zip(w[:-1], w[1:]):
        bound = math.sqrt(6.0 / (fan_in + fan_out))
        params.append((torch.rand(fan_in, fan_out, generator=gen, device=dev,
                                  dtype=dtype) * 2 - 1) * bound)
        params.append(torch.zeros(fan_out, device=dev, dtype=dtype))
    return SimpleNamespace(u=u, v=v, nodes=nodes, features=feats,
                           labels=labels, train=train, params0=params,
                           lr=float(tr["lr"]))


def _build(ctx, inp, dtype):
    from spalinalg_tpu_torch import DeviceCoo

    n = inp.nodes
    dinv = (kronecker.degrees(inp.u, inp.v, n) + 1).to(torch.float64).rsqrt()
    loops = torch.arange(n, device=ctx.device)
    rows = torch.cat([inp.u, inp.v, loops])
    cols = torch.cat([inp.v, inp.u, loops])
    vals = (dinv[rows] * dinv[cols]).to(dtype)
    _sync(ctx.device)
    t0 = time.perf_counter()
    csr = DeviceCoo(n, n, rows, cols, vals, device=ctx.device).to_csr_device()
    _sync(ctx.device)
    ctx.timings["csr_build_s"] = time.perf_counter() - t0
    return csr


def _propagate(st, z):
    """``Â @ z`` through the port; in timed units the forward and, by
    tensor hooks, the backward ``Âᵀ·G`` bracketed by CUDA events."""
    tracer = st.ctx.tracer
    if not tracer.events:
        return st.A @ z
    k = int(z.shape[1])
    work = (*roofline.csr_spmm_work(st.nodes, st.nodes, st.nnz, k,
                                    st.itemsize), st.itemsize)
    with tracer.timed("spmm_fwd", work):
        y = st.A @ z
    y.register_hook(lambda g: tracer.start("spmm_bwd", work))
    z.register_hook(lambda g: tracer.stop("spmm_bwd"))
    return y


def forward(st):
    h = st.inp.features
    layers = len(st.params) // 2
    for l in range(layers):
        w, b = st.params[2 * l], st.params[2 * l + 1]
        h = _propagate(st, h @ w) + b
        if l < layers - 1:
            h = torch.relu(h)
    return h


def unit(st):
    """One training step; returns the logits."""
    tracer = st.ctx.tracer
    inp = st.inp
    with tracer.span("gcn.forward"):
        st.opt.zero_grad(set_to_none=True)
        logits = forward(st)
        loss = F.cross_entropy(logits[inp.train], inp.labels[inp.train])
    with tracer.span("gcn.backward"):
        loss.backward()
    with tracer.span("gcn.optimizer"):
        st.opt.step()
    with tracer.span("gcn.readback"):
        st.losses.append(loss.item())
    st.iterations += 1
    st.count += 1
    return logits.detach()


def setup(ctx):
    cfg = ctx.cell.config
    dtype = getattr(torch, cfg["dtype"])
    t0 = time.perf_counter()
    inp = inputs(ctx)
    _sync(ctx.device)
    ctx.timings["inputs_s"] = time.perf_counter() - t0
    A = _build(ctx, inp, dtype)
    params = [p.clone().requires_grad_() for p in inp.params0]
    st = SimpleNamespace(
        ctx=ctx, inp=inp, A=A, params=params,
        opt=torch.optim.Adam(params, lr=inp.lr), nodes=inp.nodes,
        nnz=2 * inp.u.numel() + inp.nodes,
        itemsize=torch.empty(0, dtype=dtype).element_size(),
        count=0, iterations=0, losses=[])
    ctx.timings["nnz"] = st.nnz
    ctx.timings["longest_row"] = int((A.rowptr[1:] - A.rowptr[:-1]).max())
    t0 = time.perf_counter()
    st.logits1 = unit(st)
    beta1 = st.opt.param_groups[0]["betas"][0]
    st.grads1 = [st.opt.state[p].get("exp_avg", torch.zeros_like(p))
                 .detach().clone() / (1 - beta1) for p in params]
    for _ in range(CHECKED_STEPS - 1):
        unit(st)
    st.params3 = [p.detach().clone() for p in params]
    st.losses3 = list(st.losses)
    _sync(ctx.device)
    ctx.timings["checked_steps_s"] = time.perf_counter() - t0
    st.count = st.iterations = 0
    st.losses = []
    return st


def sync(st) -> None:
    _sync(st.ctx.device)


def end_to_end(st, units: int, seconds: float) -> dict:
    return {"gcn_step_ms": 1e3 * seconds / units}


def _leaf_gaps(prog, ref, keep) -> list:
    """Each kept leaf's ``|‖prog‖ - ‖ref‖|`` over the larger of its
    ``‖ref‖`` and the median kept leaf's."""
    pn = [float(torch.linalg.vector_norm(p.double())) for p in prog]
    rn = [float(torch.linalg.vector_norm(r.double())) for r in ref]
    med = statistics.median(rn[i] for i in keep)
    return [abs(pn[i] - rn[i]) / max(rn[i], med) for i in keep]


def gaps(prog, ref) -> dict:
    """Every gap the check reads: each step's loss, the first logits, each
    leaf's first gradient and change. ``prog`` and ``ref``: ``(losses,
    logits1, grads1, params0, params3)``."""
    lp, zp, gp, p0, p3 = prog
    lr_, zr, gr, r0, r3 = ref
    rn = [float(torch.linalg.vector_norm(g.double())) for g in gr]
    med = statistics.median(rn)
    moving = [i for i, n in enumerate(rn) if n >= QUIET_LEAF * med]
    zp = zp.to(zr.dtype)
    return {
        "loss": [abs(a - b) / abs(b) for a, b in zip(lp, lr_)],
        "logits": float((zp - zr).abs().max() / zr.abs().max()),
        "grad": _leaf_gaps(gp, gr, range(len(gr))),
        "change": _leaf_gaps([b - a for a, b in zip(p0, p3)],
                             [b - a.to(b.dtype) for a, b in zip(r0, r3)],
                             moving),
    }


def compare(prog, ref, every: dict = None) -> dict:
    """The compared numbers: the first step's loss, the first logits, the
    worst leaf's first gradient, the median leaf's change over the
    checked steps, and the worst leaf's change (a leaf the optimizer left
    as it was reads 1, or its change's share of the median leaf's where
    that is smaller). The later steps' losses swing from seed to
    seed with Adam's first steps on gradients near zero (PERF.md §2); they
    are printed, not compared."""
    g = every if every is not None else gaps(prog, ref)
    return {"loss_gap": g["loss"][0], "logits_gap": g["logits"],
            "grad_gap": max(g["grad"]),
            "change_gap": statistics.median(g["change"]),
            "change_worst_gap": max(g["change"])}


def reference(inp, dtype=torch.float64):
    losses, logits1, grads1, params3 = gcn_ref.train(inp, CHECKED_STEPS,
                                                     inp.lr, dtype)
    return (losses, logits1, grads1, inp.params0, params3)


def check(st, limits: dict) -> dict:
    prog = (st.losses3, st.logits1, st.grads1, st.inp.params0, st.params3)
    inp = st.inp
    st.A = st.opt = st.params = st.logits1 = None
    st.inp = None
    gc.collect()
    if st.ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    every = gaps(prog, reference(inp))
    st.ctx.notes["gaps"] = every
    nums = compare(prog, None, every)
    return {k: {"value": v, "limit": limits[k]} for k, v in nums.items()}


def control(ctx) -> dict:
    """The control: the reference computed in float32 with TF32 on (the
    step below the configuration's float32 with TF32 off) in the
    program's place."""
    inp = inputs(ctx)
    ref = reference(inp)
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        low = reference(inp, torch.float32)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
    ctx.notes["gaps"] = gaps(low, ref)
    return compare(low, ref, ctx.notes["gaps"])
