"""The plain reference of the ``gcn`` loop: the same 3-layer GCN training
steps in plain PyTorch, by default in float64.

It imports nothing of the program. It builds ``Â = D^-1/2 (A + I)
D^-1/2`` itself from the benchmark's edge list, as a coalesced COO tensor
and its transpose, and multiplies through ``torch.sparse.mm``; the
gradient of ``Â @ Z`` is ``Âᵀ @ G``. Adam is written out (PyTorch's
defaults: betas 0.9 / 0.999, eps 1e-8, bias-corrected).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..structures import kronecker

BETAS = (0.9, 0.999)
EPS = 1e-8


def normalized(u, v, nodes: int, dtype):
    """``(Â, Âᵀ)`` as coalesced COO tensors."""
    deg = kronecker.degrees(u, v, nodes) + 1
    dinv = deg.to(torch.float64).rsqrt()
    loops = torch.arange(nodes, device=u.device)
    rows = torch.cat([u, v, loops])
    cols = torch.cat([v, u, loops])
    vals = (dinv[rows] * dinv[cols]).to(dtype)
    a = torch.sparse_coo_tensor(torch.stack([rows, cols]), vals,
                                (nodes, nodes),
                                check_invariants=False).coalesce()
    at = torch.sparse_coo_tensor(torch.stack([cols, rows]), vals,
                                 (nodes, nodes),
                                 check_invariants=False).coalesce()
    return a, at


class _Propagate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, z, a, at):
        ctx.at = at
        return torch.sparse.mm(a, z)

    @staticmethod
    def backward(ctx, g):
        return torch.sparse.mm(ctx.at, g), None, None


def forward(params, feats, a, at):
    """Logits of the GCN: ``Â (H W_l) + b_l``, ReLU between layers."""
    h = feats
    layers = len(params) // 2
    for l in range(layers):
        w, b = params[2 * l], params[2 * l + 1]
        h = _Propagate.apply(h @ w, a, at) + b
        if l < layers - 1:
            h = torch.relu(h)
    return h


def train(inp, steps: int, lr: float, dtype=torch.float64):
    """``steps`` full-batch steps from the benchmark's initial parameters.
    Returns the losses, the first step's logits and gradients, and the
    parameters after the last step."""
    a, at = normalized(inp.u, inp.v, inp.nodes, dtype)
    feats = inp.features.to(dtype)
    params = [p.detach().to(dtype).clone().requires_grad_()
              for p in inp.params0]
    m = [torch.zeros_like(p) for p in params]
    s = [torch.zeros_like(p) for p in params]
    losses, logits1, grads1 = [], None, None
    for t in range(1, steps + 1):
        logits = forward(params, feats, a, at)
        loss = F.cross_entropy(logits[inp.train], inp.labels[inp.train])
        grads = torch.autograd.grad(loss, params)
        losses.append(float(loss.detach()))
        if t == 1:
            logits1 = logits.detach()
            grads1 = [g.detach() for g in grads]
        del logits, loss
        with torch.no_grad():
            for p, g, mi, si in zip(params, grads, m, s):
                mi.mul_(BETAS[0]).add_(g, alpha=1 - BETAS[0])
                si.mul_(BETAS[1]).add_(g * g, alpha=1 - BETAS[1])
                mhat = mi / (1 - BETAS[0] ** t)
                vhat = si / (1 - BETAS[1] ** t)
                p.sub_(lr * mhat / (vhat.sqrt() + EPS))
    return losses, logits1, grads1, [p.detach() for p in params]
