"""The plain references at toy sizes, against dense NumPy."""

import types

import numpy as np
import torch

from spbench.loops import cg_ref, gcn_ref, pagerank_ref
from spbench.structures import kronecker
from test_spbench_generators import dense_stencil


def test_cg_reference_is_jacobi_cg():
    grid = (4, 3, 3)
    a = dense_stencil(*grid)
    rng = np.random.default_rng(0)
    b = a @ rng.uniform(0.5, 1.5, a.shape[0])
    x, res = cg_ref.solve(torch.from_numpy(b), grid, 7)
    # the textbook recurrence in NumPy
    xx = np.zeros_like(b)
    r = b.copy()
    z = r / 26.0
    p = z.copy()
    rz = r @ z
    for _ in range(7):
        ap = a @ p
        alpha = rz / (p @ ap)
        xx += alpha * p
        r -= alpha * ap
        z = r / 26.0
        rz_new = r @ z
        p = z + (rz_new / rz) * p
        rz = rz_new
    np.testing.assert_allclose(x.numpy(), xx, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(float(res), np.linalg.norm(r), rtol=1e-10)
    x_conv, _ = cg_ref.solve(torch.from_numpy(b), grid, 25)
    np.testing.assert_allclose(x_conv.numpy(), np.linalg.solve(a, b),
                               rtol=1e-10)


def _graph(scale=7, seed=2):
    return kronecker.edges(scale, 6, (0.57, 0.19, 0.19, 0.05), seed, "cpu")


def test_pagerank_reference_is_gap_pagerank():
    nodes = 128
    u, v = _graph()
    a = np.zeros((nodes, nodes))
    a[u.numpy(), v.numpy()] = 1
    a[v.numpy(), u.numpy()] = 1
    deg = a.sum(0)
    x = np.full(nodes, 1.0 / nodes)
    for _ in range(20):
        contrib = np.where(deg > 0, x / np.maximum(deg, 1), 0.0)
        x = 0.85 * (a @ contrib) + (0.85 * x[deg == 0].sum() + 0.15) / nodes
    got = pagerank_ref.solve(u, v, nodes, 20, 0.85, torch.float64)
    np.testing.assert_allclose(got.numpy(), x, rtol=1e-12)
    assert abs(got.sum().item() - 1.0) < 1e-12


def test_gcn_reference_against_dense_autograd():
    nodes, feats, classes = 128, 6, 4
    u, v = _graph()
    gen = torch.Generator().manual_seed(0)
    inp = types.SimpleNamespace(
        u=u, v=v, nodes=nodes,
        features=torch.randn(nodes, feats, generator=gen),
        labels=torch.randint(0, classes, (nodes,), generator=gen),
        train=torch.arange(0, nodes, 3),
        params0=[torch.randn(feats, 8, generator=gen) * 0.3,
                 torch.zeros(8), torch.randn(8, classes, generator=gen) * 0.3,
                 torch.zeros(classes)])
    losses, logits1, grads1, params = gcn_ref.train(inp, 2, 0.01)
    a = torch.zeros(nodes, nodes, dtype=torch.float64)
    a[u, v] = 1
    a[v, u] = 1
    a += torch.eye(nodes, dtype=torch.float64)
    dinv = a.sum(1).rsqrt()
    a = dinv[:, None] * a * dinv[None, :]
    ps = [p.double().clone().requires_grad_() for p in inp.params0]
    opt = torch.optim.Adam(ps, lr=0.01)
    want = []
    for step in range(2):
        h = torch.relu(a @ (inp.features.double() @ ps[0]) + ps[1])
        out = a @ (h @ ps[2]) + ps[3]
        loss = torch.nn.functional.cross_entropy(out[inp.train],
                                                 inp.labels[inp.train])
        opt.zero_grad()
        loss.backward()
        if step == 0:
            np.testing.assert_allclose(logits1.numpy(), out.detach().numpy(),
                                       rtol=1e-12, atol=1e-12)
            for g, p in zip(grads1, ps):
                np.testing.assert_allclose(g.numpy(), p.grad.numpy(),
                                           rtol=1e-10, atol=1e-14)
        want.append(loss.item())
        opt.step()
    np.testing.assert_allclose(losses, want, rtol=1e-12)
    for got, p in zip(params, ps):
        np.testing.assert_allclose(got.numpy(), p.detach().numpy(),
                                   rtol=1e-10, atol=1e-12)
