"""The plain reference of the ``pagerank`` loop: GAP's PageRank (Beamer
et al., arXiv:1508.03619) with the dangling nodes' rank spread over every
node, in plain PyTorch over the benchmark's edge list.

It imports nothing of the program: each iteration scatters ``x[u] /
deg(u)`` along both directions of every undirected edge with
``index_add_``.
"""

from __future__ import annotations

import torch

from ..structures import kronecker


def solve(u: torch.Tensor, v: torch.Tensor, nodes: int, iters: int,
          damping: float, dtype) -> torch.Tensor:
    """The ranks after ``iters`` iterations from the uniform vector,
    computed in ``dtype``."""
    deg = kronecker.degrees(u, v, nodes)
    dangling = deg == 0
    inv = torch.where(dangling, 0.0, 1.0 / deg.clamp(min=1).to(torch.float64))
    inv = inv.to(dtype)
    src = torch.cat([u, v])
    dst = torch.cat([v, u])
    x = torch.full((nodes,), 1.0 / nodes, dtype=dtype, device=u.device)
    for _ in range(iters):
        contrib = (x * inv)[src]
        y = torch.zeros_like(x).index_add_(0, dst, contrib)
        dang = x[dangling].sum()
        x = damping * y + (damping * dang + (1.0 - damping)) / nodes
        del contrib, y
    return x
