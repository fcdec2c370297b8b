"""Graph500's Kronecker graph as GAP builds it: ``edgefactor · 2^scale``
edge tuples drawn by Graph500's generator (initiator ``a, b, c, d``), the
vertex ids relabelled by a random permutation, then symmetrised with
self-loops and duplicate edges removed. Nothing is cut: every one of the
``2^scale`` vertices stays, isolated ones included.

Everything is drawn on the device from one ``torch.Generator``, so a seed
gives the same graph on every run on the same kind of device. A
configuration fixes the seed of its graph; a run's seed at most renumbers
the nodes (``from_config``).
"""

from __future__ import annotations

import torch


def _draw(n_draw: int, scale: int, a: float, b: float, c: float, gen,
          device):
    """Graph500's generator (``kronecker_generator.m``): a bit of the
    source and of the target a level."""
    ab = a + b
    c_norm = c / (1.0 - ab)
    a_norm = a / ab
    ii = torch.zeros(n_draw, dtype=torch.int64, device=device)
    jj = torch.zeros(n_draw, dtype=torch.int64, device=device)
    for level in range(scale):
        ii_bit = torch.rand(n_draw, generator=gen, device=device) > ab
        thresh = torch.where(ii_bit, c_norm, a_norm)
        jj_bit = torch.rand(n_draw, generator=gen, device=device) > thresh
        ii |= ii_bit.to(torch.int64) << level
        jj |= jj_bit.to(torch.int64) << level
    return ii, jj


def edges(scale: int, edgefactor: int, initiator, seed: int, device):
    """``(u, v)``: the distinct undirected edges ``u < v`` of the graph,
    int64 on ``device``, sorted by ``(u, v)``."""
    a, b, c, _ = initiator
    nodes = 1 << scale
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    ii, jj = _draw(edgefactor * nodes, scale, a, b, c, gen, device)
    label = torch.randperm(nodes, generator=gen, device=device)
    u, v = label[ii], label[jj]
    del ii, jj
    ok = u != v
    u, v = u[ok], v[ok]
    key = torch.unique(torch.minimum(u, v) * nodes + torch.maximum(u, v))
    return key // nodes, key % nodes


def degrees(u: torch.Tensor, v: torch.Tensor, nodes: int) -> torch.Tensor:
    """Undirected degree of every node (int64)."""
    return (torch.bincount(u, minlength=nodes)
            + torch.bincount(v, minlength=nodes))


def relabel(u: torch.Tensor, v: torch.Tensor, nodes: int, seed: int):
    """The same graph with its nodes renumbered by a permutation drawn
    from ``seed``: ``(u, v)`` with ``u < v``, sorted."""
    gen = torch.Generator(device=u.device)
    gen.manual_seed(int(seed))
    perm = torch.randperm(nodes, generator=gen, device=u.device)
    a, b = perm[u], perm[v]
    key = torch.sort(torch.minimum(a, b) * nodes + torch.maximum(a, b)).values
    return key // nodes, key % nodes


def from_config(cfg: dict, seed: int, device, renumber: bool = True):
    """``(u, v)`` of a configuration file's graph: drawn from its fixed
    ``graph_seed`` (``scale``, ``edgefactor``, ``initiator``), so every
    run serves the same graph; where ``renumber``, relabelled by the run's
    ``seed``, so that each seed brings the same work in another order."""
    u, v = edges(int(cfg["scale"]), int(cfg["edgefactor"]),
                 cfg["initiator"], int(cfg["graph_seed"]), device)
    return relabel(u, v, int(cfg["nodes"]), seed) if renumber else (u, v)
