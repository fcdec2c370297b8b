"""The stencil and Kronecker generators at toy sizes, against NumPy."""

import itertools

import numpy as np
import pytest
import torch

from spbench.structures import kronecker, stencil27


def dense_stencil(nx, ny, nz):
    """HPCG's operator as a dense matrix, from its definition."""
    n = nx * ny * nz
    a = np.zeros((n, n))
    for z, y, x in itertools.product(range(nz), range(ny), range(nx)):
        i = (z * ny + y) * nx + x
        for dz, dy, dx in itertools.product((-1, 0, 1), repeat=3):
            zz, yy, xx = z + dz, y + dy, x + dx
            if 0 <= zz < nz and 0 <= yy < ny and 0 <= xx < nx:
                a[i, (zz * ny + yy) * nx + xx] = -1.0
        a[i, i] = 26.0
    return a


@pytest.mark.parametrize("grid", [(3, 3, 3), (5, 4, 3), (2, 6, 5)])
def test_stencil_triplets_equal_the_definition(grid):
    nx, ny, nz = grid
    rows, cols, vals = stencil27.triplets(nx, ny, nz)
    a = np.zeros((nx * ny * nz,) * 2)
    np.add.at(a, (rows.numpy(), cols.numpy()), vals.numpy())
    np.testing.assert_array_equal(a, dense_stencil(nx, ny, nz))
    assert rows.numel() == stencil27.nnz(nx, ny, nz)


def test_stencil_apply_equals_the_matrix():
    nx, ny, nz = 5, 4, 3
    x = torch.randn(nx * ny * nz, dtype=torch.float64)
    np.testing.assert_allclose(stencil27.apply(x, nx, ny, nz).numpy(),
                               dense_stencil(nx, ny, nz) @ x.numpy(),
                               rtol=1e-13, atol=1e-12)


def test_stencil_counts_at_the_configured_sizes():
    assert stencil27.nnz(256, 256, 256) == 449_455_096 == 766 ** 3


def test_kronecker_draw_follows_graph500():
    """One round against Graph500's ``kronecker_generator.m`` in NumPy on
    the same uniform draws."""
    a, b, c = 0.57, 0.19, 0.19
    scale, m = 6, 4096
    gen = torch.Generator().manual_seed(3)
    ii, jj = kronecker._draw(m, scale, a, b, c, gen, "cpu")
    gen = torch.Generator().manual_seed(3)
    ab, c_norm, a_norm = a + b, c / (1 - (a + b)), a / (a + b)
    want_i = np.zeros(m, np.int64)
    want_j = np.zeros(m, np.int64)
    for ib in range(scale):
        r1 = torch.rand(m, generator=gen).numpy()
        r2 = torch.rand(m, generator=gen).numpy()
        ii_bit = r1 > ab
        jj_bit = r2 > (c_norm * ii_bit + a_norm * (~ii_bit))
        want_i += (2 ** ib) * ii_bit
        want_j += (2 ** ib) * jj_bit
    np.testing.assert_array_equal(ii.numpy(), want_i)
    np.testing.assert_array_equal(jj.numpy(), want_j)


def _numpy_kronecker(scale, edgefactor, initiator, seed):
    """Graph500's ``kronecker_generator.m`` and GAP's builder in NumPy on
    the same uniform draws: tuples, a permutation of the ids, symmetrised,
    self-loops and duplicates removed."""
    a, b, c, _ = initiator
    n, m = 1 << scale, edgefactor << scale
    gen = torch.Generator().manual_seed(seed)
    ab, c_norm, a_norm = a + b, c / (1 - (a + b)), a / (a + b)
    ii = np.zeros(m, np.int64)
    jj = np.zeros(m, np.int64)
    for ib in range(scale):
        r1 = torch.rand(m, generator=gen).numpy()
        r2 = torch.rand(m, generator=gen).numpy()
        ii_bit = r1 > ab
        jj_bit = r2 > (c_norm * ii_bit + a_norm * (~ii_bit))
        ii += (2 ** ib) * ii_bit
        jj += (2 ** ib) * jj_bit
    label = torch.randperm(n, generator=gen).numpy()
    edges = {(min(s, t), max(s, t)) for s, t in zip(label[ii], label[jj])
             if s != t}
    return np.array(sorted(edges))


@pytest.mark.parametrize("scale,edgefactor,seed", [(6, 4, 11), (8, 16, 21),
                                                   (9, 8, 2 ** 31 + 3)])
def test_kronecker_edges_equal_graph500_as_gap_builds_it(scale, edgefactor,
                                                         seed):
    init = (0.57, 0.19, 0.19, 0.05)
    u, v = kronecker.edges(scale, edgefactor, init, seed, "cpu")
    want = _numpy_kronecker(scale, edgefactor, init, seed)
    np.testing.assert_array_equal(u.numpy(), want[:, 0])
    np.testing.assert_array_equal(v.numpy(), want[:, 1])
    assert bool((u < v).all()) and bool((v < (1 << scale)).all())
    u2, v2 = kronecker.edges(scale, edgefactor, init, seed, "cpu")
    assert torch.equal(u, u2) and torch.equal(v, v2)
    u3, _ = kronecker.edges(scale, edgefactor, init, seed + 1, "cpu")
    assert not torch.equal(u, u3)
    nodes = 1 << scale
    deg = kronecker.degrees(u, v, nodes).numpy()
    want_deg = np.bincount(u.numpy(), minlength=nodes) + np.bincount(
        v.numpy(), minlength=nodes)
    np.testing.assert_array_equal(deg, want_deg)


def test_relabel_keeps_the_graph():
    """A run's seed renumbers the configuration's graph: the same degree
    multiset and edge count, another order."""
    cfg = {"nodes": 256, "scale": 8, "edgefactor": 6,
           "initiator": [0.57, 0.19, 0.19, 0.05], "graph_seed": 8}
    u1, v1 = kronecker.from_config(cfg, 1, "cpu")
    u2, v2 = kronecker.from_config(cfg, 2, "cpu")
    assert not torch.equal(u1, u2)
    d1 = torch.sort(kronecker.degrees(u1, v1, 256)).values
    d2 = torch.sort(kronecker.degrees(u2, v2, 256)).values
    assert torch.equal(d1, d2)
    u0, v0 = kronecker.edges(8, 6, cfg["initiator"], 8, "cpu")
    assert bool((u2 < v2).all()) and u2.numel() == u0.numel()
    assert torch.equal(torch.sort(kronecker.degrees(u0, v0, 256)).values, d1)
    uk, vk = kronecker.from_config(cfg, 1, "cpu", renumber=False)
    assert torch.equal(uk, u0) and torch.equal(vk, v0)
