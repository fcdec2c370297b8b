"""Fill- and bandwidth-reducing orderings, host side (counterpart of
``spalinalg_tpu/linalg/ordering.py``).

The symbolic analysis of the factorizations runs on the host, once per
structure: reverse Cuthill-McKee compresses the band, and the level
schedule groups the rows of a triangular solve. Above 2048 rows both run
in the port's native library (``native/lib.py``), below it in NumPy, with
the JAX package's threshold, so a matrix takes the same code in both
packages. A native library that fails to build raises; it never falls
back to NumPy.

>>> from spalinalg_tpu_torch import CsrMatrix
>>> a = CsrMatrix(3, 3, [0, 2, 4, 6], [0, 2, 1, 2, 0, 1],
...               [4.0, 1.0, 4.0, 1.0, 1.0, 1.0], device="cpu")
>>> bandwidth(a), rcm_ordering(a).tolist()
(2, [0, 2, 1])
"""

from __future__ import annotations

from collections import deque
from typing import Tuple

import numpy as np

from ..native import lib as native

__all__ = ["rcm_ordering", "bandwidth", "level_schedule"]

NATIVE_ABOVE = 2048


def rcm_ordering(csr) -> np.ndarray:
    """Reverse Cuthill-McKee permutation of a (structurally symmetric)
    matrix: ``perm`` such that ``A[perm][:, perm]`` has a reduced
    bandwidth. BFS from a pseudo-peripheral vertex, neighbours by degree.
    """
    ptr, ind, _ = csr._host_arrays()
    n = csr.nrows
    if n > NATIVE_ABOVE:
        return native.rcm(ptr, ind, n)

    deg = np.diff(ptr)
    visited = np.zeros(n, dtype=bool)
    order = []

    def bfs(start):
        comp = []
        visited[start] = True
        q = deque([start])
        while q:
            u = q.popleft()
            comp.append(u)
            nbrs = ind[ptr[u]: ptr[u + 1]]
            nbrs = nbrs[~visited[nbrs]]
            for v in nbrs[np.argsort(deg[nbrs], kind="stable")]:
                if not visited[v]:
                    visited[v] = True
                    q.append(int(v))
        return comp

    for comp_start in range(n):
        if visited[comp_start]:
            continue
        # pseudo-peripheral start: one BFS, then restart from its last node
        first = bfs(comp_start)
        for u in first:
            visited[u] = False
        order.extend(bfs(first[-1]))

    return np.asarray(order[::-1], dtype=np.int64)


def bandwidth(csr) -> int:
    """Half-bandwidth ``max |i - j|`` over stored entries."""
    ptr, ind, _ = csr._host_arrays()
    rows = np.repeat(np.arange(csr.nrows, dtype=np.int64), np.diff(ptr))
    if rows.size == 0:
        return 0
    return int(np.abs(rows - ind).max())


def level_schedule(ptr: np.ndarray, ind: np.ndarray, n: int,
                   *, lower: bool) -> Tuple[np.ndarray, np.ndarray]:
    """Dependency levels of a sparse triangular solve.

    ``level[i] = 1 + max(level[j])`` over the off-diagonal entries ``j``
    of row ``i`` (lower; reversed rows for upper). Returns ``(bounds,
    order)``: ``order`` lists the rows grouped by level, and ``bounds``
    is the per-level boundary pointer into it (like a rowptr).
    """
    ptr = np.asarray(ptr, dtype=np.int64)
    ind = np.asarray(ind, dtype=np.int64)
    if n > NATIVE_ABOVE:
        n_levels, lev = native.level_schedule(ptr, ind, n, lower=lower)
    else:
        lev = np.zeros(n, dtype=np.int64)
        for i in (range(n) if lower else range(n - 1, -1, -1)):
            deps = ind[ptr[i]: ptr[i + 1]]
            deps = deps[deps < i] if lower else deps[deps > i]
            if deps.size:
                lev[i] = lev[deps].max() + 1
        n_levels = int(lev.max()) + 1 if n else 0
    order = np.argsort(lev, kind="stable")
    bounds = np.searchsorted(lev[order], np.arange(n_levels + 1))
    return bounds.astype(np.int64), order.astype(np.int64)
