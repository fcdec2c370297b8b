"""Supernodal Cholesky symbolic analysis, host side, once per structure
(counterpart of ``spalinalg_tpu/linalg/symbolic.py``).

1. fill-reducing ordering (AMD, in the port's native library),
2. elimination tree and postorder,
3. per-column L structures -> fundamental supernodes and their row
   structures (native ``spal_chol_symbolic`` above 512 columns, NumPy
   below, the JAX package's threshold),
4. relaxed amalgamation, and the assembly tree's level schedule for the
   numeric phase (:mod:`.supernodal`).

Pure structure work: no values are touched. A native library that fails
to build raises; nothing here falls back to another ordering.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

from ..native import lib as native

__all__ = ["etree", "postorder", "amd_ordering", "SupernodalSymbolic",
           "chol_symbolic"]

NATIVE_ABOVE = 512


def etree(ptr: np.ndarray, ind: np.ndarray, n: int) -> np.ndarray:
    """Elimination tree of a structurally-symmetric CSR structure
    (Liu's algorithm; ``parent[j] = -1`` for roots)."""
    if n > NATIVE_ABOVE:
        return native.etree(ptr, ind, n)
    parent = np.full(n, -1, dtype=np.int64)
    anc = np.full(n, -1, dtype=np.int64)
    for i in range(n):
        for p in range(ptr[i], ptr[i + 1]):
            j = int(ind[p])
            while j != -1 and j < i:
                nxt = int(anc[j])
                anc[j] = i
                if nxt == -1:
                    parent[j] = i
                    break
                j = -1 if nxt == i else nxt
    return parent


def postorder(parent: np.ndarray) -> np.ndarray:
    """Postorder permutation of a forest: ``post[k]`` = k-th visited node
    (children before parents, subtrees contiguous)."""
    n = parent.size
    # children lists via counting sort
    order = np.argsort(np.where(parent < 0, n, parent), kind="stable")
    starts = np.searchsorted(np.where(parent < 0, n, parent)[order],
                             np.arange(n + 1))
    post = np.empty(n, dtype=np.int64)
    k = 0
    roots = order[starts[n]:][::-1]
    stack: List[Tuple[int, bool]] = [(int(r), False) for r in roots[::-1]]
    stack.reverse()
    while stack:
        v, done = stack.pop()
        if done:
            post[k] = v
            k += 1
            continue
        stack.append((v, True))
        for c in order[starts[v]:starts[v + 1]][::-1]:
            stack.append((int(c), False))
    assert k == n
    return post


def amd_ordering(csr) -> np.ndarray:
    """Approximate-minimum-degree permutation (native)."""
    ptr, ind, _ = csr._host_arrays()
    return native.amd(ptr, ind, csr.nrows)


@dataclass(frozen=True, eq=False)
class SupernodalSymbolic:
    """Result of the symbolic phase on the (permuted, postordered) matrix.

    ``snode_ptr``: supernode column boundaries (nsn+1,);
    ``rows_ptr``/``rows_idx``: concatenated per-supernode structures —
    structure of supernode ``s`` is the sorted rows
    ``rows_idx[rows_ptr[s]:rows_ptr[s+1]]`` whose first
    ``snode_ptr[s+1]-snode_ptr[s]`` entries are the supernode's own
    columns; ``sn_parent``: assembly-tree parent per supernode;
    ``levels``: list of supernode-id arrays, leaves first.
    """

    n: int
    snode_ptr: np.ndarray
    rows_ptr: np.ndarray
    rows_idx: np.ndarray
    sn_parent: np.ndarray
    levels: List[np.ndarray]

    @property
    def nsn(self) -> int:
        return self.snode_ptr.size - 1

    def snode_of_col(self) -> np.ndarray:
        out = np.empty(self.n, dtype=np.int64)
        for s in range(self.nsn):
            out[self.snode_ptr[s]:self.snode_ptr[s + 1]] = s
        return out

    @property
    def l_nnz(self) -> int:
        """Stored entries of L (panel area, no padding)."""
        w = np.diff(self.snode_ptr)
        m = np.diff(self.rows_ptr)
        return int((w * m - w * (w - 1) // 2).sum())


def _chol_symbolic_py(ptr, ind, n):
    """NumPy fallback of the native supernodal symbolic phase."""
    parent = etree(ptr, ind, n)
    order = np.argsort(np.where(parent < 0, n, parent), kind="stable")
    starts = np.searchsorted(np.where(parent < 0, n, parent)[order],
                             np.arange(n + 1))
    structs: List[np.ndarray] = [None] * n
    count = np.zeros(n, dtype=np.int64)
    snode_ptr = [0]
    rows_ptr = [0]
    rows_chunks = []
    for j in range(n):
        cols = ind[ptr[j]:ptr[j + 1]]
        parts = [np.array([j], dtype=np.int64), cols[cols > j]]
        for c in order[starts[j]:starts[j + 1]]:
            sc = structs[c]
            parts.append(sc[sc > j])
            structs[c] = None
        s = np.unique(np.concatenate(parts))
        structs[j] = s
        count[j] = s.size
        fresh = j == 0 or not (parent[j - 1] == j
                               and count[j] == count[j - 1] - 1)
        if fresh:
            snode_ptr.append(j + 1)
            rows_chunks.append(s)
            rows_ptr.append(rows_ptr[-1] + s.size)
        else:
            snode_ptr[-1] = j + 1
    rows_idx = (np.concatenate(rows_chunks) if rows_chunks
                else np.zeros(0, np.int64))
    return (parent, np.asarray(snode_ptr, dtype=np.int64),
            np.asarray(rows_ptr, dtype=np.int64), rows_idx)


def _amalgamate(snode_ptr, rows_ptr, rows_idx, parent,
                *, always_width=16, tol=0.25, max_width=384):
    """Relaxed supernode amalgamation: merge a supernode into its
    assembly-tree parent when the parent's columns immediately follow
    (contiguity keeps the panel layout) and the padding zeros introduced
    stay under ``tol`` of the merged panel (always below
    ``always_width`` columns). Collapses the thousands of tiny
    fundamental supernodes of stencil matrices into larger fronts, and
    with them the number of distinct batched shapes."""
    nsn = snode_ptr.size - 1
    if nsn <= 1:
        return snode_ptr, rows_ptr, rows_idx
    structs = [rows_idx[rows_ptr[s]:rows_ptr[s + 1]] for s in range(nsn)]
    widths = np.diff(snode_ptr).astype(np.int64)
    snode_of = np.empty(snode_ptr[-1], dtype=np.int64)
    for s in range(nsn):
        snode_of[snode_ptr[s]:snode_ptr[s + 1]] = s
    last = snode_ptr[1:] - 1
    pcol = parent[last]
    sn_par = np.where(pcol < 0, -1, snode_of[np.clip(pcol, 0, None)])

    # process bottom-up; group[] maps original snode -> merged slot of
    # its subtree root so chains collapse transitively
    alive = np.ones(nsn, dtype=bool)
    group = np.arange(nsn, dtype=np.int64)
    for s in range(nsn - 1):
        p = sn_par[s]
        if p < 0:
            continue
        # contiguity: parent's first column == s's last column + 1
        # (p is processed later, so group[p] == p here)
        if snode_ptr[p] != snode_ptr[s + 1]:
            continue
        gs = group[s]
        if not alive[gs]:
            continue
        w_s, w_p = widths[gs], widths[p]
        wnew = w_s + w_p
        if wnew > max_width:
            continue
        m_s, m_p = structs[gs].size, structs[p].size
        mnew = w_s + m_p  # struct(s) \ cols(s) ⊆ struct(p); cols disjoint
        old = (w_s * m_s - w_s * (w_s - 1) // 2
               + w_p * m_p - w_p * (w_p - 1) // 2)
        new = wnew * mnew - wnew * (wnew - 1) // 2
        if wnew > always_width and (new - old) > tol * new:
            continue
        # merge gs into p: p's columns absorb gs's
        merged = np.union1d(structs[gs], structs[p])
        structs[p] = merged
        widths[p] = wnew
        alive[gs] = False
        group[gs] = p
        group[s] = p
        # boundaries rebuilt below from widths of alive groups
    keep = np.flatnonzero(alive)
    new_ptr = [0]
    new_rows_ptr = [0]
    chunks = []
    for s in keep:
        new_ptr.append(new_ptr[-1] + int(widths[s]))
        chunks.append(structs[s])
        new_rows_ptr.append(new_rows_ptr[-1] + structs[s].size)
    return (np.asarray(new_ptr, dtype=np.int64),
            np.asarray(new_rows_ptr, dtype=np.int64),
            np.concatenate(chunks) if chunks else np.zeros(0, np.int64))


def chol_symbolic(ptr: np.ndarray, ind: np.ndarray, n: int,
                  *, amalgamate: bool = True) -> SupernodalSymbolic:
    """Supernodal symbolic analysis of a POSTORDERED symmetric structure."""
    ptr = np.asarray(ptr, dtype=np.int64)
    ind = np.asarray(ind, dtype=np.int64)
    if n > NATIVE_ABOVE:
        parent, snode_ptr, rows_ptr, rows_idx = native.chol_symbolic(
            ptr, ind, n)
    else:
        parent, snode_ptr, rows_ptr, rows_idx = _chol_symbolic_py(
            ptr, ind, n)
    if amalgamate:
        snode_ptr, rows_ptr, rows_idx = _amalgamate(
            snode_ptr, rows_ptr, rows_idx, parent)

    nsn = snode_ptr.size - 1
    snode_of = np.empty(n + 1, dtype=np.int64)
    for s in range(nsn):
        snode_of[snode_ptr[s]:snode_ptr[s + 1]] = s
    snode_of[n] = -1
    last_col = snode_ptr[1:] - 1
    pcol = parent[last_col]
    sn_parent = np.where(pcol < 0, -1, snode_of[np.where(pcol < 0, n, pcol)])

    # level schedule of the assembly tree (leaves first)
    lev = np.zeros(nsn, dtype=np.int64)
    for s in range(nsn):  # children always precede parents (postorder)
        p = sn_parent[s]
        if p >= 0:
            lev[p] = max(lev[p], lev[s] + 1)
    n_lev = int(lev.max()) + 1 if nsn else 0
    levels = [np.flatnonzero(lev == l) for l in range(n_lev)]

    return SupernodalSymbolic(
        n=n, snode_ptr=snode_ptr, rows_ptr=rows_ptr, rows_idx=rows_idx,
        sn_parent=sn_parent, levels=levels)
