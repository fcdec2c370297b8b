"""Supernodal multifrontal Cholesky, the general-sparsity numeric phase
(counterpart of ``spalinalg_tpu/linalg/supernodal.py``).

The assembly tree is processed level by level, leaves first; within a
level, independent frontal matrices are padded to power-of-2 size classes
and each class factors as one batched dense partial Cholesky on the
device, with host-built index plans for the assembly of A's entries and
the children's extend-add (a gather and an ``index_add_`` per child
bucket). Frontal matrices use the lower-triangular convention throughout
(the strict upper triangle of a front or an update is never read).

Front layout per size class ``(nsp, mup)``: rows and columns ``[0, nsp)``
hold the (padded) supernode columns, rows ``[nsp, nsp + mup)`` the
(padded) rows below; padding never collides with real entries. The
symbolic phase (:mod:`.symbolic`) and this plan are built once per
structure, their index arrays uploaded once per device; a re-factor with
new values reuses them.

The JAX package compiles the whole numeric phase into one program; here
each bucket is a few launches (assembly, extend-adds, batched Cholesky,
triangular solve, Schur update). ``index_add_`` adds through atomics on
the card, and an extend-add of one child bucket repeats destinations, so
a factor is not bitwise repeatable there: two factors of one matrix agree
to rounding. A front that is not positive definite gives NaNs, and the
NaNs reach the root: no exception, as in the JAX package
(``SupernodalFactor.ok`` reads whether all fronts factored).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np
import torch

from .banded import _cholesky_nan
from .symbolic import SupernodalSymbolic

__all__ = ["SupernodalPlan", "build_supernodal_plan", "supernodal_factor",
           "supernodal_factor_sharded", "supernodal_solve",
           "SupernodalFactor"]


def _pad_class(x: int) -> int:
    if x <= 0:
        return 0
    p = 8
    while p < x:
        p *= 2
    return p


@dataclass(eq=False)
class _Bucket:
    """One (level, size-class) batch of supernodes."""

    sids: np.ndarray          # (B,) supernode ids
    nsp: int                  # padded #columns
    mup: int                  # padded #below-rows
    # A assembly: F.ravel()[a_dst] += A.values[a_src]
    a_dst: np.ndarray
    a_src: np.ndarray
    pad_diag: np.ndarray      # identity slots for padded diagonal columns
    # extend-add, grouped by source bucket: ((lvl, bkt), src, dst) flats
    ext: List[Tuple[Tuple[int, int], np.ndarray, np.ndarray]]
    # solve-phase index matrices (pad -> n sentinel)
    colg: np.ndarray          # (B, nsp) global col ids
    rowg: np.ndarray          # (B, mup) global below-row ids

    @property
    def mp(self) -> int:
        return self.nsp + self.mup


@dataclass(eq=False)
class SupernodalPlan:
    """Host index plans of the numeric phase, for one structure; their
    device copies are made once per device (:meth:`tables`)."""

    n: int
    sym: SupernodalSymbolic
    levels: List[List[_Bucket]]   # per level, list of buckets
    l_nnz: int
    # (level, bucket) -> the buckets whose Schur updates it extend-adds
    # last, freed once it has; a bucket no one reads keeps no update
    last_reads: Dict[Tuple[int, int], List[Tuple[int, int]]] = field(
        default_factory=dict, repr=False)
    _tables: Dict[torch.device, list] = field(default_factory=dict,
                                              repr=False)

    def tables(self, device) -> list:
        """Per level, per bucket, the plan's index arrays as int64 tensors
        on ``device`` (``_BucketTables``), uploaded on the first call."""
        device = torch.device(device)
        if device not in self._tables:
            def up(a):
                return torch.as_tensor(np.asarray(a, dtype=np.int64),
                                       device=device)

            self._tables[device] = [
                [_BucketTables(
                    a_dst=up(bk.a_dst), a_src=up(bk.a_src),
                    pad_diag=up(bk.pad_diag),
                    ext=[(key, up(s), up(d)) for key, s, d in bk.ext],
                    colg=up(bk.colg), rowg=up(bk.rowg))
                 for bk in buckets]
                for buckets in self.levels]
        return self._tables[device]

    def flops(self) -> int:
        """Operations of the numeric phase, counted from the padded front
        shapes: ``B·(ns³/3 + ns²·mu + ns·mu²)`` a bucket."""
        return int(sum(
            bk.sids.size * (bk.nsp ** 3 / 3 + bk.nsp ** 2 * bk.mup
                            + bk.nsp * bk.mup ** 2)
            for buckets in self.levels for bk in buckets))


@dataclass(eq=False)
class _BucketTables:
    a_dst: torch.Tensor
    a_src: torch.Tensor
    pad_diag: torch.Tensor
    ext: list
    colg: torch.Tensor
    rowg: torch.Tensor


@dataclass(eq=False)
class SupernodalFactor:
    plan: SupernodalPlan
    panels: Dict[Tuple[int, int], torch.Tensor]  # (level, bucket) -> (B, mp, nsp)
    dtype: torch.dtype
    info: torch.Tensor   # per front, nonzero where it was not positive definite

    @property
    def ok(self) -> bool:
        """Whether every front was positive definite (reads back)."""
        return not bool(self.info.any())


def build_supernodal_plan(sym: SupernodalSymbolic, ptr: np.ndarray,
                          ind: np.ndarray) -> SupernodalPlan:
    """Host index plans for the batched numeric phase.

    ``ptr``/``ind`` is the full symmetric (postordered) CSR structure the
    symbolic phase ran on; value indices in the plan refer to entries of
    that matrix's value array (lower triangle used).
    """
    n = sym.n
    nsn = sym.nsn
    sp, rp, ri = sym.snode_ptr, sym.rows_ptr, sym.rows_idx
    snode_of = sym.snode_of_col()
    width = np.diff(sp)
    msz = np.diff(rp)

    # bucket assignment: class = (pad(ns), pad(m - ns)) per level
    slot: Dict[int, Tuple[int, int, int]] = {}
    shape_levels: List[List[Tuple[int, int, np.ndarray]]] = []
    for l, sids in enumerate(sym.levels):
        classes: Dict[Tuple[int, int], List[int]] = {}
        for s in sids:
            key = (_pad_class(int(width[s])),
                   _pad_class(int(msz[s] - width[s])))
            classes.setdefault(key, []).append(int(s))
        lvl = []
        for (nsp, mup), ss in sorted(classes.items()):
            bi = len(lvl)
            for b, s in enumerate(ss):
                slot[s] = (l, bi, b)
            lvl.append((nsp, mup, np.asarray(ss, dtype=np.int64)))
        shape_levels.append(lvl)

    # A lower-triangle entries grouped by owning snode (by column)
    ptr = np.asarray(ptr, dtype=np.int64)
    ind = np.asarray(ind, dtype=np.int64)
    rows_of_entry = np.repeat(np.arange(n, dtype=np.int64), np.diff(ptr))
    lower = rows_of_entry >= ind
    e_i = rows_of_entry[lower]
    e_j = ind[lower]
    e_v = np.flatnonzero(lower)   # value index into A.values
    e_s = snode_of[e_j]
    order = np.argsort(e_s, kind="stable")
    e_i, e_j, e_v, e_s = e_i[order], e_j[order], e_v[order], e_s[order]
    sbounds = np.searchsorted(e_s, np.arange(nsn + 1))

    def local_row(pos, ns_s, nsp):
        """struct position -> front row (cols at [0,ns); below at nsp+)."""
        return np.where(pos < ns_s, pos, pos - ns_s + nsp)

    out_levels: List[List[_Bucket]] = []
    children_of: Dict[int, List[int]] = {}
    for c in range(nsn):
        p = int(sym.sn_parent[c])
        if p >= 0:
            children_of.setdefault(p, []).append(c)

    for l, lvl in enumerate(shape_levels):
        buckets: List[_Bucket] = []
        for nsp, mup, ss in lvl:
            B = ss.size
            mp = nsp + mup
            a_dst, a_src, pad_diag = [], [], []
            colg = np.full((B, max(nsp, 1)), n, dtype=np.int64)
            rowg = np.full((B, max(mup, 1)), n, dtype=np.int64)
            ext: Dict[Tuple[int, int], Tuple[list, list]] = {}
            for b, s in enumerate(ss):
                c0, c1 = int(sp[s]), int(sp[s + 1])
                ns_s = c1 - c0
                struct = ri[rp[s]:rp[s + 1]]
                m_s = struct.size
                colg[b, :ns_s] = np.arange(c0, c1)
                below = struct[ns_s:]
                rowg[b, : m_s - ns_s] = below
                # A entries of this snode's columns
                lo, hi = sbounds[s], sbounds[s + 1]
                ii, jj, vv = e_i[lo:hi], e_j[lo:hi], e_v[lo:hi]
                r_loc = local_row(np.searchsorted(struct, ii), ns_s, nsp)
                c_loc = jj - c0
                a_dst.append((b * mp + r_loc) * mp + c_loc)
                a_src.append(vv)
                pd = np.arange(ns_s, nsp, dtype=np.int64)
                pad_diag.append((b * mp + pd) * mp + pd)
                # extend-add from children
                for c in children_of.get(int(s), ()):
                    lc, bc, slot_c = slot[c]
                    cb = out_levels[lc][bc]
                    cs = ri[rp[c]:rp[c + 1]]
                    rows_c = cs[int(width[c]):]
                    mu_c = rows_c.size
                    if mu_c == 0:
                        continue
                    pos = local_row(np.searchsorted(struct, rows_c),
                                    ns_s, nsp)
                    mup_c = cb.mup
                    li, lj = np.tril_indices(mu_c)
                    src = (slot_c * mup_c + li) * mup_c + lj
                    dst = (b * mp + pos[li]) * mp + pos[lj]
                    sl, dl = ext.setdefault((lc, bc), ([], []))
                    sl.append(src)
                    dl.append(dst)
            ext_list = [
                (key, np.concatenate(sl).astype(np.int64),
                 np.concatenate(dl).astype(np.int64))
                for key, (sl, dl) in ext.items()
            ]
            buckets.append(_Bucket(
                sids=ss, nsp=nsp, mup=mup,
                a_dst=(np.concatenate(a_dst) if a_dst
                       else np.zeros(0, np.int64)),
                a_src=(np.concatenate(a_src) if a_src
                       else np.zeros(0, np.int64)),
                pad_diag=(np.concatenate(pad_diag) if pad_diag
                          else np.zeros(0, np.int64)),
                ext=ext_list, colg=colg, rowg=rowg,
            ))
        out_levels.append(buckets)
    return SupernodalPlan(n=n, sym=sym, levels=out_levels,
                          l_nnz=sym.l_nnz, last_reads=_last_reads(out_levels))


def _last_reads(levels) -> Dict[Tuple[int, int], List[Tuple[int, int]]]:
    """For each (level, bucket), the buckets whose Schur updates it is the
    last to extend-add (the numeric phase frees them after it)."""
    last_reader: Dict[Tuple[int, int], Tuple[int, int]] = {}
    for l, buckets in enumerate(levels):
        for bi, bk in enumerate(buckets):
            for key, _, _ in bk.ext:
                last_reader[key] = (l, bi)
    last_reads: Dict[Tuple[int, int], List[Tuple[int, int]]] = {}
    for key, reader in last_reader.items():
        last_reads.setdefault(reader, []).append(key)
    return last_reads


def _factor_bucket(F: torch.Tensor, B: int, nsp: int, mup: int):
    """Batched partial Cholesky of ``B`` fronts: ``(panel, update, info)``;
    the Cholesky reads the lower triangle of the diagonal blocks."""
    mp = nsp + mup
    F = F.view(B, mp, mp)
    L, info = _cholesky_nan(F[:, :nsp, :nsp])
    if not mup:
        return L, F.new_zeros((B, 0, 0)), info
    L21 = torch.linalg.solve_triangular(L.mT, F[:, nsp:, :nsp], upper=True,
                                        left=False)
    U = F[:, nsp:, nsp:] - L21 @ L21.mT
    return torch.cat([L, L21], dim=1), U, info


def _factor_levels(plan: SupernodalPlan, values: torch.Tensor, mesh=None,
                   axis: str = None) -> SupernodalFactor:
    """The bucket loop of both factorizations. With a ``mesh``, a bucket
    whose front count divides by the mesh size is split on its batch
    dimension and its panels, status and read updates all-gathered."""
    nd, rank = 1, 0
    if mesh is not None:
        from ..parallel.partition import gather_rows

        nd = mesh.size() if axis is None else mesh.size(
            mesh.mesh_dim_names.index(axis))
        rank = mesh.get_local_rank()
    tables = plan.tables(values.device)
    panels: Dict[Tuple[int, int], torch.Tensor] = {}
    updates: Dict[Tuple[int, int], torch.Tensor] = {}
    read = {key for keys in plan.last_reads.values() for key in keys}
    infos = []
    with torch.no_grad():
        for l, buckets in enumerate(plan.levels):
            for bi, bk in enumerate(buckets):
                t = tables[l][bi]
                B, mp = bk.sids.size, bk.mp
                F = values.new_zeros(B * mp * mp)
                F.index_add_(0, t.a_dst, values[t.a_src])
                F.index_fill_(0, t.pad_diag, 1.0)
                for (lc, bc), src, dst in t.ext:
                    F.index_add_(0, dst, updates[lc, bc].reshape(-1)[src])
                for key in plan.last_reads.get((l, bi), ()):
                    del updates[key]
                if mesh is not None and B % nd == 0:
                    mine = B // nd
                    F = F.view(B, mp * mp)[rank * mine:(rank + 1) * mine]
                    panel, update, info = _factor_bucket(
                        F.reshape(-1), mine, bk.nsp, bk.mup)
                    panel = gather_rows(panel, mesh)
                    info = gather_rows(info, mesh)
                    if (l, bi) in read:
                        update = gather_rows(update, mesh)
                else:
                    panel, update, info = _factor_bucket(
                        F, B, bk.nsp, bk.mup)
                panels[l, bi] = panel
                if (l, bi) in read:
                    updates[l, bi] = update
                infos.append(info)
    return SupernodalFactor(plan=plan, panels=panels, dtype=values.dtype,
                            info=torch.cat(infos) if infos
                            else values.new_zeros(0, dtype=torch.int32))


def supernodal_factor(plan: SupernodalPlan, values: torch.Tensor
                      ) -> SupernodalFactor:
    """Numeric factorization: a batched partial Cholesky per level bucket,
    on ``values``' device. ``values`` is the (postordered) matrix's CSR
    value array; only its lower-triangle entries are read (through the
    plan's ``a_src``). A bucket's Schur update lives until its last
    extend-add."""
    return _factor_levels(plan, values)


def supernodal_factor_sharded(plan: SupernodalPlan, values: torch.Tensor,
                              mesh, axis: str = None) -> SupernodalFactor:
    """Numeric factorization spread over the ranks of a row mesh
    (:func:`~spalinalg_tpu_torch.parallel.make_row_mesh`); every rank
    passes the same ``values``.

    A bucket whose front count ``B`` divides by the mesh size is split on
    its batch dimension: each rank factors ``B / P`` fronts, and the
    panels and Schur updates (and the fronts' status) are all-gathered
    before the next bucket, so every child's update is whole for the
    extend-add. Smaller buckets (the top of the tree, where the work is
    sequential) are factored on every rank. The returned factor is whole
    on every rank, so :func:`supernodal_solve` works unchanged. Updates
    are freed after their last extend-add, as in
    :func:`supernodal_factor`; an update no bucket reads is not gathered.
    """
    return _factor_levels(plan, values, mesh, axis)


def supernodal_solve(fac: SupernodalFactor, b, perm=None) -> torch.Tensor:
    """Solve ``A x = b`` in postordered coordinates, or in the original
    ones when the factor's fill-reducing ``perm`` is passed: a forward
    sweep over the buckets, leaves first, then a backward one."""
    plan = fac.plan
    n = plan.n
    some = next(iter(fac.panels.values()))
    dev = some.device
    tables = plan.tables(dev)
    b = torch.as_tensor(b, device=dev)
    with torch.no_grad():
        if perm is not None:
            perm = torch.as_tensor(np.asarray(perm, dtype=np.int64),
                                   device=dev)
            b = b[perm]
        w = torch.zeros(n + 1, dtype=fac.dtype, device=dev)
        w[:n] = b
        for l, buckets in enumerate(plan.levels):
            for bi, bk in enumerate(buckets):
                t, panel = tables[l][bi], fac.panels[l, bi]
                y1 = torch.linalg.solve_triangular(
                    panel[:, :bk.nsp], w[t.colg].unsqueeze(-1), upper=False)
                w[t.colg] = y1.squeeze(-1)
                if bk.mup:
                    upd = panel[:, bk.nsp:] @ y1
                    w.index_add_(0, t.rowg.reshape(-1), -upd.reshape(-1))
        for l in range(len(plan.levels) - 1, -1, -1):
            for bi, bk in enumerate(plan.levels[l]):
                t, panel = tables[l][bi], fac.panels[l, bi]
                rhs = w[t.colg].unsqueeze(-1)
                if bk.mup:
                    rhs = rhs - panel[:, bk.nsp:].mT @ w[t.rowg].unsqueeze(-1)
                x1 = torch.linalg.solve_triangular(
                    panel[:, :bk.nsp].mT, rhs, upper=True)
                w[t.colg] = x1.squeeze(-1)
        x = w[:n]
        if perm is not None:
            x = torch.empty_like(x).index_copy_(0, perm, x)
    return x
