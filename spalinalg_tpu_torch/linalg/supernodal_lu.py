"""Supernodal multifrontal sparse LU for general (unsymmetric) matrices
(counterpart of ``spalinalg_tpu/linalg/supernodal_lu.py``).

The unsymmetric sibling of :mod:`.supernodal`:

- **Structure**: the symbolic analysis runs on the symmetrized structure
  ``struct(A + Aᵀ)`` (values untouched), so the Cholesky machinery (AMD,
  elimination tree, postorder, relaxed supernodes, the assembly tree's
  levels, :mod:`.symbolic`) is reused as it is. Entries of A are
  scattered onto that pattern; missing slots hold explicit zeros.
- **Fronts**: full ``mp x mp`` frontal matrices (rows and columns both
  indexed by the supernode's row structure), carrying the L panel
  ``[L11; L21]`` and the U panel ``[U11, U12]`` together.
- **Pivoting**: restricted partial pivoting, row swaps only inside each
  diagonal block ``F11`` (``torch.linalg.lu_factor_ex`` on the batch of a
  size class); the global row order is block diagonal over supernodes,
  fixed by the elimination order. ``perturb`` lifts tiny pivots to
  ``sqrt(eps)·max|A|`` (SuperLU-DIST's static stance); pair it with
  iterative refinement (:func:`~.lu.lu_solve`).
- **Schur update**: ``F22 - L21 @ U12``, a full ``mu x mu`` extend-add into
  the parent front.

As in :mod:`.supernodal`, the plan is built on the host once per
structure and its index arrays uploaded once per device; each bucket of a
level is then a few launches: the ``index_add_`` assembly and extend-adds,
one batched LU, two batched triangular solves and the Schur product. The
JAX package compiles the sweep into one program. ``index_add_`` adds
through atomics on the card and an extend-add repeats destinations, so
two factors of the same values are not bitwise equal there: they agree to
rounding. The JAX package's ``_batched_pivoted_lu`` works around XLA's
f32-only LU on the TPU and has no counterpart here: torch's batched LU
takes float32 and float64 on the card.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np
import torch

from .supernodal import _last_reads, _pad_class
from .symbolic import SupernodalSymbolic

__all__ = ["SupernodalLuPlan", "build_supernodal_lu_plan",
           "supernodal_lu_factor", "supernodal_lu_solve",
           "SupernodalLuFactor", "symmetrize_structure",
           "map_values_to_structure"]


def symmetrize_structure(ptr: np.ndarray, ind: np.ndarray, n: int
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """CSR structure of ``A + Aᵀ`` (host; values untouched)."""
    ptr = np.asarray(ptr, dtype=np.int64)
    ind = np.asarray(ind, dtype=np.int64)
    nnz = int(ptr[-1])
    ind = ind[:nnz]
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(ptr))
    keys = np.unique(np.concatenate([rows * n + ind, ind * n + rows]))
    s_rows = keys // n
    s_cols = keys % n
    s_ptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(s_ptr, s_rows + 1, 1)
    np.cumsum(s_ptr, out=s_ptr)
    return s_ptr, s_cols


def map_values_to_structure(ptr, ind, s_ptr, s_ind, n) -> np.ndarray:
    """Position of each entry of (ptr, ind) inside the superset
    structure (s_ptr, s_ind); both must have sorted column indices."""
    ptr = np.asarray(ptr, dtype=np.int64)
    ind = np.asarray(ind, dtype=np.int64)[: int(ptr[-1])]
    s_ind = np.asarray(s_ind, dtype=np.int64)
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(ptr))
    s_rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(s_ptr))
    keys_s = s_rows * n + s_ind
    keys_a = rows * n + ind
    pos = np.searchsorted(keys_s, keys_a)
    if np.any(pos >= keys_s.size) or not np.array_equal(keys_s[pos], keys_a):
        raise ValueError("structure is not a superset of the operand")
    return pos


@dataclass(eq=False)
class _LuBucket:
    """One (level, size-class) batch of supernodal LU fronts."""

    sids: np.ndarray
    nsp: int
    mup: int
    # A assembly into full fronts: F.ravel()[a_dst] += vals[a_src]
    a_dst: np.ndarray
    a_src: np.ndarray
    pad_diag: np.ndarray
    # extend-add of full child Schur blocks, grouped by source bucket
    ext: List[Tuple[Tuple[int, int], np.ndarray, np.ndarray]]
    colg: np.ndarray          # (B, nsp) global col ids (pad -> n)
    rowg: np.ndarray          # (B, mup) global below-row ids (pad -> n)

    @property
    def mp(self) -> int:
        return self.nsp + self.mup


@dataclass(eq=False)
class _LuTables:
    a_dst: torch.Tensor
    a_src: torch.Tensor
    pad_diag: torch.Tensor
    ext: list
    colg: torch.Tensor
    rowg: torch.Tensor
    real: torch.Tensor        # (B, nsp): a column of A, not padding


@dataclass(eq=False)
class SupernodalLuPlan:
    """Host index plans of the LU numeric phase, for one structure; their
    device copies are made once per device (:meth:`tables`)."""

    n: int
    sym: SupernodalSymbolic
    levels: List[List[_LuBucket]]
    lu_nnz: int               # stored L+U entries (panel area, no padding)
    # (level, bucket) -> the buckets whose Schur updates it extend-adds
    # last, freed once it has; a bucket no one reads keeps no update
    last_reads: Dict[Tuple[int, int], List[Tuple[int, int]]] = field(
        default_factory=dict, repr=False)
    _tables: Dict[torch.device, list] = field(default_factory=dict,
                                              repr=False)

    def tables(self, device) -> list:
        """Per level, per bucket, the plan's index arrays as tensors on
        ``device`` (``_LuTables``), uploaded on the first call."""
        device = torch.device(device)
        if device not in self._tables:
            def up(a):
                return torch.as_tensor(np.asarray(a, dtype=np.int64),
                                       device=device)

            self._tables[device] = [
                [_LuTables(
                    a_dst=up(bk.a_dst), a_src=up(bk.a_src),
                    pad_diag=up(bk.pad_diag),
                    ext=[(key, up(s), up(d)) for key, s, d in bk.ext],
                    colg=up(bk.colg), rowg=up(bk.rowg),
                    real=torch.as_tensor(bk.colg[:, :bk.nsp] < self.n,
                                         device=device))
                 for bk in buckets]
                for buckets in self.levels]
        return self._tables[device]

    def flops(self) -> int:
        """Operations of the numeric phase, counted from the padded front
        shapes: ``B·(2/3·ns³ + 2·ns²·mu + 2·ns·mu²)`` a bucket (LU of the
        diagonal block, the two panel solves, the Schur product)."""
        return int(sum(
            bk.sids.size * (2 * bk.nsp ** 3 / 3 + 2 * bk.nsp ** 2 * bk.mup
                            + 2 * bk.nsp * bk.mup ** 2)
            for buckets in self.levels for bk in buckets))


@dataclass(eq=False)
class SupernodalLuFactor:
    plan: SupernodalLuPlan
    # per (level, bucket): combined LU of F11 (B,nsp,nsp), local row
    # permutation (B,nsp), L21 (B,mup,nsp), U12 (B,nsp,mup)
    lu11: Dict[Tuple[int, int], torch.Tensor]
    perm11: Dict[Tuple[int, int], torch.Tensor]
    l21: Dict[Tuple[int, int], torch.Tensor]
    u12: Dict[Tuple[int, int], torch.Tensor]
    dtype: torch.dtype


def build_supernodal_lu_plan(sym: SupernodalSymbolic, ptr: np.ndarray,
                             ind: np.ndarray) -> SupernodalLuPlan:
    """Host index plans for the batched LU numeric phase.

    ``ptr``/``ind`` is the full symmetrized (postordered) structure the
    symbolic phase ran on; ``a_src`` indexes that matrix's value array
    (both triangles are assembled, unlike the Cholesky plan)."""
    n = sym.n
    nsn = sym.nsn
    sp, rp, ri = sym.snode_ptr, sym.rows_ptr, sym.rows_idx
    snode_of = sym.snode_of_col()
    width = np.diff(sp)
    msz = np.diff(rp)

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

    # Every entry (i, j) of the symmetrized structure belongs to the
    # front of snode_of[min(i, j)]: both i and j are then in that
    # supernode's row structure (struct is the L-column pattern; the
    # U-row pattern equals it by structural symmetry).
    ptr = np.asarray(ptr, dtype=np.int64)
    ind = np.asarray(ind, dtype=np.int64)
    e_i = np.repeat(np.arange(n, dtype=np.int64), np.diff(ptr))
    e_j = ind[: int(ptr[-1])]
    e_v = np.arange(e_j.size, dtype=np.int64)
    e_s = snode_of[np.minimum(e_i, e_j)]
    order = np.argsort(e_s, kind="stable")
    e_i, e_j, e_v, e_s = e_i[order], e_j[order], e_v[order], e_s[order]
    sbounds = np.searchsorted(e_s, np.arange(nsn + 1))

    def local(pos, ns_s, nsp):
        """struct position -> front index (cols at [0,ns); below at nsp+)."""
        return np.where(pos < ns_s, pos, pos - ns_s + nsp)

    out_levels: List[List[_LuBucket]] = []
    children_of: Dict[int, List[int]] = {}
    for c in range(nsn):
        p = int(sym.sn_parent[c])
        if p >= 0:
            children_of.setdefault(p, []).append(c)

    lu_nnz = 0
    for l, lvl in enumerate(shape_levels):
        buckets: List[_LuBucket] = []
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
                lu_nnz += ns_s * m_s * 2 - ns_s * ns_s
                lo, hi = sbounds[s], sbounds[s + 1]
                ii, jj, vv = e_i[lo:hi], e_j[lo:hi], e_v[lo:hi]
                r_loc = local(np.searchsorted(struct, ii), ns_s, nsp)
                c_loc = local(np.searchsorted(struct, jj), ns_s, nsp)
                a_dst.append((b * mp + r_loc) * mp + c_loc)
                a_src.append(vv)
                pd = np.arange(ns_s, nsp, dtype=np.int64)
                pad_diag.append((b * mp + pd) * mp + pd)
                for c in children_of.get(int(s), ()):
                    lc, bc, slot_c = slot[c]
                    cb = out_levels[lc][bc]
                    cs = ri[rp[c]:rp[c + 1]]
                    rows_c = cs[int(width[c]):]
                    mu_c = rows_c.size
                    if mu_c == 0:
                        continue
                    pos = local(np.searchsorted(struct, rows_c), ns_s, nsp)
                    mup_c = cb.mup
                    li = np.repeat(np.arange(mu_c), mu_c)
                    lj = np.tile(np.arange(mu_c), mu_c)
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
            buckets.append(_LuBucket(
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
    return SupernodalLuPlan(n=n, sym=sym, levels=out_levels, lu_nnz=lu_nnz,
                            last_reads=_last_reads(out_levels))


def _row_order(lu: torch.Tensor, pivots: torch.Tensor) -> torch.Tensor:
    """LAPACK's 1-based sequence of row swaps as the row order ``perm``
    with ``F11[perm] = L·U`` (the JAX ``lu``'s third result), on the
    device: ``P`` of ``F11 = P·L·U`` holds its 1 of column ``c`` in row
    ``perm[c]``."""
    P, _, _ = torch.lu_unpack(lu, pivots, unpack_data=False)
    return P.argmax(dim=-2)


def _lu_factor_bucket(F, scale, real, *, B: int, nsp: int, mup: int,
                      perturb: bool):
    """Batched restricted-pivoting LU of ``B`` fronts: ``(lu11, perm,
    L21, U12, schur)``."""
    mp = nsp + mup
    F = F.view(B, mp, mp)
    F11 = F[:, :nsp, :nsp]
    if perturb:
        # Static pivoting safeguard: lift tiny diagonals to
        # sqrt(eps)·scale. ``scale`` is the OPERAND's max |value| (the
        # block's max would include the 1.0 pad diagonals and make the
        # threshold absolute, corrupting small-magnitude matrices), and
        # ``real`` keeps the pad diagonals out of the lift.
        eps = float(np.sqrt(torch.finfo(F.dtype).eps))
        d = torch.diagonal(F11, dim1=1, dim2=2)
        sgn = torch.where(d < 0, -1.0, 1.0).to(F.dtype)
        lift = torch.where(real & (d.abs() < eps * scale),
                           eps * scale * sgn, 0.0)
        F11 = F11 + torch.diag_embed(lift)
    lu11, pivots, _ = torch.linalg.lu_factor_ex(F11)
    perm = _row_order(lu11, pivots)
    if not mup:
        return (lu11, perm, F.new_zeros((B, 0, nsp)),
                F.new_zeros((B, nsp, 0)), F.new_zeros((B, 0, 0)))
    F12p = torch.gather(F[:, :nsp, nsp:], 1,
                        perm.unsqueeze(-1).expand(B, nsp, mup))
    U12 = torch.linalg.solve_triangular(lu11, F12p, upper=False,
                                        unitriangular=True)
    L21 = torch.linalg.solve_triangular(lu11, F[:, nsp:, :nsp], upper=True,
                                        left=False)
    schur = F[:, nsp:, nsp:] - L21 @ U12
    return lu11, perm, L21, U12, schur


def supernodal_lu_factor(plan: SupernodalLuPlan, values: torch.Tensor,
                         *, perturb: bool = False) -> SupernodalLuFactor:
    """Numeric LU: a batched restricted-pivoting dense LU per level bucket,
    on ``values``' device.

    ``values`` is the value array of the postordered symmetrized matrix
    (entries absent from A hold zero; :func:`map_values_to_structure`).
    A bucket's Schur update lives until its last extend-add."""
    tables = plan.tables(values.device)
    lu11: Dict[Tuple[int, int], torch.Tensor] = {}
    perm11: Dict[Tuple[int, int], torch.Tensor] = {}
    l21: Dict[Tuple[int, int], torch.Tensor] = {}
    u12: Dict[Tuple[int, int], torch.Tensor] = {}
    updates: Dict[Tuple[int, int], torch.Tensor] = {}
    read = {key for keys in plan.last_reads.values() for key in keys}
    with torch.no_grad():
        scale = values.abs().max() if values.numel() else values.new_zeros(())
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
                (lu11[l, bi], perm11[l, bi], l21[l, bi], u12[l, bi],
                 schur) = _lu_factor_bucket(F, scale, t.real, B=B,
                                            nsp=bk.nsp, mup=bk.mup,
                                            perturb=perturb)
                if (l, bi) in read:
                    updates[l, bi] = schur
    return SupernodalLuFactor(plan=plan, lu11=lu11, perm11=perm11, l21=l21,
                              u12=u12, dtype=values.dtype)


def supernodal_lu_solve(fac: SupernodalLuFactor, b, perm=None
                        ) -> torch.Tensor:
    """Solve ``A x = b`` in postordered coordinates, or in the original
    ones when the factorization's row/col ``perm`` is passed: forward by
    levels (the local row pivot applied to ``w[colg]``), backward in
    reverse order, on the factor's device."""
    plan = fac.plan
    n = plan.n
    dev = next(iter(fac.lu11.values())).device
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
                t = tables[l][bi]
                b1 = torch.gather(w[t.colg], 1, fac.perm11[l, bi])
                y1 = torch.linalg.solve_triangular(
                    fac.lu11[l, bi], b1.unsqueeze(-1), upper=False,
                    unitriangular=True)
                w[t.colg] = y1.squeeze(-1)
                if bk.mup:
                    upd = fac.l21[l, bi] @ y1
                    w.index_add_(0, t.rowg.reshape(-1), -upd.reshape(-1))
        for l in range(len(plan.levels) - 1, -1, -1):
            for bi, bk in enumerate(plan.levels[l]):
                t = tables[l][bi]
                rhs = w[t.colg].unsqueeze(-1)
                if bk.mup:
                    rhs = rhs - fac.u12[l, bi] @ w[t.rowg].unsqueeze(-1)
                x1 = torch.linalg.solve_triangular(fac.lu11[l, bi], rhs,
                                                   upper=True)
                w[t.colg] = x1.squeeze(-1)
        x = w[:n]
        if perm is not None:
            x = torch.empty_like(x).index_copy_(0, perm, x)
    return x
