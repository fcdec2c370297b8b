"""Sparse triangular solves (counterpart of
``spalinalg_tpu/linalg/triangular.py``).

Level-scheduled: the rows are grouped into dependency levels on the host
(``ordering.level_schedule``), and the rows of one level solve together on
the matrix's device. The solution is built in level order, so a level
writes one contiguous slice, and one gather restores row order at the
end. A level costs a handful of launches (two gathers, a product, a
segment sum, a subtraction, a division and the slice write), so a
structure deeper than ``MAX_DEVICE_LEVELS`` levels is solved by a row
sweep on the host instead, as in the JAX package.

Examples
--------
>>> import torch
>>> from spalinalg_tpu_torch import CsrMatrix
>>> L = CsrMatrix(3, 3, [0, 1, 3, 5], [0, 0, 1, 1, 2],
...               [2.0, 1.0, 2.0, 1.0, 2.0], device="cpu")
>>> solve_triangular_csr(L, torch.tensor([2.0, 5.0, 6.0],
...                                      dtype=torch.float64)).tolist()
[1.0, 2.0, 2.0]
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from ..errors import StructureError
from ..ops.reduction import segment_sum
from .ordering import level_schedule

__all__ = ["TriangularPlan", "plan_triangular", "solve_triangular_csr"]

MAX_DEVICE_LEVELS = 256


@dataclass(frozen=True, eq=False)
class TriangularPlan:
    """Host-built level schedule and gather layout of one triangular
    structure, with its index tensors on the matrix's device."""

    lower: bool
    unit_diag: bool
    n: int
    order: np.ndarray            # rows in level order
    bounds: np.ndarray           # (n_levels + 1,) level boundaries in order
    n_levels: int
    order_dev: torch.Tensor      # ``order`` on the device
    iperm_dev: torch.Tensor      # position of each row in level order
    diag_dev: torch.Tensor       # diagonal values in level order
    # per level: (entry ids, their columns' positions in level order,
    # their rows' positions within the level)
    levels: Tuple[Tuple[torch.Tensor, torch.Tensor, torch.Tensor], ...]

    @property
    def use_device(self) -> bool:
        return self.n_levels <= MAX_DEVICE_LEVELS


def plan_triangular(csr, *, lower: bool, unit_diag: bool = False
                    ) -> TriangularPlan:
    """Analyse a triangular CSR matrix once (host symbolic phase). Raises
    :class:`StructureError` on a zero or missing diagonal entry unless
    ``unit_diag``."""
    n = csr.nrows
    ptr, ind, val = csr._host_arrays()
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(ptr))
    bounds, order = level_schedule(ptr, ind, n, lower=lower)
    iperm = np.empty(n, dtype=np.int64)
    iperm[order] = np.arange(n)

    diag_mask = ind == rows
    diag = np.zeros(n, dtype=val.dtype)
    diag[rows[diag_mask]] = val[diag_mask]
    if unit_diag:
        diag[:] = 1.0
    elif np.any(diag == 0):
        raise StructureError(
            "triangular matrix has a zero/missing diagonal entry")

    dev = csr.device
    n_levels = bounds.size - 1
    levels = []
    if n_levels <= MAX_DEVICE_LEVELS:
        # off-diagonal entries ordered by their row's level-order position
        off = np.flatnonzero(ind < rows if lower else ind > rows)
        e_all = off[np.argsort(iperm[rows[off]], kind="stable")]
        pos_all = iperm[rows[e_all]]
        cuts = np.searchsorted(pos_all, bounds)
        for lv in range(n_levels):
            e_idx = e_all[cuts[lv]: cuts[lv + 1]]
            levels.append(tuple(
                torch.as_tensor(a, device=dev) for a in
                (e_idx, iperm[ind[e_idx]],
                 pos_all[cuts[lv]: cuts[lv + 1]] - bounds[lv])))

    return TriangularPlan(
        lower=lower, unit_diag=unit_diag, n=n, order=order, bounds=bounds,
        n_levels=n_levels, order_dev=torch.as_tensor(order, device=dev),
        iperm_dev=torch.as_tensor(iperm, device=dev),
        diag_dev=torch.as_tensor(diag[order], device=dev),
        levels=tuple(levels))


def _solve_device(plan: TriangularPlan, values: torch.Tensor,
                  b: torch.Tensor) -> torch.Tensor:
    b_ord = b[plan.order_dev]
    x_ord = torch.zeros_like(b_ord)
    for lv, (e_idx, col_pos, seg) in enumerate(plan.levels):
        lo, hi = int(plan.bounds[lv]), int(plan.bounds[lv + 1])
        rhs = b_ord[lo:hi]
        if e_idx.numel():
            rhs = rhs - segment_sum(values[e_idx] * x_ord[col_pos], seg,
                                    hi - lo)
        x_ord[lo:hi] = rhs / plan.diag_dev[lo:hi]
    return x_ord[plan.iperm_dev]


def _solve_host(plan: TriangularPlan, csr, b: torch.Tensor) -> torch.Tensor:
    ptr, ind, val = csr._host_arrays()
    bh = b.cpu().numpy()
    x = np.zeros(plan.n, dtype=np.result_type(val.dtype, bh.dtype))
    for i in (range(plan.n) if plan.lower else range(plan.n - 1, -1, -1)):
        s = bh[i]
        d = 1.0 if plan.unit_diag else None
        for k in range(int(ptr[i]), int(ptr[i + 1])):
            j = int(ind[k])
            if j == i:
                d = val[k] if not plan.unit_diag else 1.0
            elif (j < i) if plan.lower else (j > i):
                s -= val[k] * x[j]
        x[i] = s / d
    return torch.as_tensor(x, device=b.device)


def solve_triangular_csr(csr, b, *, lower: bool = True,
                         unit_diag: bool = False,
                         plan: TriangularPlan = None) -> torch.Tensor:
    """Solve ``L x = b`` (or ``U x = b``) for a sparse triangular CSR
    matrix. ``b`` (a tensor on the matrix's device, or a NumPy array,
    placed there) may carry a ``plan`` of the same structure, which
    amortises the symbolic phase over many solves."""
    if plan is None:
        plan = plan_triangular(csr, lower=lower, unit_diag=unit_diag)
    b = torch.as_tensor(b, device=csr.device)
    with torch.no_grad():
        if plan.use_device:
            return _solve_device(plan, csr.values, b)
        return _solve_host(plan, csr, b)
