"""SpGEMM numeric phase: the Hopper kernel's wrapper, its plain torch
version, its launch counts, and the gradient.

The kernel (``spalinalg_tpu_torch/csrc/spgemm_numeric.cu``) replaces the
Pallas kernel of the JAX package's SpGEMM numeric phase,
``spalinalg_tpu/ops/kernels/pair_route.py::_pair_kernel`` (B3). It computes

    out[g] = Σ_{t : gid[t] = g} a[a_idx[t]] · b[b_idx[t]]

in float32 and float64 by walking the plan's slot-sorted term list
(``tptr``, ``a_idx``, ``b_idx``), a warp 32 slots.

:func:`spgemm_numeric` is the wrapper. For CUDA tensors it launches the
kernel or raises; for CPU tensors it runs :func:`spgemm_numeric_plain` on
the term list. :class:`SpgemmNumeric` carries the gradient that
``jax.grad`` gives through ``spalinalg_tpu/ops/spgemm.py::_spgemm_numeric``,
in plain torch (a gather and an ``index_add_`` per operand), as it is XLA
code in the JAX package.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from ...dtypes import INDEX_DTYPE, acc_dtype, result_dtype
from ...errors import DTypeError, ShapeError

__all__ = ["LAUNCHES", "SpgemmNumeric", "spgemm_numeric",
           "spgemm_numeric_plain"]

# Kernel launches per instantiation: plain integers, advanced only where
# the wrapper launches the kernel.
LAUNCHES = {"float32": 0, "float64": 0}

_ENTRY = {torch.float32: ("f32", "float32"), torch.float64: ("f64", "float64")}


def spgemm_numeric_plain(gid, a_idx, b_idx, a_values, b_values,
                         n_out: int) -> torch.Tensor:
    """Plain torch numeric phase: two gathers, a product and ``index_add_``
    into the output slots, in the accumulation dtype. Runs on any device;
    differentiable by autograd."""
    acc = acc_dtype(a_values.dtype, b_values.dtype)
    prod = a_values.to(acc)[a_idx] * b_values.to(acc)[b_idx]
    return torch.zeros(n_out, dtype=acc, device=prod.device).index_add_(
        0, gid, prod)


def _check(plan, a_values, b_values) -> None:
    index = (plan.rowptr, plan.colind, plan.gid, plan.a_idx, plan.b_idx,
             plan.tptr)
    devices = {t.device for t in index + (a_values, b_values)}
    if len(devices) != 1:
        raise ValueError(
            f"spgemm_numeric operands on several devices: {devices}")
    if any(t.dtype != INDEX_DTYPE for t in index):
        raise DTypeError(f"plan indices must be {INDEX_DTYPE}")
    if (plan.rowptr.ndim != 1 or plan.rowptr.numel() != plan.nrows + 1
            or plan.colind.ndim != 1 or plan.colind.numel() < plan.n_out
            or plan.gid.ndim != 1 or plan.a_idx.shape != plan.gid.shape
            or plan.b_idx.shape != plan.gid.shape
            or plan.tptr.ndim != 1 or plan.tptr.numel() != plan.n_out + 1
            or a_values.ndim != 1 or b_values.ndim != 1
            or a_values.numel() < plan.nnz_a
            or b_values.numel() < plan.nnz_b):
        raise ShapeError(
            f"spgemm_numeric shapes: rowptr {tuple(plan.rowptr.shape)} for "
            f"{plan.nrows} rows, colind {tuple(plan.colind.shape)} for "
            f"{plan.n_out} slots, gid {tuple(plan.gid.shape)}, a_idx "
            f"{tuple(plan.a_idx.shape)}, b_idx {tuple(plan.b_idx.shape)}, "
            f"tptr {tuple(plan.tptr.shape)}, a {tuple(a_values.shape)} "
            f"({plan.nnz_a} entries), b {tuple(b_values.shape)} "
            f"({plan.nnz_b} entries)")


def spgemm_numeric(plan, a_values, b_values) -> torch.Tensor:
    """The values of ``C = A·B`` on an :class:`~spalinalg_tpu_torch.ops.
    spgemm.SpgemmPlan`: the kernel on CUDA tensors, the plain version on
    CPU tensors.

    The kernel reads the term list as ``tptr``, ``a_idx`` and ``b_idx``,
    the plain version as ``gid``, ``a_idx`` and ``b_idx``. Value arrays may
    be longer than the operands' entry counts; only their first ``nnz``
    entries are read. The result has the dtype ``result_dtype(a, b)``;
    bfloat16 accumulates in float32. ``n_out == 0`` launches nothing.
    """
    acc = acc_dtype(a_values.dtype, b_values.dtype)
    out_dtype = result_dtype(a_values.dtype, b_values.dtype)
    a_values = a_values.to(acc).contiguous()
    b_values = b_values.to(acc).contiguous()
    _check(plan, a_values, b_values)
    device = a_values.device
    if device.type == "cpu":
        return spgemm_numeric_plain(plan.gid, plan.a_idx, plan.b_idx,
                                    a_values, b_values,
                                    plan.n_out).to(out_dtype)
    if device.type != "cuda":
        raise ValueError(f"no spgemm_numeric kernel for device {device}")
    if plan.n_out == 0:
        return torch.zeros(0, dtype=out_dtype, device=device)
    from ._build import launch

    suffix, key = _ENTRY[acc]
    out = torch.empty(plan.n_out, dtype=acc, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        launch(f"spal_spgemm_terms_{suffix}", plan.tptr.data_ptr(),
               plan.a_idx.data_ptr(), plan.b_idx.data_ptr(),
               a_values.data_ptr(), b_values.data_ptr(), out.data_ptr(),
               plan.n_out, stream)
    LAUNCHES[key] += 1
    return out.to(out_dtype)


class SpgemmNumeric(torch.autograd.Function):
    """The numeric phase with gradients to both value arrays.

    ``SpgemmNumeric.apply(a_values, b_values, plan)``: ``da = Σ_t
    g[gid[t]]·b[b_idx[t]]`` scattered to ``a_idx`` and ``db`` likewise, so
    padding slots of either operand get 0.
    """

    @staticmethod
    def forward(ctx, a_values, b_values, plan):
        ctx.save_for_backward(a_values, b_values)
        ctx.plan = plan
        return spgemm_numeric(plan, a_values, b_values)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        a_values, b_values = ctx.saved_tensors
        plan = ctx.plan
        acc = acc_dtype(a_values.dtype, b_values.dtype)
        gg = g.to(acc)[plan.gid]
        da = db = None
        if ctx.needs_input_grad[0]:
            da = torch.zeros(a_values.shape, dtype=acc, device=g.device
                             ).index_add_(0, plan.a_idx,
                                          gg * b_values.to(acc)[plan.b_idx]
                                          ).to(a_values.dtype)
        if ctx.needs_input_grad[1]:
            db = torch.zeros(b_values.shape, dtype=acc, device=g.device
                             ).index_add_(0, plan.b_idx,
                                          gg * a_values.to(acc)[plan.a_idx]
                                          ).to(b_values.dtype)
        return da, db, None
