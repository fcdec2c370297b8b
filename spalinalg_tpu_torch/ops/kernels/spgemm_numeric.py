"""SpGEMM numeric phase: the Hopper kernel's wrapper, its plain torch
version, its launch count, and the gradient.

The kernel (``spalinalg_tpu_torch/csrc/spgemm_numeric.cu``) replaces the
Pallas kernel of the JAX package's SpGEMM numeric phase,
``spalinalg_tpu/ops/kernels/pair_route.py::_pair_kernel`` (B3). It computes

    out[g] = Σ_{t : gid[t] = g} a[a_idx[t]] · b[b_idx[t]]

over a plan's term list, sorted by output slot, with both gathers inside
the kernel, in float32 and float64.

:func:`spgemm_numeric` is the wrapper. For CUDA tensors it launches the
kernel or raises; for CPU tensors it runs :func:`spgemm_numeric_plain`.
:class:`SpgemmNumeric` carries the gradient that ``jax.grad`` gives through
``spalinalg_tpu/ops/spgemm.py::_spgemm_numeric``, in plain torch (a gather
and an ``index_add_`` per operand), as it is XLA code in the JAX package.
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

_ENTRY = {torch.float32: ("spal_spgemm_numeric_f32", "float32"),
          torch.float64: ("spal_spgemm_numeric_f64", "float64")}


def spgemm_numeric_plain(gid, a_idx, b_idx, a_values, b_values,
                         n_out: int) -> torch.Tensor:
    """Plain torch numeric phase: two gathers, a product and ``index_add_``
    into the output slots, in the accumulation dtype. Runs on any device;
    differentiable by autograd."""
    acc = acc_dtype(a_values.dtype, b_values.dtype)
    prod = a_values.to(acc)[a_idx] * b_values.to(acc)[b_idx]
    return torch.zeros(n_out, dtype=acc, device=prod.device).index_add_(
        0, gid, prod)


def spgemm_numeric(tptr, gid, a_idx, b_idx, a_values, b_values,
                   n_out: int) -> torch.Tensor:
    """The values of ``C = A·B`` on a plan's term list: the kernel on CUDA
    tensors, the plain version on CPU tensors.

    ``tptr`` (``n_out + 1``) points at each slot's first term in the
    slot-sorted list ``gid``/``a_idx``/``b_idx``; the kernel reads
    ``tptr``, the plain version ``gid``. The result has the dtype
    ``result_dtype(a, b)``; bfloat16 accumulates in float32. ``n_out == 0``
    launches nothing.
    """
    acc = acc_dtype(a_values.dtype, b_values.dtype)
    out_dtype = result_dtype(a_values.dtype, b_values.dtype)
    a_values = a_values.to(acc).contiguous()
    b_values = b_values.to(acc).contiguous()
    tensors = (tptr, gid, a_idx, b_idx, a_values, b_values)
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(
            f"spgemm_numeric operands on several devices: {devices}")
    if any(t.dtype != INDEX_DTYPE for t in tensors[:4]):
        raise DTypeError(f"plan indices must be {INDEX_DTYPE}")
    if (tptr.ndim != 1 or tptr.numel() != n_out + 1 or gid.ndim != 1
            or a_idx.shape != gid.shape or b_idx.shape != gid.shape
            or a_values.ndim != 1 or b_values.ndim != 1):
        raise ShapeError(
            f"spgemm_numeric shapes: tptr {tuple(tptr.shape)}, gid "
            f"{tuple(gid.shape)}, a_idx {tuple(a_idx.shape)}, b_idx "
            f"{tuple(b_idx.shape)}, a {tuple(a_values.shape)}, b "
            f"{tuple(b_values.shape)}, n_out {n_out}")
    device = a_values.device
    if device.type == "cpu":
        return spgemm_numeric_plain(gid, a_idx, b_idx, a_values, b_values,
                                    n_out).to(out_dtype)
    if device.type != "cuda":
        raise ValueError(f"no spgemm_numeric kernel for device {device}")
    if n_out == 0:
        return torch.zeros(0, dtype=out_dtype, device=device)
    from ._build import launch

    name, key = _ENTRY[acc]
    tptr, a_idx, b_idx = (t.contiguous() for t in (tptr, a_idx, b_idx))
    out = torch.empty(n_out, dtype=acc, device=device)
    with torch.cuda.device(device):
        launch(name, tptr.data_ptr(), a_idx.data_ptr(), b_idx.data_ptr(),
               a_values.data_ptr(), b_values.data_ptr(), out.data_ptr(),
               n_out, torch.cuda.current_stream(device).cuda_stream)
    LAUNCHES[key] += 1
    return out.to(out_dtype)


class SpgemmNumeric(torch.autograd.Function):
    """The numeric phase with gradients to both value arrays.

    ``SpgemmNumeric.apply(a_values, b_values, tptr, gid, a_idx, b_idx,
    n_out)``: ``da = Σ_t g[gid[t]]·b[b_idx[t]]`` scattered to ``a_idx`` and
    ``db`` likewise, so padding slots of either operand get 0.
    """

    @staticmethod
    def forward(ctx, a_values, b_values, tptr, gid, a_idx, b_idx, n_out):
        ctx.save_for_backward(a_values, b_values, gid, a_idx, b_idx)
        return spgemm_numeric(tptr, gid, a_idx, b_idx, a_values, b_values,
                              n_out)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        a_values, b_values, gid, a_idx, b_idx = ctx.saved_tensors
        acc = acc_dtype(a_values.dtype, b_values.dtype)
        gg = g.to(acc)[gid]
        da = db = None
        if ctx.needs_input_grad[0]:
            da = torch.zeros(a_values.shape, dtype=acc, device=g.device
                             ).index_add_(0, a_idx,
                                          gg * b_values.to(acc)[b_idx]
                                          ).to(a_values.dtype)
        if ctx.needs_input_grad[1]:
            db = torch.zeros(b_values.shape, dtype=acc, device=g.device
                             ).index_add_(0, b_idx,
                                          gg * a_values.to(acc)[a_idx]
                                          ).to(b_values.dtype)
        return da, db, None, None, None, None, None
