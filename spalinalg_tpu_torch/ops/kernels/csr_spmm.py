"""CSR SpMM: the Hopper kernel's wrapper, its plain torch version, its launch
count, and the gradient.

The kernel (``spalinalg_tpu_torch/csrc/csr_spmm.cu``) replaces the two
Pallas kernels on the JAX package's SpMM path:

- ``spalinalg_tpu/ops/kernels/csr_route.py::_route_spmm_kernel`` (B2a),
- ``spalinalg_tpu/ops/kernels/csr_route.py::_route_spmm_kernel_pk`` (B2b,
  packed active pages).

One warp per row reads ``rowptr``/``colind``/``values`` directly and
gathers rows of ``X``, for float32 and float64 and any number of columns.

:func:`csr_spmm` is the wrapper. For CUDA tensors it launches the kernel or
raises; for CPU tensors it runs the plain version, which is
:func:`~spalinalg_tpu_torch.ops.kernels.csr_spmv.csr_spmv_plain` on a 2-D
right-hand side. :class:`CsrSpmm` carries the gradient of
``csr_route.py::_route_spmm_ad_bwd``: ``dX = Aᵀ·G`` runs the same kernel on
the cached transposed structure (no atomics), and ``dvals[p] =
Σ_c G[row_p, c]·X[col_p, c]`` is plain torch, as it is XLA code outside any
Pallas kernel in the JAX package.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from ...dtypes import INDEX_DTYPE, acc_dtype
from ...errors import DTypeError, ShapeError
from .csr_spmv import csr_spmv_plain, transpose_plan

__all__ = ["LAUNCHES", "CsrSpmm", "csr_spmm", "csr_spmm_plain"]

# Kernel launches per instantiation: plain integers, advanced only where
# the wrapper launches the kernel.
LAUNCHES = {"float32": 0, "float64": 0}

_ENTRY = {torch.float32: ("spal_csr_spmm_f32", "float32"),
          torch.float64: ("spal_csr_spmm_f64", "float64")}

# Elements per temporary of the plain ``dvals`` product: at k = 64 and 17M
# entries an unchunked gather would take 8.9 GB per array in float64.
_DVALS_CHUNK = 1 << 26

csr_spmm_plain = csr_spmv_plain


def csr_spmm(rowptr, colind, values, X, nrows: int) -> torch.Tensor:
    """``Y = A @ X`` for CSR ``A`` and dense ``X`` of shape ``(ncols, k)``:
    the kernel on CUDA tensors, the plain version on CPU tensors.

    ``values`` and ``X`` are promoted to the accumulation dtype and made
    contiguous. Devices, index dtypes and shapes are checked; anything the
    kernel does not take raises. ``k == 0``, ``nrows == 0`` and a matrix
    with no stored slots launch nothing.
    """
    acc = acc_dtype(values.dtype, X.dtype)
    values = values.to(acc).contiguous()
    X = X.to(acc).contiguous()
    devices = {t.device for t in (rowptr, colind, values, X)}
    if len(devices) != 1:
        raise ValueError(f"csr_spmm operands on several devices: {devices}")
    if rowptr.dtype != INDEX_DTYPE or colind.dtype != INDEX_DTYPE:
        raise DTypeError(
            f"indices must be {INDEX_DTYPE}, got {rowptr.dtype} and "
            f"{colind.dtype}")
    if (rowptr.ndim != 1 or rowptr.numel() != nrows + 1 or colind.ndim != 1
            or values.shape != colind.shape or X.ndim != 2):
        raise ShapeError(
            f"csr_spmm shapes: rowptr {tuple(rowptr.shape)}, colind "
            f"{tuple(colind.shape)}, values {tuple(values.shape)}, X "
            f"{tuple(X.shape)}, nrows {nrows}")
    device = X.device
    if device.type == "cpu":
        return csr_spmm_plain(rowptr, colind, values, X, nrows)
    if device.type != "cuda":
        raise ValueError(f"no csr_spmm kernel for device {device}")
    k = X.shape[1]
    if nrows == 0 or colind.numel() == 0 or k == 0:
        return torch.zeros((nrows, k), dtype=acc, device=device)
    from ._build import launch

    name, key = _ENTRY[acc]
    rowptr, colind = rowptr.contiguous(), colind.contiguous()
    Y = torch.empty((nrows, k), dtype=acc, device=device)
    with torch.cuda.device(device):
        launch(name, rowptr.data_ptr(), colind.data_ptr(), values.data_ptr(),
               X.data_ptr(), Y.data_ptr(), nrows, k,
               torch.cuda.current_stream(device).cuda_stream)
    LAUNCHES[key] += 1
    return Y


def _row_dots(G, X, rows, cols) -> torch.Tensor:
    """``out[p] = Σ_c G[rows[p], c]·X[cols[p], c]``, in chunks of entries so
    that no temporary passes ``_DVALS_CHUNK`` elements."""
    step = max(1, _DVALS_CHUNK // max(1, X.shape[1]))
    return torch.cat([(G[r] * X[c]).sum(1)
                      for r, c in zip(rows.split(step), cols.split(step))])


class CsrSpmm(torch.autograd.Function):
    """``Y = A @ X`` with the closed-form gradient of
    ``spalinalg_tpu/ops/kernels/csr_route.py::_route_spmm_ad_bwd``.

    ``CsrSpmm.apply(values, X, rowptr, colind, nrows, ncols)``; gradients
    flow to ``values`` and ``X``.
    """

    @staticmethod
    def forward(ctx, values, X, rowptr, colind, nrows, ncols):
        # The structure tensors are kept as they are (not saved tensors) so
        # that the transpose cache sees the same objects on every call.
        ctx.structure = (rowptr, colind, nrows, ncols)
        ctx.save_for_backward(values, X)
        return csr_spmm(rowptr, colind, values, X, nrows)

    @staticmethod
    @once_differentiable
    def backward(ctx, G):
        values, X = ctx.saved_tensors
        rowptr, colind, nrows, ncols = ctx.structure
        acc = acc_dtype(values.dtype, X.dtype)
        G = G.to(acc)
        t = transpose_plan(rowptr, colind, nrows, ncols)
        dvals = dX = None
        if ctx.needs_input_grad[0]:
            # Padding slots have the sentinel row nrows, whose G row is 0.
            G_ext = torch.cat([G, G.new_zeros(1, G.shape[1])])
            dvals = _row_dots(G_ext, X.to(acc), t.major, colind
                              ).to(values.dtype)
        if ctx.needs_input_grad[1]:
            dX = csr_spmm(t.ptr, t.minor, values[t.perm], G, ncols
                          ).to(X.dtype)
        return dvals, dX, None, None, None, None
