"""CSR SpMV: the Hopper kernel's wrapper, its plain torch version, its launch
count, and the gradient.

The kernel (``spalinalg_tpu_torch/csrc/csr_spmv.cu``) replaces the four
Pallas kernels on the JAX package's SpMV path:

- ``spalinalg_tpu/ops/kernels/csr_route.py::_route_kernel`` (f32),
- ``spalinalg_tpu/ops/kernels/csr_route.py::_route_kernel_pk`` (f32,
  packed active pages),
- ``spalinalg_tpu/ops/kernels/csr_route_df.py::_route_kernel_df`` (f64 as
  double-float),
- ``spalinalg_tpu/ops/kernels/csr_route_df.py::_route_kernel_df_pk``.

Their routing plan, lane-gather network, spill recursion and double-float
arithmetic work around TPU limits that Hopper does not have, so one
vector-CSR kernel, instantiated for float32 and float64, reads
``rowptr``/``colind``/``values`` directly.

:func:`csr_spmv` is the wrapper. For CUDA tensors it launches the kernel or
raises; for CPU tensors it runs :func:`csr_spmv_plain`. :class:`CsrSpmv`
carries the gradient of ``csr_route.py::_route_spmv_ad_bwd``:
``dx = Aᵀ·g`` runs the same kernel on the transposed structure (no
atomics), and ``dvals = g[row]·x[colind]`` is plain torch, as it is XLA code
outside any Pallas kernel in the JAX package.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from ...convert.engine import TransposeStructure, major_ids, transpose_structure
from ...dtypes import INDEX_DTYPE, acc_dtype
from ...errors import DTypeError, ShapeError
from ...utils.plancache import StructureCache

__all__ = ["LAUNCHES", "CsrSpmv", "csr_spmv", "csr_spmv_plain", "path_for",
           "transpose_plan", "lanes_for"]

# Kernel launches per instantiation: plain integers, advanced only where
# the wrapper launches the kernel.
LAUNCHES = {"float32": 0, "float64": 0}

_ENTRY = {torch.float32: ("spal_csr_spmv_f32", "float32"),
          torch.float64: ("spal_csr_spmv_f64", "float64")}

# Lives as long as each structure does (see utils/plancache.py).
_TRANSPOSE_PLANS = StructureCache()


def path_for(device: torch.device) -> str:
    """The dispatch path the wrapper takes for tensors on ``device``."""
    return "cuda" if device.type == "cuda" else "plain"


def lanes_for(nse: int, nrows: int) -> int:
    """Lanes per row: the power of two from 1 to 32 that covers the mean
    row length."""
    lanes = 1
    while lanes < 32 and lanes * nrows < nse:
        lanes *= 2
    return lanes


def transpose_plan(ptr: torch.Tensor, minor: torch.Tensor, n_major: int,
                   n_minor: int) -> TransposeStructure:
    """The transposed structure, built once per structure (keyed on the
    identity and shape of ``ptr`` and ``minor`` and on both dimensions) and
    dropped with it."""
    return _TRANSPOSE_PLANS.get(
        (ptr, minor),
        lambda: transpose_structure(ptr, minor, n_major=n_major,
                                    n_minor=n_minor),
        n_major, n_minor)


def csr_spmv_plain(rowptr, colind, values, x, nrows: int) -> torch.Tensor:
    """Plain torch ``y = A @ x`` (or ``Y = A @ X`` for a 2-D ``x``):
    products scattered into rows with ``index_add_``. Padding slots land in
    a sentinel row that is cut off. Runs on any device; differentiable by
    autograd."""
    acc = acc_dtype(values.dtype, x.dtype)
    rows = major_ids(rowptr, colind.numel())
    v = values.to(acc).reshape((-1,) + (1,) * (x.ndim - 1))
    prod = v * x.to(acc)[colind]
    y = torch.zeros((nrows + 1,) + tuple(x.shape[1:]), dtype=acc,
                    device=x.device)
    y.index_add_(0, rows, prod)
    return y[:nrows]


def csr_spmv(rowptr, colind, values, x, nrows: int) -> torch.Tensor:
    """``y = A @ x`` for CSR ``A``: the kernel on CUDA tensors, the plain
    version on CPU tensors.

    ``values`` and ``x`` are promoted to the accumulation dtype and made
    contiguous. Devices, index dtypes and shapes are checked; anything the
    kernel does not take raises.
    """
    acc = acc_dtype(values.dtype, x.dtype)
    values = values.to(acc).contiguous()
    x = x.to(acc).contiguous()
    devices = {t.device for t in (rowptr, colind, values, x)}
    if len(devices) != 1:
        raise ValueError(f"csr_spmv operands on several devices: {devices}")
    if rowptr.dtype != INDEX_DTYPE or colind.dtype != INDEX_DTYPE:
        raise DTypeError(
            f"indices must be {INDEX_DTYPE}, got {rowptr.dtype} and "
            f"{colind.dtype}")
    if (rowptr.ndim != 1 or rowptr.numel() != nrows + 1 or colind.ndim != 1
            or values.shape != colind.shape or x.ndim != 1):
        raise ShapeError(
            f"csr_spmv shapes: rowptr {tuple(rowptr.shape)}, colind "
            f"{tuple(colind.shape)}, values {tuple(values.shape)}, x "
            f"{tuple(x.shape)}, nrows {nrows}")
    device = x.device
    if device.type == "cpu":
        return csr_spmv_plain(rowptr, colind, values, x, nrows)
    if device.type != "cuda":
        raise ValueError(f"no csr_spmv kernel for device {device}")
    if nrows == 0 or colind.numel() == 0:
        return torch.zeros(nrows, dtype=acc, device=device)
    from ._build import load_library

    lib = load_library()
    name, key = _ENTRY[acc]
    rowptr, colind = rowptr.contiguous(), colind.contiguous()
    y = torch.empty(nrows, dtype=acc, device=device)
    with torch.cuda.device(device):
        code = getattr(lib, name)(
            rowptr.data_ptr(), colind.data_ptr(), values.data_ptr(),
            x.data_ptr(), y.data_ptr(), nrows,
            lanes_for(colind.numel(), nrows),
            torch.cuda.current_stream(device).cuda_stream)
    if code != 0:
        raise RuntimeError(
            f"{name} launch failed: {lib.spal_error_string(code).decode()} "
            f"(cudaError {code})")
    LAUNCHES[key] += 1
    return y


class CsrSpmv(torch.autograd.Function):
    """``y = A @ x`` with the closed-form gradient of
    ``spalinalg_tpu/ops/kernels/csr_route.py::_route_spmv_ad_bwd``.

    ``CsrSpmv.apply(values, x, rowptr, colind, nrows, ncols)``; gradients
    flow to ``values`` and ``x``.
    """

    @staticmethod
    def forward(ctx, values, x, rowptr, colind, nrows, ncols):
        # The structure tensors are kept as they are (not saved tensors) so
        # that the transpose cache sees the same objects on every call.
        ctx.structure = (rowptr, colind, nrows, ncols)
        ctx.save_for_backward(values, x)
        return csr_spmv(rowptr, colind, values, x, nrows)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        values, x = ctx.saved_tensors
        rowptr, colind, nrows, ncols = ctx.structure
        acc = acc_dtype(values.dtype, x.dtype)
        g = g.to(acc)
        # The cached plan also keeps the row of each slot: rebuilding it with
        # a searchsorted on every backward made a forward + backward step
        # about 1.5x slower on an H100 (n = 2**21, 32 entries a row).
        t = transpose_plan(rowptr, colind, nrows, ncols)
        dvals = dx = None
        if ctx.needs_input_grad[0]:
            # Padding slots have the sentinel row nrows, whose g is 0.
            g_ext = torch.cat([g, g.new_zeros(1)])
            dvals = (g_ext[t.major] * x.to(acc)[colind]).to(values.dtype)
        if ctx.needs_input_grad[1]:
            dx = csr_spmv(t.ptr, t.minor, values[t.perm], g, ncols
                          ).to(x.dtype)
        return dvals, dx, None, None, None, None
