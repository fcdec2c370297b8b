"""DIA SpMV: the Hopper kernel's wrapper, its plain torch version, its launch
count, and the gradient.

The kernel (``spalinalg_tpu_torch/csrc/dia_spmv.cu``) replaces the Pallas
kernels on the JAX package's DIA SpMV path:

- ``spalinalg_tpu/ops/kernels/dia_stream.py::_dia_kernel`` (B7, f32),
- ``spalinalg_tpu/ops/kernels/dia_df.py::_dia_df_kernel`` (B8, f64 as
  double-float).

Their resident padded ``x``, lane rolls, row tiles, diagonal caps and
double-float planes work around TPU limits, so one kernel, instantiated
for float32 and float64, reads the row-aligned storage ``data[k, i] =
A[i, i + offsets[k]]`` directly, for any number of diagonals.

**Dtypes**: ``data`` and ``x`` are promoted to the accumulation type
(bfloat16 storage accumulates in float32, as ``dia_stream.py:131`` casts
to f32); :class:`~spalinalg_tpu_torch.formats.dia.DiaMatrix` casts the
result to the promotion of the two, as ``formats/dia.py::_matvec_xla``
gives it.

:func:`dia_spmv` is the wrapper. For CUDA tensors it launches the kernel or
raises; for CPU tensors it runs :func:`dia_spmv_plain`, a torch
transcription of ``_matvec_xla`` (pad ``x``, then one shifted
multiply-add per diagonal). :class:`DiaSpmv` carries the closed-form
gradient of ``dia_stream.py::_dia_spmv_bwd``: ``dx[j] = Σ_k data[k, j -
o_k]·g[j - o_k]`` is the same kernel with its ``transposed`` flag, reading
``data`` in place, and ``ddata[k, i] = g[i]·x[i + o_k]`` is plain torch, as
the JAX package computes it outside any Pallas kernel.

>>> import torch
>>> data = torch.tensor([[0.0, -1.0, -1.0], [2.0, 2.0, 2.0],
...                      [-1.0, -1.0, 0.0]], dtype=torch.float64)
>>> dia_spmv([-1, 0, 1], data, torch.ones(3, dtype=torch.float64), 3, 3)
tensor([1., 0., 1.], dtype=torch.float64)
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from ...dtypes import acc_dtype
from ...errors import ShapeError

__all__ = ["LAUNCHES", "DiaSpmv", "dia_spmv", "dia_spmv_plain",
           "host_offsets"]

# Kernel launches per instantiation: plain integers, advanced only where
# the wrapper launches the kernel.
LAUNCHES = {"float32": 0, "float64": 0}

_ENTRY = {torch.float32: ("spal_dia_spmv_f32", "float32"),
          torch.float64: ("spal_dia_spmv_f64", "float64")}


def host_offsets(offsets) -> List[int]:
    """The diagonal offsets as Python ints, in the order given."""
    if isinstance(offsets, torch.Tensor):
        offsets = offsets.cpu().numpy()
    return [int(o) for o in np.asarray(offsets, dtype=np.int64).reshape(-1)]


def _padded(x: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """``x`` with ``lo`` zero rows before it and ``hi`` after it."""
    pad = x.new_zeros((lo + hi,) + tuple(x.shape[1:]))
    return torch.cat([pad[:lo], x, pad[lo:]])


def dia_spmv_plain(offsets, data, x, nrows: int, ncols: int, *,
                   transposed: bool = False) -> torch.Tensor:
    """Plain torch ``y = A @ x`` for row-aligned DIA ``A`` (``x`` 1-D, or
    2-D for ``Y = A @ X``), or ``dx = Aᵀ·g`` with ``transposed``: the
    transcription of ``formats/dia.py::_matvec_xla`` and of the shifted
    accumulation of ``dia_stream.py::_dia_spmv_bwd``. Runs on any device;
    differentiable by autograd."""
    offs = host_offsets(offsets)
    acc = acc_dtype(data.dtype, x.dtype)
    data, x = data.to(acc), x.to(acc)
    trail = (1,) * (x.ndim - 1)
    lo = -min(min(offs, default=0), 0)
    if not transposed:
        # Enough trailing zeros for the largest offset's window. The JAX
        # package pads max(max_off + 2·nrows - 2·ncols, 0), too few when
        # nrows < ncols < max_off + nrows; its clamped dynamic_slice then
        # reads a shifted window (ROADMAP queue C).
        xp = _padded(x, lo, max(max(offs, default=0) + nrows - ncols, 0))
        y = x.new_zeros((nrows,) + tuple(x.shape[1:]))
        for k, o in enumerate(offs):
            seg = xp[o + lo: o + lo + nrows]
            y = y + data[k, :nrows].reshape((nrows,) + trail) * seg
        return y
    dxp = x.new_zeros((lo + ncols + nrows,) + tuple(x.shape[1:]))
    for k, o in enumerate(offs):
        dxp[o + lo: o + lo + nrows] += data[k, :nrows].reshape(
            (nrows,) + trail) * x
    return dxp[lo: lo + ncols]


def dia_spmv(offsets, data, x, nrows: int, ncols: int, *,
             transposed: bool = False) -> torch.Tensor:
    """``y = A @ x`` (``nrows`` entries) for row-aligned DIA ``A``, or with
    ``transposed`` ``dx = Aᵀ·x`` (``ncols`` entries, ``x`` of length
    ``nrows``): the kernel on CUDA tensors, the plain version on CPU
    tensors.

    For CUDA operands ``offsets`` is a 1-D int64 tensor on their device,
    which the kernel reads as it is (``DiaMatrix`` keeps one); for CPU
    operands it may also be a sequence or a NumPy array. ``data`` is
    ``(D, nrows)``; ``data`` and ``x`` are promoted to the accumulation
    dtype and made contiguous. Devices and shapes are checked; anything the
    kernel does not take raises. ``D == 0`` launches nothing and gives
    zeros.
    """
    acc = acc_dtype(data.dtype, x.dtype)
    data = data.to(acc).contiguous()
    x = x.to(acc).contiguous()
    ndiag = (offsets.numel() if isinstance(offsets, torch.Tensor)
             else len(host_offsets(offsets)))
    n_in, n_out = (nrows, ncols) if transposed else (ncols, nrows)
    if data.device != x.device:
        raise ValueError(f"dia_spmv operands on several devices: "
                         f"{data.device}, {x.device}")
    if (data.ndim != 2 or tuple(data.shape) != (ndiag, nrows) or x.ndim != 1
            or x.shape[0] != n_in):
        raise ShapeError(
            f"dia_spmv shapes: {ndiag} offsets, data {tuple(data.shape)}, x "
            f"{tuple(x.shape)}, nrows {nrows}, ncols {ncols}, transposed "
            f"{transposed}")
    device = x.device
    if device.type == "cpu":
        return dia_spmv_plain(offsets, data, x, nrows, ncols,
                              transposed=transposed)
    if device.type != "cuda":
        raise ValueError(f"no dia_spmv kernel for device {device}")
    if not (isinstance(offsets, torch.Tensor) and offsets.device == device
            and offsets.dtype == torch.int64 and offsets.ndim == 1):
        raise ValueError(f"dia_spmv on {device} takes the offsets as a 1-D "
                         f"int64 tensor on that device")
    if ndiag == 0 or n_out == 0:
        return torch.zeros(n_out, dtype=acc, device=device)
    from ._build import launch

    name, key = _ENTRY[acc]
    off = offsets.contiguous()
    y = torch.empty(n_out, dtype=acc, device=device)
    with torch.cuda.device(device):
        launch(name, off.data_ptr(), ndiag, data.data_ptr(), x.data_ptr(),
               y.data_ptr(), nrows, ncols, int(transposed),
               torch.cuda.current_stream(device).cuda_stream)
    LAUNCHES[key] += 1
    return y


def _shifted_products(offsets, g, x, nrows: int) -> torch.Tensor:
    """``out[k, i] = g[i]·x[i + offsets[k]]`` (0 where the column is out of
    range), ``(D, nrows)``, written in place row by row."""
    offs = host_offsets(offsets)
    lo = -min(min(offs, default=0), 0)
    xp = _padded(x, lo, nrows)
    out = g.new_empty((len(offs), nrows))
    for k, o in enumerate(offs):
        torch.mul(g, xp[o + lo: o + lo + nrows], out=out[k])
    return out


class DiaSpmv(torch.autograd.Function):
    """``y = A @ x`` with the closed-form gradient of
    ``spalinalg_tpu/ops/kernels/dia_stream.py::_dia_spmv_bwd``.

    ``DiaSpmv.apply(data, x, offsets, nrows, ncols, kernel_offsets)``;
    gradients flow to ``data`` and ``x``. ``offsets`` are host offsets (a
    sequence or a NumPy array), read by the ``ddata`` products;
    ``kernel_offsets``, the same as an int64 tensor on the operands'
    device, is what :func:`dia_spmv` reads.
    """

    @staticmethod
    def forward(ctx, data, x, offsets, nrows, ncols, kernel_offsets):
        ctx.structure = (offsets, nrows, ncols, kernel_offsets)
        ctx.save_for_backward(data, x)
        return dia_spmv(kernel_offsets, data, x, nrows, ncols)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        data, x = ctx.saved_tensors
        offsets, nrows, ncols, kernel_offsets = ctx.structure
        acc = acc_dtype(data.dtype, x.dtype)
        g = g.to(acc).contiguous()
        ddata = dx = None
        if ctx.needs_input_grad[0]:
            ddata = _shifted_products(offsets, g, x.to(acc), nrows
                                      ).to(data.dtype)
        if ctx.needs_input_grad[1]:
            dx = dia_spmv(kernel_offsets, data, g, nrows, ncols,
                          transposed=True).to(x.dtype)
        return ddata, dx, None, None, None, None
