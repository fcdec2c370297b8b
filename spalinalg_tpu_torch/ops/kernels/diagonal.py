"""The stored diagonal of a CSR or square-block BSR structure: the Hopper
kernel's wrapper, its plain torch version and its launch count.

The kernel (``spalinalg_tpu_torch/csrc/diagonal.cu``) replaces no Pallas
kernel: the JAX package's ``diagonal`` (``spalinalg_tpu/ops/reduce_api.py``)
is XLA code. It is bound by the index bytes it reads: a group of lanes
walks each output row's own run of indices once, so it needs no row ids,
and takes the row's last hit (of a slot stored twice, the last entry
counts, as in scipy and the JAX package). With ``invert`` the same store
writes the Jacobi preconditioner's inverse, ``d != 0 ? 1 / d : 1``.

:func:`diagonal` is the wrapper. For CUDA tensors it launches the kernel or
raises; for CPU tensors it runs :func:`diagonal_plain`, the torch chain the
port ran before the kernel (a row id for every slot, a hit mask, a
``scatter_reduce("amax")`` of the positions, a gather; then ``torch.where``
for the inverse). The kernel walks a row with 4 lanes, with 16-byte index
loads where ``idx`` is aligned. Each launch adds one to ``LAUNCHES`` (by
value type); the metrics path is ``diagonal:cuda`` or ``diagonal:plain``.

>>> import torch
>>> ptr = torch.tensor([0, 2, 3, 3], dtype=torch.int32)
>>> idx = torch.tensor([0, 1, 1], dtype=torch.int32)
>>> values = torch.tensor([4.0, 1.0, 2.0], dtype=torch.float64)
>>> diagonal(ptr, idx, values, 3)
tensor([4., 2., 0.], dtype=torch.float64)
>>> diagonal(ptr, idx, values, 3, invert=True)
tensor([0.2500, 0.5000, 1.0000], dtype=torch.float64)
"""

from __future__ import annotations

import torch

from ...convert.engine import major_ids
from ...dtypes import INDEX_DTYPE
from ...errors import DTypeError, ShapeError
from ...utils.metrics import instrument
from .csr_spmv import aligned16

__all__ = ["LAUNCHES", "diagonal", "diagonal_plain"]

# Kernel launches per value type: plain integers, advanced only where the
# wrapper launches the kernel.
LAUNCHES = {"float32": 0, "bfloat16": 0, "float64": 0}

_ENTRY = {torch.float32: ("spal_diagonal_f32", "float32"),
          torch.bfloat16: ("spal_diagonal_bf16", "bfloat16"),
          torch.float64: ("spal_diagonal_f64", "float64")}


def _inverse(d: torch.Tensor) -> torch.Tensor:
    """The Jacobi inverse: ``1 / d``, and 1 where ``d`` is 0."""
    return torch.where(d != 0, 1 / torch.where(d != 0, d, 1), 1)


def _csr_plain(ptr, idx, values, length: int, k: int) -> torch.Tensor:
    nrows = ptr.numel() - 1
    nse = idx.numel()
    dev = idx.device
    rows = major_ids(ptr, nse).long()        # padding -> nrows
    hit = (idx.long() - rows == k) & (rows < nrows)
    pos = torch.arange(nse, device=dev)
    # entries off the diagonal scatter a no-op -1, spread over the slots
    # so that no one slot takes all their atomics
    dest = torch.where(hit, rows - max(-k, 0), pos % length)
    slot = torch.full((length,), -1, dtype=torch.int64, device=dev)
    slot.scatter_reduce_(0, dest, torch.where(hit, pos, -1), "amax")
    slot = torch.where(slot < 0, nse, slot)     # nse: the zero appended below
    return torch.cat([values[:nse], values.new_zeros(1)])[slot]


def _block_plain(indptr, indices, data, length: int) -> torch.Tensor:
    b = data.shape[1]
    nbr = indptr.numel() - 1
    nb = indices.numel()
    if nb == 0:
        return data.new_zeros(length * b)
    ptr = indptr
    # each block's row (padding -> nbr, a slot never read), from the row
    # lengths alone
    counts = torch.cat([ptr[1:] - ptr[:-1], nb - ptr[-1:]]).long()
    rows = torch.repeat_interleave(counts, output_size=nb)      # int64
    hit = indices == rows
    # each row's last diagonal block, -1 where none: every block offers to
    # its own row, so no slot takes more than a row's atomics
    pos = torch.arange(nb, dtype=torch.int32, device=indices.device)
    slot = torch.full((nbr + 1,), -1, dtype=torch.int32,
                      device=indices.device)
    slot.scatter_reduce_(0, rows, torch.where(hit, pos, -1), "amax")
    del rows, hit, pos
    slot = slot[:length]
    diag = data[slot.clamp(min=0).long()].diagonal(dim1=1, dim2=2)
    return torch.where(slot[:, None] >= 0, diag, 0).reshape(-1)


def diagonal_plain(ptr, idx, values, length: int, k: int = 0, *,
                   invert: bool = False) -> torch.Tensor:
    """Plain torch :func:`diagonal`: one row id a slot (CSR) or a block
    (BSR), the last hit of each row by ``scatter_reduce("amax")``, a
    gather. Runs on any device."""
    if values.ndim == 1:
        d = _csr_plain(ptr, idx, values, length, k)
    else:
        d = _block_plain(ptr, idx, values, length)
    return _inverse(d) if invert else d


def _checked(ptr, idx, values, length: int, k: int) -> int:
    """Raise on operands the kernel does not take; the block size ``b``
    (1 for CSR)."""
    if values.ndim == 1:
        b = 1
    elif values.ndim == 3 and values.shape[1] == values.shape[2]:
        b = int(values.shape[1])
        if k != 0:
            raise ShapeError(f"a block diagonal is the main one, not {k}")
    else:
        raise ShapeError(f"diagonal values of shape {tuple(values.shape)}: "
                         "1-D (CSR) or (nblocks, b, b) (BSR)")
    if not (ptr.device == idx.device == values.device):
        raise ValueError(f"diagonal operands on several devices: "
                         f"{ptr.device}, {idx.device}, {values.device}")
    if ptr.dtype != INDEX_DTYPE or idx.dtype != INDEX_DTYPE:
        raise DTypeError(f"diagonal takes int32 ptr and idx, got "
                         f"{ptr.dtype}, {idx.dtype}")
    if ptr.ndim != 1 or idx.ndim != 1 or ptr.numel() < 1 or length < 0:
        raise ShapeError(f"diagonal structure: ptr {tuple(ptr.shape)}, idx "
                         f"{tuple(idx.shape)}, length {length}")
    nrows = ptr.numel() - 1
    if max(-k, 0) + length > nrows:
        raise ShapeError(f"diagonal {k} of length {length} past the "
                         f"{nrows} rows")
    return b


def diagonal(ptr, idx, values, length: int, k: int = 0, *,
             invert: bool = False) -> torch.Tensor:
    """The ``k``-th stored diagonal, ``length`` rows of it from row
    ``max(-k, 0)`` on, as a dense vector in the values' type: of CSR
    ``(ptr, idx, values)`` (1-D ``values``), or the main diagonal of
    square-block BSR ``(indptr, indices, data)`` (``data`` of shape
    ``(nblocks, b, b)``; ``length`` block rows, ``length·b`` values).
    Absent entries give 0; of a slot stored twice the last counts; slots
    at or past ``ptr[-1]`` are padding. With ``invert``, ``1 / d`` and 1
    where ``d`` is 0 or absent.

    The kernel on CUDA tensors, the plain version on CPU tensors. Devices,
    dtypes and shapes are checked; anything the kernel does not take
    raises.
    """
    b = _checked(ptr, idx, values, length, k)
    device = values.device
    if device.type == "cpu":
        return instrument(
            "diagonal", lambda: diagonal_plain(ptr, idx, values, length, k,
                                               invert=invert),
            path="plain", device=device, nnz=length * b)
    if device.type != "cuda":
        raise ValueError(f"no diagonal kernel for device {device}")
    if values.dtype not in _ENTRY:
        raise DTypeError(f"no diagonal kernel for {values.dtype}")
    return instrument("diagonal",
                      lambda: _launch(ptr, idx, values, length, k, b, invert),
                      path="cuda", device=device, nnz=length * b)


def _launch(ptr, idx, values, length: int, k: int, b: int,
            invert: bool) -> torch.Tensor:
    from ._build import launch

    device = values.device
    ptr, idx, values = ptr.contiguous(), idx.contiguous(), values.contiguous()
    out = torch.empty(length * b, dtype=values.dtype, device=device)
    if length == 0:
        return out
    vec = 4 if aligned16(idx) else 1
    name, key = _ENTRY[values.dtype]
    with torch.cuda.device(device):
        launch(name, ptr.data_ptr(), idx.data_ptr(), values.data_ptr(),
               out.data_ptr(), length, max(-k, 0), k, b, int(invert), vec,
               torch.cuda.current_stream(device).cuda_stream)
    LAUNCHES[key] += 1
    return out
