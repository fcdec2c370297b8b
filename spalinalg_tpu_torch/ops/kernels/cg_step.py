"""One conjugate-gradient step's vector work after the product ``ap = A·p``:
the Hopper kernels' wrappers, the plain torch step and the launch counts.

The kernels (``spalinalg_tpu_torch/csrc/cg_step.cu``) replace no Pallas
kernel: the JAX package's CG step is XLA code. They replace the port's torch
step, :func:`cg_step_plain` (24 passes over n-vectors a step), by three
passes that read and write 12 (10 with no preconditioner):

- :func:`pap`: ``p·ap`` as a 1-element tensor;
- :func:`update`: ``alpha = rz / pap``; ``r -= alpha·ap`` in place, and
  ``[r·z, r·r]`` with ``z = inv·r`` (``r`` where ``inv`` is None) as a fresh
  2-element tensor; ``z`` is not stored;
- :func:`direction`: ``alpha = rz / pap``, ``beta = rz' / rz``; ``x' = x +
  alpha·p`` out of place from the old ``p``, then ``p = z + beta·p`` in place.

:func:`dots` gives the first residual's ``[r·z, r·r]`` the same way. The
scalars stay on the device (the kernels read them there), so a ``DistCsr``
sums each dot over its ranks in place between the passes. Given the same
dots, ``x'``, ``r`` and ``p`` are the torch step's bit for bit; the dots are
summed in another order than ``torch.dot``'s, the same bits on every launch.

The wrappers launch their kernels on the CUDA tensors they take
(:func:`takes`) and raise on others: CPU tensors take the torch step. Each
launch adds one to ``LAUNCHES`` (by value type) and to ``PASS_LAUNCHES`` (by
pass). The solver (``linalg/cg.py``) records the step as
``cg_step:cuda:fused`` or, for :func:`cg_step_plain`, ``cg_step:plain``.

>>> import torch
>>> r = torch.tensor([1.0, 2.0], dtype=torch.float64)
>>> takes(r)
False
>>> dots_ = lambda pairs: [torch.dot(u, v) for u, v in pairs]
>>> x, r1, p, rz, rr = cg_step_plain(torch.zeros_like(r), r, r, 2 * r,
...                                  torch.dot(r, r), lambda v: v, dots_)
>>> x, float(rr)
(tensor([0.5000, 1.0000], dtype=torch.float64), 0.0)
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ...errors import DTypeError, ShapeError
from .csr_spmv import aligned16

__all__ = ["LAUNCHES", "PASS_LAUNCHES", "Workspace", "cg_step_plain",
           "direction", "dots", "pap", "takes", "update", "workspace"]

# Kernel launches per value type and per pass: plain integers, advanced
# only where a wrapper launches a kernel.
LAUNCHES = {"float32": 0, "float64": 0}
PASS_LAUNCHES = {"dots": 0, "pap": 0, "update": 0, "direction": 0}

# Blocks a launch at most (``csrc/cg_step.cu``'s kMaxBlocks): the partial
# sums of a workspace hold two a block.
MAX_BLOCKS = 132 * 4

_ENTRY = {torch.float32: ("f32", "float32"), torch.float64: ("f64", "float64")}


class Workspace(NamedTuple):
    """A solve's scratch for the kernels' sums: the blocks' partial sums
    and the ticket that elects the last block (0 between launches)."""
    partial: torch.Tensor
    ticket: torch.Tensor


def workspace(like: torch.Tensor) -> Workspace:
    """A workspace for vectors like ``like`` (its dtype and device)."""
    return Workspace(
        torch.empty(2 * MAX_BLOCKS, dtype=like.dtype, device=like.device),
        torch.zeros(1, dtype=torch.int32, device=like.device))


def takes(*vectors: torch.Tensor) -> bool:
    """Whether the kernels take these n-vectors: on one CUDA card, 1-D,
    contiguous, of one length and one type, float32 or float64."""
    v0 = vectors[0]
    return (v0.device.type == "cuda" and v0.dtype in _ENTRY
            and all(v.ndim == 1 and v.is_contiguous() and v.dtype == v0.dtype
                    and v.device == v0.device and v.shape == v0.shape
                    for v in vectors))


def cg_step_plain(x, r, p, ap, rz, psolve, dots):
    """The torch step: ``(x', r', p', rz', rr)`` after ``ap = A·p``, each
    a new tensor. ``psolve`` applies the preconditioner (the identity for
    none); ``dots`` gives a list of dot products (``linalg/cg.py::_dots``:
    summed over a ``DistCsr``'s ranks)."""
    (pap_,) = dots([(p, ap)])
    alpha = rz / pap_
    x = x + alpha * p
    r = r - alpha * ap
    z = psolve(r)
    rz_next, rr = dots([(r, z), (r, r)])
    p = z + (rz_next / rz) * p
    return x, r, p, rz_next, rr


def _checked(name: str, *vectors, inv=None, scalars=(), ws=None) -> str:
    """Raise on operands the kernel does not take; the entry point's type
    suffix."""
    vectors = vectors + (() if inv is None else (inv,))
    if not takes(*vectors):
        raise DTypeError(
            f"cg_step {name} takes contiguous 1-D float32 or float64 "
            f"n-vectors of one type on one card, got "
            f"{[(v.dtype, v.device, tuple(v.shape)) for v in vectors]}")
    v0 = vectors[0]
    for s in scalars:
        if s.numel() != 1 or s.dtype != v0.dtype or s.device != v0.device:
            raise ShapeError(f"cg_step {name}: a scalar operand must be one "
                             f"{v0.dtype} value on {v0.device}, got "
                             f"{s.dtype} {tuple(s.shape)} on {s.device}")
    if ws is not None and (ws.partial.dtype != v0.dtype
                           or ws.partial.device != v0.device
                           or ws.ticket.device != v0.device):
        raise ValueError(f"cg_step {name}: a workspace for {v0.dtype} on "
                         f"{v0.device}, got {ws.partial.dtype} on "
                         f"{ws.partial.device}")
    return _ENTRY[v0.dtype][0]


def _count(name: str, v: torch.Tensor) -> None:
    LAUNCHES[_ENTRY[v.dtype][1]] += 1
    PASS_LAUNCHES[name] += 1


def _args(*vectors):
    """``(pack width, stream)`` for a launch on these vectors' card."""
    v0 = vectors[0]
    vec = (16 // v0.element_size()
           if all(aligned16(v) for v in vectors if v is not None) else 1)
    return vec, torch.cuda.current_stream(v0.device).cuda_stream


def _ptr(t):
    return None if t is None else t.data_ptr()


def dots(r: torch.Tensor, inv, ws: Workspace) -> torch.Tensor:
    """The first residual's ``[r·z, r·r]``, ``z = inv·r`` (``r`` where
    ``inv`` is None), as a new 2-element tensor."""
    from ._build import launch

    suffix = _checked("dots", r, inv=inv, ws=ws)
    out = torch.empty(2, dtype=r.dtype, device=r.device)
    vec, stream = _args(r, inv)
    with torch.cuda.device(r.device):
        launch(f"spal_cg_dots_{suffix}", r.data_ptr(), _ptr(inv),
               ws.partial.data_ptr(), ws.partial.numel(), ws.ticket.data_ptr(),
               out.data_ptr(), r.numel(), vec, stream)
    _count("dots", r)
    return out


def pap(p: torch.Tensor, ap: torch.Tensor, ws: Workspace) -> torch.Tensor:
    """``p·ap`` as a new 1-element tensor."""
    from ._build import launch

    suffix = _checked("pap", p, ap, ws=ws)
    out = torch.empty(1, dtype=p.dtype, device=p.device)
    vec, stream = _args(p, ap)
    with torch.cuda.device(p.device):
        launch(f"spal_cg_pap_{suffix}", p.data_ptr(), ap.data_ptr(),
               ws.partial.data_ptr(), ws.partial.numel(), ws.ticket.data_ptr(),
               out.data_ptr(), p.numel(), vec, stream)
    _count("pap", p)
    return out


def update(r, ap, inv, rz, pap_, ws: Workspace) -> torch.Tensor:
    """``[r·z, r·r]`` as a new 2-element tensor after ``r -= alpha·ap`` in
    place, ``alpha = rz / pap_``, ``z = inv·r`` (``r`` where ``inv`` is
    None). ``rz`` and ``pap_`` are one-value tensors on the card."""
    if r.numel() and r.data_ptr() == ap.data_ptr():
        raise ValueError("cg_step update: r shares memory with ap")
    from ._build import launch

    suffix = _checked("update", r, ap, inv=inv, scalars=(rz, pap_), ws=ws)
    out = torch.empty(2, dtype=r.dtype, device=r.device)
    vec, stream = _args(r, ap, inv)
    with torch.cuda.device(r.device):
        launch(f"spal_cg_update_{suffix}", r.data_ptr(), ap.data_ptr(),
               _ptr(inv), rz.data_ptr(), pap_.data_ptr(),
               ws.partial.data_ptr(), ws.partial.numel(), ws.ticket.data_ptr(),
               out.data_ptr(), r.numel(), vec, stream)
    _count("update", r)
    return out


def direction(x, r, p, inv, rz, pap_, rz_next) -> torch.Tensor:
    """``x' = x + (rz / pap_)·p`` (a new tensor, from the old ``p``), then
    ``p = z + (rz_next / rz)·p`` in place, ``z = inv·r`` (``r`` where
    ``inv`` is None); ``rz``, ``pap_`` and ``rz_next`` are one-value
    tensors on the card."""
    if p.numel() and p.data_ptr() in (x.data_ptr(), r.data_ptr()):
        raise ValueError("cg_step direction: p shares memory with x or r")
    from ._build import launch

    suffix = _checked("direction", x, r, p, inv=inv,
                      scalars=(rz, pap_, rz_next))
    x_out = torch.empty_like(x)
    vec, stream = _args(x, x_out, r, p, inv)
    with torch.cuda.device(p.device):
        launch(f"spal_cg_direction_{suffix}", x.data_ptr(), x_out.data_ptr(),
               r.data_ptr(), p.data_ptr(), _ptr(inv), rz.data_ptr(),
               pap_.data_ptr(), rz_next.data_ptr(), p.numel(), vec, stream)
    _count("direction", p)
    return x_out
