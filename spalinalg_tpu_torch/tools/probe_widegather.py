"""Probe: the rate of wide gathers on the card, and the kernel behind it.

Counterpart of the JAX package's ``tools/probe_widegather.py``, whose
Pallas kernel asked whether the TPU's lane gather lowers from an operand
wider than its 128 output lanes. The function is the same at the same
shapes:

    out[s, l] = Σ_{k < TAKES} xt[s, idx[k, l]] · val[k, l]

with ``xt`` (NCOL, N) float32, ``idx`` (TAKES, 128) int32, ``val``
(TAKES, 128) float32 and ``out`` (NCOL, 128); an index outside ``[0, N)``
reads 0, as the TPU tool's ``FILL_OR_DROP`` gather does.

- :func:`wide_gather_mac` launches the Hopper kernel
  (``spalinalg_tpu_torch/csrc/wide_gather.cu``) for CUDA tensors, or raises;
  for CPU tensors it runs :func:`wide_gather_mac_plain`. Each launch adds
  one to ``LAUNCHES["float32"]``.
- :func:`main` checks the kernel against the plain version and prints the
  time per take and the gathered elements per second, timed with CUDA
  events, and the launch floor (:func:`launch_floor_us`). Run on a machine
  with a card:

      python -m spalinalg_tpu_torch.tools.probe_widegather

>>> import torch
>>> xt = torch.arange(6.0).reshape(2, 3)
>>> idx = torch.tensor([[2, 5], [0, 1]], dtype=torch.int32)
>>> val = torch.ones(2, 2)
>>> wide_gather_mac(xt, idx, val)
tensor([[2., 1.],
        [8., 4.]])
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from ..device import resolve_device
from ..errors import DTypeError, ShapeError

__all__ = ["LAUNCHES", "N", "NCOL", "TAKES", "LANES", "SPLIT", "WARMUP",
           "TIMED", "inputs", "launch_floor_us", "main", "run",
           "wide_gather_mac", "wide_gather_mac_plain"]

N = 16384          # operand columns (the TPU tool's lanes)
NCOL = 64          # operand rows (right-hand-side columns)
TAKES = 256        # gathers accumulated per output entry
LANES = 128        # output columns
# The kernel's order of summation (``csrc/wide_gather.cu``, ``kSplit``):
# each output sums SPLIT runs of consecutive takes, each in order, then adds
# the runs' sums in order. The plain version sums all takes in order; the
# two may differ in the last bits.
SPLIT = 8
WARMUP = 3         # launches before the timed run
TIMED = 100        # timed launches
# A spin of the card's clock queued before the timed launches (about 25 ms
# on an H100), so that the host enqueues all of them while it runs and the
# events time the kernels back to back, not the host's launch rate (a
# launch from Python takes tens of microseconds, as long as the kernel).
SPIN_CYCLES = 50_000_000

# Kernel launches: a plain integer, advanced only where the wrapper
# launches the kernel.
LAUNCHES = {"float32": 0}


def wide_gather_mac_plain(xt, idx, val) -> torch.Tensor:
    """Plain torch version: one gather, mask and multiply-add per take, in
    the order k = 0..K-1 of the TPU kernel's accumulation. Runs on any
    device."""
    n = xt.shape[1]
    ok = (idx >= 0) & (idx < n)
    safe = torch.where(ok, idx, 0).long()
    acc = xt.new_zeros((xt.shape[0], idx.shape[1]))
    for k in range(idx.shape[0]):
        hk = torch.where(ok[k], xt[:, safe[k]], 0.0)
        acc = acc + hk * val[k]
    return acc


def wide_gather_mac(xt, idx, val) -> torch.Tensor:
    """``out[s, l] = Σ_k xt[s, idx[k, l]]·val[k, l]``: the kernel on CUDA
    tensors, the plain version on CPU tensors. ``xt`` and ``val`` are
    float32, ``idx`` int32; devices and shapes are checked."""
    if (xt.dtype != torch.float32 or val.dtype != torch.float32
            or idx.dtype != torch.int32):
        raise DTypeError(
            f"wide_gather_mac takes float32 xt and val and int32 idx, got "
            f"{xt.dtype}, {val.dtype}, {idx.dtype}")
    if (xt.ndim != 2 or idx.ndim != 2 or tuple(val.shape) != tuple(idx.shape)):
        raise ShapeError(
            f"wide_gather_mac shapes: xt {tuple(xt.shape)}, idx "
            f"{tuple(idx.shape)}, val {tuple(val.shape)}")
    devices = {t.device for t in (xt, idx, val)}
    if len(devices) != 1:
        raise ValueError(f"wide_gather_mac operands on several devices: "
                         f"{devices}")
    device = xt.device
    if device.type == "cpu":
        return wide_gather_mac_plain(xt, idx, val)
    if device.type != "cuda":
        raise ValueError(f"no wide_gather kernel for device {device}")
    from ..ops.kernels._build import launch

    xt, idx, val = xt.contiguous(), idx.contiguous(), val.contiguous()
    (s, n), (k, lanes) = xt.shape, idx.shape
    out = torch.empty((s, lanes), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        launch("spal_wide_gather_f32", xt.data_ptr(), idx.data_ptr(),
               val.data_ptr(), out.data_ptr(), s, n, k, lanes,
               torch.cuda.current_stream(device).cuda_stream)
    LAUNCHES["float32"] += 1
    return out


def inputs(device, seed: int = 0):
    """The tool's inputs, drawn with NumPy from ``seed`` as the TPU tool
    draws them, on ``device``: ``(xt, idx, val)``."""
    rng = np.random.default_rng(seed)
    xt = rng.normal(size=(NCOL, N)).astype(np.float32)
    idx = rng.integers(0, N, size=(TAKES, LANES)).astype(np.int32)
    val = rng.normal(size=(TAKES, LANES)).astype(np.float32)
    return tuple(torch.from_numpy(a).to(device) for a in (xt, idx, val))


def _card(device):
    device = resolve_device(device)
    if device.type != "cuda":
        raise ValueError(f"the probe times the kernel on a card, not on "
                         f"{device}")
    return device


def _us_per_call(xt, idx, val) -> float:
    """Microseconds a call: WARMUP launches, then TIMED launches queued
    behind a spin of the card and timed with CUDA events."""
    for _ in range(WARMUP):
        wide_gather_mac(xt, idx, val)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(TIMED):
        wide_gather_mac(xt, idx, val)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) * 1e3 / TIMED


def launch_floor_us(device=None, seed: int = 0) -> float:
    """Microseconds a call of the kernel at one operand row and one take (S
    = 1, K = 1; the tool's N and L), timed as :func:`run` times the tool's
    shapes: what a launch of the kernel costs with almost no work, below
    which no call comes, whatever its bound."""
    xt, idx, val = inputs(_card(device), seed)
    return _us_per_call(xt[:1].contiguous(), idx[:1].contiguous(),
                        val[:1].contiguous())


def run(device=None, seed: int = 0) -> dict:
    """Check the kernel against the plain version at the tool's shapes and
    time it: ``1 + WARMUP + TIMED`` launches on ``device`` (``None``: the
    default device), which must be a card. Returns the
    output, the relative error, and the microseconds per take, per call and
    the Gelem/s gathered."""
    xt, idx, val = inputs(_card(device), seed)
    out = wide_gather_mac(xt, idx, val)
    ref = wide_gather_mac_plain(xt, idx, val)
    err = float((out - ref).abs().max() / (ref.abs().max() + 1e-9))
    per_call_us = _us_per_call(xt, idx, val)
    per_take_us = per_call_us / TAKES
    return {"out": out, "rel_err": err, "us_per_call": per_call_us,
            "us_per_take": per_take_us,
            "gelem_per_s": NCOL * LANES / (per_take_us * 1e-6) / 1e9}


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_widegather: no CUDA device; the probe times the kernel "
              "on a card", file=sys.stderr)
        return 1
    res = run()
    print(f"wide gather OK, rel err {res['rel_err']:.2e}")
    print(f"per take {res['us_per_take']:.3f} us -> "
          f"{res['gelem_per_s']:.1f} Gelem/s gathered")
    print(f"{res['us_per_call']:.3f} us a call; launch floor (S = 1, K = 1) "
          f"{launch_floor_us():.3f} us")
    print(json.dumps({k: v for k, v in res.items() if k != "out"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
