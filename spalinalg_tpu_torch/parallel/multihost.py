"""Multi-process runtime: initialization, heartbeat, topology (counterpart
of ``spalinalg_tpu/parallel/multihost.py``).

Jobs are SPMD and gang-scheduled: one process a card, every process runs
the same program over one process group (launched by ``torchrun`` or by
hand). Failure handling is minimal and explicit:

- :func:`initialize` wraps ``torch.distributed.init_process_group`` with a
  timeout: a missing peer surfaces as a ``RuntimeError`` at the
  rendezvous instead of a hang;
- :func:`heartbeat` is an ``all_reduce`` of ones over the group: it checks
  that the gang is alive and measures the collective's latency. With no
  process group it is the one-rank case: a sync of this process's device;
- recovery is a restart from a checkpoint: ``io.save_npz`` of a
  ``DistCsr`` writes this rank's shard, ``io.load_npz(path, mesh=mesh)``
  reads it back on the same world size. No elasticity.

The backend follows the device: NCCL for the card, gloo where the caller
asks for the CPU (``device="cpu"`` or a ``default_device("cpu")`` scope).
"""

from __future__ import annotations

import time
from datetime import timedelta
from typing import Optional

import torch
import torch.distributed as dist

from ..device import resolve_device
from .partition import _BACKEND

__all__ = ["initialize", "heartbeat", "global_device_summary"]


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    timeout_s: int = 300,
    device=None,
) -> None:
    """Join the process group (a no-op for single-process runs:
    ``num_processes`` in ``(None, 0, 1)``).

    ``coordinator_address`` is an ``init_method`` URL (``tcp://host:port``
    or ``file:///path``; a bare ``host:port`` means TCP). Raises
    ``RuntimeError`` if the gang does not assemble within ``timeout_s``.
    """
    if num_processes in (None, 0, 1):
        return
    if coordinator_address and "://" not in coordinator_address:
        coordinator_address = f"tcp://{coordinator_address}"
    backend = _BACKEND[resolve_device(device).type]
    try:
        dist.init_process_group(
            backend, init_method=coordinator_address,
            world_size=num_processes, rank=process_id,
            timeout=timedelta(seconds=timeout_s))
    except Exception as e:  # surface as a detection event
        raise RuntimeError(
            f"distributed initialization failed after {timeout_s}s — "
            f"gang incomplete or coordinator unreachable: {e}") from e


def _group_device() -> torch.device:
    """The device the default group's collectives run on: this process's
    card under NCCL, the CPU under gloo."""
    if "nccl" in dist.get_backend():
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def heartbeat(timeout_s: float = 60.0) -> float:
    """Liveness barrier over every rank of the default group; returns the
    collective's latency in seconds (an ``all_reduce`` of ones, read
    back). A wrong sum or a slow answer raises ``RuntimeError``.

    With no process group, as in a plain single process, it times a no-op
    sync on the device this process places data on
    (:func:`~spalinalg_tpu_torch.device.resolve_device`): a one read back
    from it, as the JAX ``heartbeat`` of one process does."""
    grouped = dist.is_initialized()
    n = dist.get_world_size() if grouped else 1
    one = torch.ones(1, device=_group_device() if grouped
                     else resolve_device())
    t0 = time.perf_counter()
    if grouped:
        dist.all_reduce(one)
    val = float(one[0])
    dt = time.perf_counter() - t0
    if val != n:
        raise RuntimeError(
            f"heartbeat all_reduce returned {val}, expected {n}: gang "
            "degraded")
    if dt > timeout_s:
        raise RuntimeError(f"heartbeat took {dt:.1f}s (> {timeout_s}s)")
    return dt


def global_device_summary() -> dict:
    """Structured snapshot for logs: process and device topology (one
    device a process; without a process group, this process alone and
    the device it places data on)."""
    if not dist.is_initialized():
        return {"process_index": 0, "process_count": 1,
                "local_devices": [str(resolve_device())],
                "global_device_count": 1}
    return {
        "process_index": dist.get_rank(),
        "process_count": dist.get_world_size(),
        "local_devices": [str(_group_device())],
        "global_device_count": dist.get_world_size(),
    }
