"""A cell on several cards: one process a card, started by ``run.py``.

The launcher (:func:`launch`) starts ``world`` copies of the run's own
command, rank ``r`` on card ``r``, each with ``RANK``, ``LOCAL_RANK``,
``WORLD_SIZE``, ``MASTER_ADDR``, a free ``MASTER_PORT`` and the launcher's
start time, so that ``setup_s`` counts from the launcher's start as it
does for one card. It forwards every line the ranks print to its standard
error as ``[rank r] ...``, keeps rank 0's last line of standard output
(the result) back for the caller, and ends the whole gang, within
``KILL_GRACE_S`` seconds, as soon as one rank exits non-zero.

In each rank (:func:`join`) the harness starts the default process group
(NCCL on the card, gloo on the CPU), which the port's ``make_row_mesh``
then finds and uses, and a gloo group of its own, :class:`Gang`, that
carries the harness's agreements and gathers on the host, so that none of
its traffic lands on a card's streams. Every group waits at most
``GROUP_TIMEOUT`` in a collective.
"""

from __future__ import annotations

import datetime
import os
import signal
import socket
import subprocess
import sys
import threading
import time
from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist

T0_ENV = "SPBENCH_GANG_T0"
# the longest a rank waits for the others in one collective: set-up skew
# between ranks (a first run builds the kernels in every rank at once)
# stays well inside it
GROUP_TIMEOUT = datetime.timedelta(seconds=300)
KILL_GRACE_S = 10.0


@dataclass(frozen=True)
class Member:
    """This process's place in a gang, from the launcher's environment."""

    rank: int
    world: int
    local: int
    t_start: float

    @classmethod
    def from_env(cls, env=None) -> Optional["Member"]:
        """The member this process is, or None outside a gang."""
        env = os.environ if env is None else env
        if T0_ENV not in env:
            return None
        return cls(rank=int(env["RANK"]), world=int(env["WORLD_SIZE"]),
                   local=int(env["LOCAL_RANK"]), t_start=float(env[T0_ENV]))


@dataclass
class Gang:
    """The harness's side of a gang: host-side agreements and gathers over
    a gloo group of its own."""

    rank: int
    world: int
    group: object

    def barrier(self) -> None:
        dist.barrier(group=self.group)

    def agree(self, flag: bool) -> bool:
        """Rank 0's ``flag``, on every rank."""
        t = torch.tensor([int(flag)], dtype=torch.int32)
        dist.broadcast(t, src=0, group=self.group)
        return bool(t.item())

    def gather(self, obj) -> Optional[list]:
        """Every rank's ``obj`` in rank order on rank 0; None elsewhere."""
        out = [None] * self.world if self.rank == 0 else None
        dist.gather_object(obj, out, dst=0, group=self.group)
        return out


def join(member: Member, device: torch.device) -> Gang:
    """Start this rank's process groups: the default one on ``device``
    (NCCL, bound to the card; gloo on the CPU) and the harness's gloo
    group."""
    kw = {}
    backend = "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device)
        backend, kw = "nccl", {"device_id": device}
    dist.init_process_group(backend, init_method="env://", rank=member.rank,
                            world_size=member.world, timeout=GROUP_TIMEOUT,
                            **kw)
    group = dist.new_group(backend="gloo", timeout=GROUP_TIMEOUT)
    return Gang(rank=member.rank, world=member.world, group=group)


def leave() -> None:
    """Every rank past its last collective, then the groups closed."""
    if dist.is_initialized():
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class _Out:
    """Forwards a rank's lines to standard error as ``[rank r] ...``;
    where ``hold_last``, the last line is kept back instead."""

    def __init__(self, rank: int, stream, lock, hold_last: bool):
        self.last = None
        self._thread = threading.Thread(
            target=self._pump, args=(rank, stream, lock, hold_last),
            daemon=True)
        self._thread.start()

    def _pump(self, rank, stream, lock, hold_last):
        pending = None
        for line in stream:
            line = line.rstrip("\n")
            if hold_last:
                line, pending = pending, line
                if line is None:
                    continue
            with lock:
                print(f"[rank {rank}] {line}", file=sys.stderr, flush=True)
        self.last = pending

    def join(self, timeout: float) -> None:
        self._thread.join(timeout)


def _end(procs) -> None:
    """SIGTERM to every live rank's process group, SIGKILL to what is left
    after ``KILL_GRACE_S``; waits for each."""
    for sig, grace in ((signal.SIGTERM, KILL_GRACE_S), (signal.SIGKILL, 30)):
        live = [p for p in procs if p.poll() is None]
        for p in live:
            try:
                os.killpg(p.pid, sig)
            except ProcessLookupError:
                pass
        deadline = time.monotonic() + grace
        for p in live:
            try:
                p.wait(max(deadline - time.monotonic(), 0.01))
            except subprocess.TimeoutExpired:
                pass


def launch(cmd: list, world: int, t_start: float) -> tuple:
    """Run ``cmd`` as a gang of ``world`` ranks, rank ``r`` on card ``r``;
    ``(exit code, rank 0's last line of standard output or None)``. The
    code is the first non-zero one a rank gave, or 0 where every rank
    exited 0."""
    env = dict(os.environ, MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(_free_port()), WORLD_SIZE=str(world),
               **{T0_ENV: repr(t_start)})
    lock = threading.Lock()
    procs, outs = [], []

    def stop(signum, frame):
        raise SystemExit(128 + signum)

    previous = signal.signal(signal.SIGTERM, stop)
    try:
        for r in range(world):
            p = subprocess.Popen(
                cmd, env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                stdin=subprocess.DEVNULL, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True, process_group=0)
            procs.append(p)
            outs += [_Out(r, p.stdout, lock, hold_last=(r == 0)),
                     _Out(r, p.stderr, lock, hold_last=False)]
        rc = 0
        while True:
            codes = [p.poll() for p in procs]
            bad = [(r, c) for r, c in enumerate(codes) if c not in (None, 0)]
            if bad:
                r, c = bad[0]
                with lock:
                    print(f"rank {r} exited with {c}: ending the gang",
                          file=sys.stderr, flush=True)
                rc = c if c > 0 else 128 - c
                break
            if all(c == 0 for c in codes):
                break
            time.sleep(0.05)
    finally:
        _end(procs)
        signal.signal(signal.SIGTERM, previous)
    for o in outs:
        o.join(5.0)
    return rc, (outs[0].last if rc == 0 else None)
