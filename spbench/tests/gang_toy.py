"""A toy cell with a multi-rank loop, run as a gang through ``run.py``'s
launcher: the tests of the gang on the CPU (gloo), and the gang's own
soundness on the cards (NCCL).

    python3 spbench/tests/gang_toy.py --world 4 --device cuda \\
        --seed 1 --seconds 10 --trace 0 [--grid 128 128 128]

A unit is the port's ``dist_spmv`` in halo mode on HPCG's 27-point stencil
(``--grid`` a rank, ranks stacked along z), one ``all_reduce`` of the
product's sum and a read-back of it. The check holds the last unit's
product and sum against the operator applied without a matrix.
``--traffic`` (JSON) adds the faults the tests plant: ``slow_rank`` and
``slow_s`` (that rank's units take longer), ``fail_rank`` and
``fail_at`` (``setup``, ``unit`` or ``check`` raise there; ``killed``:
the rank kills itself mid-window), ``fail_after`` (the window's units
before a fault in ``unit``, default 3), ``sync_sleep_s`` (rank ``r`` ends its
traced window ``r`` times that later) and ``fake_peak`` (rank ``r``
reports ``1000·(r + 1)`` peak bytes); ``agreements`` (set-up times that
many agreements of the harness's kind back to back, after a barrier, and
prints the mean under ``notes:`` as ``agree_alone_us``).
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import signal  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parents[2]


def cell(world: int, grid, dtype: str, traffic: dict):
    from spbench import harness

    return harness.Cell(
        name="toy.gang", chips=world,
        config={"structure": "stencil27", "grid": list(grid),
                "dtype": dtype},
        traffic={"loop": "gang_toy", "trace_units": 3, "timed_units": 2,
                 **traffic},
        limits={"y_gap": 1e-12, "sum_gap": 1e-12},
        end_to_end=[{"name": "units_per_s", "unit": "1/s"},
                    {"name": "setup_s", "unit": "s"}],
        per_layer=[{"name": "trace_window_s", "unit": "s"}])


READERS = {"trace_window_s": lambda record: record.trace["window_s"]}


def _fault(st, where: str) -> None:
    tr = st.ctx.cell.traffic
    if tr.get("fail_rank") != st.ctx.rank:
        return
    if tr.get("fail_at") == where:
        raise RuntimeError(f"planted fault in {where}")
    if tr.get("fail_at") == "killed" and where == "unit":
        print(f"planted kill at {time.time()!r}", flush=True)
        os.kill(os.getpid(), signal.SIGKILL)


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def setup(ctx):
    import torch
    from spalinalg_tpu_torch import DeviceCoo
    from spalinalg_tpu_torch.parallel import (make_row_mesh, partition_csr,
                                              shard_vector)
    from spbench.structures import stencil27

    st = SimpleNamespace(ctx=ctx, count=0, iterations=0, warm=False)
    _fault(st, "setup")
    tr = ctx.cell.traffic
    nx, ny, nz = ctx.cell.config["grid"]
    nz *= ctx.world
    n = nx * ny * nz
    dtype = getattr(torch, ctx.cell.config["dtype"])
    rows, cols, vals = stencil27.triplets(nx, ny, nz, dtype=dtype,
                                          device=ctx.device)
    A = DeviceCoo(n, n, rows, cols, vals, device=ctx.device).to_csr_device()
    del rows, cols, vals
    st.d = partition_csr(A, make_row_mesh(device=ctx.device), comm="halo")
    del A
    gen = torch.Generator(device=ctx.device)
    gen.manual_seed(int(ctx.seed))
    st.x = torch.rand(n, generator=gen, device=ctx.device, dtype=dtype) + 0.5
    st.x_local = shard_vector(st.x, st.d)
    st.grid = (nx, ny, nz)
    unit(st)                                 # the warm-up
    sync(st)
    if tr.get("agreements"):
        import torch.distributed as dist
        flag = torch.zeros(1, dtype=torch.int32)
        dist.barrier(group=ctx.group)
        t0 = time.perf_counter()
        for _ in range(int(tr["agreements"])):
            dist.broadcast(flag, src=0, group=ctx.group)
            flag.item()
        ctx.notes["agree_alone_us"] = (1e6 * (time.perf_counter() - t0)
                                       / int(tr["agreements"]))
    st.count = 0
    st.warm = True
    return st


def unit(st) -> None:
    import torch.distributed as dist
    from spalinalg_tpu_torch.parallel import dist_spmv

    tr = st.ctx.cell.traffic
    if st.warm and st.count == tr.get("fail_after", 3):
        _fault(st, "unit")
    if tr.get("slow_rank") == st.ctx.rank:
        time.sleep(float(tr["slow_s"]))
    st.y = dist_spmv(st.d, st.x_local)
    s = st.y.sum().reshape(1)
    dist.all_reduce(s)
    st.total = s.item()
    st.count += 1


def sync(st) -> None:
    _sync(st.ctx.device)
    time.sleep(float(st.ctx.cell.traffic.get("sync_sleep_s", 0))
               * st.ctx.rank)


def end_to_end(st, units: int, seconds: float) -> dict:
    return {"units_per_s": units / seconds}


def check(st, limits: dict) -> dict:
    """The last unit's product, gathered from every rank, and its summed
    total against the stencil applied in float64 on the host."""
    from spalinalg_tpu_torch.parallel import unshard_vector
    from spbench.structures import stencil27

    _fault(st, "check")
    y = unshard_vector(st.y, st.d).double().cpu()
    ref = stencil27.apply(st.x.double().cpu(), *st.grid)
    st.d = st.x_local = st.y = None
    nums = {"y_gap": float((y - ref).abs().max() / ref.abs().max()),
            "sum_gap": abs(st.total - float(ref.sum()))
            / float(ref.abs().sum())}
    return {k: {"value": v, "limit": limits[k]} for k, v in nums.items()}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--world", type=int, required=True)
    p.add_argument("--device", choices=("cpu", "cuda"), default="cpu")
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--grid", type=int, nargs=3, default=(8, 6, 4))
    p.add_argument("--dtype", default="float64")
    p.add_argument("--traffic", default="{}")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from spbench import gang, harness, run

    traffic = json.loads(args.traffic)
    me = gang.Member.from_env()
    harness.loop_module = lambda kind: sys.modules[__name__]
    harness.metric_reader = READERS.__getitem__
    if traffic.get("fake_peak") and me is not None:
        harness.peak_bytes = lambda device: 1000 * (me.rank + 1)
    if args.device == "cuda":
        if me is None and torch.cuda.device_count() < args.world:
            print(f"needs {args.world} CUDA cards", file=sys.stderr)
            return 3
        device_of = lambda i: torch.device("cuda", i)  # noqa: E731
    else:
        device_of = lambda i: torch.device("cpu")  # noqa: E731
    return run.run(cell(args.world, args.grid, args.dtype, traffic),
                   args.seed, args.seconds, bool(args.trace), T_START,
                   device_of,
                   [sys.executable, str(Path(__file__).resolve()), *argv])


if __name__ == "__main__":
    sys.exit(main())
