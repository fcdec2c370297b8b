"""The ``cg_dist`` loop (``spbench/loops/cg_dist.py``) at a toy size, run as
a gang through ``run.py``'s launcher: the loop's set-up, units and check
on every rank, with the cell's own traffic, limits and readers.

    python3 spbench/tests/gang_cg_dist.py --world 4 --seed 1 \\
        --seconds 0.5 [--trace 1] [--grid 6 5 4] [--maxiter 5] \\
        [--drop-halo] [--device cuda]

``--grid`` is a rank's slab (ranks stacked along z). ``--drop-halo`` plants
a fault under the timed path in every rank: the distributed product gets
zero slabs in place of its neighbours' entries, as if the halo exchange
had been left out; the check must then fail.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import copy  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[2]
CELL = "hpcg-256-x4.dcg50"


def cell(world: int, grid, maxiter: int):
    """The real cell, its grid cut to ``world`` slabs of ``grid``."""
    from spbench import harness

    real = harness.load_cell(CELL)
    out = copy.deepcopy(real)
    out.name = "toy.cg_dist"
    out.chips = world
    nx, ny, nz = grid
    out.config = dict(real.config, grid=[nx, ny, nz * world], ranks=world)
    out.traffic = dict(real.traffic, maxiter=maxiter)
    return out


def drop_halo() -> None:
    """The distributed product's operand with zero slabs where its
    neighbours' entries belong."""
    import torch
    from spalinalg_tpu_torch.parallel import spmv

    exchange = spmv._operand

    def operand(d, x):
        if d.comm != "halo" or d.halo_width == 0:
            return exchange(d, x)
        slab = x.new_zeros((d.halo_width,) + tuple(x.shape[1:]))
        return torch.cat([slab, x, slab])

    spmv._operand = operand


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--world", type=int, required=True)
    p.add_argument("--device", choices=("cpu", "cuda"), default="cpu")
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--grid", type=int, nargs=3, default=(6, 5, 4))
    p.add_argument("--maxiter", type=int, default=5)
    p.add_argument("--drop-halo", action="store_true")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from spbench import gang, run

    if args.drop_halo and gang.Member.from_env() is not None:
        drop_halo()
    if args.device == "cuda":
        device_of = lambda i: torch.device("cuda", i)  # noqa: E731
    else:
        device_of = lambda i: torch.device("cpu")  # noqa: E731
    return run.run(cell(args.world, args.grid, args.maxiter), args.seed,
                   args.seconds, bool(args.trace), T_START, device_of,
                   [sys.executable, str(Path(__file__).resolve()), *argv])


if __name__ == "__main__":
    sys.exit(main())
