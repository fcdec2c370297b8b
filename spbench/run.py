"""Run one cell of the benchmark of ``spalinalg_tpu_torch`` on this
machine's CUDA cards:

    python3 spbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout. The last line of standard output is the
result (JSON); the numbers the output check compared, each with its limit,
are the last lines of standard error. Exits non-zero, with no result, when
the cell's cards are missing, when the run loaded JAX or the JAX package,
or when anything fails.

A cell on one card runs in this process, on card 0. A cell on several
cards makes this process the launcher of a gang (``spbench/gang.py``): it
starts the same command once a card, rank ``r`` on card ``r``, and prints
rank 0's result; every rank's other lines go to standard error as
``[rank r] ...``.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _caches() -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the port's kernels already build into ``build/kernels/`` there)."""
    build = ROOT / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")
    os.environ["SPALINALG_PLAN_CACHE"] = str(build / "plans")


def _args(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def run(cell, seed: int, seconds: float, trace: bool, t_start: float,
        device_of, cmd: list, imported_s: float = None) -> int:
    """One run of ``cell``, its result printed; the exit code. On one card
    it runs here on ``device_of(0)``. On several, outside a gang, this
    process launches ``cmd`` (this run's own command) as one; in a gang's
    rank ``r`` it runs on ``device_of(r)``, timed from the launcher's
    start."""
    import torch

    from spbench import gang, harness

    me = gang.Member.from_env()
    if me is None and cell.chips > 1:
        rc, line = gang.launch(cmd, cell.chips, t_start)
        if rc != 0:
            return rc
        if line is None or not line.startswith("{"):
            print("rank 0 printed no result", file=sys.stderr)
            return 5
        if _forbidden(harness):
            return 4
        harness.emit(json.loads(line))
        return 0
    device = device_of(0 if me is None else me.local)
    if device.type == "cuda":
        torch.cuda.set_device(device)
        print("card: " + harness.power_limit(), flush=True)
    team = None
    if me is not None:
        t_start = me.t_start
        team = gang.join(me, device)
    out = harness.run_cell(cell, seed, seconds, trace, t_start, device,
                           print_fn=lambda s: print(s, flush=True),
                           imported_s=imported_s, gang=team)
    if team is not None:
        gang.leave()
    if _forbidden(harness):
        return 4
    if out is not None:
        harness.emit(out)
    return 0


def _forbidden(harness) -> bool:
    """Whether this process holds JAX or the JAX package, said on stderr."""
    found = harness.forbidden_modules()
    if found:
        print(f"sys.modules holds {', '.join(found)}", file=sys.stderr)
    return bool(found)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = _args(argv)
    _caches()
    sys.path.insert(0, str(ROOT))
    import torch

    from spbench import gang, harness

    imported = time.time() - T_START

    cell = harness.load_cell(args.workload)
    if gang.Member.from_env() is None and (
            not torch.cuda.is_available()
            or torch.cuda.device_count() < cell.chips):
        print(f"{args.workload} needs {cell.chips} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    return run(cell, args.seed, args.seconds, bool(args.trace), T_START,
               lambda i: torch.device("cuda", i),
               [sys.executable, str(Path(__file__).resolve()), *argv],
               imported)


if __name__ == "__main__":
    sys.exit(main())
