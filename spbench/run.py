"""Run one cell of the benchmark of ``spalinalg_tpu_torch`` on this
machine's CUDA cards:

    python3 spbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout. The last line of standard output is the
result (JSON); the numbers the output check compared, each with its limit,
are the last lines of standard error. Exits non-zero, with no result, when
the cell's cards are missing, when the run loaded JAX or the JAX package,
or when anything fails.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
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


def main(argv=None) -> int:
    args = _args(argv)
    _caches()
    sys.path.insert(0, str(ROOT))
    import torch

    from spbench import harness

    imported = time.time() - T_START

    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    print("card: " + harness.power_limit(), flush=True)
    out = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                           T_START, device,
                           print_fn=lambda s: print(s, flush=True),
                           imported_s=imported)
    found = harness.forbidden_modules()
    if found:
        print(f"sys.modules holds {', '.join(found)}", file=sys.stderr)
        return 4
    harness.emit(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
