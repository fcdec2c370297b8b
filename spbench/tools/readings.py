"""The readings that a cell's output limits are set from, on the card at
the cell's own size, several seeds in one process:

    python3 spbench/tools/readings.py --workload <cell> --what control \\
        --seeds 1 2 3
    python3 spbench/tools/readings.py --workload <cell> --what <fault> \\
        --seeds 1 2 3 [--seconds 2]

``control``: the plain reference one precision down in the program's
place (no program runs). ``program``: sound runs of the cell. A fault
name (``spbench/faults.py``): a run of the cell with that fault planted
under the timed path. Each seed prints one JSON line of the compared
numbers.
"""

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--what", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from spbench import faults, harness

    if not torch.cuda.is_available():
        print("readings are taken on a CUDA card", file=sys.stderr)
        return 3
    cell = harness.load_cell(args.workload)
    kind = cell.traffic["loop"]
    loop = harness.loop_module(kind)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    for seed in args.seeds:
        t0 = time.time()
        if args.what == "control":
            ctx = harness.Context(cell=cell, seed=seed, device=device,
                                  tracer=None)
            nums = loop.control(ctx)
            notes = ctx.notes
        else:
            with _planted(faults, kind, args.what):
                out = harness.run_cell(cell, seed, args.seconds, False,
                                       time.time(), device,
                                       print_fn=lambda s: None)
            nums = {k: c["value"] for k, c in out["checks"].items()}
            notes = out["notes"]
        print(json.dumps({"workload": cell.name, "what": args.what,
                          "seed": seed, "numbers": nums, "notes": notes,
                          "seconds": time.time() - t0}), flush=True)
        torch.cuda.empty_cache()
    return 0


def _planted(faults, kind: str, what: str):
    """The fault ``what`` of loop ``kind``, or none for ``program``."""
    if what == "program":
        return contextlib.nullcontext()
    return faults.FAULTS[kind][what]()


if __name__ == "__main__":
    sys.exit(main())
