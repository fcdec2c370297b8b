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
numbers. A cell on several cards runs one gang a seed through the
launcher that ``run.py`` uses (``spbench/gang.py``); rank 0 prints the
line.
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

    from spbench import faults, gang, harness

    cell = harness.load_cell(args.workload)
    me = gang.Member.from_env()
    if me is None and (not torch.cuda.is_available()
                       or torch.cuda.device_count() < cell.chips):
        print(f"readings of {cell.name} are taken on {cell.chips} CUDA "
              "card(s)", file=sys.stderr)
        return 3
    if me is None and cell.chips > 1:
        for seed in args.seeds:
            rc, line = gang.launch(
                [sys.executable, str(Path(__file__).resolve()),
                 "--workload", cell.name, "--what", args.what, "--seeds",
                 str(seed), "--seconds", str(args.seconds)],
                cell.chips, time.time())
            if rc != 0:
                return rc
            print(line, flush=True)
        return 0
    kind = cell.traffic["loop"]
    loop = harness.loop_module(kind)
    device = torch.device("cuda", 0 if me is None else me.local)
    torch.cuda.set_device(device)
    team = None if me is None else gang.join(me, device)
    for seed in args.seeds:
        t0 = time.time()
        if args.what == "control":
            ctx = harness.Context(cell=cell, seed=seed, device=device,
                                  tracer=None)
            if team is not None:
                ctx.rank, ctx.world, ctx.group = team.rank, team.world, \
                    team.group
            nums = loop.control(ctx)
            notes = ctx.notes
        else:
            with _planted(faults, kind, args.what):
                out = harness.run_cell(cell, seed, args.seconds, False,
                                       time.time(), device,
                                       print_fn=lambda s: None, gang=team)
            if out is not None:
                nums = {k: c["value"] for k, c in out["checks"].items()}
                notes = out["notes"]
        if me is None or me.rank == 0:
            print(json.dumps({"workload": cell.name, "what": args.what,
                              "seed": seed, "numbers": nums, "notes": notes,
                              "seconds": time.time() - t0}), flush=True)
        torch.cuda.empty_cache()
    if team is not None:
        gang.leave()
    return 0


def _planted(faults, kind: str, what: str):
    """The fault ``what`` of loop ``kind``, or none for ``program``."""
    if what == "program":
        return contextlib.nullcontext()
    return faults.FAULTS[kind][what]()


if __name__ == "__main__":
    sys.exit(main())
