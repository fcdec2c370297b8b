"""Time the BSR kernels at ``chip_smoke.py``'s main-path shapes.

For each matrix (tri128: 128 x 128 blocks, block-tridiagonal, 4096 block
rows, float32, bfloat16 and float64; banded8: 8 x 8 blocks at block
offsets -2..2, 65,536 block rows, the block pattern of ``chip_smoke.py``'s
banded matrix through ``to_bsr(8)``, float32 and float64) and product
(``bsr @ x``; ``bsr @ X`` with k = 64, and on tri128 also k = 16 and 32)
it prints one JSON line: the kernel's time, the time of
``torch.sparse_bsr_tensor(...) @ x`` on the same inputs (null for bfloat16
blocks, which torch takes only as a bfloat16 product), the kernel's max
|err| against its plain version, the variant that ran (where the package
has variants) and the package it measured. Launches are timed with CUDA
events behind a queued spin of the card, so that the host enqueues all of
them while the spin runs and the events time the card, not the host's
launch rate. Data is drawn on the card from a seeded generator.

Run it as a script, on a machine with a card; ``PYTHONPATH`` picks the
copy of ``spalinalg_tpu_torch`` it measures, so two versions of the
package compare in one session:

    PYTHONPATH=. python3 spalinalg_tpu_torch/tools/bench_bsr.py
    PYTHONPATH=path/to/other/checkout python3 spalinalg_tpu_torch/tools/bench_bsr.py
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import torch

TRI_NBR = 4096
TRI_BS = 128
BAND_NBR = 65536
BAND_BS = 8
K_MAIN = 64
K_SWEEP = (16, 32)
LAUNCHES = 20
SPIN_CYCLES = 50_000_000   # about 25 ms on an H100
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float64": torch.float64}


def block_pattern(nbr: int, offsets):
    """``(indptr, indices)`` of the block rows' columns ``i + o`` for each
    offset ``o`` that lies in ``[0, nbr)``."""
    indptr, indices = [0], []
    for i in range(nbr):
        indices.extend(i + o for o in offsets if 0 <= i + o < nbr)
        indptr.append(len(indices))
    return indptr, indices


def matrices(sp, device):
    """``{(shape, dtype): BsrMatrix}``, data drawn on the card."""
    gen = torch.Generator(device=device).manual_seed(11)
    out = {}
    for shape, nbr, bs, offsets, names in (
            ("tri128", TRI_NBR, TRI_BS, (-1, 0, 1), ("float32", "float64")),
            ("banded8", BAND_NBR, BAND_BS, (-2, -1, 0, 1, 2),
             ("float32", "float64"))):
        indptr, indices = block_pattern(nbr, offsets)
        n = nbr * bs
        for name in names:
            data = torch.randn((len(indices), bs, bs), generator=gen,
                               dtype=DTYPES[name], device=device)
            out[shape, name] = sp.BsrMatrix(n, n, bs, indptr, indices, data,
                                            device=device)
    out["tri128", "bfloat16"] = out["tri128", "float32"].astype(
        torch.bfloat16)
    return out, gen


def time_ms(fn, launches: int = LAUNCHES) -> float:
    """Milliseconds a call, ``launches`` calls timed with CUDA events behind
    a queued spin of the card, after one warm-up call."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(launches):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / launches


def variant_counts(mods) -> dict:
    return {k: v for m in mods for k, v in getattr(m, "VARIANT_LAUNCHES",
                                                   {}).items()}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--label", default="",
                        help="a name for this run, copied into each line")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("bench_bsr: no CUDA device; it times kernels on a card",
              file=sys.stderr)
        return 1
    import spalinalg_tpu_torch as sp
    from spalinalg_tpu_torch.ops.kernels import bsr_spmm as mm_mod
    from spalinalg_tpu_torch.ops.kernels import bsr_spmv as mv_mod

    device = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    mats, gen = matrices(sp, device)
    for (shape, name), bsr in mats.items():
        ip, ix, data = bsr.indptr, bsr.indices, bsr.data
        acc = torch.float64 if name == "float64" else torch.float32
        for k in (1, K_MAIN) + (K_SWEEP if shape == "tri128" else ()):
            size = (bsr.ncols,) if k == 1 else (bsr.ncols, k)
            rhs = torch.randn(size, generator=gen, dtype=acc, device=device)
            kern = mv_mod.bsr_spmv if k == 1 else mm_mod.bsr_spmm
            before = variant_counts((mv_mod, mm_mod))
            y = kern(ip, ix, data, rhs)
            after = variant_counts((mv_mod, mm_mod))
            ran = sorted(v for v in after if after[v] != before.get(v, 0))
            err = float((y - mv_mod.bsr_spmv_plain(ip, ix, data, rhs))
                        .abs().max())
            del y
            ms = time_ms(lambda: kern(ip, ix, data, rhs))
            lib_ms = None
            if name != "bfloat16":
                lib = torch.sparse_bsr_tensor(ip, ix, data, bsr.shape)
                lib_ms = time_ms(lambda: lib @ rhs)
                del lib
            print(json.dumps({
                "label": args.label, "shape": shape, "dtype": name, "k": k,
                "op": "bsr_spmv" if k == 1 else "bsr_spmm", "ms": ms,
                "library_ms": lib_ms, "max_abs_err": err,
                "variant": ran[0] if ran else None,
                "package": sp.__file__, "card": card}), flush=True)
            del rhs
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
