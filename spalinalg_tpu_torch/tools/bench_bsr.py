"""Time the BSR kernels at ``chip_smoke.py``'s main-path shapes.

For each matrix (tri128: 128 x 128 blocks, block-tridiagonal, 4096 block
rows, float32, bfloat16 and float64; banded8: 8 x 8 blocks at block
offsets -2..2, 65,536 block rows, the block pattern of ``chip_smoke.py``'s
banded matrix through ``to_bsr(8)``, float32 and float64; ex56: 3 x 3
float64 blocks in the pattern of PETSc ex56's elasticity operator at
160^3 elements, the benchmark's ``ex56-160`` (161^3 block rows, each node
coupled to its up to 27 neighbours), ``bsr @ x`` only) and product
(``bsr @ x``; ``bsr @ X`` with k = 64, and on tri128 also k = 16 and 32)
it prints one JSON line: the kernel's time, its plain version's time, the
time of ``torch.sparse_bsr_tensor(...) @ x`` on the same inputs (null for
bfloat16 blocks, which torch takes only as a bfloat16 product), the
kernel's max
|err| against its plain version, the variant that ran (where the package
has variants) and the package it measured; then, for banded8, the time of
a forward + backward ``bsr @ X`` step (autograd to the blocks and X).
Launches are timed with CUDA events behind a queued spin of the card, so
that the host enqueues all of them while the spin runs and the events time
the card, not the host's launch rate. Data is drawn on the card from a
seeded generator.

``--sweep`` times instead the SpMM's ``register`` and ``staged`` variants
of ``csrc/bsr_spmm.cu`` side by side, each named to the wrapper, on
a banded block pattern (block offsets -2..2) of square blocks br = bc in
{2, 4, 8, 16} at n = 2**19 rows, for k in {8, 16, 32, 64}, in float32,
float64 and (where a block row is 16 bytes) bfloat16 blocks: the crossover
that ``bsr_spmm_variant``'s thresholds follow. Each line also says whether
the two variants agree bitwise and which one ``bsr_spmm_variant`` picks.

Run it as a script, on a machine with a card; ``PYTHONPATH`` picks the
copy of ``spalinalg_tpu_torch`` it measures, so two versions of the
package compare in one session:

    PYTHONPATH=. python3 spalinalg_tpu_torch/tools/bench_bsr.py
    PYTHONPATH=path/to/other/checkout python3 spalinalg_tpu_torch/tools/bench_bsr.py
    PYTHONPATH=. python3 spalinalg_tpu_torch/tools/bench_bsr.py --sweep
"""

from __future__ import annotations

import argparse
import itertools
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
EX56_NODES = 161                # nodes a side: ex56 at -ne 160
KS = {"tri128": (1, K_MAIN) + K_SWEEP, "banded8": (1, K_MAIN), "ex56": (1,)}
LAUNCHES = 20
STEPS = 10
SWEEP_N = 2**19
SWEEP_BS = (2, 4, 8, 16)
SWEEP_K = (8, 16, 32, 64)
SWEEP_VARIANTS = ("register", "staged")
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


def grid27_pattern(m: int, device):
    """``(indptr, indices)`` (int32, on ``device``) of the block pattern of
    a 3-D grid of ``m`` nodes a side numbered ``(z·m + y)·m + x``: each
    node coupled to the nodes within one in x, y and z, in column
    order."""
    r = torch.arange(m, device=device)
    z, y, x = (t.reshape(-1) for t in torch.meshgrid(r, r, r, indexing="ij"))
    cols, valid = [], []
    for dz, dy, dx in itertools.product((-1, 0, 1), repeat=3):
        zz, yy, xx = z + dz, y + dy, x + dx
        valid.append((zz >= 0) & (zz < m) & (yy >= 0) & (yy < m)
                     & (xx >= 0) & (xx < m))
        cols.append((zz * m + yy) * m + xx)
    valid = torch.stack(valid, dim=1)
    indices = torch.stack(cols, dim=1)[valid].to(torch.int32)
    indptr = torch.zeros(m ** 3 + 1, dtype=torch.int32, device=device)
    indptr[1:] = torch.cumsum(valid.sum(dim=1), 0)
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
    indptr, indices = grid27_pattern(EX56_NODES, device)
    n = 3 * EX56_NODES ** 3
    data = torch.randn((indices.numel(), 3, 3), generator=gen,
                       dtype=torch.float64, device=device)
    out["ex56", "float64"] = sp.BsrMatrix._from_parts(n, n, 3, 3, indptr,
                                                      indices, data)
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


def sweep(sp, mm_mod, device, card: str, label: str) -> None:
    """One line per (block size, dtype, k): both SpMM variants' times."""
    gen = torch.Generator(device=device).manual_seed(13)
    for bs in SWEEP_BS:
        nbr = SWEEP_N // bs
        indptr, indices = block_pattern(nbr, (-2, -1, 0, 1, 2))
        ip = torch.tensor(indptr, dtype=torch.int32, device=device)
        ix = torch.tensor(indices, dtype=torch.int32, device=device)
        for name in ("float32", "bfloat16", "float64"):
            if bs * DTYPES[name].itemsize % 16:
                continue    # block rows not whole 16-byte loads: register
            acc = torch.float64 if name == "float64" else torch.float32
            data = torch.randn((len(indices), bs, bs), generator=gen,
                               dtype=acc, device=device).to(DTYPES[name])
            for k in SWEEP_K:
                X = torch.randn((SWEEP_N, k), generator=gen, dtype=acc,
                                device=device)
                ys = [mm_mod.bsr_spmm(ip, ix, data, X, variant=v)
                      for v in SWEEP_VARIANTS]
                ms = {v: time_ms(lambda v=v: mm_mod.bsr_spmm(
                    ip, ix, data, X, variant=v)) for v in SWEEP_VARIANTS}
                print(json.dumps({
                    "label": label, "sweep": True, "bs": bs, "dtype": name,
                    "k": k, **{f"{v}_ms": ms[v] for v in SWEEP_VARIANTS},
                    "bitwise": bool(torch.equal(*ys)),
                    "picks": mm_mod.bsr_spmm_variant(data, X),
                    "package": sp.__file__, "card": card}), flush=True)
                del X, ys
            del data
        torch.cuda.empty_cache()


def step_ms(bsr, X, G) -> float:
    """Milliseconds of a forward + backward ``bsr @ X`` step, gradients
    to the blocks and to X, timed like the kernels."""
    data = bsr.data.detach().requires_grad_(True)
    m = bsr.with_data(data)
    Xg = X.detach().requires_grad_(True)

    def step():
        data.grad = Xg.grad = None
        (m @ Xg).backward(G)

    return time_ms(step, STEPS)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--label", default="",
                        help="a name for this run, copied into each line")
    parser.add_argument("--sweep", action="store_true",
                        help="time both SpMM variants over block sizes, "
                             "dtypes and k instead")
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
    if args.sweep:
        sweep(sp, mm_mod, device, card, args.label)
        return 0
    mats, gen = matrices(sp, device)
    for (shape, name), bsr in mats.items():
        ip, ix, data = bsr.indptr, bsr.indices, bsr.data
        acc = torch.float64 if name == "float64" else torch.float32
        for k in KS[shape]:
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
            plain_ms = time_ms(
                lambda: mv_mod.bsr_spmv_plain(ip, ix, data, rhs), STEPS)
            lib_ms = None
            if name != "bfloat16":
                lib = torch.sparse_bsr_tensor(ip, ix, data, bsr.shape)
                lib_ms = time_ms(lambda: lib @ rhs)
                del lib
            print(json.dumps({
                "label": args.label, "shape": shape, "dtype": name, "k": k,
                "op": "bsr_spmv" if k == 1 else "bsr_spmm", "ms": ms,
                "plain_ms": plain_ms, "library_ms": lib_ms, "max_abs_err": err,
                "variant": ran[0] if ran else None,
                "package": sp.__file__, "card": card}), flush=True)
            del rhs
            torch.cuda.empty_cache()
    for name in ("float32", "float64"):
        bsr = mats["banded8", name]
        X, G = (torch.randn((bsr.ncols, K_MAIN), generator=gen,
                            dtype=bsr.data.dtype, device=device)
                for _ in range(2))
        before = variant_counts((mm_mod,))
        ms = step_ms(bsr, X, G)
        after = variant_counts((mm_mod,))
        print(json.dumps({
            "label": args.label, "shape": "banded8", "dtype": name,
            "k": K_MAIN, "op": "bsr_spmm fwd+bwd step", "ms": ms,
            "variants": {v: n - before.get(v, 0) for v, n in after.items()
                         if n != before.get(v, 0)},
            "package": sp.__file__, "card": card}), flush=True)
        del X, G
    return 0


if __name__ == "__main__":
    sys.exit(main())
