"""Time the CSR kernels at ``chip_smoke.py``'s main-path shapes.

Matrices: csr_random at n = 2**21 (32 columns a row, one in each of 32
column strata: the SpMV main path) and at n = 2**19 with k = 64 (the SpMM
main path), and the banded matrix of offsets -16..16 at n = 2**21 (SpMV:
the same entry count as csr_random, with x read about once instead of
gathered at random) and at n = 2**19 with k = 64, in float32 and float64,
drawn on the card from a seeded generator. For each it
prints one JSON line per product:

- ``csr_spmv`` (``A @ x``) and ``csr_spmm`` (``A @ X``): the kernel's time,
  the time of ``torch.sparse_csr_tensor(...) @ x`` on the same inputs, the
  kernel's max |err| against its plain version, and the variant that ran
  (where the package has variants);
- ``dvals``: the gradient with respect to the values as the package's
  backward computes it (the SDDMM kernel where the package has one, else
  its plain torch expression), beside ``torch.sparse.sampled_addmm``;
- ``step``: a forward + backward step through autograd (``A @ x`` or
  ``A @ X`` with gradients to the values and the operand).

``--spgemm`` times instead SpGEMM ``A·A`` in float32 and float64 on
config[2]'s power-law matrix of ``chip_smoke.py`` (zipf 1.8 row lengths
capped at 512, uniform columns, seed 1, n = 2**19) and on the 5-point
Laplacian of a 512 x 512 grid (``lap2d``: 25 terms a row of C). With the
plan cached, ``spgemm`` is a whole product ``a * a`` and
``spgemm_numeric`` the numeric kernel alone. ``spgemm_first`` (the
power-law matrix) is the first ``a * a`` on fresh copies of its structure:
host seconds with the symbolic phase and the plan's upload, the card's
peak bytes above those allocated before it, and the bytes still held once
the product is dropped (the cached plan).

``--variants`` times instead every variant of the package's CSR SpMM and
SDDMM kernels, each named on purpose, at the same shapes (``op`` is
``spmm_variant``, ``spmm_at_variant`` for Aᵀ·X through the transpose's
``perm``, or ``sddmm_variant``; the staged SDDMM at each tile height it
takes, ``tile_rows``), so that one run shows what the dispatch chose
between. A variant the kernel refuses for the shape is left out.

``--transposed`` times instead the backward's transposed product (Aᵀ·g
at k = 1, Aᵀ·G at k = 64) at the same shapes, in turns (each way once,
then each once more in the opposite order): ``perm`` (the kernel reading
the values through the transpose's ``perm``), ``buckets`` (pass 1, the
bucket scatter, then the kernel on ``(vb, bperm)``), ``products`` (k = 1
where no row of Aᵀ is split: pass 1 moving ``values·g[row]``, then the
vector kernel summing them), each pass alone, ``gathered`` (the kernel on
``values[perm]``) beside ``gather`` (``values[perm]`` alone),
``dispatched`` (the route the backward takes, named in ``route``) and
``library`` (``torch.sparse_csc_tensor(rowptr, colind, values) @ G``, Aᵀ
with no copy). Every route must give the ``perm`` result bitwise. A
package without the bucket module times the ``perm``, ``gathered``,
``gather`` and ``library`` lines only.

Launches are timed with CUDA events behind a queued spin of the card, so
that the host enqueues all of them while the spin runs and the events time
the card, not the host's launch rate.

Run it as a script, on a machine with a card; ``PYTHONPATH`` picks the
copy of ``spalinalg_tpu_torch`` it measures, so two versions of the
package (for example a ``git archive`` of the parent commit and the
working tree) compare on one card, in turns:

    PYTHONPATH=. python3 spalinalg_tpu_torch/tools/bench_csr.py --label change
    PYTHONPATH=path/to/parent python3 spalinalg_tpu_torch/tools/bench_csr.py --label parent
"""

from __future__ import annotations

import argparse
import inspect
import json
import subprocess
import sys
import time

import numpy as np
import torch

N_SPMV = 2**21
N_SPMM = 2**19
ROW_NNZ = 32
BAND = 16
K = 64
N_GEMM = 2**19
LAP_K = 512
LAUNCHES = 20
STEPS = 5
SPIN_CYCLES = 50_000_000   # about 25 ms on an H100
DTYPES = {"float32": torch.float32, "float64": torch.float64}


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


def random_structure(n: int, gen, device):
    """csr_random: ``(rowptr, colind)`` with one column in each of 32
    equal strata a row (sorted, no duplicates)."""
    strata = n // ROW_NNZ
    rowptr = torch.arange(n + 1, dtype=torch.int32, device=device) * ROW_NNZ
    cols = (torch.arange(ROW_NNZ, dtype=torch.int32, device=device)
            * strata)[None, :] + torch.randint(
                0, strata, (n, ROW_NNZ), generator=gen, dtype=torch.int32,
                device=device)
    return rowptr, cols.reshape(-1)


def banded_structure(n: int, device):
    """The banded matrix of offsets -BAND..BAND clipped at the edges."""
    lo = np.maximum(np.arange(n) - BAND, 0)
    hi = np.minimum(np.arange(n) + BAND, n - 1)
    lens = hi - lo + 1
    rowptr = np.concatenate([[0], np.cumsum(lens)])
    colind = np.repeat(lo - rowptr[:-1], lens) + np.arange(rowptr[-1])
    return (torch.from_numpy(rowptr.astype(np.int32)).to(device),
            torch.from_numpy(colind.astype(np.int32)).to(device))


def variant_counts(mods) -> dict:
    return {(m.__name__, v): n for m in mods
            for v, n in getattr(m, "VARIANT_LAUNCHES", {}).items()}


def ran(mods, fn):
    """``(result, variants)``: ``fn()`` and the variants it launched."""
    before = variant_counts(mods)
    out = fn()
    after = variant_counts(mods)
    return out, sorted(key[1] for key, n in after.items()
                       if n != before.get(key, 0))


def dvals_fn(kernels, t, rowptr, colind, G, X, nrows: int):
    """The package's ``dvals`` as its backward computes it: the SDDMM
    kernel where the package has one (called as its version takes it:
    with the row pointer and the cached row ids since the staged and
    rowwalk variants, with the row ids alone before), else the plain
    expression the backward used (``g[row]·x[col]`` for SpMV, chunked row
    dots for SpMM)."""
    sddmm = getattr(kernels, "csr_sddmm", None)
    if sddmm is not None:
        if "rowptr" in inspect.signature(sddmm.csr_sddmm).parameters:
            return lambda: sddmm.csr_sddmm(rowptr, colind, G, X, nrows,
                                           major=t.major)
        return lambda: sddmm.csr_sddmm(t.major, colind, G, X, nrows)
    if G.ndim == 1:
        g_ext = torch.cat([G, G.new_zeros(1)])
        return lambda: g_ext[t.major] * X[colind]
    G_ext = torch.cat([G, G.new_zeros(1, G.shape[1])])
    return lambda: kernels.csr_spmm._row_dots(G_ext, X, t.major, colind)


def sweep(emit, mods, shape, n, k, rowptr, colind, t, gen, device) -> None:
    """Every variant of the CSR SpMM (forward and Aᵀ·X through ``perm``)
    and SDDMM kernels, named on purpose, at one shape (``--variants``)."""
    mm_mod, sd_mod = mods[1], mods[-1]
    for name, dtype in DTYPES.items():
        size = (n, max(k, 1))
        values = torch.randn(colind.numel(), generator=gen, dtype=dtype,
                             device=device)
        X = torch.randn(size, generator=gen, dtype=dtype, device=device)
        G = torch.randn(size, generator=gen, dtype=dtype, device=device)
        common = {"shape": shape, "n": n, "nnz": colind.numel(), "k": k,
                  "dtype": name}
        for variant in (v for v in mm_mod.VARIANT_LAUNCHES if v != "finish"):
            for op, args, perm in (
                    ("spmm_variant", (rowptr, colind, values, X, n), None),
                    ("spmm_at_variant", (t.ptr, t.minor, values, G, n),
                     t.perm)):
                fn = lambda: mm_mod.csr_spmm(*args, perm=perm,  # noqa: E731
                                             variant=variant)
                try:
                    fn()
                except RuntimeError:
                    continue
                emit(op=op, **common, variant=variant, ms=time_ms(fn))
        heights = getattr(sd_mod, "SDDMM_TILE_ROWS", None)
        for variant in sd_mod.VARIANT_LAUNCHES:
            for rows in ((heights, 64) if variant == "staged" else (None,)):
                if rows is not None:
                    sd_mod.SDDMM_TILE_ROWS = rows
                fn = lambda: sd_mod.csr_sddmm(  # noqa: E731
                    rowptr, colind, G, X, n, major=t.major, variant=variant)
                try:
                    fn()
                except RuntimeError:
                    continue
                emit(op="sddmm_variant", **common, variant=variant,
                     tile_rows=rows, ms=time_ms(fn))
        if heights is not None:
            sd_mod.SDDMM_TILE_ROWS = heights
        del values, X, G
        torch.cuda.empty_cache()


def transposed(emit, mods, shape, n, k, rowptr, colind, t, gen,
               device) -> None:
    """The backward's Aᵀ·g (k = 1) or Aᵀ·G on each route, in turns
    (``--transposed``)."""
    try:
        from spalinalg_tpu_torch.ops.kernels import csr_transpose as ct
    except ImportError:
        ct = None
    kern = mods[0].csr_spmv if k == 1 else mods[1].csr_spmm
    for name, dtype in DTYPES.items():
        values = torch.randn(colind.numel(), generator=gen, dtype=dtype,
                             device=device)
        G = torch.randn((n,) if k == 1 else (n, k), generator=gen,
                        dtype=dtype, device=device)
        itemsize = values.element_size()
        common = {"shape": shape, "n": n, "nnz": colind.numel(), "k": k,
                  "dtype": name}
        ways = {"perm": lambda: kern(t.ptr, t.minor, values, G, n,
                                     perm=t.perm)}
        want = ways["perm"]()
        gathered = values[t.perm]
        ways["gathered"] = lambda: kern(t.ptr, t.minor, gathered, G, n)
        ways["gather"] = lambda: values[t.perm]
        extra, route = {}, None
        if ct is not None:
            product = (mods[0].transposed_spmv if k == 1
                       else mods[1].transposed_spmm)
            routes = ["buckets"]
            if k == 1 and mods[0].csr_spmv_plan(t.ptr).npieces == 0:
                routes.append("products")
            for r in routes:
                ways[r] = (lambda r=r: product(rowptr, colind, t, values, G,
                                               n, route=r))
            plan = ct.bucket_plan(rowptr, colind, t, n, itemsize)
            extra["buckets"] = {"width": plan.width,
                                "plan_bytes": plan.nbytes}
            vb = ct.bucket_values(values, plan)
            ways["pass1"] = lambda: ct.bucket_values(values, plan)
            ways["pass2"] = lambda: kern(t.ptr, t.minor, vb, G, n,
                                         perm=plan.bperm)
            if "products" in routes:
                vp = ct.bucket_values(values, plan, g=G, major=t.major)
                ways["pass1_products"] = lambda: ct.bucket_values(
                    values, plan, g=G, major=t.major)
                ways["pass2_products"] = lambda: mods[0].csr_spmv_products(
                    t.ptr, t.minor, vp, n, perm=plan.bperm)
            route = (mods[0].spmv_route if k == 1 else mods[1].spmm_route)(
                rowptr, colind, t, n, itemsize)
            ways["dispatched"] = lambda: product(rowptr, colind, t, values,
                                                 G, n)
            for way in routes + ["dispatched"]:
                if not torch.equal(ways[way](), want):
                    raise AssertionError(f"{shape} {name}: {way} differs "
                                         "from the perm path")
        lib = torch.sparse_csc_tensor(rowptr, colind, values, (n, n))
        ways["library"] = lambda: lib @ (G if k > 1 else G[:, None])
        times = {way: [] for way in ways}
        for order in (list(ways), list(ways)[::-1]):
            for way in order:
                times[way].append(time_ms(ways[way]))
        for way, ms in times.items():
            emit(op="transposed", **common, way=way, ms=sum(ms) / len(ms),
                 turns=ms, **({"route": route} if way == "dispatched"
                              else {}), **extra.get(way, {}))
        del values, G, want, gathered, lib, ways
        torch.cuda.empty_cache()


def power_law(sp, device, n: int = N_GEMM):
    """config[2]'s matrix (``chip_smoke.power_law``) in both dtypes."""
    rng = np.random.default_rng(1)
    deg = np.minimum(rng.zipf(1.8, size=n), 512)
    rowptr = np.concatenate([[0], np.cumsum(deg)])
    colind = rng.integers(0, n, size=int(rowptr[-1]))
    colind = colind[np.lexsort((colind, np.repeat(np.arange(n), deg)))]
    values = rng.normal(size=colind.size)
    ptr = torch.from_numpy(rowptr.astype(np.int32)).to(device)
    ind = torch.from_numpy(colind.astype(np.int32)).to(device)
    return {name: sp.CsrMatrix._from_parts(
                n, n, ptr, ind, torch.from_numpy(values).to(device, dtype))
            for name, dtype in DTYPES.items()}


def laplacian5(sp, device, k: int = LAP_K):
    """The 5-point Laplacian of a k x k grid (``chip_smoke.laplacian5``)
    in both dtypes."""
    n = k * k
    i = np.arange(n, dtype=np.int64)
    r, c = i // k, i % k
    ok = np.stack([r > 0, c > 0, np.ones(n, dtype=bool), c < k - 1,
                   r < k - 1], axis=1)
    rowptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(ok.sum(axis=1), out=rowptr[1:])
    colind = (i[:, None] + np.array([-k, -1, 0, 1, k]))[ok]
    values = np.broadcast_to(np.array([-1.0, -1.0, 4.0, -1.0, -1.0]),
                             ok.shape)[ok]
    ptr = torch.from_numpy(rowptr.astype(np.int32)).to(device)
    ind = torch.from_numpy(colind.astype(np.int32)).to(device)
    return {name: sp.CsrMatrix._from_parts(
                n, n, ptr, ind, torch.from_numpy(values).to(device, dtype))
            for name, dtype in DTYPES.items()}


def first_product(sp, a) -> dict:
    """The first ``a * a`` on fresh copies of ``a``'s structure, for which
    no plan is cached: host seconds (symbolic phase included), the card's
    peak bytes above those allocated before, and the bytes still held once
    the product is dropped."""
    fresh = sp.CsrMatrix._from_parts(a.nrows, a.ncols, a.rowptr.clone(),
                                     a.colind.clone(), a.values)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    start = time.perf_counter()
    c = fresh * fresh
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    peak = torch.cuda.max_memory_allocated() - base
    del c
    held = torch.cuda.memory_allocated() - base
    return {"seconds": seconds, "peak_bytes": peak, "held_bytes": held}


def spgemm(emit, sp, device) -> None:
    """``a * a`` and its numeric kernel (``--spgemm``), plan cached; the
    power-law matrix's first product."""
    from spalinalg_tpu_torch.ops import spgemm as sg
    from spalinalg_tpu_torch.ops.kernels import spgemm_numeric as nm

    for shape, mats in (("power_law", power_law(sp, device)),
                        ("lap2d", laplacian5(sp, device))):
        for name, a in mats.items():
            spgemm_case(emit, sp, sg, nm, shape, name, a)
        del mats
        torch.cuda.empty_cache()


def spgemm_case(emit, sp, sg, nm, shape, name, a) -> None:
    """One matrix and dtype of :func:`spgemm`."""
    plan = sg._cached_plan(a, a)
    v = a.values
    common = {"shape": shape, "n": a.nrows, "nnz": a.nnz,
              "terms": int(plan.a_idx.numel()), "dtype": name}
    emit(op="spgemm", **common, ms=time_ms(lambda: a * a, STEPS))
    emit(op="spgemm_numeric", **common,
         ms=time_ms(lambda: nm.spgemm_numeric(plan, v, v)))
    del plan
    torch.cuda.empty_cache()
    if shape == "power_law":
        emit(op="spgemm_first", **common, **first_product(sp, a))
        torch.cuda.empty_cache()


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--label", default="",
                        help="a name for this run, copied into each line")
    parser.add_argument("--variants", action="store_true",
                        help="time every CSR SpMM and SDDMM variant by name")
    parser.add_argument("--spgemm", action="store_true",
                        help="time SpGEMM A·A on the config[2] matrix")
    parser.add_argument("--transposed", action="store_true",
                        help="time the backward's Aᵀ·g and Aᵀ·G routes")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("bench_csr: no CUDA device; it times kernels on a card",
              file=sys.stderr)
        return 1
    import spalinalg_tpu_torch as sp
    from spalinalg_tpu_torch.ops import kernels
    from spalinalg_tpu_torch.ops.kernels import csr_spmm as mm_mod
    from spalinalg_tpu_torch.ops.kernels import csr_spmv as mv_mod

    mods = [mv_mod, mm_mod]
    try:  # a package without the SDDMM kernel computes dvals in torch
        from spalinalg_tpu_torch.ops.kernels import csr_sddmm
        mods.append(csr_sddmm)
    except ImportError:
        pass
    device = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    gen = torch.Generator(device=device).manual_seed(13)
    cases = (("csr_random", N_SPMV, 1, random_structure(N_SPMV, gen, device)),
             ("banded", N_SPMV, 1, banded_structure(N_SPMV, device)),
             ("csr_random", N_SPMM, K, random_structure(N_SPMM, gen, device)),
             ("banded", N_SPMM, K, banded_structure(N_SPMM, device)))

    def emit(**row):
        print(json.dumps({"label": args.label, **row,
                          "package": sp.__file__, "card": card}), flush=True)

    if args.spgemm:
        spgemm(emit, sp, device)
        return 0
    for shape, n, k, (rowptr, colind) in cases:
        t = mv_mod.transpose_plan(rowptr, colind, n, n)
        if args.variants:
            sweep(emit, mods, shape, n, k, rowptr, colind, t, gen, device)
            continue
        if args.transposed:
            transposed(emit, mods, shape, n, k, rowptr, colind, t, gen,
                       device)
            continue
        for name, dtype in DTYPES.items():
            size = (n,) if k == 1 else (n, k)
            values = torch.randn(colind.numel(), generator=gen, dtype=dtype,
                                 device=device)
            X = torch.randn(size, generator=gen, dtype=dtype, device=device)
            G = torch.randn(size, generator=gen, dtype=dtype, device=device)
            op = "csr_spmv" if k == 1 else "csr_spmm"
            kern = mv_mod.csr_spmv if k == 1 else mm_mod.csr_spmm
            common = {"shape": shape, "n": n, "nnz": colind.numel(), "k": k,
                      "dtype": name}
            # the product
            y, variants = ran(mods, lambda: kern(rowptr, colind, values, X, n))
            err = float((y - mv_mod.csr_spmv_plain(rowptr, colind, values, X,
                                                   n)).abs().max())
            del y
            lib = torch.sparse_csr_tensor(rowptr, colind, values, (n, n))
            emit(op=op, **common,
                 ms=time_ms(lambda: kern(rowptr, colind, values, X, n)),
                 library_ms=time_ms(lambda: lib @ X), max_abs_err=err,
                 variant=variants[0] if variants else None)
            # dvals
            fn = dvals_fn(kernels, t, rowptr, colind, G, X, n)
            _, variants = ran(mods, fn)
            lib_ms = time_ms(lambda: torch.sparse.sampled_addmm(
                lib, G if k > 1 else G[:, None],
                (X if k > 1 else X[:, None]).T, beta=0.0))
            emit(op="dvals", **common, ms=time_ms(fn), library_ms=lib_ms,
                 variant=variants[0] if variants else None)
            del lib
            # a forward + backward step through autograd
            mat = sp.CsrMatrix._from_parts(n, n, rowptr, colind, values)
            vg = values.clone().requires_grad_(True)
            Xg = X.clone().requires_grad_(True)
            m = mat.with_values(vg)
            emit(op="step", **common,
                 ms=time_ms(lambda: (m @ Xg).backward(G), STEPS))
            del vg, Xg, m, mat, values, X, G
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
