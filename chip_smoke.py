#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check its
kernels against their plain torch versions.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases (each raises on failure; the last line is printed only when all
pass):

0. The machine: card, power limit, CUDA and nvcc. Exits non-zero without
   a CUDA device.
1. Build: ``nvcc`` compiles ``spalinalg_tpu_torch/csrc`` into
   ``build/kernels/``.
2. BASELINE config[0] at its published size: a 1000 x 1000 matrix of 1 %
   random density in float64, built with ``CooMatrix.with_triplets``
   (duplicates and explicit zeros included), ``CsrMatrix.from_coo`` onto
   the card, ``csr @ x``, held against ``coo.to_dense() @ x`` on the host.
3. Real scale: ``bench.py``'s csr_random pattern (32 uniform random columns
   per row) at n = 2**21 rows, 67,108,864 stored entries, in float32 and
   float64, through the same COO -> CSR path. The main path (config[0]
   and a forward and backward SpMV in each dtype) runs once between a
   reset and a read of the launch counts; then the kernel is held against
   the plain version on the card, row by row, and must repeat bitwise.
4. Times of kernel and plain version at the phase 3 shapes, in turns
   (plain, kernel, kernel, plain), with CUDA events.
5. Where the time goes at the phase 3 shapes: ``csr @ x`` with autograd
   on, a forward + backward step, the transpose build alone (CUDA events),
   and a ``torch.profiler`` trace of the steps: device time per kernel
   name and the device's idle share.

It prints, before the last line, one JSON line describing each kernel and
the card's ``nvidia-smi`` name and power limit; the last line is the
``{"ok": true, "device": ...}`` record.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from spalinalg_tpu_torch import CooMatrix, CsrMatrix
from spalinalg_tpu_torch.convert.engine import major_ids, transpose_structure
from spalinalg_tpu_torch.ops.kernels import _build
from spalinalg_tpu_torch.ops.kernels.csr_spmv import (
    LAUNCHES, csr_spmv, csr_spmv_plain)

SOURCE = "spalinalg_tpu_torch/csrc/csr_spmv.cu"
REPLACES = {"float32": "spalinalg_tpu/ops/kernels/csr_route.py:930",
            "float64": "spalinalg_tpu/ops/kernels/csr_route_df.py:47"}
TOL = {"float32": 1e-5, "float64": 1e-12}
DTYPES = {"float32": (np.float32, torch.float32),
          "float64": (np.float64, torch.float64)}
N_BIG = 2**21
ROW_NNZ = 32
HBM_TBPS = 3.35  # published H100 SXM device-memory bandwidth
TIMED_LAUNCHES = 20
PROFILED_STEPS = 10


def nvidia_smi_card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def within(err: torch.Tensor, scale: torch.Tensor, tol: float, what: str):
    """Row-by-row check ``err <= tol * scale``."""
    bad = int((err > tol * scale).sum())
    if bad:
        worst = float((err / scale.clamp_min(1e-300)).max())
        raise AssertionError(
            f"{what}: {bad} entries outside tol {tol} (worst scaled error "
            f"{worst:.3e})")


def config0(device):
    """BASELINE config[0]: 1000 x 1000, 1 % density, float64, with
    duplicates and explicit zeros."""
    rng = np.random.default_rng(0)
    n, k = 1000, 10_000
    rows = rng.integers(0, n, size=k)
    cols = rng.integers(0, n, size=k)
    vals = rng.normal(size=k)
    vals[rng.random(k) < 0.01] = 0.0                  # explicit zeros
    rows = np.concatenate([rows, rows[:200]])         # explicit duplicates
    cols = np.concatenate([cols, cols[:200]])
    vals = np.concatenate([vals, rng.normal(size=200)])
    coo = CooMatrix.with_triplets(n, n, rows, cols, vals)
    csr = CsrMatrix.from_coo(coo, device=device)
    x = rng.normal(size=n)
    return coo, csr, x


def big_matrix(np_dtype, device):
    """csr_random at n = 2**21: 32 uniform random columns per row, one in
    each of 32 equal column strata (so no duplicates, and nnz is exactly
    2**26), with triplets generated in row order."""
    rng = np.random.default_rng(1)
    strata = N_BIG // ROW_NNZ
    rows = np.repeat(np.arange(N_BIG, dtype=np.int64), ROW_NNZ)
    cols = (np.arange(ROW_NNZ, dtype=np.int64) * strata)[None, :] \
        + rng.integers(0, strata, size=(N_BIG, ROW_NNZ))
    vals = rng.normal(size=rows.size).astype(np_dtype)
    t0 = time.perf_counter()
    coo = CooMatrix.with_triplets(N_BIG, N_BIG, rows, cols.reshape(-1), vals)
    del rows, cols, vals
    csr = CsrMatrix.from_coo(coo, device=device)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    if csr.nnz != N_BIG * ROW_NNZ:
        raise AssertionError(f"expected {N_BIG * ROW_NNZ} entries, got "
                             f"{csr.nnz}")
    x = torch.from_numpy(rng.normal(size=N_BIG).astype(np_dtype)).to(device)
    g = torch.from_numpy(rng.normal(size=N_BIG).astype(np_dtype)).to(device)
    return csr, x, g, seconds


def edge_structures(device) -> None:
    """Kernel against plain version on structures the main path's matrices
    do not reach: every lane count (mean row lengths from 0.5 to 64), empty
    rows, padding slots past ``rowptr[-1]`` holding values that must count
    for nothing, and a matrix with no stored slots."""
    rng = np.random.default_rng(2)
    n = 3000
    for name, (np_dtype, _) in DTYPES.items():
        for mean in (0.5, 1.5, 3, 6, 12, 24, 64):
            lens = rng.poisson(mean, size=n)
            lens[::7] = 0
            ptr = np.concatenate([[0], np.cumsum(lens)])
            nse = int(ptr[-1]) + 37
            rowptr = torch.from_numpy(ptr.astype(np.int32)).to(device)
            colind = torch.from_numpy(
                rng.integers(0, n, size=nse).astype(np.int32)).to(device)
            values = torch.from_numpy(
                rng.normal(size=nse).astype(np_dtype)).to(device)
            x = torch.from_numpy(rng.normal(size=n).astype(np_dtype)).to(device)
            y = csr_spmv(rowptr, colind, values, x, n)
            y_p = csr_spmv_plain(rowptr, colind, values, x, n)
            scale = csr_spmv_plain(rowptr, colind, values.abs(), x.abs(), n)
            within((y - y_p).abs(), scale, TOL[name],
                   f"{name} edge structure, mean row length {mean}")
            if not bool((y[::7] == 0).all()):
                raise AssertionError(f"{name}: an empty row is not 0")
        empty = csr_spmv(torch.zeros(n + 1, dtype=torch.int32, device=device),
                         torch.zeros(0, dtype=torch.int32, device=device),
                         torch.zeros(0, dtype=DTYPES[name][1], device=device),
                         x, n)
        if not bool((empty == 0).all()):
            raise AssertionError(f"{name}: a matrix with no entries is not 0")
    torch.cuda.synchronize()


def time_ms(fn, launches: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(launches):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / launches


def profile_steps(step, steps: int):
    """Run ``step`` ``steps`` times under ``torch.profiler``. Returns the
    wall ms (CUDA events), the summed device ms of every kernel, and per
    kernel name its device ms and launch count, largest first."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall = time_ms(step, steps) * steps
    per_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            ms, n = per_name.get(e.name, (0.0, 0))
            per_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    busy = sum(ms for ms, _ in per_name.values())
    return wall, busy, sorted(per_name.items(), key=lambda kv: -kv[1][0])


def where_the_time_goes(big, card: str) -> None:
    for name, (csr, x, g) in big.items():
        values = csr.values.detach().clone().requires_grad_(True)
        xg = x.detach().clone().requires_grad_(True)
        mat = csr.with_values(values)
        step = lambda: (mat @ xg).backward(g)
        for fn in (lambda: mat @ xg, step):
            time_ms(fn, 3)
        fwd = time_ms(lambda: mat @ xg, TIMED_LAUNCHES)
        fwd_bwd = time_ms(step, PROFILED_STEPS)
        build = time_ms(lambda: transpose_structure(
            csr.rowptr, csr.colind, n_major=N_BIG, n_minor=N_BIG), 3)
        print(f"phase 5: {name} csr @ x (autograd on) {fwd:.4f} ms; forward "
              f"+ backward {fwd_bwd:.4f} ms/step; transpose_structure "
              f"{build:.4f} ms | {card}")
        wall, busy, per_name = profile_steps(step, PROFILED_STEPS)
        if not per_name:
            print(f"phase 5: {name} profiler saw no device kernels: device "
                  "time not measured")
            continue
        print(f"phase 5: {name} profiled {PROFILED_STEPS} steps: wall "
              f"{wall:.4f} ms, device kernels {busy:.4f} ms, idle share "
              f"{max(0.0, 1 - busy / wall):.4f}")
        for kname, (ms, n) in per_name[:8]:
            print(f"phase 5: {name}   {ms / PROFILED_STEPS:8.4f} ms/step "
                  f"{n / PROFILED_STEPS:4.1f} launches/step  {kname[:90]}")


def main() -> int:
    # ---- phase 0: the machine ----------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    card = nvidia_smi_card()
    device = torch.device("cuda", 0)
    print(f"phase 0: nvidia-smi: {card}")
    print(f"phase 0: torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}, count "
          f"{torch.cuda.device_count()}, nvcc {_build.find_nvcc()}")

    # ---- phase 1: build ----------------------------------------------
    cached = _build.library_path().exists()
    t0 = time.perf_counter()
    _build.load_library()
    print(f"phase 1: nvcc {' '.join(_build.NVCC_FLAGS)} {SOURCE} -> "
          f"build/kernels/{_build.library_path().name}: "
          f"{time.perf_counter() - t0:.2f} s"
          f"{' (already built)' if cached else ''}")

    # ---- building the inputs (host COO -> CSR on the card) -----------
    coo0, csr0, x0 = config0(device)
    big = {}
    for name, (np_dtype, _) in DTYPES.items():
        csr, x, g, seconds = big_matrix(np_dtype, device)
        big[name] = (csr, x, g)
        print(f"phase 3: {name} n={N_BIG} nnz={csr.nnz}: COO build + "
              f"CsrMatrix.from_coo(device='cuda') {seconds:.2f} s")

    # ---- the main path, once, between a reset and a read of the counts
    for key in LAUNCHES:
        LAUNCHES[key] = 0
    y0 = csr0 @ torch.from_numpy(x0).to(device)
    main_out = {}
    for name, (csr, x, g) in big.items():
        values = csr.values.detach().clone().requires_grad_(True)
        xg = x.detach().clone().requires_grad_(True)
        y = csr.with_values(values) @ xg
        y.backward(g)
        main_out[name] = (y.detach(), values.grad, xg.grad)
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    print(f"main path launches: {launches}")
    # config[0] forward (f64) plus a forward and an A^T g per big matrix.
    if launches != {"float32": 2, "float64": 3}:
        raise AssertionError(f"unexpected kernel launch counts {launches}")

    # ---- phase 2: config[0] against the dense product -----------------
    d0 = coo0.to_dense()
    ref = d0 @ x0
    err = np.abs(y0.cpu().numpy() - ref)
    scale = np.abs(d0) @ np.abs(x0)
    if not np.all(err <= 1e-12 * scale):
        raise AssertionError(f"config[0]: max error {err.max():.3e}")
    print(f"phase 2: config[0] 1000x1000 nnz={csr0.nnz} f64: csr @ x matches "
          f"coo.to_dense() @ x, max |err| {err.max():.3e} <= 1e-12*(|A||x|)")
    try:
        csr0 @ torch.ones(1000, 2, dtype=torch.float64, device=device)
    except NotImplementedError as e:
        print(f"phase 2: a 2-D right-hand side on the card raises: {e}")
    else:
        raise AssertionError("SpMM on the card ran without its kernel")

    # ---- phase 3: kernel against plain version on the card -----------
    report = {}
    for name, (csr, x, g) in big.items():
        tol = TOL[name]
        rowptr, colind, values = csr.rowptr, csr.colind, csr.values
        y, dvals, dx = main_out[name]
        y_p = csr_spmv_plain(rowptr, colind, values, x, N_BIG)
        scale = csr_spmv_plain(rowptr, colind, values.abs(), x.abs(), N_BIG)
        err = (y - y_p).abs()
        within(err, scale, tol, f"{name} forward")
        y1 = csr_spmv(rowptr, colind, values, x, N_BIG)
        y2 = csr_spmv(rowptr, colind, values, x, N_BIG)
        torch.cuda.synchronize()
        if not (torch.equal(y1, y2) and torch.equal(y1, y)):
            raise AssertionError(f"{name}: kernel results differ run to run")
        # backward against the plain version's autograd
        v_p = values.detach().clone().requires_grad_(True)
        x_p = x.detach().clone().requires_grad_(True)
        dvals_p, dx_p = torch.autograd.grad(
            csr_spmv_plain(rowptr, colind, v_p, x_p, N_BIG), (v_p, x_p), g)
        rows = major_ids(rowptr, colind.numel())
        cols = colind
        scale_dx = torch.zeros_like(x).index_add_(
            0, cols, values.abs() * g.abs()[rows])
        within((dx - dx_p).abs(), scale_dx, tol, f"{name} dx")
        within((dvals - dvals_p).abs(), (g[rows] * x[cols]).abs(), tol,
               f"{name} dvals")
        report[name] = {"max_abs_err": float(err.max())}
        print(f"phase 3: {name}: kernel == plain within {tol}*(|A||x|) row by "
              f"row (max |err| {float(err.max()):.3e}); bitwise repeatable; "
              f"dx and dvals match the plain autograd")
        del y_p, scale, y1, y2, v_p, x_p, dvals_p, dx_p, rows, cols, scale_dx
    edge_structures(device)
    print("phase 3: edge structures (lane counts 1..32, empty rows, padding, "
          "no entries): kernel == plain in float32 and float64")

    # ---- phase 4: times ------------------------------------------------
    for name, (csr, x, _) in big.items():
        rowptr, colind, values = csr.rowptr, csr.colind, csr.values
        kernel = lambda: csr_spmv(rowptr, colind, values, x, N_BIG)
        plain = lambda: csr_spmv_plain(rowptr, colind, values, x, N_BIG)
        for fn in (plain, kernel):
            time_ms(fn, 3)
        p1 = time_ms(plain, TIMED_LAUNCHES)
        k1 = time_ms(kernel, TIMED_LAUNCHES)
        k2 = time_ms(kernel, TIMED_LAUNCHES)
        p2 = time_ms(plain, TIMED_LAUNCHES)
        nnz, itemsize = csr.nse, values.element_size()
        nbytes = (itemsize + 4) * nnz + itemsize * 2 * N_BIG + 4 * (N_BIG + 1)
        for label, ms in (("kernel", (k1 + k2) / 2), ("plain", (p1 + p2) / 2)):
            gbs = nbytes / ms / 1e6
            print(f"phase 4: {name} {label}: {ms:.4f} ms/SpMV, "
                  f"{nnz / ms / 1e6:.2f} Gnnz/s, {gbs:.1f} GB/s, "
                  f"{100 * gbs / (HBM_TBPS * 1e3):.1f} % of {HBM_TBPS} TB/s "
                  f"| {card}")
        print(f"phase 4: {name} turns (ms): plain {p1:.4f}, kernel {k1:.4f}, "
              f"kernel {k2:.4f}, plain {p2:.4f}")
        report[name].update(ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2)

    # ---- phase 5: where the time goes ----------------------------------
    where_the_time_goes(big, card)

    kernels = [{"name": f"csr_spmv_{name}",
                "route": "cuda", "source": SOURCE, "replaces": REPLACES[name],
                "launches": launches[name], **report[name]}
               for name in DTYPES]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
