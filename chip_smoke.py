#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one NVIDIA GPU and check its
kernels against their plain torch versions.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases (each raises on failure; the last line is printed only when all
pass; each prints its seconds):

0. The machine: card, power limit, CUDA and nvcc. Exits non-zero without
   a CUDA device.
1. Build: ``nvcc`` compiles ``spalinalg_tpu_torch/csrc`` (one process per
   source, all at once) into ``build/kernels/``.
2. BASELINE config[0] at its published size: a 1000 x 1000 matrix of 1 %
   random density in float64, built with ``CooMatrix.with_triplets``
   (duplicates and explicit zeros included), ``CsrMatrix.from_coo`` onto
   the card, ``csr @ x``, held against ``coo.to_dense() @ x`` on the host.
3. SpMV at real scale: ``bench.py``'s csr_random pattern (32 uniform random
   columns per row) at n = 2**21 rows, 67,108,864 stored entries, in
   float32 and float64, through the same COO -> CSR path. The kernel is
   held against the plain version on the card, row by row, and must repeat
   bitwise; the backward's Aᵀ·g through ``perm`` must equal the kernel on
   the gathered values bitwise, and its dvals (the SDDMM kernel at k = 1)
   the plain version; edge structures for both SpMV variants (rows of 0,
   1, 31, 32, 33, 4096 and 150,000 entries, padding slots holding values,
   colind, values and perm views off a 16-byte boundary, the perm path)
   and for both SDDMM variants (k in {1, 3, 4, 32, 64, 100}, padding
   slots, G off a 16-byte boundary); ``csr @ x`` and ``csc @ x`` of
   ``from_dense`` matrices with the metrics recorder on, whose path must
   name the SpMV variant that launched.
4. SpMV times of kernel and plain version at the phase 3 shapes, in turns
   (plain, kernel, kernel, plain), and of torch's CSR product, each run of
   launches queued behind a spin of the card; Aᵀ·g through ``perm``
   against the gathered form; SDDMM at k = 1 beside
   ``torch.sparse.sampled_addmm``; SpMV on phase 7's power-law matrix and
   on a matrix with rows of 300,000 and 120,000 entries (the vector
   variant's long-row split), checked and timed.
5. Where the SpMV time goes at the phase 3 shapes: ``csr @ x`` with
   autograd on, a forward + backward step, the transpose build alone, and
   a ``torch.profiler`` trace: device time per kernel name and idle share.
6. SpMM, BASELINE config[1] at k = 64: csr_random (32 columns per row from
   32 strata) and a banded matrix (offsets -16..16) at n = 2**19 rows, in
   float32 and float64, built from sorted host arrays with the validating
   constructor; ``csc @ X`` through the CSR mirror on csr_random. Kernel
   against plain version row by row, bitwise repeats, gradients against
   the plain version's autograd, Aᵀ·G through ``perm`` and the SDDMM at
   k = 64 against their plain forms; edge structures (empty rows, padding
   slots holding values, k in {1, 3, 4, 32, 64, 100}, X on and off a
   16-byte boundary: both SpMM variants; the perm path).
7. SpGEMM, BASELINE config[2]: ``A·A`` on ``bench.py``'s power-law
   generator (zipf 1.8, capped at 512, seed 1) at n = 2**19, in float32
   and float64; host times of the native symbolic phase and of the plan
   upload. Kernel against plain version slot by slot, bitwise repeats,
   gradients against the plain autograd; edge structures (empty slots, a
   slot of more than 10k terms, n_out == 0); ``a * b``, ``csc * csc`` and
   ``a ** 3`` at config[0]'s size against dense products.
8. SpMM and SpGEMM times, in turns (plain, kernel, kernel, plain), every
   run and torch's CSR product behind the spin, csr_random and banded
   each; SDDMM at k = 64 beside ``torch.sparse.sampled_addmm``.
9. Where the SpMM and SpGEMM time goes: ``torch.profiler`` over a forward +
   backward SpMM step and a SpGEMM numeric step.
10. BSR: tri128, ``bench.py``'s block-tridiagonal pattern of 128 x 128
    blocks at 4096 block rows (n = 524,288, 12,286 blocks, 201M stored
    values), generated on the card from a seeded generator, through the
    validating constructor, in float32, bfloat16 (``astype``) and float64;
    banded8, config[1]'s banded matrix through ``CsrMatrix.to_bsr(8)``, in
    float32 and float64. ``bsr @ x`` and ``bsr @ X`` (k = 64): kernel
    against plain version row by row, bitwise repeats, gradients against
    the plain autograd, banded8's ``bsr @ X`` against its ``csr @ X``; the
    kernel variants each main path ran (``MAIN_VARIANTS``: the vector SpMV
    on both matrices, the tiled SpMM on tri128, the staged SpMM on
    banded8); the staged SpMM, named on purpose, against the plain version
    and bitwise against the register variant on the same operands
    (banded8's forward and Aᵀ·G operands; 4 x 4, 16 x 16, 2 x 2, 4 x 8
    and 8 x 4 blocks; a k of 68; bf16 blocks; empty block rows and padding
    blocks; block columns spread too wide for shared memory, which take
    the kernel's device-memory path), and the staged variant refusing k =
    65, an operand off 16 bytes and 17-row blocks; edge structures on both
    sides of every variant bound (empty block rows, padding blocks, bs 1,
    3, 8 and 384, rectangular blocks, (128, 128) with k in {16, 17, 32,
    65, 130}, (96, 160), (64, 64), (40, 48), (40, 18), (64, 8), k in {1,
    3, 32, 64, 100}, data and operand views off a 16-byte boundary, no
    blocks); the card's peak memory.
11. BSR times, in turns, each run of launches (and torch's BSR call)
    queued behind a spin of the card, and ``torch.profiler`` over forward
    + backward steps.
12. DeviceCoo: ``coo.to_device().to_csr_device()`` on the card for phase 3's
    triplets (both dtypes) and config[0]'s (duplicates and zeros): the
    padded CSR holds ``CsrMatrix.from_coo``'s structure exactly and its
    values within tol; config[0]'s padded result times x against the dense
    product; seconds beside the host conversion's.
13. DIA: dia9 (``bench.py``'s 9-diagonal pattern at n = 2**25, drawn on the
    card) and lap3d (the 7-point Laplacian of a 256**3 grid, built on the
    host with ``DiaMatrix.from_diagonals``), in float32 and float64. Kernel
    against plain version row by row, bitwise repeats, gradients against
    the plain autograd; edge structures (D = 1, offsets at +-(n - 1),
    rectangular 300 x 1000 and 1000 x 300, D = 0, unsorted offsets); the
    stencil path: the 64**3 Laplacian through ``diags`` + ``kron`` + ``+``
    into CSR on the card, then ``DiaMatrix.from_csr``, whose ``dia @ x``
    is held against ``csr @ x`` (kernel B1) and ``dia.T @ g`` against the
    backward's dx.
14. DIA times, in turns, forward and transposed, behind the spin; the
    card's peak memory.
15. B10: the wide-gather probe (``spalinalg_tpu_torch/tools/
    probe_widegather.py``) at its tool's shapes, kernel against plain
    version, out-of-range indices, rows longer than shared memory (the
    kernel's device-memory path), bitwise repeats, microseconds per call
    and per take, Gelem/s, and the launch floor (the same kernel at S = 1,
    K = 1, behind the same spin).

Each main path (config[0]; a forward and backward SpMV per dtype; config[1]
forward and backward for each matrix and for ``csc @ X``; config[2]
forward and backward; on the CSR paths also the kernel variants of
MAIN_VARIANTS; BSR ``bsr @ x`` and ``bsr @ X`` forward and backward
on every BSR matrix; DIA ``dia @ x`` forward and backward on dia9 and
lap3d per dtype; the probe's ``run``) runs once, between a reset and a read
of every launch count, before its checks; the counts must be exactly the
path's. Phase 2 also checks that ``CsrMatrix.from_coo`` with no device
lands on ``cuda:0``.

It prints, before the last line, one JSON line describing each kernel (its
launches on the main path, max |err| against the plain version, its time,
the plain version's, the bound from compulsory bytes or operations, and the
time of one PyTorch library call that computes the same function, or null
where there is none; the rows of kernels with variants also the launches
of each variant; banded8 has BSR rows of its own, the banded matrix CSR
SpMM rows, and SDDMM at k = 1 rows beside its k = 64 ones) and the card's
``nvidia-smi`` name and power limit; the last line is the ``{"ok": true,
"device": ...}`` record.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

from spalinalg_tpu_torch import (BsrMatrix, CooMatrix, CscMatrix, CsrMatrix,
                                 DiaMatrix, diags, kron)
from spalinalg_tpu_torch.convert.engine import major_ids, transpose_structure
from spalinalg_tpu_torch.formats.dia import _diag_span
from spalinalg_tpu_torch.ops import spgemm as spgemm_mod
from spalinalg_tpu_torch.ops.kernels import _build
from spalinalg_tpu_torch.ops.kernels import bsr_spmm as bsr_spmm_mod
from spalinalg_tpu_torch.ops.kernels import bsr_spmv as bsr_spmv_mod
from spalinalg_tpu_torch.ops.kernels import csr_sddmm as sddmm_mod
from spalinalg_tpu_torch.ops.kernels import csr_spmm as spmm_mod
from spalinalg_tpu_torch.ops.kernels import dia_spmv as dia_mod
from spalinalg_tpu_torch.ops.kernels import csr_spmv as spmv_mod
from spalinalg_tpu_torch.ops.kernels import spgemm_numeric as numeric_mod
from spalinalg_tpu_torch.ops.kernels.bsr_spmm import bsr_spmm
from spalinalg_tpu_torch.ops.kernels.bsr_spmv import (_block_outer, bsr_spmv,
                                                      bsr_spmv_plain,
                                                      transposed_blocks)
from spalinalg_tpu_torch.ops.kernels.csr_sddmm import (csr_sddmm,
                                                       csr_sddmm_plain)
from spalinalg_tpu_torch.ops.kernels.csr_spmm import csr_spmm, csr_spmm_plain
from spalinalg_tpu_torch.ops.kernels.csr_spmv import (BUDGET, csr_spmv,
                                                      csr_spmv_plain,
                                                      transpose_plan)
from spalinalg_tpu_torch.ops.kernels.dia_spmv import (_shifted_products,
                                                      dia_spmv,
                                                      dia_spmv_plain)
from spalinalg_tpu_torch.ops.kernels.spgemm_numeric import (
    spgemm_numeric, spgemm_numeric_plain)
from spalinalg_tpu_torch.tools import probe_widegather as probe
from spalinalg_tpu_torch.utils import metrics

KERNELS = {
    "csr_spmv": ("spalinalg_tpu_torch/csrc/csr_spmv.cu", spmv_mod.LAUNCHES),
    "csr_spmm": ("spalinalg_tpu_torch/csrc/csr_spmm.cu", spmm_mod.LAUNCHES),
    "csr_sddmm": ("spalinalg_tpu_torch/csrc/csr_sddmm.cu",
                  sddmm_mod.LAUNCHES),
    "spgemm": ("spalinalg_tpu_torch/csrc/spgemm_numeric.cu",
               numeric_mod.LAUNCHES),
    "bsr_spmv": ("spalinalg_tpu_torch/csrc/bsr_spmv.cu",
                 bsr_spmv_mod.LAUNCHES),
    "bsr_spmm": ("spalinalg_tpu_torch/csrc/bsr_spmm.cu",
                 bsr_spmm_mod.LAUNCHES),
    "dia_spmv": ("spalinalg_tpu_torch/csrc/dia_spmv.cu", dia_mod.LAUNCHES),
    "wide_gather": ("spalinalg_tpu_torch/csrc/wide_gather.cu",
                    probe.LAUNCHES),
}
# Launches per variant of the kernels that have two (advanced with the
# per-dtype counts above).
VARIANTS = {"csr_spmv": spmv_mod.VARIANT_LAUNCHES,
            "csr_spmm": spmm_mod.VARIANT_LAUNCHES,
            "csr_sddmm": sddmm_mod.VARIANT_LAUNCHES,
            "bsr_spmv": bsr_spmv_mod.VARIANT_LAUNCHES,
            "bsr_spmm": bsr_spmm_mod.VARIANT_LAUNCHES}
# dvals of both CSR backward passes: XLA code in the JAX package.
SDDMM_REPLACES = ("spalinalg_tpu/ops/kernels/csr_route.py:1093 and :1364 "
                  "(XLA dvals; no Pallas kernel)")
REPLACES = {
    ("csr_spmv", "float32"): "spalinalg_tpu/ops/kernels/csr_route.py:930",
    ("csr_spmv", "float64"): "spalinalg_tpu/ops/kernels/csr_route_df.py:47",
    ("csr_spmm", "float32"): "spalinalg_tpu/ops/kernels/csr_route.py:1112",
    ("csr_spmm", "float64"): "spalinalg_tpu/ops/kernels/csr_route.py:1112",
    ("csr_sddmm", "float32"): SDDMM_REPLACES,
    ("csr_sddmm", "float64"): SDDMM_REPLACES,
    ("spgemm", "float32"): "spalinalg_tpu/ops/kernels/pair_route.py:473",
    ("spgemm", "float64"): "spalinalg_tpu/ops/kernels/pair_route.py:473",
    ("bsr_spmv", "float32"): "spalinalg_tpu/ops/kernels/bsr_stream.py:71",
    ("bsr_spmv", "bfloat16"): "spalinalg_tpu/ops/kernels/bsr_stream.py:71",
    ("bsr_spmv", "float64"): "spalinalg_tpu/ops/kernels/bsr_df.py:66",
    ("bsr_spmm", "float32"): "spalinalg_tpu/ops/kernels/bsr_stream.py:194",
    ("bsr_spmm", "bfloat16"): "spalinalg_tpu/ops/kernels/bsr_stream.py:194",
    ("bsr_spmm", "float64"): "spalinalg_tpu/ops/kernels/bsr_stream.py:194",
    ("dia_spmv", "float32"): "spalinalg_tpu/ops/kernels/dia_stream.py:58",
    ("dia_spmv", "float64"): "spalinalg_tpu/ops/kernels/dia_df.py:59",
    ("wide_gather", "float32"): "tools/probe_widegather.py:39",
}
# Launches of each main path: config[0] forward (f64); a forward, an Aᵀ·g
# and a dvals (SDDMM) per SpMV matrix; a forward, an Aᵀ·G and a dvals for
# each of csr_random, banded and csc @ X; one numeric phase per SpGEMM
# dtype; a forward and an
# Aᵀ·g (Aᵀ·G) for each BSR matrix: tri128 in three dtypes, banded8 in two;
# a forward and an Aᵀ·g for each DIA matrix, dia9 and lap3d, per dtype; the
# probe's check, warm-up and timed launches.
MAIN_LAUNCHES = {
    "config[0]": {"csr_spmv": {"float64": 1}},
    "SpMV": {"csr_spmv": {"float32": 2, "float64": 2},
             "csr_sddmm": {"float32": 1, "float64": 1}},
    "SpMM": {"csr_spmm": {"float32": 6, "float64": 6},
             "csr_sddmm": {"float32": 3, "float64": 3}},
    "SpGEMM": {"spgemm": {"float32": 1, "float64": 1}},
    "BSR bsr @ x": {"bsr_spmv": {"float32": 4, "bfloat16": 2, "float64": 4}},
    "BSR bsr @ X": {"bsr_spmm": {"float32": 4, "bfloat16": 2, "float64": 4}},
    "DIA dia @ x": {"dia_spmv": {"float32": 4, "float64": 4}},
    "B10 probe": {"wide_gather": {"float32": 1 + probe.WARMUP + probe.TIMED}},
}
# Variants each main path must run. CSR paths, by kernel: config[0] and the
# SpMV path (csr_random, forward and Aᵀ·g per dtype) the vector SpMV, whose
# dvals at k = 1 is the scalar SDDMM; the SpMM path (k = 64, all three
# matrices) the vector SpMM in float32, the register one in float64, and
# the vector SDDMM. BSR paths, by matrix
# (forward and Aᵀ·g in each dtype): the vector SpMV on both; the tiled SpMM
# on tri128, the staged SpMM on banded8's 8 x 8 blocks.
MAIN_VARIANTS = {
    "config[0]": {"csr_spmv": {"vector": 1}},
    "SpMV": {"csr_spmv": {"vector": 4}, "csr_sddmm": {"scalar": 2}},
    "SpMM": {"csr_spmm": {"vector": 6, "register": 6},
             "csr_sddmm": {"vector": 6}},
    "BSR bsr @ x": {"tri128": {"vector": 6}, "banded8": {"vector": 4}},
    "BSR bsr @ X": {"tri128": {"tiled": 6}, "banded8": {"staged": 4}},
}
# Rows of the kernel line beside the rows that carry each dtype's launch
# count: banded8 for BSR; the banded matrix for CSR SpMM; SDDMM at k = 1 on
# the SpMV matrix (the main rows: k = 64 on csr_random). Each gets the
# launches of its own matrix's main path.
# Keyed by (kernel, row suffix), in float32 and float64; the value names
# the row's matrix in the record of variants a main path ran.
EXTRA_ROWS = {("bsr_spmv", "banded8"): "banded8",
              ("bsr_spmm", "banded8"): "banded8",
              ("csr_spmm", "banded"): "banded",
              ("csr_sddmm", "k1"): "spmv"}
CSR_KERNELS = ("csr_spmv", "csr_spmm", "csr_sddmm")
TOL = {"float32": 1e-5, "bfloat16": 1e-5, "float64": 1e-12}
DTYPES = {"float32": (np.float32, torch.float32),
          "float64": (np.float64, torch.float64)}
N_BIG = 2**21
ROW_NNZ = 32
N_MM = 2**19
K_MM = 64
BAND = 16
N_GEMM = 2**19
N_LONG = 2**20   # rows of the long-row SpMV edge matrix
HBM_TBPS = 3.35  # published H100 SXM device-memory bandwidth
# Published peak operation rates of the H100 SXM (dense, FLOP/s), for the
# type of the stored values: float32 outside the tensor cores; bfloat16 on
# the tensor cores; float64 on the tensor cores (34 TFLOP/s outside them),
# the data sheet's fastest float64 rate.
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12, "float64": 67e12}
TIMED_LAUNCHES = 20
# A spin of the card queued before timed launches (about 25 ms on an H100),
# so that the host enqueues them all while it runs and the events time the
# card back to back, not the host's launch rate: a BSR product takes 0.05-3
# ms, a launch from Python tens of microseconds.
SPIN_CYCLES = 50_000_000
PLAIN_SPMM_LAUNCHES = 3
PROFILED_STEPS = 10
TRI_NBR = 4096   # bench.py's bsr cells: 1024 block rows of 128 x 128
TRI_BS = 128
BAND_BS = 8
PLAIN_BSR_SPMM_LAUNCHES = 5
BSR_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
              "float64": torch.float64}
N_DIA = 2**25    # bench.py's dia cells (n = 2**22) scaled past the L2
DIA9_OFFSETS = [-300, -130, -1, 0, 1, 7, 129, 250, 333]
LAP_K = 256      # lap3d: the 7-point Laplacian of a LAP_K**3 grid
STENCIL_K = 64   # the stencil path's grid


def nvidia_smi_card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


@contextlib.contextmanager
def phase(label: str):
    t0 = time.perf_counter()
    yield
    torch.cuda.synchronize()
    print(f"{label}: {time.perf_counter() - t0:.2f} s", flush=True)


def within(err: torch.Tensor, scale: torch.Tensor, tol: float, what: str):
    """Entry-by-entry check ``err <= tol * scale``."""
    bad = int((err > tol * scale).sum())
    if bad:
        worst = float((err / scale.clamp_min(1e-300)).max())
        raise AssertionError(
            f"{what}: {bad} entries outside tol {tol} (worst scaled error "
            f"{worst:.3e})")


def bitwise_equal(*tensors) -> bool:
    return all(torch.equal(tensors[0], t) for t in tensors[1:])


def free_memory():
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


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
    return csr, x, g, coo, seconds


def spmm_structures():
    """Host CSR arrays (sorted columns) of config[1]'s two matrices at
    n = 2**19: csr_random, 32 columns per row, one in each of 32 column
    strata; banded, offsets -16..16 clipped at the edges."""
    rng = np.random.default_rng(3)
    strata = N_MM // ROW_NNZ
    cols = (np.arange(ROW_NNZ, dtype=np.int64) * strata)[None, :] \
        + rng.integers(0, strata, size=(N_MM, ROW_NNZ))
    random = (np.arange(N_MM + 1, dtype=np.int64) * ROW_NNZ,
              cols.reshape(-1))
    lo = np.maximum(np.arange(N_MM) - BAND, 0)
    hi = np.minimum(np.arange(N_MM) + BAND, N_MM - 1)
    lens = hi - lo + 1
    rowptr = np.concatenate([[0], np.cumsum(lens)])
    banded = (rowptr, np.repeat(lo - rowptr[:-1], lens)
              + np.arange(rowptr[-1]))
    return {"random": random, "banded": banded}, rng


def spmm_inputs(device):
    """config[1] matrices, right-hand sides and output gradients, keyed by
    (matrix, dtype), plus the csc form of csr_random."""
    structures, rng = spmm_structures()
    mats, rhs = {}, {}
    for mname, (rowptr, colind) in structures.items():
        vals = rng.normal(size=colind.size)
        for name, (np_dtype, _) in DTYPES.items():
            mats[mname, name] = CsrMatrix(N_MM, N_MM, rowptr, colind,
                                          vals.astype(np_dtype),
                                          device=device)
    for name, (np_dtype, _) in DTYPES.items():
        X = rng.normal(size=(N_MM, K_MM)).astype(np_dtype)
        G = rng.normal(size=(N_MM, K_MM)).astype(np_dtype)
        rhs[name] = (torch.from_numpy(X).to(device),
                     torch.from_numpy(G).to(device))
        mats["csc", name] = mats["random", name].to_csc()
    return mats, rhs


def power_law(device):
    """``bench.py``'s config[2] generator (zipf 1.8 row lengths capped at
    512, uniform random columns, seed 1) at n = 2**19, in both dtypes on
    one structure. It can repeat a column within a row, as bench.py's
    does, which the validating constructor refuses, so the matrix goes
    through the trusted one; SpGEMM sums such terms like any other."""
    rng = np.random.default_rng(1)
    deg = np.minimum(rng.zipf(1.8, size=N_GEMM), 512)
    rowptr = np.concatenate([[0], np.cumsum(deg)])
    nnz = int(rowptr[-1])
    colind = rng.integers(0, N_GEMM, size=nnz)
    order = np.repeat(np.arange(N_GEMM), deg)
    colind = colind[np.lexsort((colind, order))]
    values = rng.normal(size=nnz)
    ptr_t = torch.from_numpy(rowptr.astype(np.int32)).to(device)
    ind_t = torch.from_numpy(colind.astype(np.int32)).to(device)
    return {name: CsrMatrix._from_parts(
                N_GEMM, N_GEMM, ptr_t, ind_t,
                torch.from_numpy(values.astype(np_dtype)).to(device))
            for name, (np_dtype, _) in DTYPES.items()}


def spgemm_plan_timed(a):
    """Build (and cache) the plan of ``a·a`` as ``a * a`` does; return it
    with the host seconds of the symbolic phase, its path, and the seconds
    of the rest (int32 conversion, upload, slot pointers)."""
    rec = metrics.enable()
    rec.records.clear()
    try:
        t0 = time.perf_counter()
        plan = spgemm_mod._cached_plan(a, a)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
        sym = [r for r in rec.records if r.op == "spgemm_symbolic"]
    finally:
        metrics.disable()
        rec.records.clear()
    if len(sym) != 1:
        raise AssertionError(f"expected one symbolic phase, got {sym}")
    return plan, sym[0].seconds, sym[0].path, total - sym[0].seconds


def reset_launches() -> None:
    for counts in [c for _, c in KERNELS.values()] + list(VARIANTS.values()):
        for key in counts:
            counts[key] = 0


def variant_counts() -> dict:
    return {kname: dict(counts) for kname, counts in VARIANTS.items()}


def record_variants(seen, shape: str, name: str, before) -> None:
    """Add to ``seen[kernel, shape, dtype]`` the launches of each variant
    since ``before`` (a ``variant_counts()``)."""
    for kname, counts in VARIANTS.items():
        per = {v: n - before[kname][v] for v, n in counts.items()
               if n != before[kname][v]}
        if per:
            seen[kname, shape, name] = per


def drive(label: str, path, totals) -> dict:
    """Run one main path between a reset and a read of every launch count;
    fail unless the counts are exactly the path's (MAIN_LAUNCHES), and, on
    a CSR path, unless the CSR kernel variants that ran are exactly its
    MAIN_VARIANTS. Adds the counts to ``totals``; returns the path's
    outputs."""
    with phase(f"main path {label}"):
        reset_launches()
        out = path()
        torch.cuda.synchronize()
        got = {kname: {key: n for key, n in counts.items() if n}
               for kname, (_, counts) in KERNELS.items()}
        got = {kname: per for kname, per in got.items() if per}
        ran = {kname: {v: n for v, n in VARIANTS[kname].items() if n}
               for kname in CSR_KERNELS}
        ran = {kname: per for kname, per in ran.items() if per}
    print(f"main path {label} launches: {got}")
    if got != MAIN_LAUNCHES[label]:
        raise AssertionError(f"main path {label}: kernel launch counts {got},"
                             f" expected {MAIN_LAUNCHES[label]}")
    if ran:
        print(f"main path {label} CSR variants: {ran}")
        if ran != MAIN_VARIANTS.get(label):
            raise AssertionError(f"main path {label}: CSR kernel variants "
                                 f"{ran}, expected {MAIN_VARIANTS.get(label)}")
    for kname, per in got.items():
        for key, n in per.items():
            totals[kname][key] += n
    return out


def run_config0(device, csr0, x0, seen):
    before = variant_counts()
    out = {"config0": csr0 @ torch.from_numpy(x0).to(device)}
    record_variants(seen, "config0", "float64", before)
    return out


def run_spmv(big, seen):
    """A forward and backward ``csr @ x`` per dtype; ``seen[kernel,
    "spmv", dtype]`` gets the variants each dtype's step ran."""
    out = {}
    for name, (csr, x, g) in big.items():
        before = variant_counts()
        values = csr.values.detach().clone().requires_grad_(True)
        xg = x.detach().clone().requires_grad_(True)
        y = csr.with_values(values) @ xg
        y.backward(g)
        out["spmv", name] = (y.detach(), values.grad, xg.grad)
        record_variants(seen, "spmv", name, before)
    return out


def run_spmm(mats, rhs, seen):
    """A forward and backward ``mat @ X`` per config[1] matrix;
    ``seen[kernel, matrix, dtype]`` gets the variants each step ran."""
    out = {}
    for (mname, name), mat in mats.items():
        before = variant_counts()
        X, G = rhs[name]
        values = mat.values.detach().clone().requires_grad_(True)
        Xg = X.detach().clone().requires_grad_(True)
        Y = mat.with_values(values) @ Xg
        Y.backward(G)
        out["spmm", mname, name] = (Y.detach(), values.grad, Xg.grad)
        record_variants(seen, mname, name, before)
    return out


def run_spgemm(gemm):
    """A forward and backward ``a * a`` per dtype."""
    out = {}
    for name, (a, gc) in gemm.items():
        values = a.values.detach().clone().requires_grad_(True)
        ag = a.with_values(values)
        c = ag * ag
        c.values.backward(gc)
        out["spgemm", name] = (c, values.grad)
    return out


def run_bsr(op: str, bsr_in, seen):
    """A forward and backward ``bsr @ x`` (op ``bsr_spmv``) or ``bsr @ X``
    (``bsr_spmm``) per BSR matrix; bfloat16 blocks take no gradient, their
    operand does. ``seen[op, shape, dtype]`` gets the launches of each
    kernel variant the matrix's step ran."""
    out = {}
    counts = VARIANTS[op]
    for (shape, name), (bsr, x, g, X, G) in bsr_in.items():
        before = dict(counts)
        rhs, gout = (x, g) if op == "bsr_spmv" else (X, G)
        data = bsr.data.detach().requires_grad_(name != "bfloat16")
        rg = rhs.detach().requires_grad_(True)
        y = bsr.with_data(data) @ rg
        y.backward(gout)
        out[op, shape, name] = (y.detach(), data.grad, rg.grad)
        seen[op, shape, name] = {v: n - before[v] for v, n in counts.items()
                                 if n != before[v]}
    return out


def check_variants(label: str, op: str, seen) -> None:
    """Fail unless the BSR main path ``label`` ran exactly the variants of
    MAIN_VARIANTS on each matrix."""
    got = {}
    for (o, shape, _), per in seen.items():
        if o == op:
            for v, n in per.items():
                got.setdefault(shape, {}).setdefault(v, 0)
                got[shape][v] += n
    print(f"main path {label} variants: {got}")
    if got != MAIN_VARIANTS[label]:
        raise AssertionError(f"main path {label}: kernel variants {got}, "
                             f"expected {MAIN_VARIANTS[label]}")


def on_card(a, dtype=None, shift: bool = False, device=None):
    """A NumPy array as a tensor on the card; ``shift`` makes it a view one
    element past a 16-byte boundary (the kernels' views off 16 bytes)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if dtype is not None:
        t = t.to(dtype)
    if not shift:
        return t.to(device)
    flat = torch.zeros(t.numel() + 1, dtype=t.dtype, device=device)
    flat[1:] = t.reshape(-1).to(device)
    return flat[1:].view(t.shape)


def ran_variant(counts, before, what: str) -> str:
    """The one variant launched since ``before`` (a copy of ``counts``).
    The SpMV's ``finish`` count (its second kernel, after a vector launch
    with split rows) names no variant."""
    ran = [v for v, n in counts.items() if n != before[v] and v != "finish"]
    if len(ran) != 1:
        raise AssertionError(f"{what}: variants {ran} ran, not one")
    return ran[0]


def edge_rowptr(lens, pad: int, rng, m: int):
    """Row pointer and column indices for row lengths ``lens``, with
    ``pad`` padding slots past ``rowptr[-1]``."""
    ptr = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    return ptr, rng.integers(0, m, size=int(ptr[-1]) + pad).astype(np.int32)


# Row lengths of the SpMV edge structures: every lane count of the scalar
# variant (mean row lengths 0.5 to 64); rows of 0, 1, 31, 32, 33 and 4096
# entries, on both sides of the vector variant's window budget (BUDGET =
# 256 entries) and of its 16-byte vectors; and one row of 150,000 entries
# among short ones, split over 586 warps.
def spmv_edge_lengths(rng, n: int):
    for mean in (0.5, 1.5, 3, 6, 12, 24, 64):
        lens = rng.poisson(mean, size=n)
        lens[::7] = 0
        yield f"mean row length {mean}", lens
    lens = rng.choice([0, 1, 31, 32, 33, 4096], size=n,
                      p=[0.2, 0.2, 0.2, 0.2, 0.19, 0.01])
    yield "rows of 0, 1, 31, 32, 33 and 4096 entries", lens
    lens = rng.poisson(5, size=n)
    lens[1234] = 150_000
    yield "a row of 150,000 entries", lens


def edge_structures(device) -> None:
    """SpMV kernel against plain version on structures the main path's
    matrices do not reach (spmv_edge_lengths), each with padding slots
    past ``rowptr[-1]`` holding values that must count for nothing, in both
    variants (operands on 16-byte boundaries: vector; colind, values or
    perm a view off one: scalar); the ``perm`` path bitwise against the
    materialised gather; and a matrix with no stored slots."""
    rng = np.random.default_rng(2)
    n = 3000
    for name, (np_dtype, torch_dtype) in DTYPES.items():
        x = on_card(rng.normal(size=n).astype(np_dtype), device=device)
        for what, lens in spmv_edge_lengths(rng, n):
            ptr, cols = edge_rowptr(lens, 37, rng, n)
            vals = rng.normal(size=cols.size).astype(np_dtype)
            perm = rng.permutation(cols.size).astype(np.int32)
            rowptr = on_card(ptr, device=device)
            for shifted in (None, "colind", "values", "perm"):
                colind = on_card(cols, shift=shifted == "colind",
                                 device=device)
                values = on_card(vals, shift=shifted == "values",
                                 device=device)
                p = on_card(perm, shift=shifted == "perm", device=device)
                label = (f"{name} SpMV edge structure, {what}"
                         + (f", {shifted} off 16 bytes" if shifted else ""))
                for use_perm in ((False, True) if shifted in (None, "perm")
                                 else (False,)):
                    if shifted == "perm" and not use_perm:
                        continue
                    kw = {"perm": p} if use_perm else {}
                    before = dict(spmv_mod.VARIANT_LAUNCHES)
                    y = csr_spmv(rowptr, colind, values, x, n, **kw)
                    variant = ran_variant(spmv_mod.VARIANT_LAUNCHES, before,
                                          label)
                    want = "scalar" if shifted else "vector"
                    if variant != want:
                        raise AssertionError(f"{label}: ran {variant}, "
                                             f"expected {want}")
                    v = values[p] if use_perm else values
                    y_p = csr_spmv_plain(rowptr, colind, v, x, n)
                    scale = csr_spmv_plain(rowptr, colind, v.abs(), x.abs(),
                                           n)
                    within((y - y_p).abs(), scale, TOL[name],
                           f"{label}{', perm' if use_perm else ''}")
                    if not bool((y[torch.from_numpy(lens == 0).to(device)]
                                 == 0).all()):
                        raise AssertionError(f"{label}: an empty row is not 0")
                    if not torch.equal(y, csr_spmv(rowptr, colind, values, x,
                                                   n, **kw)):
                        raise AssertionError(f"{label}: not bitwise "
                                             "repeatable")
                    if use_perm and shifted is None and not torch.equal(
                            y, csr_spmv(rowptr, colind, values[p].clone(), x,
                                        n)):
                        raise AssertionError(f"{label}: the perm path differs "
                                             "from the gathered values")
        before = dict(spmv_mod.LAUNCHES)
        empty = csr_spmv(torch.zeros(n + 1, dtype=torch.int32, device=device),
                         torch.zeros(0, dtype=torch.int32, device=device),
                         torch.zeros(0, dtype=torch_dtype, device=device),
                         x, n)
        if not bool((empty == 0).all()) or spmv_mod.LAUNCHES != before:
            raise AssertionError(f"{name}: a matrix with no entries launched "
                                 "or is not 0")
    torch.cuda.synchronize()


SPMM_EDGE_KS = (1, 3, 4, 32, 64, 100)


def spmm_edge_structures(device) -> None:
    """SpMM kernel against plain version: row lengths from empty to 40 on
    average, every seventh row empty, padding slots past ``rowptr[-1]``
    holding values, k in SPMM_EDGE_KS with X on and off a 16-byte boundary
    (both sides of the float32 vector variant's bound); the ``perm`` path bitwise
    against the materialised gather; a matrix with no stored slots, and
    k = 0, which launch nothing."""
    rng = np.random.default_rng(4)
    n, m = 3000, 2500
    for name, (np_dtype, torch_dtype) in DTYPES.items():
        for mean in (0.5, 3, 40):
            lens = rng.poisson(mean, size=n)
            lens[::7] = 0
            ptr, cols = edge_rowptr(lens, 37, rng, m)
            rowptr, colind = on_card(ptr, device=device), on_card(
                cols, device=device)
            values = on_card(rng.normal(size=cols.size).astype(np_dtype),
                             device=device)
            perm = on_card(rng.permutation(cols.size).astype(np.int32),
                           device=device)
            for k in SPMM_EDGE_KS:
                Xh = rng.normal(size=(m, k)).astype(np_dtype)
                for shift in (False, True):
                    X = on_card(Xh, shift=shift, device=device)
                    what = (f"{name} SpMM edge structure, mean {mean}, k {k}"
                            + (", X off 16 bytes" if shift else ""))
                    before = dict(spmm_mod.VARIANT_LAUNCHES)
                    Y = csr_spmm(rowptr, colind, values, X, n)
                    variant = ran_variant(spmm_mod.VARIANT_LAUNCHES, before,
                                          what)
                    want = ("vector" if name == "float32" and k % 4 == 0
                            and not shift else "register")
                    if variant != want:
                        raise AssertionError(f"{what}: ran {variant}, "
                                             f"expected {want}")
                    Y_p = csr_spmm_plain(rowptr, colind, values, X, n)
                    scale = csr_spmm_plain(rowptr, colind, values.abs(),
                                           X.abs(), n)
                    within((Y - Y_p).abs(), scale, TOL[name], what)
                    if not bool((Y[::7] == 0).all()):
                        raise AssertionError(f"{what}: an empty row is not 0")
                    if not torch.equal(Y, csr_spmm(rowptr, colind, values, X,
                                                   n)):
                        raise AssertionError(f"{what}: not bitwise repeatable")
                    if not torch.equal(
                            csr_spmm(rowptr, colind, values, X, n, perm=perm),
                            csr_spmm(rowptr, colind, values[perm], X, n)):
                        raise AssertionError(f"{what}: the perm path differs "
                                             "from the gathered values")
        before = dict(spmm_mod.LAUNCHES)
        X = torch.ones(m, 4, dtype=torch_dtype, device=device)
        none = csr_spmm(torch.zeros(n + 1, dtype=torch.int32, device=device),
                        torch.zeros(0, dtype=torch.int32, device=device),
                        torch.zeros(0, dtype=torch_dtype, device=device), X, n)
        zero_k = csr_spmm(rowptr, colind, values, X[:, :0], n)
        if (not bool((none == 0).all()) or zero_k.shape != (n, 0)
                or spmm_mod.LAUNCHES != before):
            raise AssertionError(f"{name}: no entries or k = 0 launched or "
                                 "gave a wrong result")
    torch.cuda.synchronize()


def sddmm_edge_structures(device) -> None:
    """SDDMM kernel against plain version: row lengths from empty to 40 on
    average, every seventh row empty, padding slots (major == nrows) that
    must give exactly 0, k in SPMM_EDGE_KS with G and X on and off a
    16-byte boundary (both variants); bitwise repeats; no slots."""
    rng = np.random.default_rng(8)
    n, m = 3000, 2500
    for name, (np_dtype, torch_dtype) in DTYPES.items():
        itemsize = np.dtype(np_dtype).itemsize
        for mean in (0.5, 3, 40):
            lens = rng.poisson(mean, size=n)
            lens[::7] = 0
            ptr, cols = edge_rowptr(lens, 37, rng, m)
            colind = on_card(cols, device=device)
            major = major_ids(on_card(ptr, device=device), cols.size)
            pad = major == n
            for k in SPMM_EDGE_KS:
                Gh = rng.normal(size=(n, k)).astype(np_dtype)
                Xh = rng.normal(size=(m, k)).astype(np_dtype)
                for shift in (False, True):
                    G = on_card(Gh, shift=shift, device=device)
                    X = on_card(Xh, device=device)
                    what = (f"{name} SDDMM edge structure, mean {mean}, k {k}"
                            + (", G off 16 bytes" if shift else ""))
                    before = dict(sddmm_mod.VARIANT_LAUNCHES)
                    out = csr_sddmm(major, colind, G, X, n)
                    variant = ran_variant(sddmm_mod.VARIANT_LAUNCHES, before,
                                          what)
                    want = ("vector" if k * itemsize % 16 == 0 and not shift
                            else "scalar")
                    if variant != want:
                        raise AssertionError(f"{what}: ran {variant}, "
                                             f"expected {want}")
                    ref = csr_sddmm_plain(major, colind, G, X, n)
                    scale = csr_sddmm_plain(major, colind, G.abs(), X.abs(),
                                            n)
                    within((out - ref).abs(), scale, TOL[name], what)
                    if not bool((out[pad] == 0).all()):
                        raise AssertionError(f"{what}: a padding slot is "
                                             "not 0")
                    if not torch.equal(out, csr_sddmm(major, colind, G, X,
                                                      n)):
                        raise AssertionError(f"{what}: not bitwise repeatable")
        before = dict(sddmm_mod.LAUNCHES)
        none = csr_sddmm(major[:0], colind[:0],
                         torch.ones(n, 4, dtype=torch_dtype, device=device),
                         torch.ones(m, 4, dtype=torch_dtype, device=device), n)
        if none.shape != (0,) or sddmm_mod.LAUNCHES != before:
            raise AssertionError(f"{name}: SDDMM with no slots launched")
    torch.cuda.synchronize()


def spgemm_edge_structures(device) -> None:
    """SpGEMM kernel against plain version on term lists the main path does
    not reach: empty slots (every ninth, and 40 in a row), one slot of
    12,000 terms and others of thousands, a slot count that is not a
    multiple of 32, operand padding past the referenced entries holding
    values; and n_out == 0, which launches nothing."""
    rng = np.random.default_rng(5)
    n_out, nnz_a, nnz_b = 5001, 4000, 3000
    lens = rng.poisson(1.3, size=n_out)
    lens[::9] = 0
    lens[200:240] = 0
    lens[17], lens[100], lens[101], lens[4999] = 12_000, 3000, 700, 2500
    tptr_np = np.concatenate([[0], np.cumsum(lens)])
    n_terms = int(tptr_np[-1])
    as_t = lambda a: torch.from_numpy(a.astype(np.int32)).to(device)  # noqa: E731
    tptr = as_t(tptr_np)
    gid = as_t(np.repeat(np.arange(n_out), lens))
    a_idx = as_t(rng.integers(0, nnz_a, size=n_terms))
    b_idx = as_t(rng.integers(0, nnz_b, size=n_terms))
    for name, (np_dtype, torch_dtype) in DTYPES.items():
        a = torch.from_numpy(rng.normal(size=nnz_a + 50).astype(np_dtype)
                             ).to(device)
        b = torch.from_numpy(rng.normal(size=nnz_b).astype(np_dtype)
                             ).to(device)
        out = spgemm_numeric(tptr, gid, a_idx, b_idx, a, b, n_out)
        ref = spgemm_numeric_plain(gid, a_idx, b_idx, a, b, n_out)
        scale = spgemm_numeric_plain(gid, a_idx, b_idx, a.abs(), b.abs(),
                                     n_out)
        within((out - ref).abs(), scale, TOL[name],
               f"{name} SpGEMM edge structure")
        if not bool((out[torch.from_numpy(lens == 0).to(device)] == 0).all()):
            raise AssertionError(f"{name}: an empty slot is not 0")
        if not torch.equal(out, spgemm_numeric(tptr, gid, a_idx, b_idx, a, b,
                                               n_out)):
            raise AssertionError(f"{name}: SpGEMM edge structure not "
                                 "bitwise repeatable")
        before = dict(numeric_mod.LAUNCHES)
        empty = spgemm_numeric(tptr[:1], gid[:0], a_idx[:0], b_idx[:0], a, b,
                               0)
        if empty.shape != (0,) or numeric_mod.LAUNCHES != before:
            raise AssertionError(f"{name}: n_out == 0 launched or gave a "
                                 "wrong result")
    torch.cuda.synchronize()


def spgemm_dense_checks(csr0, device) -> None:
    """``a * b``, ``csc * csc`` and ``a ** 3`` at config[0]'s size against
    dense products on the host, within 1e-12·(|A|·|B|)."""
    rng = np.random.default_rng(6)
    n = 1000
    rows, cols = rng.integers(0, n, 10_000), rng.integers(0, n, 10_000)
    b = CsrMatrix.from_coo(CooMatrix.with_triplets(
        n, n, rows, cols, rng.normal(size=10_000)), device=device)
    da, db = (m.to_dense().cpu().numpy() for m in (csr0, b))
    checks = (("a * b", csr0 * b, da @ db, np.abs(da) @ np.abs(db)),
              ("csc * csc", (csr0.to_csc() * b.to_csc()).to_csr(), da @ db,
               np.abs(da) @ np.abs(db)),
              ("a ** 3", csr0 ** 3, da @ da @ da,
               np.abs(da) @ np.abs(da) @ np.abs(da)))
    for what, c, ref, scale in checks:
        got = c.to_dense().cpu().numpy()
        if not (np.isfinite(got).all() and np.all(np.abs(got - ref)
                                                   <= 1e-12 * scale)):
            raise AssertionError(f"config[0] {what}: max error "
                                 f"{np.abs(got - ref).max():.3e}")
        print(f"phase 7: config[0] {what}: nnz {c.nnz}, matches the dense "
              f"product within 1e-12*(|A||B|), max |err| "
              f"{np.abs(got - ref).max():.3e}")


def time_ms(fn, launches: int, spin: bool = False) -> float:
    """Milliseconds a call of ``fn`` over ``launches`` calls, with CUDA
    events; ``spin`` queues a spin of the card before them (SPIN_CYCLES)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if spin:
        torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(launches):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / launches


def turns(kernel, plain, n_kernel: int, n_plain: int, spin: bool = False):
    """Times in turns (plain, kernel, kernel, plain) after a warm-up:
    ``(kernel_ms, plain_ms, (p1, k1, k2, p2))``."""
    for fn in (plain, kernel):
        time_ms(fn, 1)
    p1 = time_ms(plain, n_plain, spin)
    k1 = time_ms(kernel, n_kernel, spin)
    k2 = time_ms(kernel, n_kernel, spin)
    p2 = time_ms(plain, n_plain, spin)
    return (k1 + k2) / 2, (p1 + p2) / 2, (p1, k1, k2, p2)


def bound(nbytes: float, flops: float, name: str) -> dict:
    """The least time the card could take for the work: compulsory bytes
    over the published bandwidth or operations over the published peak for
    the type, whichever is larger, and which of the two it is."""
    by_bytes = nbytes / (HBM_TBPS * 1e12) * 1e3
    by_ops = flops / PEAK_FLOPS[name] * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def library_ms(fn, spin: bool = False) -> float:
    """Time of one PyTorch library call (a yardstick only: the port never
    calls it), after a warm-up."""
    time_ms(fn, 3)
    return time_ms(fn, TIMED_LAUNCHES, spin)


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


def print_profile(label: str, step, steps: int) -> None:
    wall, busy, per_name = profile_steps(step, steps)
    if not per_name:
        print(f"{label} profiler saw no device kernels: device time not "
              "measured")
        return
    print(f"{label} profiled {steps} steps: wall {wall:.4f} ms, device "
          f"kernels {busy:.4f} ms, idle share {max(0.0, 1 - busy / wall):.4f}")
    for kname, (ms, n) in per_name[:8]:
        print(f"{label}   {ms / steps:8.4f} ms/step {n / steps:4.1f} "
              f"launches/step  {kname[:90]}")


def where_the_time_goes(big, card: str) -> None:
    for name, (csr, x, g) in big.items():
        values = csr.values.detach().clone().requires_grad_(True)
        xg = x.detach().clone().requires_grad_(True)
        mat = csr.with_values(values)
        step = lambda: (mat @ xg).backward(g)  # noqa: E731
        for fn in (lambda: mat @ xg, step):
            time_ms(fn, 3)
        fwd = time_ms(lambda: mat @ xg, TIMED_LAUNCHES)
        fwd_bwd = time_ms(step, PROFILED_STEPS)
        build = time_ms(lambda: transpose_structure(
            csr.rowptr, csr.colind, n_major=N_BIG, n_minor=N_BIG), 3)
        print(f"phase 5: {name} csr @ x (autograd on) {fwd:.4f} ms; forward "
              f"+ backward {fwd_bwd:.4f} ms/step; transpose_structure "
              f"{build:.4f} ms | {card}")
        print_profile(f"phase 5: {name}", step, PROFILED_STEPS)


def check_spmv(big, main_out, report) -> None:
    for name, (csr, x, g) in big.items():
        tol = TOL[name]
        rowptr, colind, values = csr.rowptr, csr.colind, csr.values
        y, dvals, dx = main_out["spmv", name]
        y_p = csr_spmv_plain(rowptr, colind, values, x, N_BIG)
        scale = csr_spmv_plain(rowptr, colind, values.abs(), x.abs(), N_BIG)
        err = (y - y_p).abs()
        within(err, scale, tol, f"{name} forward")
        y1 = csr_spmv(rowptr, colind, values, x, N_BIG)
        y2 = csr_spmv(rowptr, colind, values, x, N_BIG)
        torch.cuda.synchronize()
        if not bitwise_equal(y, y1, y2):
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
        # The backward's Aᵀ·g reads the values through the transpose's
        # perm: bitwise the kernel on the gathered copy.
        t = transpose_plan(rowptr, colind, N_BIG, N_BIG)
        if not torch.equal(dx, csr_spmv(t.ptr, t.minor, values[t.perm], g,
                                        N_BIG)):
            raise AssertionError(f"{name}: Aᵀ·g through perm differs from "
                                 "the kernel on the gathered values")
        sd = csr_sddmm(t.major, colind, g, x, N_BIG)
        sd_err = (sd - csr_sddmm_plain(t.major, colind, g, x, N_BIG)).abs()
        within(sd_err, (g[rows] * x[cols]).abs(), tol, f"{name} SDDMM k=1")
        if not torch.equal(sd, dvals.to(sd.dtype)):
            raise AssertionError(f"{name}: SDDMM differs from the main "
                                 "path's dvals")
        report["csr_spmv", name] = {"max_abs_err": float(err.max())}
        report["csr_sddmm", f"{name}_k1"] = {
            "max_abs_err": float(sd_err.max())}
        print(f"phase 3: {name}: kernel == plain within {tol}*(|A||x|) row by "
              f"row (max |err| {float(err.max()):.3e}); bitwise repeatable; "
              f"dx and dvals match the plain autograd; Aᵀ·g through perm "
              f"bitwise equal to the gathered form; SDDMM k=1 == plain "
              f"(max |err| {float(sd_err.max()):.3e})")
        del y_p, scale, y1, y2, v_p, x_p, dvals_p, dx_p, rows, cols, scale_dx
        del sd, sd_err
    edge_structures(big["float32"][0].device)
    print("phase 3: SpMV edge structures (lane counts 1..32; rows of 0, 1, "
          "31, 32, 33, 4096 and 150,000 entries; padding with values; "
          "colind, values and perm off 16 bytes; the perm path; no "
          "entries): kernel == plain in float32 and float64, both variants")
    sddmm_edge_structures(big["float32"][0].device)
    print("phase 3: SDDMM edge structures (padding slots, k in "
          f"{', '.join(map(str, SPMM_EDGE_KS))}, G off 16 bytes, no slots): "
          "kernel == plain in float32 and float64, both variants")
    check_metrics_paths(big["float32"][0].device)
    print("phase 3: from_dense CSR and CSC on the card: csr @ x and csc @ x "
          "match NumPy, nnz_device is the entry count, and the metrics path "
          "names the SpMV variant that launched")


def check_metrics_paths(device) -> None:
    """With the metrics recorder on, ``csr @ x`` and ``csc @ x`` (matrices
    made by ``from_dense`` on the card) record the SpMV variant that
    launched, the CSC one through its mirror, and ``nnz_device`` is the
    entry count."""
    rng = np.random.default_rng(5)
    dense = rng.normal(size=(96, 80)) * (rng.random((96, 80)) < 0.2)
    x = torch.from_numpy(rng.normal(size=80)).to(device)
    rec = metrics.enable()
    rec.records.clear()
    try:
        for op, mat in (("csr_spmv", CsrMatrix.from_dense(dense,
                                                          device=device)),
                        ("csc_spmv", CscMatrix.from_dense(dense,
                                                          device=device))):
            if int(mat.nnz_device()) != int(np.count_nonzero(dense)):
                raise AssertionError(f"{op}: nnz_device {mat.nnz_device()}")
            before = dict(spmv_mod.VARIANT_LAUNCHES)
            y = mat @ x
            variant = ran_variant(spmv_mod.VARIANT_LAUNCHES, before, op)
            want = f"{op}:cuda:{variant}"
            if rec.records[-1].path != want:
                raise AssertionError(f"{op}: metrics path "
                                     f"{rec.records[-1].path}, ran {want}")
            err = (y - torch.from_numpy(dense @ x.cpu().numpy()).to(device))
            within(err.abs(), torch.from_numpy(
                np.abs(dense) @ np.abs(x.cpu().numpy())).to(device),
                TOL["float64"], f"{op} from_dense")
    finally:
        metrics.disable()
        rec.records.clear()


def sampled_addmm_ms(rowptr, colind, values, G, X, shape):
    """Time of ``torch.sparse.sampled_addmm(A, G, Xᵀ, beta=0)``, the SDDMM
    of the pattern of ``A`` (a yardstick only), behind the spin; None, with
    the reason printed, where torch refuses it."""
    pattern = torch.sparse_csr_tensor(rowptr, colind, values, shape)
    try:
        ms = library_ms(lambda: torch.sparse.sampled_addmm(
            pattern, G, X.T, beta=0.0), spin=True)
    except RuntimeError as e:
        print(f"torch.sparse.sampled_addmm refused: {str(e)[:200]}")
        ms = None
    del pattern
    free_memory()
    return ms


def time_sddmm(rowptr, colind, G, X, nrows: int, what: str, card: str):
    """SDDMM kernel and plain version in turns behind the spin, the
    library call beside them; returns the kernel line's numbers."""
    t = transpose_plan(rowptr, colind, nrows, X.shape[0])
    k = 1 if G.ndim == 1 else G.shape[1]
    k_ms, p_ms, (p1, k1, k2, p2) = turns(
        lambda: csr_sddmm(t.major, colind, G, X, nrows),
        lambda: csr_sddmm_plain(t.major, colind, G, X, nrows),
        TIMED_LAUNCHES, PLAIN_SPMM_LAUNCHES, spin=True)
    free_memory()
    nse, itemsize = colind.numel(), G.element_size()
    # compulsory bytes: rowptr, the column ids, the output, G and X once
    # (the kernel's per-slot row ids are its design's cost, not the
    # function's: 4·nse bytes more)
    nbytes = ((4 + itemsize) * nse + 4 * (nrows + 1)
              + itemsize * k * (nrows + X.shape[0]))
    values = torch.ones(nse, dtype=G.dtype, device=G.device)
    lib_ms = sampled_addmm_ms(rowptr, colind, values,
                              G if G.ndim == 2 else G[:, None],
                              X if X.ndim == 2 else X[:, None],
                              (nrows, X.shape[0]))
    del values
    for label, ms in (("kernel", k_ms), ("plain", p_ms), ("library", lib_ms)):
        if ms is not None:
            gbs = nbytes / ms / 1e6
            print(f"phase 4/8: {what} SDDMM k={k} {label}: {ms:.4f} ms, "
                  f"{gbs:.1f} GB/s, {100 * gbs / (HBM_TBPS * 1e3):.1f} % of "
                  f"{HBM_TBPS} TB/s | {card}")
    print(f"phase 4/8: {what} SDDMM k={k} turns (ms): plain {p1:.4f}, kernel "
          f"{k1:.4f}, kernel {k2:.4f}, plain {p2:.4f}")
    return dict(ms=k_ms, plain_ms=p_ms, library_ms=lib_ms,
                **bound(nbytes, 2 * nse * k,
                        "float64" if G.dtype == torch.float64 else "float32"))


def time_spmv(big, report, card: str) -> None:
    """SpMV kernel and plain version in turns, torch's CSR product, and
    SDDMM at k = 1 (the SpMV backward's dvals), each run of launches
    behind a queued spin of the card."""
    for name, (csr, x, g) in big.items():
        rowptr, colind, values = csr.rowptr, csr.colind, csr.values
        k_ms, p_ms, (p1, k1, k2, p2) = turns(
            lambda: csr_spmv(rowptr, colind, values, x, N_BIG),
            lambda: csr_spmv_plain(rowptr, colind, values, x, N_BIG),
            TIMED_LAUNCHES, TIMED_LAUNCHES, spin=True)
        nnz, itemsize = csr.nse, values.element_size()
        nbytes = (itemsize + 4) * nnz + itemsize * 2 * N_BIG + 4 * (N_BIG + 1)
        for label, ms in (("kernel", k_ms), ("plain", p_ms)):
            gbs = nbytes / ms / 1e6
            print(f"phase 4: {name} {label}: {ms:.4f} ms/SpMV, "
                  f"{nnz / ms / 1e6:.2f} Gnnz/s, {gbs:.1f} GB/s, "
                  f"{100 * gbs / (HBM_TBPS * 1e3):.1f} % of {HBM_TBPS} TB/s "
                  f"| {card}")
        print(f"phase 4: {name} turns (ms): plain {p1:.4f}, kernel {k1:.4f}, "
              f"kernel {k2:.4f}, plain {p2:.4f}")
        t = transpose_plan(rowptr, colind, N_BIG, N_BIG)
        gathered = values[t.perm]
        perm_ms = time_ms(lambda: csr_spmv(t.ptr, t.minor, values, g, N_BIG,
                                           perm=t.perm), TIMED_LAUNCHES,
                          spin=True)
        gath_ms = time_ms(lambda: csr_spmv(t.ptr, t.minor, gathered, g,
                                           N_BIG), TIMED_LAUNCHES, spin=True)
        copy_ms = time_ms(lambda: values[t.perm], TIMED_LAUNCHES, spin=True)
        del gathered
        print(f"phase 4: {name} Aᵀ·g: through perm {perm_ms:.4f} ms; on the "
              f"gathered copy {gath_ms:.4f} ms + the gather values[perm] "
              f"{copy_ms:.4f} ms | {card}")
        lib = torch.sparse_csr_tensor(rowptr, colind, values, (N_BIG, N_BIG))
        lib_ms = library_ms(lambda: lib @ x, spin=True)
        diff = (lib @ x - csr_spmv(rowptr, colind, values, x, N_BIG)).abs()
        print(f"phase 4: {name} library torch.sparse_csr_tensor @ x: "
              f"{lib_ms:.4f} ms (max |diff| to the kernel "
              f"{float(diff.max()):.3e}) | {card}")
        del lib, diff
        report["csr_spmv", name].update(
            ms=k_ms, plain_ms=p_ms, library_ms=lib_ms,
            **bound(nbytes, 2 * nnz, name))
        report["csr_sddmm", f"{name}_k1"].update(time_sddmm(
            rowptr, colind, g, x, N_BIG, f"{name} csr_random n={N_BIG}",
            card))


def long_row_matrix(np_dtype, device):
    """An edge matrix for the long-row split at scale: N_LONG rows of 8
    random entries on average (Poisson), with row 777 holding 300,000 and
    row N_LONG // 2 holding 120,000 entries."""
    rng = np.random.default_rng(9)
    n = N_LONG
    lens = rng.poisson(8, size=n)
    lens[777], lens[n // 2] = 300_000, 120_000
    ptr = np.concatenate([[0], np.cumsum(lens)])
    cols = rng.integers(0, n, size=int(ptr[-1]))
    order = np.repeat(np.arange(n), lens)
    cols = cols[np.lexsort((cols, order))]
    return CsrMatrix._from_parts(
        n, n, on_card(ptr.astype(np.int32), device=device),
        on_card(cols.astype(np.int32), device=device),
        on_card(rng.normal(size=cols.size).astype(np_dtype), device=device))


def skewed_spmv(gemm, card: str) -> None:
    """SpMV on the power-law matrix of phase 7 (zipf 1.8, rows up to 512)
    and on a matrix with rows of 300,000 and 120,000 entries: kernel
    against plain version row by row, bitwise repeats, times behind the
    spin; both exercise the vector variant's long-row split."""
    for name, (np_dtype, _) in DTYPES.items():
        a = gemm[name][0]
        for what, mat in (("power-law", a),
                          ("long rows", long_row_matrix(np_dtype, a.device))):
            rowptr, colind, values = mat.rowptr, mat.colind, mat.values
            n = mat.nrows
            x = torch.randn(n, dtype=values.dtype, device=values.device,
                            generator=torch.Generator(
                                device=values.device).manual_seed(12))
            plan = spmv_mod.csr_spmv_plan(rowptr)
            before = dict(spmv_mod.VARIANT_LAUNCHES)
            y = csr_spmv(rowptr, colind, values, x, n)
            variant = ran_variant(spmv_mod.VARIANT_LAUNCHES, before,
                                  f"{name} {what} SpMV")
            finished = spmv_mod.VARIANT_LAUNCHES["finish"] - before["finish"]
            if finished != int(plan.nlong > 0):
                raise AssertionError(f"{name} {what}: {finished} finishing "
                                     f"launches counted, {plan.nlong} rows "
                                     "split")
            err = (y - csr_spmv_plain(rowptr, colind, values, x, n)).abs()
            within(err, csr_spmv_plain(rowptr, colind, values.abs(), x.abs(),
                                       n), TOL[name], f"{name} {what} SpMV")
            if not torch.equal(y, csr_spmv(rowptr, colind, values, x, n)):
                raise AssertionError(f"{name} {what}: not bitwise repeatable")
            lens = rowptr[1:] - rowptr[:-1]
            ms = time_ms(lambda: csr_spmv(rowptr, colind, values, x, n),
                         TIMED_LAUNCHES, spin=True)
            lib = torch.sparse_csr_tensor(rowptr, colind, values, mat.shape)
            lib_ms = library_ms(lambda: lib @ x, spin=True)
            print(f"phase 4: {name} {what} SpMV n={n} nnz={mat.nse} (rows "
                  f"up to {int(lens.max())} entries; {plan.nlong} rows over "
                  f"{BUDGET} split into {plan.npieces} pieces): {variant} "
                  f"kernel == plain within {TOL[name]}*(|A||x|) (max |err| "
                  f"{float(err.max()):.3e}), bitwise repeatable; {ms:.4f} ms, "
                  f"torch.sparse_csr_tensor @ x {lib_ms:.4f} ms | {card}")
            del y, err, lib, lens, x
        free_memory()


def check_spmm(mats, rhs, main_out, report) -> None:
    for (mname, name), mat in mats.items():
        if mname == "csc":
            continue
        tol = TOL[name]
        X, G = rhs[name]
        rowptr, colind, values = mat.rowptr, mat.colind, mat.values
        Y, dvals, dX = main_out["spmm", mname, name]
        what = f"{name} {mname} SpMM"
        Y_p = csr_spmm_plain(rowptr, colind, values, X, N_MM)
        err = (Y - Y_p).abs()
        del Y_p
        within(err, csr_spmm_plain(rowptr, colind, values.abs(), X.abs(),
                                   N_MM), tol, f"{what} forward")
        max_err = float(err.max())
        del err
        if not bitwise_equal(Y, csr_spmm(rowptr, colind, values, X, N_MM),
                             csr_spmm(rowptr, colind, values, X, N_MM)):
            raise AssertionError(f"{what}: kernel results differ run to run")
        v_p = values.detach().clone().requires_grad_(True)
        X_p = X.detach().clone().requires_grad_(True)
        dvals_p, dX_p = torch.autograd.grad(
            csr_spmm_plain(rowptr, colind, v_p, X_p, N_MM), (v_p, X_p), G)
        del v_p, X_p
        t = transpose_plan(rowptr, colind, N_MM, N_MM)
        within((dX - dX_p).abs(), csr_spmm_plain(
            t.ptr, t.minor, values.abs()[t.perm], G.abs(), N_MM), tol,
            f"{what} dX")
        dvals_scale = csr_sddmm_plain(t.major, colind, G.abs(), X.abs(), N_MM)
        within((dvals - dvals_p).abs(), dvals_scale, tol, f"{what} dvals")
        if not torch.equal(dX, csr_spmm(t.ptr, t.minor, values[t.perm], G,
                                        N_MM)):
            raise AssertionError(f"{what}: Aᵀ·G through perm differs from "
                                 "the kernel on the gathered values")
        sd = csr_sddmm(t.major, colind, G, X, N_MM)
        sd_err = (sd - csr_sddmm_plain(t.major, colind, G, X, N_MM)).abs()
        within(sd_err, dvals_scale, tol, f"{what} SDDMM k={K_MM}")
        if not torch.equal(sd, dvals):
            raise AssertionError(f"{what}: SDDMM differs from the main "
                                 "path's dvals")
        del dvals_scale, sd
        del dvals_p, dX_p
        free_memory()
        if mname == "random":
            Yc, dvals_c, dX_c = main_out["spmm", "csc", name]
            mirror = transpose_plan(mats["csc", name].colptr,
                                    mats["csc", name].rowind, N_MM, N_MM)
            if not bitwise_equal(Yc, Y) or not bitwise_equal(dX_c, dX) \
                    or not bitwise_equal(dvals_c[mirror.perm], dvals):
                raise AssertionError(f"{name}: csc @ X differs from csr @ X")
            report["csr_spmm", name] = {"max_abs_err": max_err}
            report["csr_sddmm", name] = {"max_abs_err": float(sd_err.max())}
        else:
            report["csr_spmm", f"{name}_{mname}"] = {"max_abs_err": max_err}
        del sd_err
        print(f"phase 6: {what} n={N_MM} nnz={mat.nnz} k={K_MM}: kernel == "
              f"plain within {tol}*(|A||X|) entry by entry (max |err| "
              f"{max_err:.3e}); bitwise repeatable; dX and dvals match the "
              f"plain autograd; Aᵀ·G through perm bitwise equal to the "
              f"gathered form; SDDMM k={K_MM} == plain and == dvals"
              + ("; csc @ X through the mirror bitwise equal to csr @ X"
                 if mname == "random" else ""))
    spmm_edge_structures(X.device)
    print("phase 6: SpMM edge structures (empty rows, padding with values, k "
          f"in {', '.join(map(str, SPMM_EDGE_KS))}, X off 16 bytes, the perm "
          "path; no entries; k = 0): kernel == plain in float32 and "
          "float64, both variants")


def check_spgemm(gemm, plan, main_out, report) -> None:
    for name, (a, gc) in gemm.items():
        tol = TOL[name]
        c, dvals = main_out["spgemm", name]
        if not (torch.equal(c.rowptr, plan.rowptr)
                and torch.equal(c.colind, plan.colind)
                and c.values.shape == (plan.n_out,)
                and c.values.dtype == a.dtype
                and bool(torch.isfinite(c.values).all())):
            raise AssertionError(f"{name}: A·A has the wrong structure, "
                                 "dtype or non-finite values")
        args = (plan.gid, plan.a_idx, plan.b_idx)
        v = a.values
        ref = spgemm_numeric_plain(*args, v, v, plan.n_out)
        scale = spgemm_numeric_plain(*args, v.abs(), v.abs(), plan.n_out)
        err = (c.values.detach() - ref).abs()
        within(err, scale, tol, f"{name} SpGEMM")
        again = [spgemm_numeric(plan.tptr, *args, v, v, plan.n_out)
                 for _ in range(2)]
        if not bitwise_equal(c.values.detach(), *again):
            raise AssertionError(f"{name}: SpGEMM results differ run to run")
        v_p = v.detach().clone().requires_grad_(True)
        (dv_p,) = torch.autograd.grad(
            spgemm_numeric_plain(*args, v_p, v_p, plan.n_out), (v_p,), gc)
        gg = gc.abs()[plan.gid]
        scale_dv = torch.zeros_like(v).index_add_(
            0, plan.a_idx, gg * v.abs()[plan.b_idx]).index_add_(
            0, plan.b_idx, gg * v.abs()[plan.a_idx])
        within((dvals - dv_p).abs(), scale_dv, tol, f"{name} SpGEMM dvals")
        report["spgemm", name] = {"max_abs_err": float(err.max())}
        print(f"phase 7: {name} A·A n={N_GEMM} nnz_a={a.nnz} terms="
              f"{plan.a_idx.numel()} n_out={plan.n_out}: kernel == plain "
              f"within {tol}*sum|a||b| slot by slot (max |err| "
              f"{float(err.max()):.3e}); bitwise repeatable; the gradient "
              f"matches the plain autograd")
        del ref, scale, err, again, v_p, dv_p, gg, scale_dv
    spgemm_edge_structures(plan.gid.device)
    print("phase 7: SpGEMM edge structures (empty slots, a 12,000-term slot, "
          "n_out == 0): kernel == plain in float32 and float64")


def time_spmm_spgemm(mats, rhs, gemm, plan, report, card: str) -> None:
    for (mname, name), mat in mats.items():
        if mname == "csc":
            continue
        X, _ = rhs[name]
        rowptr, colind, values = mat.rowptr, mat.colind, mat.values
        k_ms, p_ms, (p1, k1, k2, p2) = turns(
            lambda: csr_spmm(rowptr, colind, values, X, N_MM),
            lambda: csr_spmm_plain(rowptr, colind, values, X, N_MM),
            TIMED_LAUNCHES, PLAIN_SPMM_LAUNCHES, spin=True)
        free_memory()
        nnz, itemsize = mat.nse, values.element_size()
        nbytes = ((itemsize + 4) * nnz + itemsize * K_MM * 2 * N_MM
                  + 4 * (N_MM + 1))
        for label, ms in (("kernel", k_ms), ("plain", p_ms)):
            gbs = nbytes / ms / 1e6
            print(f"phase 8: {name} {mname} SpMM k={K_MM} {label}: {ms:.4f} "
                  f"ms, {2 * nnz * K_MM / ms / 1e6:.1f} GFLOP/s, {gbs:.1f} "
                  f"GB/s, {100 * gbs / (HBM_TBPS * 1e3):.1f} % of "
                  f"{HBM_TBPS} TB/s | {card}")
        print(f"phase 8: {name} {mname} SpMM turns (ms): plain {p1:.4f}, "
              f"kernel {k1:.4f}, kernel {k2:.4f}, plain {p2:.4f}")
        lib = torch.sparse_csr_tensor(rowptr, colind, values, (N_MM, N_MM))
        lib_ms = library_ms(lambda: lib @ X, spin=True)
        print(f"phase 8: {name} {mname} library torch.sparse_csr_tensor @ X: "
              f"{lib_ms:.4f} ms | {card}")
        del lib
        free_memory()
        row = name if mname == "random" else f"{name}_{mname}"
        report["csr_spmm", row].update(
            ms=k_ms, plain_ms=p_ms, library_ms=lib_ms,
            **bound(nbytes, 2 * nnz * K_MM, name))
        if mname == "random":
            # every entry gathers a whole row of X, which is larger than
            # the L2 here: the floor if no gather hits L2
            gather_ms = ((itemsize + 4) * nnz + itemsize * K_MM * (nnz + N_MM)
                         ) / (HBM_TBPS * 1e12) * 1e3
            print(f"phase 8: {name} random SpMM: gathers of X rows with no L2 "
                  f"hit would take {gather_ms:.4f} ms at {HBM_TBPS} TB/s "
                  f"(compulsory-byte bound "
                  f"{report['csr_spmm', row]['bound_ms']:.4f} ms)")
            G = rhs[name][1]
            report["csr_sddmm", name].update(time_sddmm(
                rowptr, colind, G, X, N_MM, f"{name} csr_random n={N_MM}",
                card))
    n_terms = plan.a_idx.numel()
    args = (plan.gid, plan.a_idx, plan.b_idx)
    for name, (a, _) in gemm.items():
        v = a.values
        k_ms, p_ms, (p1, k1, k2, p2) = turns(
            lambda: spgemm_numeric(plan.tptr, *args, v, v, plan.n_out),
            lambda: spgemm_numeric_plain(*args, v, v, plan.n_out),
            TIMED_LAUNCHES, TIMED_LAUNCHES, spin=True)
        for label, ms in (("kernel", k_ms), ("plain", p_ms)):
            print(f"phase 8: {name} SpGEMM numeric {label}: {ms:.4f} ms, "
                  f"{n_terms / ms / 1e6:.3f} Gterms/s | {card}")
        print(f"phase 8: {name} SpGEMM turns (ms): plain {p1:.4f}, kernel "
              f"{k1:.4f}, kernel {k2:.4f}, plain {p2:.4f}")
        # compulsory bytes: term lists, slot pointers, the value array (A·A
        # reads one array as both operands, counted once) and the output;
        # one multiply-add per term
        itemsize = v.element_size()
        nbytes = (8 * n_terms + 4 * (plan.n_out + 1)
                  + itemsize * (v.numel() + plan.n_out))
        report["spgemm", name].update(ms=k_ms, plain_ms=p_ms,
                                      library_ms=None,
                                      **bound(nbytes, 2 * n_terms, name))


def profile_spmm_spgemm(mats, rhs, gemm, card: str) -> None:
    for name in DTYPES:
        X, G = rhs[name]
        mat = mats["random", name]
        values = mat.values.detach().clone().requires_grad_(True)
        Xg = X.detach().clone().requires_grad_(True)
        m = mat.with_values(values)
        step = lambda: (m @ Xg).backward(G)  # noqa: E731
        time_ms(step, 2)
        print(f"phase 9: {name} csr_random SpMM k={K_MM} forward + backward "
              f"{time_ms(step, 3):.4f} ms/step | {card}")
        print_profile(f"phase 9: {name} SpMM fwd+bwd", step, 3)
        a, _ = gemm[name]
        gstep = lambda: a * a  # noqa: E731
        time_ms(gstep, 2)
        print(f"phase 9: {name} A·A (plan cached) {time_ms(gstep, 5):.4f} "
              f"ms/product | {card}")
        print_profile(f"phase 9: {name} SpGEMM", gstep, 5)
        del values, Xg, m
        free_memory()


def tri128_matrices(device, gen):
    """``bench.py::_make_bsr``'s block-tridiagonal pattern of 128 x 128
    blocks at TRI_NBR block rows, data generated on the card, through the
    validating constructor: float32 and float64 data drawn separately,
    bfloat16 as ``astype`` of the float32 matrix."""
    i = np.arange(TRI_NBR)
    cols = np.stack([i - 1, i, i + 1], 1)
    keep = (cols >= 0) & (cols < TRI_NBR)
    indptr = np.concatenate([[0], np.cumsum(keep.sum(1))])
    indices = cols[keep]
    n = TRI_NBR * TRI_BS
    out = {}
    for name in ("float32", "float64"):
        data = torch.randn((indices.size, TRI_BS, TRI_BS), generator=gen,
                           dtype=BSR_DTYPES[name], device=device)
        out[name] = BsrMatrix(n, n, TRI_BS, indptr, indices, data,
                              device=device)
    out["bfloat16"] = out["float32"].astype(torch.bfloat16)
    return out


def bsr_inputs(device, mats):
    """The BSR matrices with ``x``, ``g``, ``X`` and ``G`` (k = K_MM) on the
    card, keyed by (shape, dtype): tri128 in three dtypes; banded8, the
    config[1] banded CSR matrices through ``to_bsr(8)``, in two."""
    gen = torch.Generator(device=device).manual_seed(11)
    t0 = time.perf_counter()
    shapes = {"tri128": tri128_matrices(device, gen)}
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    shapes["banded8"] = {name: mats["banded", name].to_bsr(BAND_BS)
                         for name in DTYPES}
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    out = {}
    for shape, by_dtype in shapes.items():
        for name, bsr in by_dtype.items():
            acc = torch.float64 if name == "float64" else torch.float32
            n = bsr.nrows
            out[shape, name] = (bsr, *(
                torch.randn(size, generator=gen, dtype=acc, device=device)
                for size in ((n,), (n,), (n, K_MM), (n, K_MM))))
            print(f"phase 10: {shape} {name}: n={n} blocksize={bsr.blocksize}"
                  f" blocks={bsr.n_blocks} stored values={bsr.nnz} data "
                  f"{bsr.data.numel() * bsr.data.element_size() / 1e6:.1f} MB")
    print(f"phase 10: tri128 generation + BsrMatrix(...) {t1 - t0:.2f} s; "
          f"banded8 CsrMatrix.to_bsr(8) in two dtypes {t2 - t1:.2f} s")
    return out


# Block sizes of the BSR edge structures and the k of each (None: bsr @ x).
# The first seven reach neither variant bound of the SpMM or sit below it;
# (128, 128) to (64, 8) sit on both sides of the tiled SpMM's (br >= 32,
# bc >= 16, k >= 16, 16-byte rows of the blocks and of X) and of the vector
# SpMV's (16-byte block rows), with ragged row, column and depth tiles.
BSR_EDGE_KS = (None, 1, 3, 32, 64, 100)
BSR_EDGE_CASES = {
    (1, 1): BSR_EDGE_KS, (3, 3): BSR_EDGE_KS, (8, 8): BSR_EDGE_KS,
    (4, 8): BSR_EDGE_KS, (8, 4): BSR_EDGE_KS, (5, 40): BSR_EDGE_KS,
    (384, 384): BSR_EDGE_KS,
    (128, 128): (None, 1, 16, 17, 32, 64, 65, 100, 130),
    (96, 160): BSR_EDGE_KS, (64, 64): BSR_EDGE_KS, (40, 48): BSR_EDGE_KS,
    (40, 18): BSR_EDGE_KS, (64, 8): BSR_EDGE_KS,
}


def bsr_edge_case(kern, indptr, indices, data, x, empty, tol, what):
    """One BSR edge case: kernel against plain version within
    ``tol·(|A||x|)``, empty rows 0, a bitwise repeat. Returns the variant
    that ran."""
    counts = VARIANTS["bsr_spmv" if kern is bsr_spmv else "bsr_spmm"]
    before = dict(counts)
    y = kern(indptr, indices, data, x)
    ran = ran_variant(counts, before, what)
    within((y - bsr_spmv_plain(indptr, indices, data, x)).abs(),
           bsr_spmv_plain(indptr, indices, data.abs(), x.abs()), tol, what)
    if not bool((y[empty] == 0).all()):
        raise AssertionError(f"{what}: an empty row is not 0")
    if not torch.equal(y, kern(indptr, indices, data, x)):
        raise AssertionError(f"{what}: not bitwise repeatable")
    return ran


def bsr_edge_structures(device) -> dict:
    """BSR kernels against plain versions on structures the main path does
    not reach (BSR_EDGE_CASES): every fourth block row empty; padding
    blocks past ``indptr[-1]`` holding values that must count for nothing;
    a ``data`` view 4 bytes off a 16-byte boundary (8 in float64) and an
    operand view one element off it, which must take the scalar and
    register variants; a matrix with no blocks and k = 0, which launch
    nothing. Returns, per dtype, the cases each variant ran."""
    rng = np.random.default_rng(8)
    gen = torch.Generator(device=device).manual_seed(12)
    ran = {name: {} for name in BSR_DTYPES}
    for (br, bc), ks in BSR_EDGE_CASES.items():
        nbr, nbc = (60, 50) if max(br, bc) < 100 else (6, 5)
        lens = rng.poisson(2.0, nbr)
        lens[::4] = 0
        ptr = np.concatenate([[0], np.cumsum(lens)])
        nblocks = int(ptr[-1]) + 3
        indptr = torch.from_numpy(ptr.astype(np.int32)).to(device)
        indices = torch.from_numpy(
            rng.integers(0, nbc, nblocks).astype(np.int32)).to(device)
        empty = torch.from_numpy(np.repeat(lens == 0, br)).to(device)
        for name, dtype in BSR_DTYPES.items():
            acc = torch.float64 if name == "float64" else torch.float32
            data = torch.randn((nblocks, br, bc), generator=gen, dtype=acc,
                               device=device).to(dtype)
            # the same blocks 4 bytes (one float64) past a 16-byte boundary
            shift = max(1, 4 // data.element_size())
            off_data = torch.empty(data.numel() + shift, dtype=dtype,
                                   device=device)[shift:].view(data.shape)
            off_data.copy_(data)
            for k in ks:
                kern = bsr_spmv if k is None else bsr_spmm
                size = (nbc * bc,) if k is None else (nbc * bc, k)
                x = torch.randn(size, generator=gen, dtype=acc, device=device)
                # the operand one element past a 16-byte boundary
                off_x = torch.empty(x.numel() + 1, dtype=acc,
                                    device=device)[1:].view(size)
                off_x.copy_(x)
                what = f"{name} BSR edge structure ({br}, {bc}), k {k}"
                for d, r, how in ((data, x, ""), (off_data, x, " data view"),
                                  (data, off_x, " operand view")):
                    v = bsr_edge_case(kern, indptr, indices, d, r, empty,
                                      TOL[name], what + how)
                    if how and v not in ("scalar", "register"):
                        raise AssertionError(f"{what}{how}: off a 16-byte "
                                             f"boundary, ran {v}")
                    ran[name].setdefault(v, []).append(
                        (br, bc, k, how.strip() or "aligned"))
            before = (dict(bsr_spmv_mod.LAUNCHES), dict(bsr_spmm_mod.LAUNCHES))
            none = (torch.zeros(nbr + 1, dtype=torch.int32, device=device),
                    indices[:0], data[:0])
            x = torch.ones(nbc * bc, dtype=acc, device=device)
            zero_mv = bsr_spmv(*none, x)
            zero_mm = bsr_spmm(*none, x[:, None].expand(-1, 4))
            zero_k = bsr_spmm(indptr, indices, data, x[:, None][:, :0])
            if (not bool((zero_mv == 0).all()) or not bool((zero_mm == 0).all())
                    or zero_k.shape != (nbr * br, 0)
                    or (bsr_spmv_mod.LAUNCHES, bsr_spmm_mod.LAUNCHES)
                    != before):
                raise AssertionError(f"{name} ({br}, {bc}): no blocks or k = 0"
                                     " launched or gave a wrong result")
    torch.cuda.synchronize()
    for name, per in ran.items():
        aligned = {v: [c[:3] for c in cases if c[3] == "aligned"]
                   for v, cases in per.items()}
        if set(per) != {"scalar", "vector", "register", "tiled", "staged"}:
            raise AssertionError(f"{name}: the edge structures ran only the "
                                 f"variants {sorted(per)}")
        if "staged" not in per:
            raise AssertionError(f"{name}: the edge structures ran no staged "
                                 "SpMM")
        tiled = aligned.get("tiled", [])
        k_min = 32 if name == "float64" else 16
        if ((128, 128, k_min) not in tiled or (128, 128, 17) in tiled
                or (name == "float64") != ((128, 128, 16) not in tiled)):
            raise AssertionError(f"{name}: (128, 128) k = 16 / 17 / 32 took "
                                 "the wrong SpMM variant")
        print(f"phase 10: BSR edge structures {name}: "
              + "; ".join(f"{v} {len(cases)} cases" for v, cases
                          in sorted(per.items()))
              + f"; aligned tiled {tiled}")
    return ran


def check_bsr(bsr_in, main_out, mats, report) -> None:
    for (shape, name), (bsr, x, g, X, G) in bsr_in.items():
        tol = TOL[name]
        ip, ix, data = bsr.indptr, bsr.indices, bsr.data
        br, bc = bsr.blocksize
        t, data_t = transposed_blocks(ip, ix, data, bsr.ncols)
        abs_t = data_t.abs()
        del data_t
        for op, kern, rhs, gout in (("bsr_spmv", bsr_spmv, x, g),
                                    ("bsr_spmm", bsr_spmm, X, G)):
            what = f"{shape} {name} " + ("bsr @ x" if op == "bsr_spmv"
                                         else f"bsr @ X k={K_MM}")
            y, ddata, dx = main_out[op, shape, name]
            err = (y - bsr_spmv_plain(ip, ix, data, rhs)).abs()
            within(err, bsr_spmv_plain(ip, ix, data.abs(), rhs.abs()), tol,
                   f"{what} forward")
            max_err = float(err.max())
            del err
            if not bitwise_equal(y, kern(ip, ix, data, rhs),
                                 kern(ip, ix, data, rhs)):
                raise AssertionError(f"{what}: kernel results differ run to "
                                     "run")
            grad_data = name != "bfloat16"
            d_p = data.detach().clone().requires_grad_(grad_data)
            r_p = rhs.detach().clone().requires_grad_(True)
            grads = torch.autograd.grad(
                bsr_spmv_plain(ip, ix, d_p, r_p),
                (d_p, r_p) if grad_data else (r_p,), gout)
            del d_p, r_p
            within((dx - grads[-1]).abs(), bsr_spmv_plain(
                t.ptr, t.minor, abs_t, gout.abs()), tol, f"{what} dx")
            if grad_data:
                within((ddata - grads[0]).abs(), _block_outer(
                    gout.abs(), rhs.abs(), t.major, ix, br, bc), tol,
                    f"{what} ddata")
            del grads
            free_memory()
            report[op, row_name(shape, name)] = {"max_abs_err": max_err}
            print(f"phase 10: {what}: kernel == plain within {tol}*(|A||x|) "
                  f"row by row (max |err| {max_err:.3e}); bitwise repeatable; "
                  + ("dx and ddata match" if grad_data else "dx matches")
                  + " the plain autograd")
        del abs_t
        if shape == "banded8":
            csr = mats["banded", name]
            Y_csr = csr_spmm(csr.rowptr, csr.colind, csr.values, X, N_MM)
            err = (main_out["bsr_spmm", shape, name][0] - Y_csr).abs()
            within(err, csr_spmm_plain(csr.rowptr, csr.colind,
                                       csr.values.abs(), X.abs(), N_MM),
                   tol, f"banded8 {name} bsr @ X against csr @ X")
            print(f"phase 10: banded8 {name} bsr @ X matches the same "
                  f"matrix's csr @ X (kernel B2) within {tol}*(|A||X|) (max "
                  f"|err| {float(err.max()):.3e})")
            del Y_csr, err
    check_staged_spmm(bsr_in, x.device)
    bsr_edge_structures(x.device)
    print("phase 10: BSR edge structures (bs 1, 3, 8, 384; (4, 8), (8, 4), "
          "(5, 40), (128, 128), (96, 160), (64, 64), (40, 48), (40, 18), "
          "(64, 8); empty block rows; padding blocks; k in 1, 3, 16, 17, 32, "
          "64, 65, 100, 130; data and operand views off a 16-byte boundary; "
          "no blocks; k = 0): kernel == plain in float32, bfloat16 and "
          "float64, both variants of each kernel")


# Phase 10's staged-against-register cases beside banded8: block shape, k,
# the block columns' spread (nbc) and the dtypes. k = 68 is 17 (float32) or
# 34 (float64) 16-byte column groups; bfloat16 blocks take the staged
# variant where a block row is 16 bytes. At nbc = 2000 the rows of X a CTA
# reads span more than its shared memory holds, so the kernel reads them
# from device memory (its other path); at 50 they fit.
STAGED_CASES = (((4, 4), 64, 50, ("float32", "float64")),
                ((8, 8), 68, 50, ("float32", "bfloat16", "float64")),
                ((16, 16), 8, 50, ("float32", "bfloat16", "float64")),
                ((2, 2), 16, 50, ("float64",)),
                ((4, 8), 32, 50, ("float32", "float64")),
                ((8, 4), 100, 50, ("float32", "float64")),
                ((8, 8), 64, 2000, ("float32", "bfloat16", "float64")),
                ((16, 16), 32, 2000, ("float32", "float64")))


def staged_case(indptr, indices, data, X, empty, tol, what) -> float:
    """The staged SpMM against the plain version within ``tol·(|A||X|)``,
    bitwise against the register variant on the same operands (both named
    on purpose: no fallback), empty rows 0, bitwise repeats. Returns the
    max |err|."""
    y = bsr_spmm(indptr, indices, data, X, variant="staged")
    err = (y - bsr_spmv_plain(indptr, indices, data, X)).abs()
    within(err, bsr_spmv_plain(indptr, indices, data.abs(), X.abs()), tol,
           what)
    if empty is not None and not bool((y[empty] == 0).all()):
        raise AssertionError(f"{what}: an empty row is not 0")
    if not torch.equal(y, bsr_spmm(indptr, indices, data, X,
                                   variant="register")):
        raise AssertionError(f"{what}: the staged and register variants "
                             "differ")
    if not torch.equal(y, bsr_spmm(indptr, indices, data, X,
                                   variant="staged")):
        raise AssertionError(f"{what}: staged variant not bitwise "
                             "repeatable")
    return float(err.max())


def check_staged_spmm(bsr_in, device) -> None:
    """Phase 10: the staged SpMM on banded8's forward and Aᵀ·G operands and
    on STAGED_CASES (every fourth block row empty, three padding blocks
    past ``indptr[-1]``), against the plain version and bitwise against
    the register variant; k = 65, an operand one element off 16 bytes and
    blocks of 17 rows go to the register variant, and the staged variant
    refuses them."""
    for name in ("float32", "float64"):
        bsr, _, _, X, G = bsr_in["banded8", name]
        ip, ix, data = bsr.indptr, bsr.indices, bsr.data
        err = staged_case(ip, ix, data, X, None, TOL[name],
                          f"banded8 {name} bsr @ X")
        t, data_t = transposed_blocks(ip, ix, data, bsr.ncols)
        err_t = staged_case(t.ptr, t.minor, data_t, G, None, TOL[name],
                            f"banded8 {name} Aᵀ·G")
        del data_t
        free_memory()
        print(f"phase 10: banded8 {name} staged SpMM, forward and Aᵀ·G: == "
              f"plain within {TOL[name]}*(|A||X|) (max |err| {err:.3e} / "
              f"{err_t:.3e}), bitwise == the register variant")
    rng = np.random.default_rng(17)
    gen = torch.Generator(device=device).manual_seed(18)
    for (br, bc), k, nbc, names in STAGED_CASES:
        nbr = 60
        lens = rng.poisson(3.0, nbr)
        lens[::4] = 0
        ptr = np.concatenate([[0], np.cumsum(lens)])
        nblocks = int(ptr[-1]) + 3
        indptr = torch.from_numpy(ptr.astype(np.int32)).to(device)
        indices = torch.from_numpy(
            rng.integers(0, nbc, nblocks).astype(np.int32)).to(device)
        empty = torch.from_numpy(np.repeat(lens == 0, br)).to(device)
        for name in names:
            acc = torch.float64 if name == "float64" else torch.float32
            data = torch.randn((nblocks, br, bc), generator=gen, dtype=acc,
                               device=device).to(BSR_DTYPES[name])
            X = torch.randn((nbc * bc, k), generator=gen, dtype=acc,
                            device=device)
            staged_case(indptr, indices, data, X, empty, TOL[name],
                        f"{name} ({br}, {bc}) k={k} nbc={nbc}")
    indices = indices % 50
    X65 = torch.randn((50 * 8, 65), generator=gen, device=device)
    off = torch.empty(50 * 8 * 64 + 1, device=device)[1:].view(50 * 8, 64)
    off.copy_(X65[:, :64])
    data8 = torch.randn((nblocks, 8, 8), generator=gen, device=device)
    data17 = torch.randn((nblocks, 17, 8), generator=gen, device=device)
    for data, X, how in ((data8, X65, "k = 65"),
                         (data8, off, "an operand off 16 bytes"),
                         (data17, X65[:, :64].contiguous(), "17-row blocks")):
        if bsr_spmm_mod.bsr_spmm_variant(data, X) != "register":
            raise AssertionError(f"{how}: not the register variant")
        try:
            bsr_spmm(indptr, indices, data, X, variant="staged")
        except RuntimeError:
            continue
        raise AssertionError(f"{how}: the staged variant took it")
    torch.cuda.synchronize()
    print("phase 10: staged SpMM == plain and bitwise == register on (4, 4) "
          "k=64, (8, 8) k=68, (16, 16) k=8, (2, 2) k=16 (float64), (4, 8) "
          "k=32, (8, 4) k=100, and (8, 8) k=64 and (16, 16) k=32 with block "
          "columns spread past shared memory; bf16 blocks, empty block "
          "rows, padding blocks; k = 65, an operand off 16 bytes and 17-row "
          "blocks go to register, and the staged variant refuses them")


def row_name(shape: str, name: str) -> str:
    """The kernel line's row of a BSR matrix's products: tri128's rows are
    the dtype's (``bsr_spmv_float32``), banded8's carry the shape
    (``bsr_spmv_float32_banded8``)."""
    return name if shape == "tri128" else f"{name}_{shape}"


def time_bsr(bsr_in, report, card: str) -> None:
    """Times of every BSR product in turns, and of torch's BSR call, each
    run of launches behind a queued spin of the card (banded8's products
    take 0.05-0.1 ms, less than the host needs to launch one)."""
    for (shape, name), (bsr, x, _, X, _) in bsr_in.items():
        ip, ix, data = bsr.indptr, bsr.indices, bsr.data
        nblocks = bsr.n_blocks
        nbr = ip.numel() - 1
        for op, kern, rhs, n_plain in (
                ("bsr_spmv", bsr_spmv, x, TIMED_LAUNCHES),
                ("bsr_spmm", bsr_spmm, X, PLAIN_BSR_SPMM_LAUNCHES)):
            k = 1 if rhs.ndim == 1 else rhs.shape[1]
            k_ms, p_ms, (p1, k1, k2, p2) = turns(
                lambda: kern(ip, ix, data, rhs),
                lambda: bsr_spmv_plain(ip, ix, data, rhs),
                TIMED_LAUNCHES, n_plain, spin=True)
            free_memory()
            # compulsory bytes: blocks, block indices, pointer, x/X and y/Y
            nbytes = (data.element_size() * bsr.nnz + 4 * nblocks
                      + 4 * (nbr + 1)
                      + rhs.element_size() * k * (bsr.nrows + bsr.ncols))
            for label, ms in (("kernel", k_ms), ("plain", p_ms)):
                gbs = nbytes / ms / 1e6
                print(f"phase 11: {shape} {name} {op} k={k} {label}: "
                      f"{ms:.4f} ms, {bsr.nnz / ms / 1e6:.2f} Gnnz/s, "
                      f"{2 * bsr.nnz * k / ms / 1e6:.1f} GFLOP/s, {gbs:.1f} "
                      f"GB/s, {100 * gbs / (HBM_TBPS * 1e3):.1f} % of "
                      f"{HBM_TBPS} TB/s | {card}")
            print(f"phase 11: {shape} {name} {op} turns (ms): plain "
                  f"{p1:.4f}, kernel {k1:.4f}, kernel {k2:.4f}, plain "
                  f"{p2:.4f}")
            # torch's BSR product takes bfloat16 blocks only with a bfloat16
            # operand (and refuses them for a vector): not this function
            lib_ms = None
            if name != "bfloat16":
                lib = torch.sparse_bsr_tensor(ip, ix, data, bsr.shape)
                lib_ms = library_ms(lambda: lib @ rhs, spin=True)
                del lib
                free_memory()
                print(f"phase 11: {shape} {name} {op} library "
                      f"torch.sparse_bsr_tensor @ {'x' if k == 1 else 'X'}: "
                      f"{lib_ms:.4f} ms | {card}")
            report[op, row_name(shape, name)].update(
                ms=k_ms, plain_ms=p_ms, library_ms=lib_ms,
                **bound(nbytes, 2 * bsr.nnz * k, name))


def profile_bsr(bsr_in, card: str) -> None:
    for shape, name in (("tri128", "float32"), ("tri128", "bfloat16"),
                        ("tri128", "float64"), ("banded8", "float32")):
        bsr, x, g, X, G = bsr_in[shape, name]
        data = bsr.data.detach().requires_grad_(name != "bfloat16")
        m = bsr.with_data(data)
        for what, rhs, gout in (("bsr @ x", x, g), (f"bsr @ X k={K_MM}", X, G)):
            rg = rhs.detach().requires_grad_(True)
            step = lambda: (m @ rg).backward(gout)  # noqa: E731
            free_memory()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            step()
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - base
            time_ms(step, 2)
            print(f"phase 11: {shape} {name} {what} forward + backward "
                  f"{time_ms(step, 3):.4f} ms/step; peak {peak / 1e9:.3f} GB "
                  f"above the inputs (gradients included) | {card}")
            print_profile(f"phase 11: {shape} {name} {what} fwd+bwd", step, 3)
            data.grad = None
            del rg
        del data, m
        free_memory()


def check_device_coo(coos, big, host_seconds, coo0, csr0, x0,
                     device) -> None:
    """Phase 12: ``coo.to_device().to_csr_device()`` on the card against
    ``CsrMatrix.from_coo``: the structure exactly, the values within tol
    (phase 3's triplets hold no duplicates, config[0]'s do); config[0]'s
    padded result times x0 against the dense product."""
    for name, coo in coos.items():
        csr = big[name][0]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dev = coo.to_device(device).to_csr_device()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        nnz = csr.nnz
        if not (dev.nnz == nnz and dev.nse == coo.length
                and torch.equal(dev.rowptr, csr.rowptr)
                and torch.equal(dev.colind[:nnz], csr.colind)):
            raise AssertionError(f"{name}: DeviceCoo.to_csr_device structure "
                                 "differs from CsrMatrix.from_coo")
        err = (dev.values[:nnz] - csr.values).abs()
        within(err, csr.values.abs(), TOL[name], f"{name} DeviceCoo values")
        print(f"phase 12: {name} n={N_BIG} {coo.length} triplets: "
              f"coo.to_device() + to_csr_device() {seconds:.2f} s on the card "
              f"(upload included); the host's CsrMatrix.from_coo took "
              f"{host_seconds[name]:.2f} s in this run; structure equal, max "
              f"|err| {float(err.max()):.3e}")
        del dev, err
        free_memory()
    t0 = time.perf_counter()
    dev0 = coo0.to_device(device).to_csr_device()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    nnz = csr0.nnz
    if not (dev0.nnz == nnz and dev0.nse == coo0.length
            and torch.equal(dev0.rowptr, csr0.rowptr)
            and torch.equal(dev0.colind[:nnz], csr0.colind)
            and not bool(dev0.values[nnz:].any())):
        raise AssertionError("config[0]: DeviceCoo.to_csr_device structure "
                             "differs from CsrMatrix.from_coo")
    d0 = coo0.to_dense()
    rows, cols, vals = coo0.to_arrays()
    abs_sums = CooMatrix.with_triplets(*coo0.shape, rows, cols,
                                       np.abs(vals)).to_dense()
    r, c, _ = csr0.to_coo().to_arrays()
    within((dev0.values[:nnz] - csr0.values).abs(),
           torch.from_numpy(abs_sums[r, c]).to(device), 1e-12,
           "config[0] DeviceCoo values")
    y = (dev0 @ torch.from_numpy(x0).to(device)).cpu().numpy()
    err = np.abs(y - d0 @ x0)
    if not np.all(err <= 1e-12 * (np.abs(d0) @ np.abs(x0))):
        raise AssertionError(f"config[0] DeviceCoo @ x0: max error "
                             f"{err.max():.3e}")
    print(f"phase 12: config[0] {coo0.length} triplets (duplicates, zeros): "
          f"to_csr_device {seconds:.3f} s, nnz {nnz} of nse {dev0.nse}: "
          f"structure equal to from_coo; padded csr @ x0 matches the dense "
          f"product within 1e-12*(|A||x|), max |err| {err.max():.3e}")


def laplacian_diagonals(k: int):
    """The 7 diagonals of the 7-point Laplacian of a k**3 grid (6 on the
    main diagonal, -1 towards each neighbour, 0 where the neighbour lies
    outside the grid) and their offsets."""
    n = k ** 3
    i = np.arange(n)
    near = np.where(i[:-1] % k != k - 1, -1.0, 0.0)
    row = np.where((i[:-k] // k) % k != k - 1, -1.0, 0.0)
    plane = -np.ones(n - k * k)
    return ([plane, row, near, 6.0, near, row, plane],
            [-k * k, -k, -1, 0, 1, k, k * k])


def dia_inputs(device):
    """dia9 drawn on the card (out-of-range slots zeroed), lap3d built on
    the host with ``DiaMatrix.from_diagonals``, each in float32 and float64,
    with x and g drawn on the card, keyed by (shape, dtype)."""
    gen = torch.Generator(device=device).manual_seed(13)
    out = {}
    t0 = time.perf_counter()
    for name, (_, dtype) in DTYPES.items():
        data = torch.randn((len(DIA9_OFFSETS), N_DIA), generator=gen,
                           dtype=dtype, device=device)
        for k, o in enumerate(DIA9_OFFSETS):
            i0, length = _diag_span(o, N_DIA, N_DIA)
            data[k, :i0] = 0
            data[k, i0 + length:] = 0
        out["dia9", name] = DiaMatrix(N_DIA, N_DIA, DIA9_OFFSETS, data,
                                      device=device)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    diagonals, offsets = laplacian_diagonals(LAP_K)
    for name, (np_dtype, _) in DTYPES.items():
        out["lap3d", name] = DiaMatrix.from_diagonals(
            diagonals, offsets, LAP_K ** 3, dtype=np_dtype, device=device)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    for key, dia in out.items():
        n = dia.nrows
        out[key] = (dia, *(torch.randn(n, generator=gen, dtype=dia.dtype,
                                       device=device) for _ in range(2)))
        print(f"phase 13: {key[0]} {key[1]}: n={n} D={dia.offsets.size} "
              f"in-range slots {dia.nnz} data "
              f"{dia.data.numel() * dia.data.element_size() / 1e9:.3f} GB")
    print(f"phase 13: dia9 drawn on the card {t1 - t0:.2f} s; lap3d "
          f"DiaMatrix.from_diagonals on the host + upload, two dtypes "
          f"{t2 - t1:.2f} s")
    return out


def run_dia(dia_in):
    """A forward and backward ``dia @ x`` per DIA matrix, with gradients to
    the diagonals and to x."""
    out = {}
    for key, (dia, x, g) in dia_in.items():
        data = dia.data.detach().requires_grad_(True)
        xg = x.detach().requires_grad_(True)
        y = DiaMatrix(dia.nrows, dia.ncols, dia.offsets, data,
                      device=dia.device) @ xg
        y.backward(g)
        out[key] = (y.detach(), data.grad, xg.grad)
    return out


def dia_edge_structures(device) -> None:
    """DIA kernel against plain version, forward and transposed, on
    structures the main path does not reach: one diagonal (at 0 and at 5),
    offsets at +-(n - 1), the rectangular cases 300 x 1000 and 1000 x 300
    of ``tests/test_dia.py:118-121``, an unsorted offset order, and D = 0,
    which launches nothing and gives zeros."""
    gen = torch.Generator(device=device).manual_seed(14)
    cases = [(5000, 5000, [0]), (5000, 5000, [5]),
             (5000, 5000, [4999, -4999, 0]), (300, 1000, [0, 5, 600]),
             (1000, 300, [-299, -1, 0, 200]),
             (7000, 7000, [5, -3, 0, 100, -700, 6999])]
    for name, (_, dtype) in DTYPES.items():
        for n, m, offs in cases:
            off_t = torch.tensor(offs, dtype=torch.int64, device=device)
            data = torch.randn((len(offs), n), generator=gen, dtype=dtype,
                               device=device)
            x = torch.randn(m, generator=gen, dtype=dtype, device=device)
            g = torch.randn(n, generator=gen, dtype=dtype, device=device)
            what = f"{name} DIA edge structure {n}x{m} offsets {offs}"
            for rhs, transposed in ((x, False), (g, True)):
                y = dia_spmv(off_t, data, rhs, n, m, transposed=transposed)
                within((y - dia_spmv_plain(offs, data, rhs, n, m,
                                           transposed=transposed)).abs(),
                       dia_spmv_plain(offs, data.abs(), rhs.abs(), n, m,
                                      transposed=transposed),
                       TOL[name], what + (" transposed" if transposed
                                          else ""))
                if not torch.equal(y, dia_spmv(off_t, data, rhs, n, m,
                                               transposed=transposed)):
                    raise AssertionError(f"{what}: not bitwise repeatable")
        before = dict(dia_mod.LAUNCHES)
        no_offs = torch.zeros(0, dtype=torch.int64, device=device)
        none = dia_spmv(no_offs, torch.zeros(0, 40, dtype=dtype,
                                             device=device),
                        torch.ones(50, dtype=dtype, device=device), 40, 50)
        none_t = dia_spmv(no_offs, torch.zeros(0, 40, dtype=dtype,
                                               device=device),
                          torch.ones(40, dtype=dtype, device=device), 40, 50,
                          transposed=True)
        if (none.shape != (40,) or none_t.shape != (50,) or none.any()
                or none_t.any() or dia_mod.LAUNCHES != before):
            raise AssertionError(f"{name}: D = 0 launched or gave a wrong "
                                 "result")
    torch.cuda.synchronize()


def stencil_path(device) -> None:
    """The 64**3 Laplacian through ``diags`` + ``kron`` + ``+`` into CSR on
    the card (no device named: the default), then ``DiaMatrix.from_csr``;
    its diagonals equal ``from_diagonals``'s, ``dia @ x`` matches ``csr @
    x`` (kernel B1) and ``dia.T @ g`` the backward's dx, in both dtypes."""
    k = STENCIL_K
    n = k ** 3
    t0 = time.perf_counter()
    t = diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(k, k))
    eye = diags([1.0], [0], shape=(k, k))
    csr = (kron(kron(t, eye), eye) + kron(kron(eye, t), eye)
           + kron(kron(eye, eye), t))
    dia = DiaMatrix.from_csr(csr)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    diagonals, offsets = laplacian_diagonals(k)
    ref = DiaMatrix.from_diagonals(diagonals, offsets, n, device=device)
    if not (csr.device == device and dia.device == device
            and csr.nnz == 7 * n - 6 * k * k
            and dia.nnz == sum(n - abs(o) for o in offsets)
            and list(dia.offsets) == offsets
            and torch.equal(dia.data, ref.data)):
        raise AssertionError(
            f"stencil path: csr on {csr.device} nnz {csr.nnz}, dia on "
            f"{dia.device} offsets {dia.offsets.tolist()}, not the 7-point "
            "Laplacian")
    gen = torch.Generator(device=device).manual_seed(15)
    for name, (_, dtype) in DTYPES.items():
        c, d = csr.astype(dtype), dia.astype(dtype)
        x = torch.randn(n, generator=gen, dtype=dtype, device=device)
        g = torch.randn(n, generator=gen, dtype=dtype, device=device)
        xg = x.clone().requires_grad_(True)
        y = d @ xg
        y.backward(g)
        scale = dia_spmv_plain(d.offsets, d.data.abs(), x.abs(), n, n)
        err = (y.detach() - c @ x).abs()
        within(err, scale, TOL[name], f"stencil {name} dia @ x vs csr @ x")
        err_t = (xg.grad - d.T @ g).abs()
        within(err_t, dia_spmv_plain(d.offsets, d.data.abs(), g.abs(), n, n,
                                     transposed=True), TOL[name],
               f"stencil {name} dia.T @ g vs the backward's dx")
        print(f"phase 13: stencil {name} {k}^3: dia @ x matches csr @ x "
              f"(kernel B1) within {TOL[name]}*(|A||x|) (max |err| "
              f"{float(err.max()):.3e}); dia.T @ g matches the backward's dx "
              f"(max |err| {float(err_t.max()):.3e})")
    print(f"phase 13: stencil {k}^3 diags + kron + + -> CSR on {csr.device} "
          f"-> DiaMatrix.from_csr: {seconds:.2f} s, nnz {csr.nnz}, offsets "
          f"{dia.offsets.tolist()}")


def check_dia(dia_in, main_out, report) -> None:
    for key, (dia, x, g) in dia_in.items():
        shape, name = key
        tol = TOL[name]
        offs, data, n = dia.offsets, dia.data, dia.nrows
        y, ddata, dx = main_out[key]
        err = (y - dia_spmv_plain(offs, data, x, n, n)).abs()
        within(err, dia_spmv_plain(offs, data.abs(), x.abs(), n, n), tol,
               f"{shape} {name} forward")
        max_err = float(err.max())
        del err
        off = dia._device_offsets()
        if not bitwise_equal(y, dia_spmv(off, data, x, n, n),
                             dia_spmv(off, data, x, n, n)):
            raise AssertionError(f"{shape} {name}: kernel results differ run "
                                 "to run")
        d_p = data.detach().clone().requires_grad_(True)
        x_p = x.detach().clone().requires_grad_(True)
        ddata_p, dx_p = torch.autograd.grad(
            dia_spmv_plain(offs, d_p, x_p, n, n), (d_p, x_p), g)
        del d_p, x_p
        within((dx - dx_p).abs(), dia_spmv_plain(
            offs, data.abs(), g.abs(), n, n, transposed=True), tol,
            f"{shape} {name} dx")
        del dx_p
        within((ddata - ddata_p).abs(), _shifted_products(
            offs, g.abs(), x.abs(), n), tol, f"{shape} {name} ddata")
        del ddata_p
        free_memory()
        if shape == "dia9":
            report["dia_spmv", name] = {"max_abs_err": max_err}
        print(f"phase 13: {shape} {name} n={n} D={offs.size}: kernel == "
              f"plain within {tol}*(|A||x|) row by row (max |err| "
              f"{max_err:.3e}); bitwise repeatable; dx and ddata match the "
              f"plain autograd")
    dia_edge_structures(x.device)
    print("phase 13: DIA edge structures (D = 1, offsets at +-(n - 1), "
          "300 x 1000, 1000 x 300, unsorted offsets, D = 0), forward and "
          "transposed: kernel == plain in float32 and float64")


def time_dia(dia_in, report, card: str) -> None:
    for key, (dia, x, g) in dia_in.items():
        shape, name = key
        offs, data, n = dia.offsets, dia.data, dia.nrows
        # the offsets already on the card, as DiaMatrix.__matmul__ has them
        off = dia._device_offsets()
        k_ms, p_ms, (p1, k1, k2, p2) = turns(
            lambda: dia_spmv(off, data, x, n, n),
            lambda: dia_spmv_plain(offs, data, x, n, n),
            TIMED_LAUNCHES, PLAIN_BSR_SPMM_LAUNCHES, spin=True)
        t_ms = time_ms(lambda: dia_spmv(off, data, g, n, n,
                                        transposed=True), TIMED_LAUNCHES,
                       spin=True)
        free_memory()
        # compulsory bytes: the diagonals, x, y and the offsets
        itemsize = data.element_size()
        nbytes = itemsize * (data.numel() + 2 * n) + 8 * offs.size
        for label, ms in (("kernel", k_ms), ("plain", p_ms),
                          ("kernel transposed", t_ms)):
            gbs = nbytes / ms / 1e6
            print(f"phase 14: {shape} {name} dia @ x {label}: {ms:.4f} ms, "
                  f"{dia.nnz / ms / 1e6:.2f} Gnnz/s, {gbs:.1f} GB/s, "
                  f"{100 * gbs / (HBM_TBPS * 1e3):.1f} % of {HBM_TBPS} TB/s "
                  f"| {card}")
        print(f"phase 14: {shape} {name} turns (ms): plain {p1:.4f}, kernel "
              f"{k1:.4f}, kernel {k2:.4f}, plain {p2:.4f}")
        data_g = data.detach().requires_grad_(True)
        xg = x.detach().requires_grad_(True)
        mat = DiaMatrix(n, n, offs, data_g, device=data.device)
        step = lambda: (mat @ xg).backward(g)  # noqa: E731
        time_ms(step, 2)
        print(f"phase 14: {shape} {name} dia @ x forward + backward "
              f"{time_ms(step, 3):.4f} ms/step | {card}")
        print_profile(f"phase 14: {shape} {name} dia @ x fwd+bwd", step, 3)
        del data_g, xg, mat, step
        free_memory()
        if shape == "dia9":
            report["dia_spmv", name].update(
                ms=k_ms, plain_ms=p_ms, library_ms=None,
                **bound(nbytes, 2 * dia.nnz, name))


def check_probe(res, device, report, card: str) -> None:
    """Phase 15: the probe's kernel against its plain version at the
    tool's shapes and with out-of-range indices; its time per take."""
    xt, idx, val = probe.inputs(device)
    out = res["out"]
    ref = probe.wide_gather_mac_plain(xt, idx, val)
    scale = probe.wide_gather_mac_plain(xt.abs(), idx, val.abs())
    err = (out - ref).abs()
    within(err, scale, TOL["float32"], "B10 wide gather")
    if not bitwise_equal(out, probe.wide_gather_mac(xt, idx, val)):
        raise AssertionError("B10 wide gather: not bitwise repeatable")
    gen = torch.Generator(device=device).manual_seed(16)
    bad = torch.randint(-3 * probe.N, 3 * probe.N, idx.shape, generator=gen,
                        dtype=torch.int32, device=device)
    within((probe.wide_gather_mac(xt, bad, val)
            - probe.wide_gather_mac_plain(xt, bad, val)).abs(),
           probe.wide_gather_mac_plain(xt.abs(), bad, val.abs()),
           TOL["float32"], "B10 wide gather, out-of-range indices")
    # rows longer than a CTA's shared memory take the kernel's other path
    long_xt = torch.randn((2, 70_000), generator=gen, device=device)
    long_idx = torch.randint(-5, 70_005, (16, probe.LANES), generator=gen,
                             dtype=torch.int32, device=device)
    long_val = torch.randn((16, probe.LANES), generator=gen, device=device)
    within((probe.wide_gather_mac(long_xt, long_idx, long_val)
            - probe.wide_gather_mac_plain(long_xt, long_idx, long_val)).abs(),
           probe.wide_gather_mac_plain(long_xt.abs(), long_idx,
                                       long_val.abs()),
           TOL["float32"], "B10 wide gather, rows past shared memory")
    p_ms = time_ms(lambda: probe.wide_gather_mac_plain(xt, idx, val), 5)
    floor_us = probe.launch_floor_us(device)
    s, n = xt.shape
    k, lanes = idx.shape
    nbytes = 4 * (s * n + 2 * k * lanes + s * lanes)
    report["wide_gather", "float32"] = {
        "max_abs_err": float(err.max()), "ms": res["us_per_call"] / 1e3,
        "plain_ms": p_ms, "library_ms": None,
        **bound(nbytes, 2 * s * lanes * k, "float32"),
        "launch_floor_ms": floor_us / 1e3}
    print(f"phase 15: B10 wide gather ({s}, {n}) x {k} takes of {lanes}: "
          f"kernel == plain within 1e-5*sum|xt||val| (max |err| "
          f"{float(err.max()):.3e}, the probe's rel err "
          f"{res['rel_err']:.2e}); out-of-range indices read 0; rows of "
          f"70,000 (past shared memory) match; bitwise "
          f"repeatable; {res['us_per_call']:.3f} us per call, "
          f"{res['us_per_take']:.4f} us per take, {res['gelem_per_s']:.1f} "
          f"Gelem/s gathered; plain {p_ms:.4f} ms | {card}")
    print(f"phase 15: B10 launch floor (the same kernel at S = 1, K = 1, "
          f"behind the same spin): {floor_us:.3f} us a call; bound "
          f"{report['wide_gather', 'float32']['bound_ms'] * 1e3:.3f} us | "
          f"{card}")


def kernel_line(launches, report, seen) -> list:
    """One row per kernel and dtype (its launches over every main path),
    and the rows of EXTRA_ROWS (the launches of their own matrix's main
    path); each row of a kernel with variants names the variants its
    launches ran."""
    def variants(kname, name, shapes=None):
        out = {}
        for (k, shape, n), per in seen.items():
            if k == kname and n == name and (shapes is None
                                             or shape in shapes):
                for v, count in per.items():
                    out[v] = out.get(v, 0) + count
        return out

    rows = []
    for kname, (source, counts) in KERNELS.items():
        for name in counts:
            row = {"name": f"{kname}_{name}", "route": "cuda",
                   "source": source, "replaces": REPLACES[kname, name],
                   "launches": launches[kname][name], **report[kname, name]}
            if kname in VARIANTS:
                row["variants"] = variants(kname, name)
            rows.append(row)
    for (kname, suffix), shape in EXTRA_ROWS.items():
        for name in ("float32", "float64"):
            per = variants(kname, name, (shape,))
            rows.append({"name": f"{kname}_{name}_{suffix}", "route": "cuda",
                         "source": KERNELS[kname][0],
                         "replaces": REPLACES[kname, name],
                         "launches": sum(per.values()),
                         **report[kname, f"{name}_{suffix}"],
                         "variants": per})
    return rows


def main() -> int:
    # ---- phase 0: the machine ----------------------------------------
    warnings.filterwarnings("ignore", message="Sparse", category=UserWarning)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
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
    print(f"phase 1: nvcc {' '.join(_build.NVCC_FLAGS)} "
          f"{' '.join(src for src, _ in KERNELS.values())} -> "
          f"build/kernels/{_build.library_path().name}: "
          f"{time.perf_counter() - t0:.2f} s"
          f"{' (already built)' if cached else ''}")

    # ---- building the inputs -----------------------------------------
    with phase("inputs: config[0] and SpMV at n = 2**21"):
        coo0, csr0, x0 = config0(device)
        big, coos, host_seconds = {}, {}, {}
        for name, (np_dtype, _) in DTYPES.items():
            *big[name], coos[name], host_seconds[name] = big_matrix(np_dtype,
                                                                    device)
            print(f"phase 3: {name} n={N_BIG} nnz={big[name][0].nnz}: COO "
                  f"build + CsrMatrix.from_coo(device='cuda') "
                  f"{host_seconds[name]:.2f} s")
    with phase("inputs: config[1] SpMM matrices"):
        mats, rhs = spmm_inputs(device)
        for mname in ("random", "banded"):
            print(f"phase 6: {mname} n={N_MM} nnz={mats[mname, 'float32'].nnz}"
                  f" k={K_MM}")
    with phase("inputs: config[2] power-law matrix and A·A plan"):
        gmats = power_law(device)
        plan, sym_s, sym_path, upload_s = spgemm_plan_timed(gmats["float32"])
        rng = np.random.default_rng(7)
        gc = rng.normal(size=plan.n_out)
        gemm = {name: (a, torch.from_numpy(gc.astype(DTYPES[name][0]))
                       .to(device)) for name, a in gmats.items()}
        per_slot = plan.tptr[1:] - plan.tptr[:-1]
        print(f"phase 7: power-law n={N_GEMM} nnz={gmats['float32'].nnz}, "
              f"A·A terms={plan.a_idx.numel()} n_out={plan.n_out} (terms per "
              f"slot: max {int(per_slot.max())}, slots with more than one "
              f"{int((per_slot > 1).sum())}): symbolic phase ({sym_path}) "
              f"{sym_s:.2f} s on the host; int32 conversion + upload + slot "
              f"pointers {upload_s:.2f} s")
        del per_slot

    # ---- the main paths, each once, between a reset and a read of the
    # counts
    launches = {kname: dict.fromkeys(counts, 0)
                for kname, (_, counts) in KERNELS.items()}
    seen = {}
    main_out = drive("config[0]",
                     lambda: run_config0(device, csr0, x0, seen), launches)
    main_out.update(drive("SpMV", lambda: run_spmv(big, seen), launches))
    main_out.update(drive("SpMM", lambda: run_spmm(mats, rhs, seen),
                          launches))
    main_out.update(drive("SpGEMM", lambda: run_spgemm(gemm), launches))

    # ---- phase 2: config[0] against the dense product -----------------
    with phase("phase 2"):
        d0 = coo0.to_dense()
        ref = d0 @ x0
        err = np.abs(main_out["config0"].cpu().numpy() - ref)
        scale = np.abs(d0) @ np.abs(x0)
        if not np.all(err <= 1e-12 * scale):
            raise AssertionError(f"config[0]: max error {err.max():.3e}")
        print(f"phase 2: config[0] 1000x1000 nnz={csr0.nnz} f64: csr @ x "
              f"matches coo.to_dense() @ x, max |err| {err.max():.3e} <= "
              "1e-12*(|A||x|)")
        unnamed = CsrMatrix.from_coo(coo0)
        if not (unnamed.device == torch.device("cuda", 0)
                and torch.equal(unnamed.rowptr, csr0.rowptr)
                and torch.equal(unnamed.values, csr0.values)):
            raise AssertionError(f"CsrMatrix.from_coo with no device landed "
                                 f"on {unnamed.device}, not cuda:0")
        print(f"phase 2: CsrMatrix.from_coo(coo) with no device lands on "
              f"{unnamed.device}")
        del unnamed

    report = {}
    with phase("phase 3"):
        check_spmv(big, main_out, report)
    with phase("phase 4"):
        time_spmv(big, report, card)
        skewed_spmv(gemm, card)
    with phase("phase 5"):
        where_the_time_goes(big, card)
    big = {name: (csr,) for name, (csr, _, _) in big.items()}
    free_memory()
    with phase("phase 6"):
        check_spmm(mats, rhs, main_out, report)
    with phase("phase 7"):
        check_spgemm(gemm, plan, main_out, report)
        spgemm_dense_checks(csr0, device)
    del main_out
    free_memory()
    with phase("phase 8"):
        time_spmm_spgemm(mats, rhs, gemm, plan, report, card)
    with phase("phase 9"):
        profile_spmm_spgemm(mats, rhs, gemm, card)
    del gemm, plan
    free_memory()

    # ---- BSR: its main paths, checks (phase 10) and times (phase 11) --
    with phase("inputs: BSR tri128 and banded8"):
        bsr_in = bsr_inputs(device, mats)
    bsr_out = drive("BSR bsr @ x",
                    lambda: run_bsr("bsr_spmv", bsr_in, seen), launches)
    check_variants("BSR bsr @ x", "bsr_spmv", seen)
    bsr_out.update(drive("BSR bsr @ X",
                         lambda: run_bsr("bsr_spmm", bsr_in, seen), launches))
    check_variants("BSR bsr @ X", "bsr_spmm", seen)
    free_memory()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    with phase("phase 10"):
        check_bsr(bsr_in, bsr_out, mats, report)
    print(f"phase 10: peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB, of which "
          f"{resident / 1e9:.2f} GB resident before the checks (every "
          f"phase's inputs and the main paths' outputs)")
    del bsr_out
    free_memory()
    with phase("phase 11"):
        time_bsr(bsr_in, report, card)
        profile_bsr(bsr_in, card)
    del bsr_in, mats, rhs
    free_memory()

    # ---- DeviceCoo: COO -> CSR on the card (phase 12) -------------------
    with phase("phase 12"):
        check_device_coo(coos, big, host_seconds, coo0, csr0, x0, device)
    del coos, big
    free_memory()

    # ---- DIA: its main path, checks (phase 13) and times (phase 14) ----
    torch.cuda.reset_peak_memory_stats()
    with phase("inputs: DIA dia9 and lap3d"):
        dia_in = dia_inputs(device)
    dia_out = drive("DIA dia @ x", lambda: run_dia(dia_in), launches)
    with phase("phase 13"):
        check_dia(dia_in, dia_out, report)
        stencil_path(device)
    del dia_out
    free_memory()
    with phase("phase 14"):
        time_dia(dia_in, report, card)
    dia_bytes = sum(d.data.numel() * d.data.element_size()
                    for d, _, _ in dia_in.values())
    print(f"phase 14: peak device memory over the DIA phases "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB (the DIA "
          f"matrices hold {dia_bytes / 1e9:.2f} GB)")
    del dia_in
    free_memory()

    # ---- B10: the wide-gather probe (phase 15) --------------------------
    probe_out = drive("B10 probe", lambda: probe.run(device), launches)
    with phase("phase 15"):
        check_probe(probe_out, device, report, card)
    print(f"total: {time.perf_counter() - t_start:.2f} s")

    kernels = kernel_line(launches, report, seen)
    if any(k["launches"] == 0 for k in kernels):
        raise AssertionError("a kernel was not launched on the main path")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
