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
   bitwise; the backward's Aᵀ·g (the bucket route: pass 1, the bucket
   scatter of ``csrc/csr_transpose.cu``, bitwise its plain version, then
   the kernel on the bucketed values) must equal bitwise the launch through
   ``perm`` and the kernel on the gathered values, and repeat, and its
   dvals (the SDDMM kernel at k = 1) the plain version; the bucket route's
   edge structures (padding slots, empty columns, ncols below the block
   width, a block a column, ncols not a multiple of the block width, a
   column of 150,000 entries, no entries, values and G off 16 bytes; k =
   1, 3, 64); edge
   structures for both SpMV variants (rows of 0,
   1, 31, 32, 33, 4096 and 150,000 entries, padding slots holding values,
   colind, values and perm views off a 16-byte boundary, the perm path)
   and for both SDDMM variants (k in {1, 3, 4, 32, 64, 100}, padding
   slots, G off a 16-byte boundary); ``csr @ x`` and ``csc @ x`` of
   ``from_dense`` matrices with the metrics recorder on, whose path must
   name the SpMV variant that launched.
4. SpMV times of kernel and plain version at the phase 3 shapes, in turns
   (plain, kernel, kernel, plain), and of torch's CSR product, each run of
   launches queued behind a spin of the card; Aᵀ·g four ways: the bucket
   route (in turns with the next; it must be faster where dispatched),
   through ``perm``, the gathered copy beside the gather, and
   ``torch.sparse_csc_tensor @ g`` (each pass and the plain versions
   beside them), and so Aᵀ·g and Aᵀ·G (k = 64 and 256, the SpMM's long
   row in pieces) and the forward ``A @ X`` beside
   ``torch.sparse_csr_tensor @ X`` on phase 3's structure with a column
   of 150,000 entries (the bucket route where a row of Aᵀ is split);
   SDDMM at k = 1 beside
   ``torch.sparse.sampled_addmm``; SpMV on phase 7's power-law matrix and
   on a matrix with rows of 300,000 and 120,000 entries (the vector
   variant's long-row split), checked and timed.
5. Where the SpMV time goes at the phase 3 shapes: ``csr @ x`` with
   autograd on, a forward + backward step, the transpose build alone, the
   bucket plan's build time and bytes and the step's peak memory, and a
   ``torch.profiler`` trace: device time per kernel name and idle share.
6. SpMM, BASELINE config[1] at k = 64: csr_random (32 columns per row from
   32 strata) and a banded matrix (offsets -16..16) at n = 2**19 rows, in
   float32 and float64, built from sorted host arrays with the validating
   constructor; ``csc @ X`` through the CSR mirror on csr_random. Kernel
   against plain version row by row, bitwise repeats, gradients against
   the plain version's autograd, Aᵀ·G (the bucket route on csr_random,
   ``perm`` on banded, each also the other named) bitwise as in phase 3,
   and the SDDMM at k = 64 against its plain form; edge structures (empty
   rows, padding
   slots holding values, k in {1, 3, 4, 32, 64, 100}, X on and off a
   16-byte boundary: both SpMM variants; the perm path).
7. SpGEMM, BASELINE config[2]: ``A·A`` on ``bench.py``'s power-law
   generator (zipf 1.8, capped at 512, seed 1) at n = 2**19, in float32
   and float64; host times of the native symbolic phase and of the plan
   upload, the plan's device bytes. The main path's product against the
   plain version slot by slot, the kernel bitwise repeatable and bitwise
   the main path's, gradients against the plain autograd; edge structures
   built as real A and B (empty rows of A, entries whose B row is empty,
   repeated and unsorted columns in A and B rows, an exact cancellation
   kept as 0, a row of more than 10k terms, a row whose 12,000 terms share
   one slot, value arrays longer than nnz, two C rows of about 9k slots,
   n_out == 0 with no launch); ``a * b``, ``csc * csc`` and ``a ** 3`` at
   config[0]'s size against dense products.
8. SpMM and SpGEMM times, in turns (plain, kernel, kernel, plain), every
   run and torch's CSR product behind the spin, csr_random and banded
   each; SDDMM at k = 64 beside ``torch.sparse.sampled_addmm``; Aᵀ·G on
   both matrices as phase 4 times Aᵀ·g; the
   SpGEMM kernel and its plain version in turns, and
   ``torch.sparse_csr_tensor(A) @ torch.sparse_csr_tensor(A)`` (timed
   only) as the library call.
9. Where the SpMM and SpGEMM time goes: ``torch.profiler`` over a forward +
   backward SpMM step (csr_random: the bucket plan's bytes and the step's
   peak memory) and a SpGEMM numeric step.
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
    blocks; blocks of at most 32 values on short block rows, where the
    scalar SpMV must run, and on long ones, where the stream SpMV must);
    the card's peak memory.
11. BSR times, in turns, each run of launches (and torch's BSR call)
    queued behind a spin of the card, and ``torch.profiler`` over forward
    + backward steps. Then ex56, the stream SpMV's main path: PETSc ex56's
    block pattern at 161**3 block rows of up to 27 3 x 3 float64 blocks
    (``tools/bench_bsr.py``'s, 111,284,641 blocks), ``bsr @ x`` once
    between a reset and a read of the counts (one launch, the stream
    variant), against the plain version within ``1e-13·(|A||x|)``, a
    bitwise repeat, timed in turns beside torch's BSR call. Then the
    Jacobi diagonal's main path: ``diagonal`` of HPCG's 27-point operator
    at 256**3 (values drawn on the card, float32, bfloat16 and float64) and
    of ex56's blocks, one launch each of ``csrc/diagonal.cu``; the diagonal
    and its Jacobi inverse bitwise the plain version's; the inverse timed
    in turns behind the spin beside its bound.
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

16. The Krylov solvers (``spalinalg_tpu_torch.linalg``): CG with Jacobi on
    the 7-point Laplacian of a 128**3 grid (n = 2,097,152, 14,581,760
    entries) in float64 and float32 to ``1e-8·||b||`` / ``1e-4·||b||``;
    CG with Chebyshev (degree 8) on it in float64; PCG with IC(0) against
    Jacobi on the 64**3 Laplacian (190 levels a triangular solve: the
    device path); GMRES(32) and BiCGSTAB with ILU(0) on a 64**3
    convection-diffusion matrix (upwind), float64; CG on the BSR form
    (``to_bsr(8)``) of the 64**3 Laplacian, float32. Each solve runs once
    between a reset and a read of the launch counts, which must be exactly
    the SpMVs its iterations need (CG: iterations + 1) on the CSR or BSR
    SpMV kernel, one diagonal launch for a Jacobi set-up on a CSR matrix,
    and nothing else; on each solver's matrix and dtype that
    kernel is held against its plain version (``b`` as the operand,
    within ``TOL·|A||x|``); ``||b - A·x||``, recomputed in float64 by the
    plain SpMV, must be within 1.01 x tol; the metrics path must name
    ``csr_spmv:cuda:*`` / ``bsr_spmv:cuda:*`` (and ``diagonal:cuda``). Prints iterations, ms per
    iteration beside the SpMV kernel's ms, and the device operations of
    one IC(0) application.
17. BASELINE config[3]: ``cholesky`` -> ``cholesky_solve`` on the 5-point
    Laplacian of a 512**2 grid (n = 262,144, 1,308,672 entries) in float64
    and float32, where ``method="auto"`` must take the supernodal path:
    host seconds of ordering, symbolic analysis and plan, the cold factor,
    the re-factor with the plan cached (and its GFLOP/s from the front
    shapes, its device operations), the solve, ``||A·x - b|| / ||b||``
    (the plain SpMV) within 1e-10 / 1e-4, whether two factors repeat bitwise (else they
    must agree within the dtype's tol), the peak device memory; and the
    256**2 Laplacian in float64, where ``auto`` must take the banded path,
    whose solve must match ``method="supernodal"``'s within 1e-10.
18. LU, ``spsolve``, QR: ``lu`` -> ``lu_solve`` on the upwind
    convection-diffusion of a 512**2 grid (n = 262,144, 1,308,672
    entries) in float64 and float32, where ``auto`` must take the
    supernodal path through the slab guard: host seconds of symmetrize,
    AMD, etree + postorder, symbolic analysis and plan, the cold factor,
    the re-factor through ``supernodal_lu_factor`` (median of 3, GFLOP/s
    over the padded fronts), the solve with exactly one B1 launch
    (``refine=1``), ``||b - A·x|| / ||b||`` from the plain SpMV within
    1e-10 / 1e-4, the gap between two factors, the peak memory;
    ``spsolve`` on the 256**2 convection-diffusion (auto -> LU -> banded;
    against ``lu_solve`` and the supernodal solve within 1e-10) and on the
    256**2 Laplacian (auto -> Cholesky); ``lstsq`` on the 512**2 gradient
    operator ``[Dx; Dy; 0.1·I]`` (785,408 x 262,144) in both dtypes: AᵀA
    by exactly one B3 launch (held against the plain SpGEMM), the refined
    solve by exactly three B1 launches, ``||Aᵀ(b - A·x)|| / ||Aᵀb||`` within
    1e-10 / 1e-3; ``qr_r_dense``, ``qr_q_apply`` and ``qr_qt_apply`` on the
    64**2 gradient operator (n = 4096), one B2 launch each at k = 8 on a
    transposed view.
19. Eigen and funm, float64: ``eigsh(L, k=4, sigma=0, block=2)`` on the
    512**2 Laplacian (48 ``lu_solve``, one B1 launch each; eigenvalues
    within 1e-8 of ``4 - 2cos(πi/513) - 2cos(πj/513)``); ``eigsh(k=1,
    which="LA", m=64)`` on phase 16's 128**3 Laplacian (64 B1 launches;
    the Ritz value at most λ_max and within 0.01 of it); ``lobpcg(k=8,
    maxiter=40)`` on the 512**2 Laplacian (B2 launches 41 at k = 8 and 40
    at k = 24, read from the metrics recorder; Ritz values not below the
    exact ones); ``svds(A, k=6)`` on phase 18's gradient operator (64 B1
    launches and one B2; singular values interlacing the exact ones);
    ``expm_multiply(-L, b, m=32)`` (32 B1 launches; within 1e-10 of a
    plain scaling-and-squaring Taylor reference). The B2 kernel is held
    against its plain version on the operands these solvers hand it: a
    transposed slice (``blk.T``, k = 2), QR's ``Q`` (k = 24), a column
    slice of it (k = 8).
20. The distributed tier (``spalinalg_tpu_torch.parallel``) on a one-rank
    NCCL group (``make_row_mesh()``: the script needs one card, and NCCL
    takes one rank a card): BASELINE config[4], the 5-point
    Laplacian of a 3163**2 grid (10,004,569 rows, 50,010,193 entries)
    built by formula in float64, and its float32 copy: ``partition_csr``
    host seconds in both comm modes; ``dist_spmv`` (one B1 launch) and
    ``dist_spmm`` at k = 64 (one B2 launch) in both modes against the
    plain SpMV / SpMM of the whole matrix on the card within
    ``TOL·|A||x|``, whether they are bitwise equal to ``csr @ x`` /
    ``csr @ X``, and their times beside the single-card product's (each
    run behind the spin); CG with Jacobi on a DistCsr of phase 16's
    128**3 Laplacian (cg(csr)'s iteration count, one B1 launch a step and
    one more); ``dist_bsr_spmv`` on tri128 and banded8 in both dtypes (one
    B4/B6 launch each) against the plain BSR SpMV; ``DistCsr * DistCsr``
    on phase 7's power-law generator at n = 2**16 (one B3 launch; the
    structure of the single-card plan of ``a * a``, values within tol of
    the plain numeric phase on it);
    ``supernodal_factor_sharded`` on config[3]'s 512**2 Laplacian (its
    solve's residual within 1e-10 of ``supernodal_factor``'s); the
    ``heartbeat`` latency. Every count is exact; multi-rank correctness
    (halo slabs, uneven shards) is the 4-rank gloo tests'
    (``tests/test_torch_parallel.py``).
21. IO and utils (``spalinalg_tpu_torch.io``, ``.utils``; run after
    phase 15, before the solver tier, and its DistCsr checkpoint inside
    phase 20's group): config[3]'s
    512**2 Laplacian written as ``.mtx`` and ``.mtx.gz`` and read back
    (seconds, equal triplets), then CSR on the card -> ``csr @ x`` (one
    B1c launch, held against the plain SpMV) -> ``cholesky`` -> solve;
    ``compress_host`` on csr_random's float64 triplets (n = 2**21,
    67,108,864 entries): the native sort and merge against the NumPy path
    on the same triplets, once each, equal arrays; on that CSR
    ``checked_structure`` (ms), ``checked_call`` refusing a copy with one
    out-of-range ``colind`` before any launch, ``determinism_audit`` of
    B1c, ``trace_to`` around three ``annotate``-d SpMVs (the trace names
    the region and the ``csr_spmv`` kernel), a ``to_sparse_csr`` ->
    ``from_sparse_coo`` round trip on the card, ``heartbeat()`` with no
    process group; checkpoints of config[3] as COO, DOK, CSR, CSC, BSR(8)
    and DIA in both dtypes (seconds, bytes; the loaded matrix's product,
    one launch of B1c / B1a, B6 / B4 or B8 / B7, bitwise the original's
    and held against its plain version) and of a ``DistCsr`` of phase
    16's 128**3 Laplacian on phase 20's group; the on-disk Cholesky plan
    cache: a cold ``cholesky`` of config[3] writes its plan, and after
    ``_SYMBOLIC.clear()`` the next loads it (host seconds of both, the
    file's bytes, bitwise equal factors and solves). The script points
    ``SPALINALG_PLAN_CACHE`` at a fresh temporary directory before phase
    1 and removes it at the end; phase 21's plans go to directories of
    their own, so phases 17-18 still measure cold host plans.

Each main path (config[0]; a forward and backward SpMV per dtype; config[1]
forward and backward for each matrix and for ``csc @ X``; config[2]
forward and backward; on the CSR paths also the kernel variants of
MAIN_VARIANTS; BSR ``bsr @ x`` and ``bsr @ X`` forward and backward
on every BSR matrix, and ex56's ``bsr @ x``; DIA ``dia @ x`` forward and backward on dia9 and
lap3d per dtype; the probe's ``run``) runs once, between a reset and a read
of every launch count, before its checks; the counts must be exactly the
path's. Phase 2 also checks that ``CsrMatrix.from_coo`` with no device
lands on ``cuda:0``.

It prints, before the last line, one JSON line describing each kernel (its
launches on the main path, max |err| against the plain version, its time,
the plain version's, the bound from compulsory bytes or operations, and the
time of one PyTorch library call that computes the same function, or null
where there is none; the rows of kernels with variants also the launches
of each variant; banded8 has BSR rows of its own (ex56 a BSR SpMV row,
float64), the banded matrix CSR
SpMM rows, and SDDMM at k = 1 rows beside its k = 64 ones; the backward's
Aᵀ·g and Aᵀ·G have rows of their own, ``_at``, with the launches whose
route was the bucket one, both routes' times and pass 1's; the CSR and BSR
SpMV rows also the launches of phase 16's solvers, and the CSR SpMV,
SpMM and SpGEMM rows those of phases 18-19; the CSR SpMV and SpMM,
SpGEMM and BSR SpMV rows those of phase 20 as ``dist_launches``; the
CSR, BSR and DIA SpMV rows those of phase 21 as ``io_launches``) and the
card's ``nvidia-smi`` name and power limit; the last line is the ``{"ok": true,
"device": ...}`` record.
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch

from spalinalg_tpu_torch import (BsrMatrix, CooMatrix, CscMatrix, CsrMatrix,
                                 DiaMatrix, diags, kron)
from spalinalg_tpu_torch.convert import engine
from spalinalg_tpu_torch.convert.engine import major_ids, transpose_structure
from spalinalg_tpu_torch.errors import StructureError
from spalinalg_tpu_torch.formats.dia import _diag_span
from spalinalg_tpu_torch.io import (from_sparse_coo, load_npz,
                                   read_matrix_market, save_npz,
                                   to_sparse_csr, write_matrix_market)
from spalinalg_tpu_torch.io.checkpoint import shard_path
from spalinalg_tpu_torch.native import lib as native_lib
from spalinalg_tpu_torch.ops import spgemm as spgemm_mod
from spalinalg_tpu_torch.ops.kernels import _build
from spalinalg_tpu_torch.ops.kernels import bsr_spmm as bsr_spmm_mod
from spalinalg_tpu_torch.ops.kernels import bsr_spmv as bsr_spmv_mod
from spalinalg_tpu_torch.ops.kernels import cg_step as step_mod
from spalinalg_tpu_torch.ops.kernels import csr_sddmm as sddmm_mod
from spalinalg_tpu_torch.ops.kernels import csr_spmm as spmm_mod
from spalinalg_tpu_torch.ops.kernels import csr_transpose as transpose_mod
from spalinalg_tpu_torch.ops.kernels import dia_spmv as dia_mod
from spalinalg_tpu_torch.ops.kernels import diagonal as diag_mod
from spalinalg_tpu_torch.ops.kernels import csr_spmv as spmv_mod
from spalinalg_tpu_torch.ops.kernels import spgemm_numeric as numeric_mod
from spalinalg_tpu_torch.ops.kernels.bsr_spmm import bsr_spmm
from spalinalg_tpu_torch.ops.kernels.bsr_spmv import (STREAM_MAX_VALUES,
                                                      _block_outer, bsr_spmv,
                                                      bsr_spmv_plain,
                                                      transposed_blocks)
from spalinalg_tpu_torch.ops.kernels.cg_step import cg_step_plain
from spalinalg_tpu_torch.ops.kernels.csr_sddmm import (csr_sddmm,
                                                       csr_sddmm_plain)
from spalinalg_tpu_torch.ops.kernels.csr_spmm import csr_spmm, csr_spmm_plain
from spalinalg_tpu_torch.ops.kernels.csr_spmv import (BUDGET, STAGE_BUDGET,
                                                      csr_spmv,
                                                      csr_spmv_plain,
                                                      csr_tile_plan,
                                                      stage_bytes,
                                                      transpose_plan)
from spalinalg_tpu_torch.ops.kernels.dia_spmv import (_shifted_products,
                                                      dia_spmv,
                                                      dia_spmv_plain)
from spalinalg_tpu_torch.ops.kernels.diagonal import (diagonal_plain,
                                                      diagonal as
                                                      stored_diagonal)
from spalinalg_tpu_torch.ops.reduce_api import diagonal as mat_diagonal
from spalinalg_tpu_torch.ops.kernels.spgemm_numeric import (
    spgemm_numeric, spgemm_numeric_plain)
from spalinalg_tpu_torch.linalg import (bicgstab, cg, chebyshev, cholesky,
                                        cholesky_solve, eigsh, expm_multiply,
                                        gmres, ic0, ilu0, lobpcg, lstsq, lu,
                                        lu_solve, qr, qr_q_apply, qr_qt_apply,
                                        qr_r_dense, spsolve, svds)
from spalinalg_tpu_torch.linalg.cholesky import SLAB_LIMIT_BYTES, permute_csr
from spalinalg_tpu_torch.linalg.supernodal import (supernodal_factor,
                                                   supernodal_factor_sharded,
                                                   supernodal_solve)
from spalinalg_tpu_torch.linalg.supernodal_lu import supernodal_lu_factor
from spalinalg_tpu_torch.parallel import (dist_bsr_spmv, dist_dot, dist_spmm,
                                          dist_spmv, make_row_mesh,
                                          multihost, partition_bsr,
                                          partition_csr, shard_bsr_vector,
                                          shard_matrix_rows, shard_vector,
                                          unshard_vector)
from spalinalg_tpu_torch.parallel.partition import gather_rows, mesh_device
from spalinalg_tpu_torch.tools import probe_widegather as probe
from spalinalg_tpu_torch.tools.bench_bsr import EX56_NODES, grid27_pattern
from spalinalg_tpu_torch.utils import (annotate, checked_call,
                                       checked_structure, determinism_audit,
                                       metrics, trace_to)

# the module (``spalinalg_tpu_torch.linalg.cholesky`` names the function)
chol_mod = sys.modules["spalinalg_tpu_torch.linalg.cholesky"]

KERNELS = {
    "csr_spmv": ("spalinalg_tpu_torch/csrc/csr_spmv.cu", spmv_mod.LAUNCHES),
    "csr_spmm": ("spalinalg_tpu_torch/csrc/csr_spmm.cu", spmm_mod.LAUNCHES),
    "csr_sddmm": ("spalinalg_tpu_torch/csrc/csr_sddmm.cu",
                  sddmm_mod.LAUNCHES),
    "csr_transpose": ("spalinalg_tpu_torch/csrc/csr_transpose.cu",
                      transpose_mod.LAUNCHES),
    "spgemm": ("spalinalg_tpu_torch/csrc/spgemm_numeric.cu",
               numeric_mod.LAUNCHES),
    "bsr_spmv": ("spalinalg_tpu_torch/csrc/bsr_spmv.cu",
                 bsr_spmv_mod.LAUNCHES),
    "bsr_spmm": ("spalinalg_tpu_torch/csrc/bsr_spmm.cu",
                 bsr_spmm_mod.LAUNCHES),
    "dia_spmv": ("spalinalg_tpu_torch/csrc/dia_spmv.cu", dia_mod.LAUNCHES),
    "diagonal": ("spalinalg_tpu_torch/csrc/diagonal.cu", diag_mod.LAUNCHES),
    "cg_step": ("spalinalg_tpu_torch/csrc/cg_step.cu", step_mod.LAUNCHES),
    "wide_gather": ("spalinalg_tpu_torch/csrc/wide_gather.cu",
                    probe.LAUNCHES),
}
# Launches per variant of the kernels that have two (advanced with the
# per-dtype counts above).
VARIANTS = {"csr_spmv": spmv_mod.VARIANT_LAUNCHES,
            "csr_spmm": spmm_mod.VARIANT_LAUNCHES,
            "csr_sddmm": sddmm_mod.VARIANT_LAUNCHES,
            "csr_transpose": transpose_mod.VARIANT_LAUNCHES,
            "bsr_spmv": bsr_spmv_mod.VARIANT_LAUNCHES,
            "bsr_spmm": bsr_spmm_mod.VARIANT_LAUNCHES}
# dvals of both CSR backward passes: XLA code in the JAX package.
SDDMM_REPLACES = ("spalinalg_tpu/ops/kernels/csr_route.py:1093 and :1364 "
                  "(XLA dvals; no Pallas kernel)")
# dx and dX of both CSR backward passes: an XLA scatter-add in the JAX
# package, which the Aᵀ·g and Aᵀ·G rows (the forward kernels on the
# transposed structure) and pass 1 of their bucket route take the place of.
AT_REPLACES = ("spalinalg_tpu/ops/kernels/csr_route.py:1096 and :1367 "
               "(XLA scatter-add of dx, dX; no Pallas kernel)")
# The Jacobi diagonal: XLA code in the JAX package.
DIAG_REPLACES = ("spalinalg_tpu/ops/reduce_api.py::diagonal (XLA; no Pallas "
                 "kernel)")
# The CG step's vector work: XLA code inside the JAX package's loop.
STEP_REPLACES = ("spalinalg_tpu/linalg/cg.py's step (XLA; no Pallas "
                 "kernel)")
REPLACES = {
    ("csr_spmv", "float32"): "spalinalg_tpu/ops/kernels/csr_route.py:930",
    ("csr_spmv", "float64"): "spalinalg_tpu/ops/kernels/csr_route_df.py:47",
    ("csr_spmm", "float32"): "spalinalg_tpu/ops/kernels/csr_route.py:1112",
    ("csr_spmm", "float64"): "spalinalg_tpu/ops/kernels/csr_route.py:1112",
    ("csr_sddmm", "float32"): SDDMM_REPLACES,
    ("csr_sddmm", "float64"): SDDMM_REPLACES,
    ("csr_transpose", "float32"): AT_REPLACES,
    ("csr_transpose", "float64"): AT_REPLACES,
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
    ("diagonal", "float32"): DIAG_REPLACES,
    ("diagonal", "bfloat16"): DIAG_REPLACES,
    ("diagonal", "float64"): DIAG_REPLACES,
    ("cg_step", "float32"): STEP_REPLACES,
    ("cg_step", "float64"): STEP_REPLACES,
    ("wide_gather", "float32"): "tools/probe_widegather.py:39",
}
# Launches of each main path: config[0] forward (f64); a forward, an Aᵀ·g
# and a dvals (SDDMM) per SpMV matrix, and pass 1 of the bucket route of its
# Aᵀ·g; a forward, an Aᵀ·G and a dvals for each of csr_random, banded and
# csc @ X, and pass 1 for the Aᵀ·G of csr_random and csc @ X (banded keeps
# the perm route); one numeric phase per SpGEMM
# dtype; a forward and an Aᵀ·g (Aᵀ·G) for each BSR matrix: tri128 in three dtypes, banded8 in two;
# a forward and an Aᵀ·g for each DIA matrix, dia9 and lap3d, per dtype; the
# diagonal of HPCG's operator in three dtypes and of ex56's blocks; one CG
# step (the first residual's dots and three passes) at HPCG's 256^3 in two
# dtypes and at ex56's size;
# the probe's check, warm-up and timed launches.
MAIN_LAUNCHES = {
    "config[0]": {"csr_spmv": {"float64": 1}},
    "SpMV": {"csr_spmv": {"float32": 2, "float64": 2},
             "csr_sddmm": {"float32": 1, "float64": 1},
             "csr_transpose": {"float32": 1, "float64": 1}},
    "SpMM": {"csr_spmm": {"float32": 6, "float64": 6},
             "csr_sddmm": {"float32": 3, "float64": 3},
             "csr_transpose": {"float32": 2, "float64": 2}},
    "SpGEMM": {"spgemm": {"float32": 1, "float64": 1}},
    "BSR bsr @ x": {"bsr_spmv": {"float32": 4, "bfloat16": 2, "float64": 4}},
    "BSR bsr @ X": {"bsr_spmm": {"float32": 4, "bfloat16": 2, "float64": 4}},
    "BSR ex56 bsr @ x": {"bsr_spmv": {"float64": 1}},
    "Jacobi diagonal": {"diagonal": {"float32": 1, "bfloat16": 1,
                                     "float64": 2}},
    "CG step": {"cg_step": {"float32": 4, "float64": 8}},
    "DIA dia @ x": {"dia_spmv": {"float32": 4, "float64": 4}},
    "B10 probe": {"wide_gather": {"float32": 1 + probe.WARMUP + probe.TIMED}},
}
# Variants each main path must run. CSR paths, by kernel: config[0] and the
# SpMV path (csr_random, forward and Aᵀ·g per dtype) the vector SpMV, whose
# dvals at k = 1 is the rowwalk SDDMM; the SpMM path (k = 64, forward and
# Aᵀ·G per matrix and dtype) on csr_random and csc @ X the vector SpMM in
# float32 and the register one in float64, on the banded matrix the staged
# one in both; its dvals the vector SDDMM on csr_random and csc @ X, the
# staged one on the banded matrix; the bucket scatter (pass 1) before each
# Aᵀ·g and each Aᵀ·G but banded's. BSR paths, by matrix
# (forward and Aᵀ·g in each dtype): the vector SpMV on both; the tiled SpMM
# on tri128, the staged SpMM on banded8's 8 x 8 blocks.
MAIN_VARIANTS = {
    "config[0]": {"csr_spmv": {"vector": 1}},
    "SpMV": {"csr_spmv": {"vector": 2, "products": 2},
             "csr_sddmm": {"rowwalk": 2},
             "csr_transpose": {"scatter": 2}},
    "SpMM": {"csr_spmm": {"vector": 4, "register": 4, "staged": 4},
             "csr_sddmm": {"vector": 4, "staged": 2},
             "csr_transpose": {"scatter": 4}},
    "BSR bsr @ x": {"tri128": {"vector": 6}, "banded8": {"vector": 4}},
    "BSR bsr @ X": {"tri128": {"tiled": 6}, "banded8": {"staged": 4}},
    "BSR ex56 bsr @ x": {"ex56": {"stream": 1}},
}
# Rows of the kernel line beside the rows that carry each dtype's launch
# count: banded8 for BSR; the banded matrix for CSR SpMM and SDDMM; SDDMM
# at k = 1 on the SpMV matrix (the main rows: k = 64 on csr_random). Each
# gets the launches of its own matrix's main path.
# Keyed by (kernel, row suffix); the value names the row's matrix in the
# record of variants a main path ran and the row's dtypes. ex56's bsr @ x
# (float64) is the main path of the stream SpMV; ex56's diagonal and CG
# step (float64) have rows beside HPCG's (those kernels' main rows).
F32_F64 = ("float32", "float64")
EXTRA_ROWS = {("bsr_spmv", "banded8"): ("banded8", F32_F64),
              ("bsr_spmm", "banded8"): ("banded8", F32_F64),
              ("bsr_spmv", "ex56"): ("ex56", ("float64",)),
              ("diagonal", "ex56"): ("ex56", ("float64",)),
              ("cg_step", "ex56"): ("ex56", ("float64",)),
              ("csr_spmm", "banded"): ("banded", F32_F64),
              ("csr_sddmm", "banded"): ("banded", F32_F64),
              ("csr_sddmm", "k1"): ("spmv", F32_F64)}
# Kernels whose transposed product in the backward (Aᵀ·g, Aᵀ·G) has rows
# of its own ("_at"), with the main-path launches that took the bucket
# route (csr_random; for the SpMM also csc @ X).
AT_ROWS = ("csr_spmv", "csr_spmm")
# Kernels whose variants drive() checks against MAIN_VARIANTS.
CSR_KERNELS = ("csr_spmv", "csr_spmm", "csr_sddmm", "csr_transpose")
TOL = {"float32": 1e-5, "bfloat16": 1e-5, "float64": 1e-12}
CTA_SHARED = 232448   # bytes of shared memory a CTA may hold on an H100
LONG_ROW = 9314       # slots of the long C row of the SpGEMM edge pairs
DTYPES = {"float32": (np.float32, torch.float32),
          "float64": (np.float64, torch.float64)}
N_BIG = 2**21
ROW_NNZ = 32
N_MM = 2**19
K_MM = 64
K_WIDE = 256     # the GCN's hidden width: the split column's widest product
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
# ex56's bsr @ x against its plain version, relative to |A||x|: float64
# sums of at most 81 products a row, in another order.
EX56_TOL = 1e-13
BSR_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
              "float64": torch.float64}
N_DIA = 2**25    # bench.py's dia cells (n = 2**22) scaled past the L2
DIA9_OFFSETS = [-300, -130, -1, 0, 1, 7, 129, 250, 333]
LAP_K = 256      # lap3d: the 7-point Laplacian of a LAP_K**3 grid
HPCG_K = 256     # the Jacobi diagonal's CSR: HPCG's operator on HPCG_K**3
# The CG step's dots against float64 torch.dot, relative to sum |u·v|:
# sums of 1.3-1.7e7 products in another order (read at most 1.8e-16 and
# 8.6e-8 on the card); a sum that drops a tenth of its blocks is off by
# about 0.3.
STEP_DOT_TOL = {"float64": 1e-12, "float32": 1e-6}
STENCIL_K = 64   # the stencil path's grid
KRYLOV_K = 128   # phase 16: CG on the 7-point Laplacian of a KRYLOV_K**3 grid
PRECOND_K = 64   # phase 16: IC(0), ILU(0) and BSR CG on PRECOND_K**3 grids
CONVECTION = 0.5  # upwind convection of phase 16's nonsymmetric grid
CG_RTOL = {"float64": 1e-8, "float32": 1e-4}   # tol = CG_RTOL·||b||
GMRES_RESTART = 32
CHEBYSHEV_DEGREE = 8
CHOL_K = 512     # phase 17, config[3]: the 5-point Laplacian of CHOL_K**2
BAND_K = 256     # phase 17: the banded path's grid
CHOL_RTOL = {"float64": 1e-10, "float32": 1e-4}  # ||A·x - b|| / ||b||
BAND_MATCH = 1e-10   # banded against supernodal solve, relative
REFACTORS = 3
SOLVES = 5
LU_K = 512       # phase 18: upwind convection-diffusion of LU_K**2 (lu)
SPSOLVE_K = 256  # phase 18: spsolve's grids (banded LU and Cholesky)
LU_RTOL = {"float64": 1e-10, "float32": 1e-4}   # ||b - A·x|| / ||b||
LSQ_K = 512      # phase 18, 19: the gradient operator of LSQ_K**2
GRAD_REG = 0.1   # its regularising identity's weight
LSQ_RTOL = {"float64": 1e-10, "float32": 1e-3}  # ||Aᵀ(b - A·x)|| / ||Aᵀb||
QR_APPLY_K = 64  # phase 18: qr_q_apply / qr_qt_apply / qr_r_dense, n = 4096
QR_APPLY_COLS = 8
QR_RTOL = 1e-10
EIG_K = 512      # phase 19: the 5-point Laplacian of EIG_K**2
EIG_SI_K = 4     # shift-invert eigenpairs (a degenerate pair among them)
EIG_BLOCK = 2
EIG_SI_STEPS = 12   # eigsh's block Lanczos steps: ceil(max(2k + 8, 24) / 2)
EIG_RTOL = 1e-8     # against the exact eigenvalues, relative to the largest
EIG_RESID = 1e-5    # ||L·v - λ·v|| / ||L|| (||L|| <= 8, Gershgorin)
LANCZOS_M = 64
LOBPCG_K = 8
LOBPCG_ITERS = 40
LOBPCG_CONV_K = 32   # lobpcg run to convergence: the LOBPCG_CONV_K**2 Laplacian
LOBPCG_CONV_ITERS = 200
LOBPCG_RTOL = 1e-8   # its Ritz values against the exact ones, relative
LOBPCG_RESID = 1e-5  # its residuals ||A·x - θ·x|| (plain SpMM)
RESID_ATOL = 1e-10   # a reported residual against the plain recomputation
RITZ_RTOL = 1e-8     # eigsh LA / svds Ritz values against plain Lanczos
RITZ_RESID_RTOL = 1e-4  # and their residuals against the reference's
                        # (relative, above RESID_ATOL)
SVDS_K = 6
SVDS_M = 32      # eigsh's default Krylov size for k = 6
EXPM_M = 32
EXPM_STEPS = 16  # the plain reference: exp(-L) = exp(-L / 16)**16, ...
EXPM_TERMS = 18  # ... each a Taylor series of 18 terms (||L|| / 16 <= 0.5)
EXPM_RTOL = 1e-10
DIST_K = 3163    # phase 20, config[4]: the 5-point Laplacian of DIST_K**2
DIST_KMM = 64    # its dist_spmm's k (10,004,569 x 64 float64: 5.1 GB)
DIST_GEMM_N = 2**16   # phase 20: DistCsr * DistCsr on the power-law matrix
TRACE_PAD = 256  # phase 21: tiny kernels before the traced SpMVs


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


def csr_random_triplets(np_dtype, rng):
    """csr_random's triplets at n = 2**21: 32 uniform random columns per
    row, one in each of 32 equal column strata (so no duplicates, and nnz
    is exactly 2**26), generated in row order."""
    strata = N_BIG // ROW_NNZ
    rows = np.repeat(np.arange(N_BIG, dtype=np.int64), ROW_NNZ)
    cols = (np.arange(ROW_NNZ, dtype=np.int64) * strata)[None, :] \
        + rng.integers(0, strata, size=(N_BIG, ROW_NNZ))
    vals = rng.normal(size=rows.size).astype(np_dtype)
    return rows, cols.reshape(-1), vals


def big_matrix(np_dtype, device):
    """csr_random at n = 2**21 (``csr_random_triplets``) through
    ``CooMatrix`` and ``CsrMatrix.from_coo``: float32 triplets take the
    NumPy compress, float64 ones the native one (phase 21)."""
    rng = np.random.default_rng(1)
    rows, cols, vals = csr_random_triplets(np_dtype, rng)
    t0 = time.perf_counter()
    coo = CooMatrix.with_triplets(N_BIG, N_BIG, rows, cols, vals)
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


def power_law(device, n: int = N_GEMM):
    """``bench.py``'s config[2] generator (zipf 1.8 row lengths capped at
    512, uniform random columns, seed 1) at ``n`` rows (2**19 for
    config[2]), in both dtypes on one structure. It can repeat a column
    within a row, as bench.py's does, which the validating constructor
    refuses, so the matrix goes through the trusted one; SpGEMM sums such
    terms like any other."""
    rng = np.random.default_rng(1)
    deg = np.minimum(rng.zipf(1.8, size=n), 512)
    rowptr = np.concatenate([[0], np.cumsum(deg)])
    nnz = int(rowptr[-1])
    colind = rng.integers(0, n, size=nnz)
    order = np.repeat(np.arange(n), deg)
    colind = colind[np.lexsort((colind, order))]
    values = rng.normal(size=nnz)
    ptr_t = torch.from_numpy(rowptr.astype(np.int32)).to(device)
    ind_t = torch.from_numpy(colind.astype(np.int32)).to(device)
    return {name: CsrMatrix._from_parts(
                n, n, ptr_t, ind_t,
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
    fail unless the counts are exactly the path's (MAIN_LAUNCHES), and
    unless the variants of the CSR kernels that ran are exactly
    its MAIN_VARIANTS. Adds the counts to ``totals``; returns the path's
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
        print(f"main path {label} variants: {ran}")
        if ran != MAIN_VARIANTS.get(label):
            raise AssertionError(f"main path {label}: kernel variants "
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


def record_routes(seen, kname: str, shape: str, name: str, before) -> None:
    """Add to ``seen[kname + "_at", shape, dtype]`` the backward passes
    since ``before`` (a copy of ``transpose_mod.ROUTES``) whose transposed
    product took the buckets or products route, by route."""
    per = {r: n - before[r] for r, n in transpose_mod.ROUTES.items()
           if r != "perm" and n != before[r]}
    if per:
        seen[f"{kname}_at", shape, name] = per


def run_spmv(big, seen):
    """A forward and backward ``csr @ x`` per dtype; ``seen[kernel,
    "spmv", dtype]`` gets the variants each dtype's step ran, and
    ``seen["csr_spmv_at", "spmv", dtype]`` its bucket-route Aᵀ·g."""
    out = {}
    for name, (csr, x, g) in big.items():
        before = variant_counts()
        routes = dict(transpose_mod.ROUTES)
        values = csr.values.detach().clone().requires_grad_(True)
        xg = x.detach().clone().requires_grad_(True)
        y = csr.with_values(values) @ xg
        y.backward(g)
        out["spmv", name] = (y.detach(), values.grad, xg.grad)
        record_variants(seen, "spmv", name, before)
        record_routes(seen, "csr_spmv", "spmv", name, routes)
    return out


def run_spmm(mats, rhs, seen):
    """A forward and backward ``mat @ X`` per config[1] matrix;
    ``seen[kernel, matrix, dtype]`` gets the variants each step ran, and
    ``seen["csr_spmm_at", matrix, dtype]`` its bucket-route Aᵀ·G."""
    out = {}
    for (mname, name), mat in mats.items():
        before = variant_counts()
        routes = dict(transpose_mod.ROUTES)
        X, G = rhs[name]
        values = mat.values.detach().clone().requires_grad_(True)
        Xg = X.detach().clone().requires_grad_(True)
        Y = mat.with_values(values) @ Xg
        Y.backward(G)
        out["spmm", mname, name] = (Y.detach(), values.grad, Xg.grad)
        record_variants(seen, mname, name, before)
        record_routes(seen, "csr_spmm", mname, name, routes)
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
    MAIN_VARIANTS on each of its matrices."""
    got = {}
    for (o, shape, _), per in seen.items():
        if o == op and shape in MAIN_VARIANTS[label]:
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
    The ``finish`` count (the SpMV's and the SpMM's second kernel, after a
    launch with split rows) names no variant."""
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


def spmm_variant_rule(name: str, k: int, shift: bool, plan) -> str:
    """The SpMM variant the dispatch must take: staged where the widest
    window fits STAGE_BUDGET and X is aligned, else vector for float32
    rows of whole 16-byte vectors, else register."""
    itemsize = 8 if name == "float64" else 4
    if not shift and plan.max_window * k * itemsize <= STAGE_BUDGET:
        return "staged"
    return ("vector" if name == "float32" and k % 4 == 0 and not shift
            else "register")


def spmm_edge_structures(device) -> None:
    """SpMM kernel against plain version: row lengths from empty to 40 on
    average, every seventh row empty, padding slots past ``rowptr[-1]``
    holding values, k in SPMM_EDGE_KS with X on and off a 16-byte boundary
    (both sides of the float32 vector variant's bound and of the staged
    variant's budget); the ``perm`` path bitwise against the materialised
    gather; a matrix with no stored slots, and k = 0, which launch
    nothing."""
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
                    want = spmm_variant_rule(
                        name, k, shift, csr_tile_plan(rowptr, colind))
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


def sddmm_variant_rule(k: int, itemsize: int, shift: bool, plan) -> str:
    """The SDDMM variant the dispatch must take: staged where a CTA's
    staged bytes fit STAGE_BUDGET and G is aligned, else vector for rows
    of whole 16-byte vectors, else rowwalk at k = 1, else scalar."""
    if not shift and (plan.max_window + plan.rows) * k * itemsize \
            + 4 * plan.max_slots <= STAGE_BUDGET:
        return "staged"
    if k * itemsize % 16 == 0 and not shift:
        return "vector"
    return "rowwalk" if k == 1 else "scalar"


def sddmm_edge_structures(device) -> None:
    """SDDMM kernel against plain version: row lengths from empty to 40 on
    average, every seventh row empty, padding slots (past rowptr[nrows])
    that must give exactly 0, k in SPMM_EDGE_KS with G and X on and off a
    16-byte boundary; the dispatched variant and each of the others named
    on purpose (scalar and vector read the per-slot row ids, staged and
    rowwalk rowptr; vector only on whole 16-byte rows, rowwalk only at
    k = 1); bitwise repeats; no slots."""
    rng = np.random.default_rng(8)
    n, m = 3000, 2500
    for name, (np_dtype, torch_dtype) in DTYPES.items():
        itemsize = np.dtype(np_dtype).itemsize
        for mean in (0.5, 3, 40):
            lens = rng.poisson(mean, size=n)
            lens[::7] = 0
            ptr, cols = edge_rowptr(lens, 37, rng, m)
            colind = on_card(cols, device=device)
            rowptr = on_card(ptr, device=device)
            major = major_ids(rowptr, cols.size)
            pad = major == n
            plan = csr_tile_plan(rowptr, colind, sddmm_mod.SDDMM_TILE_ROWS)
            for k in SPMM_EDGE_KS:
                Gh = rng.normal(size=(n, k)).astype(np_dtype)
                Xh = rng.normal(size=(m, k)).astype(np_dtype)
                for shift in (False, True):
                    G = on_card(Gh, shift=shift, device=device)
                    X = on_card(Xh, device=device)
                    what = (f"{name} SDDMM edge structure, mean {mean}, k {k}"
                            + (", G off 16 bytes" if shift else ""))
                    before = dict(sddmm_mod.VARIANT_LAUNCHES)
                    out = csr_sddmm(rowptr, colind, G, X, n)
                    variant = ran_variant(sddmm_mod.VARIANT_LAUNCHES, before,
                                          what)
                    want = sddmm_variant_rule(k, itemsize, shift, plan)
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
                    if not torch.equal(out, csr_sddmm(rowptr, colind, G, X,
                                                      n)):
                        raise AssertionError(f"{what}: not bitwise repeatable")
                    for other in ("scalar", "vector", "rowwalk", "staged"):
                        takes = {"scalar": True,
                                 "vector": (k * itemsize % 16 == 0
                                            and not shift),
                                 "rowwalk": k == 1,
                                 "staged": not shift and sddmm_shared(
                                     plan, k, itemsize) <= CTA_SHARED}[other]
                        if other != want:
                            sddmm_named(rowptr, colind, G, X, n, major, other,
                                        takes, ref, scale, pad, TOL[name],
                                        what)
        before = dict(sddmm_mod.LAUNCHES)
        none = csr_sddmm(torch.zeros(n + 1, dtype=torch.int32, device=device),
                         colind[:0],
                         torch.ones(n, 4, dtype=torch_dtype, device=device),
                         torch.ones(m, 4, dtype=torch_dtype, device=device), n)
        if none.shape != (0,) or sddmm_mod.LAUNCHES != before:
            raise AssertionError(f"{name}: SDDMM with no slots launched")
    torch.cuda.synchronize()


def sddmm_shared(plan, k: int, itemsize: int) -> int:
    """Shared memory the staged SDDMM asks for: the window of X, the
    tile's rows of G and its column ids, each copied from the 16-byte
    boundary below it in whole 16-byte pieces (``csr_sddmm.cu``)."""
    def run(nbytes):
        return (nbytes + 31) // 16 * 16
    return (run(plan.max_window * k * itemsize) + run(plan.rows * k * itemsize)
            + run(4 * plan.max_slots))


def sddmm_named(rowptr, colind, G, X, n, major, variant, takes, ref, scale,
                pad, tol, what) -> None:
    """The SDDMM variant ``variant`` named on purpose: within ``tol`` of the
    plain version with padding slots 0 and bitwise repeatable where the
    kernel takes the operands (``takes``), else refused (no fallback)."""
    what = f"{what}, {variant} named"
    try:
        out = csr_sddmm(rowptr, colind, G, X, n, major=major, variant=variant)
    except RuntimeError:
        if takes:
            raise
        return
    if not takes:
        raise AssertionError(f"{what}: the kernel took operands it refuses")
    within((out - ref).abs(), scale, tol, what)
    if not bool((out[pad] == 0).all()):
        raise AssertionError(f"{what}: a padding slot is not 0")
    if not torch.equal(out, csr_sddmm(rowptr, colind, G, X, n, major=major,
                                      variant=variant)):
        raise AssertionError(f"{what}: not bitwise repeatable")


def spgemm_edge_pairs(device, np_dtype, rng):
    """Real A and B structures for the SpGEMM edge checks, as ``(what, a,
    b, cancel)``: ``cancel`` is the row of C (or None) whose first slot
    sums 1·1 + 1·(-1)."""
    # B: 4000 rows over 60,000 columns: empty rows, short rows, a few long
    # ones, columns unsorted with repeats; rows 0 and 1 hold one column
    # each, with values 1 and -1, for the cancellation
    nb, ncols = 4000, 60_000
    b_len = rng.integers(0, 24, size=nb)
    b_len[::5] = 0
    b_len[:2] = 1
    b_len[[10, 11, 12, 13, 14, 15]] = 2000
    b_len[20] = 500
    b_len[21] = 1
    b_col = rng.integers(0, ncols, size=int(b_len.sum()))
    b_ptr = np.concatenate([[0], np.cumsum(b_len)])
    b_col[b_ptr[2] + 1] = b_col[b_ptr[2]]          # a repeat in B row 2
    b_col[0] = b_col[1] = 7
    b_val = rng.normal(size=b_col.size)
    b_val[0], b_val[1] = 1.0, -1.0
    # A: 3000 rows: empty ones, short ones, medium ones, heavy ones, one of
    # more than 10k terms over the long B rows, one whose 12,000 terms
    # share one slot (B row 21 has one entry); unsorted columns with
    # repeats
    na = 3000
    a_len = rng.integers(1, 6, size=na)
    a_len[::7] = 0
    a_len[100:400] = rng.integers(20, 40, size=300)
    a_len[400:420] = rng.integers(200, 400, size=20)
    a_len[1] = 2
    a_len[5] = 6
    a_len[7] = 12_000
    a_ptr = np.concatenate([[0], np.cumsum(a_len)])
    a_col = rng.integers(0, nb, size=int(a_len.sum()))
    a_col[a_ptr[1]:a_ptr[2]] = [0, 1]                  # the cancellation
    a_col[a_ptr[5]:a_ptr[6]] = [10, 11, 12, 13, 14, 10]  # > 10k terms
    a_col[a_ptr[7]:a_ptr[8]] = 21                        # one slot
    a_col[a_ptr[3]] = 5                                  # an empty B row
    a_col[a_ptr[100] + 1] = a_col[a_ptr[100]]            # a repeat in A
    a_val = rng.normal(size=a_col.size)
    a_val[a_ptr[1]:a_ptr[2]] = 1.0
    pad = 64     # value arrays past nnz hold values that must not be read

    def csr(nrows, n, ptr, col, val):
        val = np.concatenate([val, np.full(pad, 1e30)]).astype(np_dtype)
        return CsrMatrix._from_parts(
            nrows, n, torch.from_numpy(ptr.astype(np.int32)).to(device),
            torch.from_numpy(col.astype(np.int32)).to(device),
            torch.from_numpy(val).to(device))

    pairs = [("mixed", csr(na, nb, a_ptr, a_col, a_val),
              csr(nb, ncols, b_ptr, b_col, b_val), 1)]
    # two long C rows, of LONG_ROW slots and one more: A rows of distinct
    # columns (shuffled) times the identity
    at = LONG_ROW
    cols = [rng.permutation(at), rng.permutation(at + 1)]
    ptr = np.array([0, at, 2 * at + 1])
    pairs.append(("long", csr(2, at + 1, ptr, np.concatenate(cols),
                                rng.normal(size=2 * at + 1)),
                  csr(at + 1, at + 1, np.arange(at + 2), np.arange(at + 1),
                      rng.normal(size=at + 1)), None))
    # no product terms: every entry of A meets an empty B row
    pairs.append(("empty", csr(3, 4, np.array([0, 1, 1, 3]),
                               np.array([0, 2, 2]), rng.normal(size=3)),
                  csr(4, 5, np.array([0, 0, 2, 2, 3]), np.array([1, 3, 4]),
                      rng.normal(size=3)), None))
    return pairs


def spgemm_edge_structures(device) -> None:
    """The SpGEMM kernel against the plain version on real A and B
    structures the main path does not reach (spgemm_edge_pairs), bitwise
    repeatable; the cancellation kept as an exact 0; n_out == 0 launches
    nothing."""
    rng = np.random.default_rng(5)
    for name, (np_dtype, _) in DTYPES.items():
        for what, a, b, cancel in spgemm_edge_pairs(device, np_dtype, rng):
            plan = spgemm_mod.spgemm_plan(a, b)
            args = (plan.gid, plan.a_idx, plan.b_idx)
            label = f"{name} SpGEMM edge structure {what}"
            if what == "empty":
                before = dict(numeric_mod.LAUNCHES)
                out = spgemm_numeric(plan, a.values, b.values)
                if out.shape != (0,):
                    raise AssertionError(f"{label}: shape {out.shape}")
                if plan.n_out != 0 or numeric_mod.LAUNCHES != before:
                    raise AssertionError(f"{label}: n_out == 0 launched")
                continue
            ref = spgemm_numeric_plain(*args, a.values, b.values, plan.n_out)
            scale = spgemm_numeric_plain(*args, a.values.abs(),
                                         b.values.abs(), plan.n_out)
            out = spgemm_numeric(plan, a.values, b.values)
            within((out - ref).abs(), scale, TOL[name], label)
            if not torch.equal(out, spgemm_numeric(plan, a.values,
                                                   b.values)):
                raise AssertionError(f"{label}: not bitwise repeatable")
            if cancel is not None:
                g = int(plan.rowptr[cancel])
                if float(out[g]) != 0.0 or float(scale[g]) != 2.0:
                    raise AssertionError(f"{label}: the cancelling slot is "
                                         "not 0")
    torch.cuda.synchronize()
    print(f"phase 7: SpGEMM edge structures (mixed, long, empty): the kernel "
          f"== plain within tol in float32 and float64, bitwise repeatable, "
          f"the cancelling slot exactly 0, C rows of {LONG_ROW} and "
          f"{LONG_ROW + 1} slots, n_out == 0 launched nothing")


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


def print_plan_bytes(label: str, rowptr, colind, ncols: int, values,
                     step) -> None:
    """The bucket plan's build time (host clock, reads back included) and
    device bytes, the transient ``vb`` of a backward, and the peak device
    bytes of one ``step`` above those allocated before it."""
    nrows = rowptr.numel() - 1
    t = transpose_plan(rowptr, colind, nrows, ncols)
    itemsize = values.element_size()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plan = transpose_mod.build_bucket_plan(rowptr, colind, t.perm, ncols,
                                           itemsize)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    del plan
    plan = transpose_mod.bucket_plan(rowptr, colind, t, ncols, itemsize)
    free_memory()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    step()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    print(f"{label} bucket plan: built in {build_s:.4f} s; {plan.nbytes} "
          f"device bytes (bperm {4 * plan.nse}, lpos {2 * plan.nse}, runs "
          f"{plan.nbytes - 6 * plan.nse}), cached with the structure; vb "
          f"{itemsize * plan.nse} bytes a backward (transient); a step's "
          f"peak {peak} bytes above the {base} allocated before it")


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
        print_plan_bytes(f"phase 5: {name}", csr.rowptr, csr.colind, N_BIG,
                         values, step)
        print_profile(f"phase 5: {name}", step, PROFILED_STEPS)


def transposed_product(kname: str):
    """The backward's transposed product of a kernel, on a named route:
    ``transposed_spmv`` (routes perm, buckets, products) or
    ``transposed_spmm`` (perm, buckets)."""
    return (spmv_mod.transposed_spmv if kname == "csr_spmv"
            else spmm_mod.transposed_spmm)


def dispatched_route(kname: str, rowptr, colind, t, ncols: int,
                     itemsize: int) -> str:
    """The route the backward of ``kname`` takes on this structure."""
    if kname == "csr_spmv":
        return spmv_mod.spmv_route(rowptr, colind, t, ncols, itemsize)
    return spmm_mod.spmm_route(rowptr, colind, t, ncols, itemsize)


def check_transposed(what: str, kname: str, rowptr, colind, values, G,
                     ncols: int, main=None, route=None):
    """The backward's transposed product ``Aᵀ·G`` of A = ``(rowptr, colind,
    values)``: pass 1 (the bucket scatter, and for the SpMV the scatter of
    the products ``values·g[row]``) bitwise its plain version and
    repeatable, ``vb[bperm]`` bitwise ``values[perm]``; every route
    (through perm, buckets, for the SpMV products where the transposed
    structure splits no row, else the products kernel refuses it), the
    kernel on the gathered copy and the dispatched route bitwise equal,
    each twice, and to ``main`` (the main path's dx) where given; the
    dispatched route is ``route`` where given. Returns the max |err|
    against the plain version and pass 1's max |err| against its plain
    version (for the pass the dispatched route runs)."""
    nrows = rowptr.numel() - 1
    t = transpose_plan(rowptr, colind, nrows, ncols)
    itemsize = values.element_size()
    got = dispatched_route(kname, rowptr, colind, t, ncols, itemsize)
    if route is not None and got != route:
        raise AssertionError(f"{what}: the backward takes the {got} route, "
                             f"expected {route}")
    plan = transpose_mod.bucket_plan(rowptr, colind, t, ncols, itemsize)
    scale_by = ({"g": G, "major": t.major} if kname == "csr_spmv" else {})
    pass1_err = {}
    for kw in ({}, scale_by) if scale_by else ({},):
        before = dict(transpose_mod.LAUNCHES)
        vb = transpose_mod.bucket_values(values, plan, **kw)
        if transpose_mod.LAUNCHES == before and plan.nse:
            raise AssertionError(f"{what}: pass 1 did not launch")
        plain = transpose_mod.bucket_values_plain(values, plan, **kw)
        if not bitwise_equal(vb, plain,
                             transpose_mod.bucket_values(values, plan, **kw)):
            raise AssertionError(f"{what}: pass 1{' (products)' if kw else ''}"
                                 " differs from its plain version or from "
                                 "run to run")
        err = (vb - plain).abs()
        pass1_err["products" if kw else "buckets"] = (
            float(err.max()) if err.numel() else 0.0)
        del plain, err
    vb = transpose_mod.bucket_values(values, plan)
    gathered = values[t.perm]
    if not torch.equal(vb[plan.bperm], gathered):
        raise AssertionError(f"{what}: vb[bperm] differs from values[perm]")
    kern = csr_spmv if kname == "csr_spmv" else csr_spmm
    product = transposed_product(kname)
    outs = {"through perm": kern(t.ptr, t.minor, values, G, ncols,
                                 perm=t.perm),
            "gathered copy": kern(t.ptr, t.minor, gathered, G, ncols),
            "named plan": kern(t.ptr, t.minor, vb, G, ncols,
                               perm=plan.bperm)}
    routes = ["perm", "buckets"]
    if kname == "csr_spmv":
        if spmv_mod.csr_spmv_plan(t.ptr).npieces == 0:
            routes.append("products")
        else:
            try:
                spmv_mod.csr_spmv_products(t.ptr, t.minor, vb, ncols,
                                           perm=plan.bperm)
            except ValueError:
                pass
            else:
                raise AssertionError(f"{what}: the products kernel took rows "
                                     "it would split")
    for r in routes:
        outs[f"{r} route"] = product(rowptr, colind, t, values, G, ncols,
                                     route=r)
        outs[f"{r} route again"] = product(rowptr, colind, t, values, G,
                                           ncols, route=r)
    outs[f"dispatched ({got})"] = product(rowptr, colind, t, values, G, ncols)
    if main is not None:
        outs["main path"] = main
    first = outs["through perm"]
    for way, out in outs.items():
        if not torch.equal(first, out):
            raise AssertionError(f"{what}: Aᵀ·G on the {way} differs bitwise "
                                 "from the launch through perm")
    plain = csr_spmv_plain(t.ptr, t.minor, gathered, G, ncols)
    scale = csr_spmv_plain(t.ptr, t.minor, values.abs()[t.perm], G.abs(),
                           ncols)
    err = (first - plain).abs()
    within(err, scale, TOL["float64" if values.dtype == torch.float64
                           else "float32"], f"{what} Aᵀ·G")
    return (float(err.max()) if err.numel() else 0.0,
            pass1_err["products" if got == "products" else "buckets"])


def split_column_matrix(device):
    """``(rowptr, colind, ncols)``: 2**20 rows of eight random columns on
    average (Poisson) and a column, 777, of 150,000 entries: its block is
    past BUCKET_BYTES, the transposed SpMV and SpMM split its row into
    pieces (one row bounds their launches), and the values, 34 / 68 MB, fit
    the L2 in float32 and not in float64."""
    rng = np.random.default_rng(16)
    n = 2**20
    lens = rng.poisson(8, size=n)
    lens[:150_000] += 1
    ptr = np.concatenate([[0], np.cumsum(lens)])
    cols = rng.integers(0, n, size=int(ptr[-1]))
    cols[ptr[:150_000]] = 777
    return (on_card(ptr.astype(np.int32), device=device),
            on_card(cols.astype(np.int32), device=device), n)


def few_columns_matrix(nrows: int, ncols: int, per_row: int, pad: int,
                       seed: int, device):
    """``(rowptr, colind, ncols)``: ``nrows`` rows of ``per_row`` distinct
    columns below ``ncols - 1`` (the last column empty), and ``pad``
    padding slots. So many entries a column that bucket_width gives
    narrow blocks."""
    rng = np.random.default_rng(seed)
    cols = np.argsort(rng.random((nrows, ncols - 1)), axis=1)[:, :per_row]
    cols = np.concatenate([np.sort(cols, axis=1).ravel(),
                           rng.integers(0, ncols, size=pad)])
    ptr = np.arange(nrows + 1) * per_row
    return (on_card(ptr.astype(np.int32), device=device),
            on_card(cols.astype(np.int32), device=device), ncols)


def transpose_edge_matrices(device):
    """``(what, rowptr, colind, ncols, routes, widths)`` for the bucket
    route's edge structures, each with the route its backward must take
    (one for every kernel and dtype, or a dict by (kernel, dtype)) and,
    where it matters, the block widths bucket_width must give in float32
    and float64: padding slots
    holding values and empty columns with ncols below the block width; 4
    columns (the last empty) of 300,000 entries each, where bucket_width
    gives a block a column in both dtypes; 5 columns of 120,000 entries
    each, where it gives blocks of 4 (float32) and 2 (float64) columns, so
    ncols is not a multiple of the width; split_column_matrix (its block
    past BUCKET_BYTES; the SpMV's values fit the L2 in float32, perm, and
    not in float64, buckets; the SpMM keeps perm, one row bounding its
    launch); no entries, with and without padding slots. Every route is
    also run by name."""
    rng = np.random.default_rng(16)
    n, m = 3000, 5001
    lens = rng.poisson(6, size=n)
    lens[::5] = 0
    ptr = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    cols = (2 * rng.integers(0, m // 2, size=int(ptr[-1]) + 37)).astype(
        np.int32)           # odd columns empty; 37 padding slots
    yield ("padding slots, empty columns, ncols < W",
           on_card(ptr, device=device), on_card(cols, device=device), m,
           "perm", (8192, 8192))
    yield ("padding slots, an empty column, a block a column (W = 1)",
           *few_columns_matrix(400_000, 4, 3, 37, 18, device), "perm",
           (1, 1))
    yield ("padding slots, ncols = 5 not a multiple of W (4 f32, 2 f64)",
           *few_columns_matrix(150_000, 5, 4, 11, 19, device), "perm",
           (4, 2))
    yield ("a column of 150,000 entries", *split_column_matrix(device),
           {("csr_spmv", "float32"): "perm",
            ("csr_spmv", "float64"): "buckets",
            ("csr_spmm", "float32"): "perm",
            ("csr_spmm", "float64"): "perm"},
           None)
    for pad in (0, 5):
        yield (f"no entries, {pad} padding slots",
               torch.zeros(41, dtype=torch.int32, device=device),
               torch.zeros(pad, dtype=torch.int32, device=device), 40, "perm",
               None)


def transpose_edge_structures(device) -> None:
    """The bucket route (check_transposed) on transpose_edge_matrices, in
    both dtypes, for Aᵀ·g and Aᵀ·G at k = 3 and 64, with the values and G
    on and off a 16-byte boundary (pass 1's scalar loads); the block width
    each plan took is printed, and must be the one the structure names."""
    rng = np.random.default_rng(17)
    for what, rowptr, colind, ncols, routes, want in transpose_edge_matrices(
            device):
        nrows = rowptr.numel() - 1
        nse = colind.numel()
        t = transpose_plan(rowptr, colind, nrows, ncols)
        widths = {}
        for name, (np_dtype, dtype) in DTYPES.items():
            vals = rng.normal(size=nse).astype(np_dtype)
            widths[name] = transpose_mod.bucket_plan(
                rowptr, colind, t, ncols, np_dtype().itemsize).width
            for shift in (False, True):
                values = on_card(vals, shift=shift, device=device)
                label = (f"{name} transpose edge structure, {what}"
                         + (", values and G off 16 bytes" if shift else ""))
                for k in (None, 3, 64):
                    shape = (nrows,) if k is None else (nrows, k)
                    G = on_card(rng.normal(size=shape).astype(np_dtype),
                                shift=shift, device=device)
                    kname = "csr_spmv" if k is None else "csr_spmm"
                    check_transposed(f"{label}, k={k or 1}", kname, rowptr,
                                     colind, values, G, ncols,
                                     route=routes if isinstance(routes, str)
                                     else routes[kname, name])
                    del G
            del values
        if want is not None and tuple(widths.values()) != want:
            raise AssertionError(f"{what}: block widths {widths}, expected "
                                 f"{want}")
        if nse == 0:
            before = dict(transpose_mod.LAUNCHES)
            plan = transpose_mod.bucket_plan(rowptr, colind, t, ncols, 8)
            transpose_mod.bucket_values(
                torch.zeros(0, dtype=torch.float64, device=device), plan)
            if transpose_mod.LAUNCHES != before:
                raise AssertionError("pass 1 launched on no slots")
        print(f"phase 3: transpose edge structure, {what}: {nse} slots, "
              f"ncols {ncols}, block widths {widths['float32']} (float32) / "
              f"{widths['float64']} (float64)")
        del t
    free_memory()


def time_transposed(what: str, kname: str, rowptr, colind, values, G,
                    ncols: int, nbytes: float, card: str) -> dict:
    """The backward's transposed product four ways, behind the spin: the
    dispatched route (in turns with the launch through perm; it must be
    faster where it is not that launch), through perm, the kernel on the
    gathered copy beside the gather ``values[perm]``, and the library call
    ``torch.sparse_csc_tensor(rowptr, colind, values) @ G`` (Aᵀ with no
    copy); also every other route, each pass, the plain version and pass
    1's. Returns the Aᵀ row's and pass 1's numbers (``nbytes``: the
    function's bytes, the forward's count)."""
    kern = csr_spmv if kname == "csr_spmv" else csr_spmm
    product = transposed_product(kname)
    nrows = rowptr.numel() - 1
    t = transpose_plan(rowptr, colind, nrows, ncols)
    itemsize = values.element_size()
    name = "float64" if values.dtype == torch.float64 else "float32"
    route = dispatched_route(kname, rowptr, colind, t, ncols, itemsize)
    plan = transpose_mod.bucket_plan(rowptr, colind, t, ncols, itemsize)
    d_ms, p_ms, (p1, d1, d2, p2) = turns(
        lambda: product(rowptr, colind, t, values, G, ncols, route=route),
        lambda: product(rowptr, colind, t, values, G, ncols, route="perm"),
        TIMED_LAUNCHES, TIMED_LAUNCHES, spin=True)
    if route != "perm" and d_ms >= p_ms:
        raise AssertionError(f"{what}: the dispatched {route} route "
                             f"({d_ms:.4f} ms) is not faster than through "
                             f"perm ({p_ms:.4f} ms)")
    vb = transpose_mod.bucket_values(values, plan)
    gathered = values[t.perm]
    ways = {"pass 1": lambda: transpose_mod.bucket_values(values, plan),
            "pass 2": lambda: kern(t.ptr, t.minor, vb, G, ncols,
                                   perm=plan.bperm),
            "gathered copy": lambda: kern(t.ptr, t.minor, gathered, G, ncols),
            "gather values[perm]": lambda: values[t.perm]}
    for r in ("buckets", "products"):
        if r != route and (r == "buckets" or kname == "csr_spmv"
                           and spmv_mod.csr_spmv_plan(t.ptr).npieces == 0):
            ways[f"{r} route"] = (lambda r=r: product(
                rowptr, colind, t, values, G, ncols, route=r))
    if kname == "csr_spmv":
        ways["pass 1 (products)"] = lambda: transpose_mod.bucket_values(
            values, plan, g=G, major=t.major)
    ms = {way: time_ms(fn, TIMED_LAUNCHES, spin=True)
          for way, fn in ways.items()}
    del gathered, vb
    plain_ms = time_ms(lambda: csr_spmv_plain(t.ptr, t.minor, values[t.perm],
                                              G, ncols),
                       PLAIN_SPMM_LAUNCHES, spin=True)
    pass1 = "pass 1 (products)" if route == "products" else "pass 1"
    pass1_plain_ms = time_ms(
        lambda: transpose_mod.bucket_values_plain(
            values, plan, **({"g": G, "major": t.major}
                             if route == "products" else {})),
        PLAIN_SPMM_LAUNCHES, spin=True)
    free_memory()
    nnz = int(rowptr[-1])
    lib = torch.sparse_csc_tensor(rowptr, colind[:nnz], values[:nnz],
                                  (ncols, nrows))
    rhs = G if G.ndim == 2 else G[:, None]
    lib_ms = library_ms(lambda: lib @ rhs, spin=True)
    diff = float(((lib @ rhs).reshape(-1) - product(
        rowptr, colind, t, values, G, ncols).reshape(-1)).abs().max())
    del lib
    free_memory()
    others = "; ".join(f"{way} {v:.4f}" for way, v in ms.items())
    print(f"phase 4/8: {what} {'Aᵀ·g' if G.ndim == 1 else 'Aᵀ·G'}: "
          f"dispatched ({route} route) {d_ms:.4f} ms; through perm "
          f"{p_ms:.4f}; gathered copy {ms['gathered copy']:.4f} + the gather "
          f"values[perm] {ms['gather values[perm]']:.4f}; library "
          f"torch.sparse_csc_tensor @ G {lib_ms:.4f} (max |diff| "
          f"{diff:.3e}); plain {plain_ms:.4f} | {card}")
    print(f"phase 4/8: {what} transposed, each alone (ms): {others}")
    print(f"phase 4/8: {what} transposed turns (ms): perm {p1:.4f}, {route} "
          f"{d1:.4f}, {route} {d2:.4f}, perm {p2:.4f}")
    runs = plan.run_start.numel()
    # The function of pass 1: read the values and the plan's places (lpos
    # and the runs), write vb; for the products also read g and the rows,
    # which rowptr gives (the kernel reads the transpose's major, 4 bytes a
    # slot, instead).
    pass1_bytes = ((2 * itemsize + 2) * plan.nse
                   + 4 * (plan.nslab + 1 + 2 * runs)
                   + (itemsize * nrows + 4 * (nrows + 1)
                      if route == "products" else 0))
    at = dict(ms=d_ms, plain_ms=plain_ms, library_ms=lib_ms,
              dispatched=route, perm_ms=p_ms,
              **{f"{way.replace(' ', '_')}_ms": v for way, v in ms.items()
                 if way.endswith("route")},
              pass1_ms=ms[pass1], pass2_ms=ms["pass 2"],
              gathered_ms=ms["gathered copy"],
              gather_ms=ms["gather values[perm]"],
              **bound(nbytes, 2 * nnz * (1 if G.ndim == 1 else G.shape[1]),
                      name))
    pass1_row = dict(ms=ms[pass1], plain_ms=pass1_plain_ms,
                     library_ms=None, plan_bytes=plan.nbytes,
                     width=plan.width, **bound(pass1_bytes, 0, name))
    print(f"phase 4/8: {what} {pass1} (bucket scatter, {plan.nblocks} blocks "
          f"of {plan.width} columns, {runs} runs): {ms[pass1]:.4f} ms, plain "
          f"{pass1_plain_ms:.4f} ms, bound {pass1_row['bound_ms']:.4f} ms "
          f"({pass1_bytes} bytes, "
          f"{100 * pass1_row['bound_ms'] / ms[pass1]:.1f} % of it); plan "
          f"{plan.nbytes} device bytes | {card}")
    return {"at": at, "pass1": pass1_row}


def time_split_column(device, card: str) -> None:
    """The products on split_column_matrix, the structure of phase 3
    whose Aᵀ has a row that the SpMV and the SpMM split into pieces: the
    forward ``A @ X`` (rows of eight: no pieces) beside
    ``torch.sparse_csr_tensor @ X`` at k = 64 and 256, and time_transposed
    for Aᵀ·g and for Aᵀ·G at k = 64 and 256, in both dtypes (each route; a
    dispatched bucket route must be faster than through perm), each with
    its bound."""
    rowptr, colind, n = split_column_matrix(device)
    nnz = colind.numel()
    gen = torch.Generator(device=device)
    gen.manual_seed(21)
    for name, (_, dtype) in DTYPES.items():
        itemsize = torch.empty((), dtype=dtype).element_size()
        values = torch.randn(nnz, generator=gen, dtype=dtype, device=device)
        for k in (1, K_MM, K_WIDE):
            G = torch.randn((n,) if k == 1 else (n, k), generator=gen,
                            dtype=dtype, device=device)
            nbytes = ((itemsize + 4) * nnz + itemsize * k * 2 * n
                      + 4 * (n + 1))
            what = f"{name} a column of 150,000 entries, n={n} k={k}"
            if k > 1:
                time_split_forward(what, rowptr, colind, values, G, n,
                                   nbytes, card)
            time_transposed(what, "csr_spmv" if k == 1 else "csr_spmm",
                            rowptr, colind, values, G, n, nbytes, card)
            del G
        del values
    free_memory()


def time_split_forward(what: str, rowptr, colind, values, X, n: int,
                       nbytes: float, card: str) -> None:
    """The forward ``A @ X`` on split_column_matrix behind the spin, the
    dispatched kernel beside ``torch.sparse_csr_tensor(A) @ X``, with the
    bound and the metrics path."""
    name = "float64" if values.dtype == torch.float64 else "float32"
    time_ms(lambda: csr_spmm(rowptr, colind, values, X, n), 1)
    ms = time_ms(lambda: csr_spmm(rowptr, colind, values, X, n),
                 TIMED_LAUNCHES, spin=True)
    nnz = int(rowptr[-1])
    lib = torch.sparse_csr_tensor(rowptr, colind[:nnz], values[:nnz], (n, n))
    lib_ms = library_ms(lambda: lib @ X, spin=True)
    del lib
    b = bound(nbytes, 2 * nnz * X.shape[1], name)
    path = spmm_mod.kernel_path(rowptr, colind, values, X)
    print(f"phase 4/8: {what} A @ X ({path}): {ms:.4f} ms; library "
          f"torch.sparse_csr_tensor @ X {lib_ms:.4f}; "
          f"bound {b['bound_ms']:.4f} ms ({b['bound_by']}) | {card}")


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
        # The backward's Aᵀ·g (the bucket route) is bitwise the kernel
        # through perm and on the gathered copy.
        t = transpose_plan(rowptr, colind, N_BIG, N_BIG)
        if not torch.equal(dx, csr_spmv(t.ptr, t.minor, values[t.perm], g,
                                        N_BIG)):
            raise AssertionError(f"{name}: Aᵀ·g differs from the kernel on "
                                 "the gathered values")
        at_err, pass1_err = check_transposed(
            f"{name} csr_random", "csr_spmv", rowptr, colind, values, g,
            N_BIG, main=dx, route="products")
        sd = csr_sddmm(rowptr, colind, g, x, N_BIG)
        sd_err = (sd - csr_sddmm_plain(t.major, colind, g, x, N_BIG)).abs()
        within(sd_err, (g[rows] * x[cols]).abs(), tol, f"{name} SDDMM k=1")
        if not torch.equal(sd, dvals.to(sd.dtype)):
            raise AssertionError(f"{name}: SDDMM differs from the main "
                                 "path's dvals")
        report["csr_spmv", name] = {"max_abs_err": float(err.max())}
        report["csr_spmv", f"{name}_at"] = {"max_abs_err": at_err}
        report["csr_transpose", name] = {"max_abs_err": pass1_err}
        report["csr_sddmm", f"{name}_k1"] = {
            "max_abs_err": float(sd_err.max())}
        print(f"phase 3: {name}: kernel == plain within {tol}*(|A||x|) row by "
              f"row (max |err| {float(err.max()):.3e}); bitwise repeatable; "
              f"dx and dvals match the plain autograd; Aᵀ·g (products route, "
              f"max |err| {at_err:.3e}) bitwise equal to the main path's dx, "
              f"through perm, on the buckets and the gathered copy, and run "
              f"to run; pass 1 bitwise its plain version (max |err| "
              f"{pass1_err:.3e}); "
              f"SDDMM k=1 == plain "
              f"(max |err| {float(sd_err.max()):.3e})")
        del y_p, scale, y1, y2, v_p, x_p, dvals_p, dx_p, rows, cols, scale_dx
        del sd, sd_err
    edge_structures(big["float32"][0].device)
    print("phase 3: SpMV edge structures (lane counts 1..32; rows of 0, 1, "
          "31, 32, 33, 4096 and 150,000 entries; padding with values; "
          "colind, values and perm off 16 bytes; the perm path; no "
          "entries): kernel == plain in float32 and float64, both variants")
    transpose_edge_structures(big["float32"][0].device)
    print("phase 3: bucket-route edge structures (padding slots, empty "
          "columns, ncols < W, W = 1, ncols not a multiple of W, a column "
          "of 150,000 entries, no entries; values and G off 16 bytes; k = "
          "1, 3, 64): pass 1 == plain, Aᵀ·g and Aᵀ·G bitwise through perm, "
          "on every route and the gathered copy, in float32 and float64")
    sddmm_edge_structures(big["float32"][0].device)
    print("phase 3: SDDMM edge structures (padding slots, k in "
          f"{', '.join(map(str, SPMM_EDGE_KS))}, G off 16 bytes, no slots): "
          "kernel == plain in float32 and float64, the dispatched variant "
          "and every other one named (or refused where it does not take "
          "the operands)")
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
        lambda: csr_sddmm(rowptr, colind, G, X, nrows, major=t.major),
        lambda: csr_sddmm_plain(t.major, colind, G, X, nrows),
        TIMED_LAUNCHES, PLAIN_SPMM_LAUNCHES, spin=True)
    free_memory()
    nse, itemsize = colind.numel(), G.element_size()
    # compulsory bytes: rowptr, the column ids, the output, G and X once
    # (the scalar and vector variants' per-slot row ids are their design's
    # cost, not the function's: 4·nse bytes more)
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
        timed = time_transposed(f"{name} csr_random n={N_BIG}", "csr_spmv",
                                rowptr, colind, values, g, N_BIG, nbytes,
                                card)
        report["csr_spmv", f"{name}_at"].update(timed["at"])
        report["csr_transpose", name].update(timed["pass1"])
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
    time_split_column(big["float32"][0].device, card)


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
            raise AssertionError(f"{what}: Aᵀ·G differs from the kernel on "
                                 "the gathered values")
        at_err, _ = check_transposed(
            what, "csr_spmm", rowptr, colind, values, G, N_MM, main=dX,
            route="buckets" if mname == "random" else "perm")
        sd = csr_sddmm(rowptr, colind, G, X, N_MM)
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
            report["csr_spmm", f"{name}_at"] = {"max_abs_err": at_err}
            report["csr_sddmm", name] = {"max_abs_err": float(sd_err.max())}
        else:
            report["csr_spmm", f"{name}_{mname}"] = {"max_abs_err": max_err}
            report["csr_sddmm", f"{name}_{mname}"] = {
                "max_abs_err": float(sd_err.max())}
        del sd_err
        print(f"phase 6: {what} n={N_MM} nnz={mat.nnz} k={K_MM}: kernel == "
              f"plain within {tol}*(|A||X|) entry by entry (max |err| "
              f"{max_err:.3e}); bitwise repeatable; dX and dvals match the "
              f"plain autograd; Aᵀ·G ({'bucket' if mname == 'random' else 'perm'}"
              f" route, max |err| {at_err:.3e}) bitwise equal to the bucket "
              f"route, through perm, the gathered copy, and run to run; "
              f"SDDMM k={K_MM} == plain and == dvals"
              + ("; csc @ X through the mirror bitwise equal to csr @ X"
                 if mname == "random" else ""))
    spmm_edge_structures(X.device)
    print("phase 6: SpMM edge structures (empty rows, padding with values, k "
          f"in {', '.join(map(str, SPMM_EDGE_KS))}, X off 16 bytes, the perm "
          "path; no entries; k = 0): kernel == plain in float32 and "
          "float64, each variant the dispatch takes")


# Phase 22: k of the staged CSR kernels' edge structures.
STAGED_KS = (1, 3, 32, 64, 100)


def budget_structure(rows_per_tile: int, width: int, ntiles: int, rng):
    """Host CSR arrays ``(rowptr, colind, nrows, ncols)`` whose every tile
    of ``rows_per_tile`` rows reads exactly ``width`` columns: the tile's
    first row holds its window's two ends, every row four columns of the
    window."""
    ptr, cols = [0], []
    for t in range(ntiles):
        base = t * rows_per_tile
        for i in range(rows_per_tile):
            inner = rng.choice(np.arange(base + 1, base + width - 1),
                               2 if i == 0 else 4, replace=False)
            row = ([base, base + width - 1] if i == 0 else []) + list(inner)
            cols += sorted(row)
            ptr.append(len(cols))
    return (np.asarray(ptr, np.int32), np.asarray(cols, np.int32),
            ntiles * rows_per_tile, (ntiles - 1) * rows_per_tile + width)


def staged_spmm_case(rowptr, colind, values, X, n, tol, what, perm=None,
                     empty=None) -> float:
    """The staged SpMM named on purpose: bitwise the register variant on
    the same operands, within ``tol·(|A||X|)`` of the plain version, empty
    rows 0. Returns the max |err|."""
    Y = csr_spmm(rowptr, colind, values, X, n, perm=perm, variant="staged")
    if not torch.equal(Y, csr_spmm(rowptr, colind, values, X, n, perm=perm,
                                   variant="register")):
        raise AssertionError(f"{what}: the staged and register variants "
                             "differ")
    v = values if perm is None else values[perm]
    err = (Y - csr_spmm_plain(rowptr, colind, v, X, n)).abs()
    within(err, csr_spmm_plain(rowptr, colind, v.abs(), X.abs(), n), tol,
           what)
    if empty is not None and not bool((Y[empty] == 0).all()):
        raise AssertionError(f"{what}: an empty row is not 0")
    return float(err.max())


def staged_sddmm_case(rowptr, colind, G, X, n, tol, what) -> float:
    """The staged SDDMM named on purpose: within ``tol·(|G||X|)`` of the
    plain version, padding slots 0, bitwise repeatable. Returns the max
    |err|."""
    major = major_ids(rowptr, colind.numel())
    out = csr_sddmm(rowptr, colind, G, X, n, variant="staged")
    err = (out - csr_sddmm_plain(major, colind, G, X, n)).abs()
    within(err, csr_sddmm_plain(major, colind, G.abs(), X.abs(), n), tol,
           what)
    if not bool((out[major == n] == 0).all()):
        raise AssertionError(f"{what}: a padding slot is not 0")
    if not torch.equal(out, csr_sddmm(rowptr, colind, G, X, n,
                                      variant="staged")):
        raise AssertionError(f"{what}: not bitwise repeatable")
    return float(err.max())


def refused(fn, what: str) -> None:
    try:
        fn()
    except RuntimeError:
        return
    raise AssertionError(f"{what}: the staged variant took it")


def dispatched(counts, fn, what: str) -> str:
    before = dict(counts)
    fn()
    return ran_variant(counts, before, what)


def check_staged_csr(mats, rhs, device) -> None:
    """Phase 22: the staged CSR SpMM and SDDMM, named on purpose. On the
    banded matrix's forward and Aᵀ·G (through ``perm``) operands the
    staged SpMM is bitwise the register variant and within tolerance of
    the plain version, the staged SDDMM within tolerance; on structures
    whose windows sit just under and just over STAGE_BUDGET the dispatch
    takes staged and leaves it, and the named variant still runs; on a
    near-banded structure with empty tiles, a last partial tile, a lone
    wide row, padding slots, ``perm``, X or G off 16 bytes and k in
    STAGED_KS (k = 3 puts the windows' first rows inside a 16-byte piece;
    k = 32, 64 and 100 take the SpMM's split rows, k = 1 and 3 its
    register loop) each runs or, past the shared memory a CTA may hold or
    off 16 bytes, is refused."""
    for name in DTYPES:
        mat = mats["banded", name]
        X, G = rhs[name]
        rowptr, colind, values = mat.rowptr, mat.colind, mat.values
        t = transpose_plan(rowptr, colind, N_MM, N_MM)
        err = staged_spmm_case(rowptr, colind, values, X, N_MM, TOL[name],
                               f"banded {name} SpMM")
        err_t = staged_spmm_case(t.ptr, t.minor, values, G, N_MM, TOL[name],
                                 f"banded {name} Aᵀ·G", perm=t.perm)
        err_s = staged_sddmm_case(rowptr, colind, G, X, N_MM, TOL[name],
                                  f"banded {name} SDDMM")
        free_memory()
        print(f"phase 22: banded {name} k={K_MM}: staged SpMM forward and "
              f"Aᵀ·G through perm bitwise == register, == plain within "
              f"{TOL[name]}*(|A||X|) (max |err| {err:.3e} / {err_t:.3e}); "
              f"staged SDDMM == plain within {TOL[name]}*(|G||X|) (max |err| "
              f"{err_s:.3e})")
    rng = np.random.default_rng(22)
    # just under and just over the budget at k = 64
    for name, (np_dtype, torch_dtype) in DTYPES.items():
        itemsize = np.dtype(np_dtype).itemsize
        row_bytes = K_MM * itemsize
        sd_rows = sddmm_mod.SDDMM_TILE_ROWS
        for side, extra in (("under", 0), ("over", 1)):
            width = STAGE_BUDGET // row_bytes + extra
            ptr, cols, n, m = budget_structure(64, width, 6, rng)
            rowptr, colind = on_card(ptr, device=device), on_card(
                cols, device=device)
            values = on_card(rng.normal(size=cols.size).astype(np_dtype),
                             device=device)
            X = on_card(rng.normal(size=(m, K_MM)).astype(np_dtype),
                        device=device)
            what = f"{name} SpMM window just {side} the budget"
            if csr_tile_plan(rowptr, colind).max_window * row_bytes \
                    != STAGE_BUDGET + extra * row_bytes:
                raise AssertionError(f"{what}: the structure's window is off")
            got = dispatched(spmm_mod.VARIANT_LAUNCHES, lambda: csr_spmm(
                rowptr, colind, values, X, n), what)
            want = "staged" if side == "under" else (
                "vector" if name == "float32" else "register")
            if got != want:
                raise AssertionError(f"{what}: ran {got}, expected {want}")
            staged_spmm_case(rowptr, colind, values, X, n, TOL[name], what)
            # the SDDMM's budget also holds a tile's rows of G and its ids
            width = (STAGE_BUDGET - 4 * 4 * sd_rows) // row_bytes - sd_rows \
                + extra
            ptr, cols, n, m = budget_structure(sd_rows, width, 6, rng)
            rowptr, colind = on_card(ptr, device=device), on_card(
                cols, device=device)
            G = on_card(rng.normal(size=(n, K_MM)).astype(np_dtype),
                        device=device)
            X = on_card(rng.normal(size=(m, K_MM)).astype(np_dtype),
                        device=device)
            what = f"{name} SDDMM staged bytes just {side} the budget"
            plan = csr_tile_plan(rowptr, colind, sd_rows)
            if stage_bytes(plan, K_MM, itemsize, with_rows=True) \
                    != STAGE_BUDGET + extra * row_bytes:
                raise AssertionError(f"{what}: the structure's bytes are off")
            got = dispatched(sddmm_mod.VARIANT_LAUNCHES, lambda: csr_sddmm(
                rowptr, colind, G, X, n), what)
            want = "staged" if side == "under" else "vector"
            if got != want:
                raise AssertionError(f"{what}: ran {got}, expected {want}")
            staged_sddmm_case(rowptr, colind, G, X, n, TOL[name], what)
    # a near-banded structure: rows 128..255 empty (whole tiles), a last
    # partial tile, row 300 of 150 entries over 600 columns, 9 padding
    # slots past rowptr[-1]
    n, m = 64 * 12 + 17, 900
    want_lens = rng.poisson(6, n)
    want_lens[128:256] = 0
    row_cols = []
    for r in range(n):
        if r == 300:
            c = rng.choice(600, 150, replace=False)
        else:
            lo, hi = max(0, r - 24), min(m, r + 25)
            c = rng.choice(np.arange(lo, hi), min(want_lens[r], hi - lo),
                           replace=False)
        row_cols.append(np.sort(c))
    lens = np.array([c.size for c in row_cols])
    ptr = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    cols = np.concatenate(row_cols + [rng.integers(0, m, 9)]).astype(np.int32)
    rowptr, colind = on_card(ptr, device=device), on_card(cols, device=device)
    empty = on_card(lens == 0, device=device)
    perm = on_card(rng.permutation(cols.size).astype(np.int32), device=device)
    plan = csr_tile_plan(rowptr, colind)
    plan_sd = csr_tile_plan(rowptr, colind, sddmm_mod.SDDMM_TILE_ROWS)
    ran = {"staged": 0, "refused": 0}
    for name, (np_dtype, torch_dtype) in DTYPES.items():
        itemsize = np.dtype(np_dtype).itemsize
        values = on_card(rng.normal(size=cols.size).astype(np_dtype),
                         device=device)
        for k in STAGED_KS:
            Xh = rng.normal(size=(m, k)).astype(np_dtype)
            Gh = rng.normal(size=(n, k)).astype(np_dtype)
            for shift in (False, True):
                X = on_card(Xh, shift=shift, device=device)
                what = (f"{name} near-banded SpMM k {k}"
                        + (", X off 16 bytes" if shift else ""))
                if not shift and (plan.max_window * k * itemsize + 32
                                  <= CTA_SHARED):
                    staged_spmm_case(rowptr, colind, values, X, n, TOL[name],
                                     what, empty=empty)
                    staged_spmm_case(rowptr, colind, values, X, n, TOL[name],
                                     f"{what}, perm", perm=perm, empty=empty)
                    ran["staged"] += 1
                else:
                    refused(lambda: csr_spmm(rowptr, colind, values, X, n,
                                             variant="staged"), what)
                    ran["refused"] += 1
                for g_shift, x_shift in ((False, False), (True, False),
                                         (False, True)):
                    if shift and (g_shift or x_shift):
                        continue
                    G = on_card(Gh, shift=g_shift, device=device)
                    Xs = on_card(Xh, shift=x_shift, device=device)
                    what = (f"{name} near-banded SDDMM k {k}"
                            + (", G off 16 bytes" if g_shift else "")
                            + (", X off 16 bytes" if x_shift else ""))
                    if not (g_shift or x_shift) and sddmm_shared(
                            plan_sd, k, itemsize) <= CTA_SHARED:
                        staged_sddmm_case(rowptr, colind, G, Xs, n, TOL[name],
                                          what)
                        ran["staged"] += 1
                    else:
                        refused(lambda: csr_sddmm(rowptr, colind, G, Xs, n,
                                                  variant="staged"), what)
                        ran["refused"] += 1
    if ran["refused"] == 0 or ran["staged"] == 0:
        raise AssertionError(f"phase 22: the edge cases ran {ran}")
    torch.cuda.synchronize()
    print(f"phase 22: windows just under / over STAGE_BUDGET "
          f"({STAGE_BUDGET} bytes) at k={K_MM}: the dispatch takes staged / "
          f"leaves it, the named staged SpMM bitwise == register, the "
          f"staged SDDMM == plain; near-banded structure (empty tiles, a "
          f"last partial tile, a lone row of 150 entries over 600 columns, "
          f"padding slots, perm) at k in {', '.join(map(str, STAGED_KS))}: "
          f"{ran['staged']} staged cases == register bitwise (SpMM) / == "
          f"plain (SDDMM), {ran['refused']} refused (X or G off 16 bytes, "
          f"or past {CTA_SHARED} bytes of shared memory)")


def check_spgemm(gemm, plan, main_out, report) -> None:
    """The main path's ``a * a`` against the plain numeric phase slot by
    slot; the kernel bitwise repeatable and bitwise the main path's; the
    gradient against the plain autograd."""
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
        runs = [spgemm_numeric(plan, v, v) for _ in range(2)]
        if not bitwise_equal(*runs):
            raise AssertionError(f"{name}: SpGEMM results differ run to run")
        if not torch.equal(runs[0], c.values.detach()):
            raise AssertionError(f"{name}: the main path's A·A is not the "
                                 "kernel's")
        del runs
        v_p = v.detach().clone().requires_grad_(True)
        (dv_p,) = torch.autograd.grad(
            spgemm_numeric_plain(*args, v_p, v_p, plan.n_out), (v_p,), gc)
        gg = gc.abs()[plan.gid]
        scale_dv = torch.zeros_like(v).index_add_(
            0, plan.a_idx, gg * v.abs()[plan.b_idx]).index_add_(
            0, plan.b_idx, gg * v.abs()[plan.a_idx])
        within((dvals - dv_p).abs(), scale_dv, tol, f"{name} SpGEMM dvals")
        report["spgemm", name] = {"max_abs_err": float(err.max())}
        print(f"phase 7: {name} A·A n={a.nrows} nnz_a={a.nnz} terms="
              f"{plan.a_idx.numel()} n_out={plan.n_out}: the main path "
              f"== plain within {tol}*sum|a||b| slot by slot (max |err| "
              f"{float(err.max()):.3e}), bitwise repeatable; the gradient "
              f"matches the plain autograd")
        del ref, scale, err, v_p, dv_p, gg, scale_dv


def time_spgemm(gemm, plan, report, card: str) -> None:
    """The kernel and the plain version in turns, behind the spin; the
    library call (timed only); the bound from the function's bytes (the
    term list's printed beside it)."""
    n_terms = plan.a_idx.numel()
    args = (plan.gid, plan.a_idx, plan.b_idx)
    for name, (a, _) in gemm.items():
        v = a.values
        itemsize = v.element_size()
        k_ms, p_ms, (p1, k1, k2, p2) = turns(
            lambda: spgemm_numeric(plan, v, v),
            lambda: spgemm_numeric_plain(*args, v, v, plan.n_out),
            TIMED_LAUNCHES, TIMED_LAUNCHES, spin=True)
        lib = torch.sparse_csr_tensor(a.rowptr, a.colind, v,
                                      (a.nrows, a.ncols))
        lib_ms = library_ms(lambda: lib @ lib, spin=True)
        del lib
        free_memory()
        # compulsory bytes of the function: A's arrays once (A·A reads one
        # array as both operands), C's column ids read and values written,
        # both row pointers; one multiply-add a term
        nbytes = ((4 + itemsize) * a.nnz + 4 * (a.nrows + 1)
                  + (4 + itemsize) * plan.n_out + 4 * (plan.nrows + 1))
        terms_bytes = (8 * n_terms + 4 * (plan.n_out + 1)
                       + itemsize * (a.nnz + plan.n_out))
        b = bound(nbytes, 2 * n_terms, name)
        for label, ms in (("kernel", k_ms), ("plain", p_ms),
                          ("library torch.sparse_csr_tensor(A) @ "
                           "torch.sparse_csr_tensor(A)", lib_ms)):
            print(f"phase 8: {name} SpGEMM numeric {label}: {ms:.4f} ms, "
                  f"{n_terms / ms / 1e6:.3f} Gterms/s | {card}")
        print(f"phase 8: {name} SpGEMM turns (ms): plain {p1:.4f}, kernel "
              f"{k1:.4f}, kernel {k2:.4f}, plain {p2:.4f}")
        print(f"phase 8: {name} SpGEMM bound {b['bound_ms']:.4f} ms "
              f"({b['bound_by']}: the function's {nbytes} bytes); the term "
              f"list's count, {terms_bytes} bytes, would give "
              f"{terms_bytes / (HBM_TBPS * 1e12) * 1e3:.4f} ms")
        report["spgemm", name].update(
            ms=k_ms, plain_ms=p_ms, library_ms=lib_ms, **b)
    held = sum(t.numel() * t.element_size()
               for t in (plan.a_idx, plan.b_idx, plan.gid, plan.tptr,
                         plan.rowptr, plan.colind))
    print(f"phase 8: A·A plan device bytes: {held} (term list, slot "
          f"pointers, C's structure)")


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
        report["csr_sddmm", row].update(time_sddmm(
            rowptr, colind, G, X, N_MM, f"{name} {mname} n={N_MM}", card))
        # the backward's Aᵀ·G on both matrices (banded: the perm route)
        timed = time_transposed(f"{name} {mname} n={N_MM} k={K_MM}",
                                "csr_spmm", rowptr, colind, values, G, N_MM,
                                nbytes, card)
        if mname == "random":
            report["csr_spmm", f"{name}_at"].update(timed["at"])
        free_memory()
    time_spgemm(gemm, plan, report, card)


def profile_spmm_spgemm(mats, rhs, gemm, card: str) -> None:
    for name in DTYPES:
        X, G = rhs[name]
        for mname, label in (("random", "csr_random"), ("banded", "banded")):
            mat = mats[mname, name]
            values = mat.values.detach().clone().requires_grad_(True)
            Xg = X.detach().clone().requires_grad_(True)
            m = mat.with_values(values)
            step = lambda: (m @ Xg).backward(G)  # noqa: E731
            time_ms(step, 2)
            print(f"phase 9: {name} {label} SpMM k={K_MM} forward + backward "
                  f"{time_ms(step, 3):.4f} ms/step | {card}")
            if mname == "random":
                print_plan_bytes(f"phase 9: {name} {label}", mat.rowptr,
                                 mat.colind, N_MM, values, step)
            print_profile(f"phase 9: {name} {label} SpMM fwd+bwd", step, 3)
            del values, Xg, m
        a, _ = gemm[name]
        gstep = lambda: a * a  # noqa: E731
        time_ms(gstep, 2)
        print(f"phase 9: {name} A·A (plan cached) {time_ms(gstep, 5):.4f} "
              f"ms/product | {card}")
        print_profile(f"phase 9: {name} SpGEMM", gstep, 5)
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


# The edge shapes whose blocks the stream SpMV takes.
STREAM_SHAPES = tuple(bs for bs in BSR_EDGE_CASES
                      if bs[0] * bs[1] <= STREAM_MAX_VALUES)


def bsr_edge_layouts():
    """``((br, bc), ks, rows)`` for each edge shape and structure: short
    block rows (a mean of 1.5 blocks) for every shape, and long ones too
    for STREAM_SHAPES."""
    for bs, ks in BSR_EDGE_CASES.items():
        yield bs, ks, "short"
        if bs in STREAM_SHAPES:
            yield bs, ks, "long"


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
    operand view one element off it, which must take the stream or scalar
    SpMV and the register SpMM; a matrix with no blocks and k = 0, which
    launch nothing. Blocks of at most ``STREAM_MAX_VALUES`` values run on
    two structures, short block rows (the scalar SpMV's) and long ones
    (the stream SpMV's), and each such shape must run both SpMV variants
    in every dtype. Returns, per dtype, the cases each variant ran."""
    rng = np.random.default_rng(8)
    gen = torch.Generator(device=device).manual_seed(12)
    ran = {name: {} for name in BSR_DTYPES}
    for (br, bc), ks, rows in bsr_edge_layouts():
        nbr, nbc = (60, 50) if max(br, bc) < 100 else (6, 5)
        # long block rows hold STREAM_MIN_STEPS warp steps of
        # STREAM_MAX_VALUES // (br * bc) blocks and more on average
        slots = STREAM_MAX_VALUES // (br * bc) if rows == "long" else 0
        lens = rng.poisson(2.0 + 6.0 * slots, nbr)
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
                what = (f"{name} BSR edge structure ({br}, {bc}), {rows} "
                        f"block rows, k {k}")
                for d, r, how in ((data, x, ""), (off_data, x, " data view"),
                                  (data, off_x, " operand view")):
                    v = bsr_edge_case(kern, indptr, indices, d, r, empty,
                                      TOL[name], what + how)
                    if how and v not in ("stream", "scalar", "register"):
                        raise AssertionError(f"{what}{how}: off a 16-byte "
                                             f"boundary, ran {v}")
                    ran[name].setdefault(v, []).append(
                        (br, bc, k, how.strip() or "aligned", rows))
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
        if set(per) != {"scalar", "vector", "stream", "register", "tiled",
                        "staged"}:
            raise AssertionError(f"{name}: the edge structures ran only the "
                                 f"variants {sorted(per)}")
        if "staged" not in per:
            raise AssertionError(f"{name}: the edge structures ran no staged "
                                 "SpMM")
        for bs in STREAM_SHAPES:
            for v, rows in (("stream", "long"), ("scalar", "short")):
                if not any(c[:3] == (*bs, None) and c[4] == rows
                           for c in per.get(v, [])):
                    raise AssertionError(f"{name} {bs}: no bsr @ x on {rows}"
                                         f" block rows ran the {v} SpMV")
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


def ex56_inputs(device):
    """``(bsr, x)``: PETSc ex56's block pattern at EX56_NODES nodes a side
    (``tools/bench_bsr.py``'s ``ex56``, the operator of the benchmark's
    ``ex56-160`` cell: 161**3 block rows of up to 27 blocks) with 3 x 3
    float64 blocks and ``x`` drawn on the card."""
    gen = torch.Generator(device=device).manual_seed(13)
    indptr, indices = grid27_pattern(EX56_NODES, device)
    n = 3 * EX56_NODES ** 3
    data = torch.randn((indices.numel(), 3, 3), generator=gen,
                       dtype=torch.float64, device=device)
    x = torch.randn(n, generator=gen, dtype=torch.float64, device=device)
    bsr = BsrMatrix._from_parts(n, n, 3, 3, indptr, indices, data)
    print(f"phase 11: ex56 float64: n={n} blocksize=(3, 3) "
          f"blocks={bsr.n_blocks} stored values={bsr.nnz} data "
          f"{data.numel() * data.element_size() / 1e6:.1f} MB")
    return bsr, x


def run_ex56(bsr, x, seen):
    """ex56's ``bsr @ x``, once; ``seen["bsr_spmv", "ex56", "float64"]``
    gets the variant it ran."""
    counts = VARIANTS["bsr_spmv"]
    before = dict(counts)
    y = bsr @ x
    seen["bsr_spmv", "ex56", "float64"] = {
        v: n - before[v] for v, n in counts.items() if n != before[v]}
    return y


def check_ex56(bsr, x, y, report, card) -> None:
    """ex56's ``bsr @ x`` (the stream SpMV) against the plain version entry
    by entry within ``EX56_TOL·(|A||x|)``, a bitwise repeat; then kernel
    and plain version in turns and torch's BSR call, behind the spin, and
    the bound from compulsory bytes."""
    ip, ix, data = bsr.indptr, bsr.indices, bsr.data
    nbr = ip.numel() - 1
    what = "ex56 float64 bsr @ x"
    err = (y - bsr_spmv_plain(ip, ix, data, x)).abs()
    within(err, bsr_spmv_plain(ip, ix, data.abs(), x.abs()), EX56_TOL, what)
    max_err = float(err.max())
    del err
    free_memory()
    if not bitwise_equal(y, bsr_spmv(ip, ix, data, x)):
        raise AssertionError(f"{what}: kernel results differ run to run")
    print(f"phase 11: {what}: kernel == plain within {EX56_TOL}*(|A||x|) "
          f"row by row (max |err| {max_err:.3e}); bitwise repeatable")
    k_ms, p_ms, (p1, k1, k2, p2) = turns(
        lambda: bsr_spmv(ip, ix, data, x),
        lambda: bsr_spmv_plain(ip, ix, data, x),
        TIMED_LAUNCHES, PLAIN_BSR_SPMM_LAUNCHES, spin=True)
    free_memory()
    nbytes = (data.element_size() * bsr.nnz + 4 * bsr.n_blocks
              + 4 * (nbr + 1) + x.element_size() * (bsr.nrows + bsr.ncols))
    lib = torch.sparse_bsr_tensor(ip, ix, data, bsr.shape)
    lib_ms = library_ms(lambda: lib @ x, spin=True)
    del lib
    free_memory()
    b = bound(nbytes, 2 * bsr.nnz, "float64")
    print(f"phase 11: {what} kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms "
          f"(turns: plain {p1:.4f}, kernel {k1:.4f}, kernel {k2:.4f}, plain "
          f"{p2:.4f}), torch.sparse_bsr_tensor @ x {lib_ms:.4f} ms, bound "
          f"{b['bound_ms']:.4f} ms ({b['bound_by']}; "
          f"{100 * b['bound_ms'] / k_ms:.1f} % of it) | {card}")
    report["bsr_spmv", "float64_ex56"] = {
        "max_abs_err": max_err, "ms": k_ms, "plain_ms": p_ms,
        "library_ms": lib_ms, **b}


def hpcg_inputs(device):
    """``{name: CsrMatrix}``: HPCG's 27-point pattern at HPCG_K**3 rows
    (the benchmark's ``hpcg-256`` structure, ``tools/bench_bsr.py``'s
    ``grid27_pattern``) with values drawn on the card, so that a wrong
    position shows, in float64, float32 and bfloat16."""
    indptr, indices = grid27_pattern(HPCG_K, device)
    n = HPCG_K ** 3
    gen = torch.Generator(device=device).manual_seed(19)
    values = torch.randn(indices.numel(), generator=gen, dtype=torch.float64,
                         device=device)
    out = {name: CsrMatrix._from_parts(n, n, indptr, indices, values.to(dt))
           for name, dt in BSR_DTYPES.items()}
    print(f"phase 11: HPCG {HPCG_K}^3: n={n} nnz={indices.numel()}, "
          f"float32, bfloat16 and float64")
    return out


def run_diagonal(hpcg, bsr, seen):
    """The Jacobi diagonal's main path: ``diagonal`` of HPCG's operator in
    each dtype and of ex56's 3 x 3 blocks, once each;
    ``seen["diagonal", "ex56", "float64"]`` gets the launches counted
    across ex56's call (its own kernel-line row)."""
    out = {("hpcg", name): mat_diagonal(a) for name, a in hpcg.items()}
    before = diag_mod.LAUNCHES["float64"]
    out["ex56", "float64"] = mat_diagonal(bsr)
    seen["diagonal", "ex56", "float64"] = {
        "launches": diag_mod.LAUNCHES["float64"] - before}
    return out


def check_diagonal(hpcg, bsr, out, report, card) -> None:
    """The diagonal kernel against its plain version on the main path's
    matrices: the diagonal and the Jacobi inverse bit for bit; then the
    inverse (the Jacobi set-up's one launch) and the plain version in
    turns behind the spin, beside the bound from compulsory bytes (the
    walked indices, the row pointers, the diagonal values read and the
    output written)."""
    cases = {("hpcg", name): (f"HPCG {HPCG_K}^3 {name}", name,
                              (a.rowptr, a.colind, a.values, a.nrows))
             for name, a in hpcg.items()}
    cases["ex56", "float64"] = ("ex56 float64 3 x 3", "float64_ex56",
                                (bsr.indptr, bsr.indices, bsr.data,
                                 bsr.nrows // 3))
    for key, (what, row, (ptr, idx, vals, length)) in cases.items():
        for invert, got in ((False, out[key]),
                            (True, stored_diagonal(ptr, idx, vals, length,
                                                   invert=True))):
            if not bitwise_equal(got, diagonal_plain(ptr, idx, vals, length,
                                                     invert=invert)):
                raise AssertionError(f"diagonal {what} (invert {invert}): "
                                     "kernel != plain version")
        k_ms, p_ms, (p1, k1, k2, p2) = turns(
            lambda: stored_diagonal(ptr, idx, vals, length, invert=True),
            lambda: diagonal_plain(ptr, idx, vals, length, invert=True),
            TIMED_LAUNCHES, 3, spin=True)
        free_memory()
        per_row = vals.element_size() * (1 if vals.ndim == 1 else
                                         vals.shape[1])
        walked = int(ptr[length]) - int(ptr[0])
        b = bound(4 * walked + 4 * (length + 1) + 2 * per_row * length, 0,
                  "float64")
        print(f"phase 11: diagonal {what}: the diagonal and its inverse "
              f"bitwise the plain version's; kernel (inverse) {k_ms:.4f} ms, "
              f"plain {p_ms:.4f} ms (turns: plain {p1:.4f}, kernel "
              f"{k1:.4f}, kernel {k2:.4f}, plain {p2:.4f}), bound "
              f"{b['bound_ms']:.4f} ms ({b['bound_by']}; "
              f"{100 * b['bound_ms'] / k_ms:.1f} % of it) | {card}")
        report["diagonal", row] = {"max_abs_err": 0.0, "ms": k_ms,
                                   "plain_ms": p_ms, "library_ms": None, **b}


def step_launches(steps: int) -> int:
    """CG-step launches of a fused solve that enqueues ``steps`` steps:
    three passes a step and the first residual's dots."""
    return 3 * steps + 1


def cg_step_inputs(device):
    """``{(shape, name): (x, r, p, ap, inv, rz)}``: CG vectors drawn on
    the card at HPCG's 256**3 unknowns (float64 and float32) and ex56's
    3·161**3 = 12,519,843 (float64), the Jacobi inverse in [0.5, 2)."""
    gen = torch.Generator(device=device).manual_seed(23)
    out = {}
    for shape, n, names in (("hpcg", HPCG_K ** 3, ("float64", "float32")),
                            ("ex56", 3 * EX56_NODES ** 3, ("float64",))):
        for name in names:
            dtype = DTYPES[name][1]

            def draw(lo=-1.0, hi=1.0):
                return torch.empty(n, dtype=dtype, device=device).uniform_(
                    lo, hi, generator=gen)

            out[shape, name] = (draw(), draw(), draw(), draw(), draw(0.5, 2.0),
                                draw(0.5, 1.5)[:1].clone())
        print(f"phase 11: CG step vectors n={n} ({shape}), "
              f"{', '.join(names)}, Jacobi")
    return out


def fused_step(x, r, p, ap, inv, rz, ws):
    """One step of the three passes, ``r`` and ``p`` in place:
    ``(x', [p·ap, r·z, r·r])``."""
    pap = step_mod.pap(p, ap, ws)
    sums = step_mod.update(r, ap, inv, rz, pap, ws)
    x = step_mod.direction(x, r, p, inv, rz, pap, sums[0])
    return x, torch.cat([pap, sums])


def run_cg_step(step_in, seen):
    """The CG step's main path, as a solve runs it: the first residual's
    dots, then one step (three launches) on copies of each case's ``r``
    and ``p``; ``seen["cg_step", "ex56", "float64"]`` gets the launches of
    ex56's."""
    out = {}
    for key, (x, r, p, ap, inv, rz) in step_in.items():
        before = step_mod.LAUNCHES["float64"]
        ws = step_mod.workspace(x)
        first = step_mod.dots(r, inv, ws)
        r1, p1 = r.clone(), p.clone()
        x1, sums = fused_step(x, r1, p1, ap, inv, rz, ws)
        out[key] = (x1, r1, p1, sums, first)
        if key == ("ex56", "float64"):
            seen["cg_step", "ex56", "float64"] = {
                "launches": step_mod.LAUNCHES["float64"] - before}
    return out


def check_cg_step(step_in, out, report, card) -> None:
    """The three passes against the torch step (``cg_step_plain``) fed
    their own dots: x', r and p bit for bit; the dots of every pass and
    the first residual's (``dots``) within STEP_DOT_TOL of float64
    ``torch.dot`` and the same bits launch after launch; then the passes
    and the torch step in turns behind the spin, each pass alone, beside
    the bound: 12 n-vectors read or written."""
    for key, (x, r, p, ap, inv, rz) in step_in.items():
        shape, name = key
        what = f"CG step {shape} {name} (n={x.numel()})"
        x1, r1, p1, sums, first = out[key]
        fed = [list(sums[:1]), list(sums[1:])]
        want = cg_step_plain(x, r, p, ap, rz.reshape(()), lambda v: inv * v,
                             lambda pairs: [v.reshape(()) for v in
                                            fed.pop(0)])
        for label, got, w in (("x'", x1, want[0]), ("r", r1, want[1]),
                              ("p", p1, want[2])):
            if not bitwise_equal(got, w):
                raise AssertionError(f"{what}: {label} != the torch step's")
        errs = []
        for got, u, v in ((sums[0], p, ap), (sums[1], r1, inv * r1),
                          (sums[2], r1, r1), (first[0], r, inv * r),
                          (first[1], r, r)):
            exact = torch.dot(u.double(), v.double())
            scale = torch.dot(u.double().abs(), v.double().abs())
            errs.append(float((got.double() - exact).abs() / scale))
        if max(errs) > STEP_DOT_TOL[name]:
            raise AssertionError(f"{what}: dots {errs} past "
                                 f"{STEP_DOT_TOL[name]}·sum|u·v|")
        ws = step_mod.workspace(x)
        for _ in range(2):
            if not bitwise_equal(step_mod.dots(r, inv, ws), first):
                raise AssertionError(f"{what}: the first residual's dots "
                                     f"differ launch to launch")
            r2, p2 = r.clone(), p.clone()
            if not bitwise_equal(fused_step(x, r2, p2, ap, inv, rz, ws)[1],
                                 sums):
                raise AssertionError(f"{what}: dots differ launch to launch")
        del r2, p2
        # the timed steps run on working copies, r and p updated in place
        rw, pw = r.clone(), p.clone()
        rz0 = rz.reshape(())
        torch_dots = lambda pairs: [torch.dot(u, v) for u, v in pairs]
        k_ms, p_ms, (q1, k1, k2, q2) = turns(
            lambda: fused_step(x, rw, pw, ap, inv, rz, ws),
            lambda: cg_step_plain(x, rw, pw, ap, rz0, lambda v: inv * v,
                                  torch_dots),
            TIMED_LAUNCHES, TIMED_LAUNCHES, spin=True)
        pap = step_mod.pap(pw, ap, ws)
        sw = step_mod.update(rw, ap, inv, rz, pap, ws)
        passes = {
            "pap": (2, lambda: step_mod.pap(pw, ap, ws)),
            "update": (4, lambda: step_mod.update(rw, ap, inv, rz, pap, ws)),
            "direction": (6, lambda: step_mod.direction(x, rw, pw, inv, rz,
                                                        pap, sw[0])),
            "dots": (2, lambda: step_mod.dots(rw, inv, ws))}
        itemsize = x.element_size()
        each = []
        for pname, (vectors, fn) in passes.items():
            ms = time_ms(fn, TIMED_LAUNCHES, spin=True)
            pb = bound(vectors * itemsize * x.numel(), 0, name)["bound_ms"]
            each.append(f"{pname} {ms:.4f} ms (bound {pb:.4f}, "
                        f"{100 * pb / ms:.1f} %)")
        del rw, pw, sw
        free_memory()
        b = bound(12 * itemsize * x.numel(), 0, name)
        print(f"phase 11: {what}: x', r and p bitwise the torch step's "
              f"given the kernels' dots (relative errors "
              f"{', '.join(f'{e:.2e}' for e in errs)}: pap, update's two, "
              f"the first residual's two); dots bitwise repeatable; "
              f"three passes {k_ms:.4f} ms, torch step {p_ms:.4f} ms (turns: "
              f"torch {q1:.4f}, passes {k1:.4f}, passes {k2:.4f}, torch "
              f"{q2:.4f}), bound {b['bound_ms']:.4f} ms (12 vectors, "
              f"{b['bound_by']}; {100 * b['bound_ms'] / k_ms:.1f} % of it); "
              f"{'; '.join(each)} | {card}")
        row = name if shape == "hpcg" else f"{name}_{shape}"
        report["cg_step", row] = {"max_abs_err": 0.0, "ms": k_ms,
                                  "plain_ms": p_ms, "library_ms": None, **b}


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


def stencil_csr(k: int, dims: int, device, convection: float = 0.0):
    """The (2·dims + 1)-point Laplacian of a k**dims grid (diagonal 2·dims,
    neighbours -1), plus ``convection`` times the upwind first difference
    along each axis (nonsymmetric when positive), float64 CSR from sorted
    host arrays through the validating constructor."""
    n = k ** dims
    idx = np.arange(n, dtype=np.int64)
    rows, cols = [idx], [idx]
    vals = [np.full(n, dims * (2.0 + convection))]
    for d in range(dims):
        stride = k ** d
        coord = (idx // stride) % k
        for step in (-1, 1):
            ok = (coord + step >= 0) & (coord + step < k)
            rows.append(idx[ok])
            cols.append(idx[ok] + step * stride)
            vals.append(np.full(int(ok.sum()),
                                -1.0 - (convection if step < 0 else 0.0)))
    r, c, v = (np.concatenate(a) for a in (rows, cols, vals))
    order = np.lexsort((c, r))
    ptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(ptr, r + 1, 1)
    return CsrMatrix(n, n, np.cumsum(ptr), c[order], v[order], device=device)


def card_vector(n: int, np_dtype, seed: int, device) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.normal(size=n).astype(np_dtype)).to(device)


def solver_run(fn):
    """Run ``fn`` once between a reset and a read of every launch count:
    ``(result, seconds to the card's completion, launches)``."""
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    got = {kname: {key: n for key, n in counts.items() if n}
           for kname, (_, counts) in KERNELS.items()}
    return out, seconds, {kname: per for kname, per in got.items() if per}


def expect_launches(what: str, got, kname: str, name: str, n: int,
                    solver_launches) -> None:
    """Fail unless the run launched ``kname`` in ``name`` exactly ``n``
    times and no other kernel; add ``n`` to the kernel line's
    ``solver_launches``."""
    expect_counts(what, got, {kname: {name: n}}, solver_launches)


def expect_counts(what: str, got, want, solver_launches) -> None:
    """Fail unless the run launched exactly ``want`` (``{kernel: {dtype:
    n}}``) and nothing else; add each count to the kernel line's
    ``solver_launches``."""
    if got != want:
        raise AssertionError(f"{what}: kernel launches {got}, expected "
                             f"{want}")
    for kname, per in want.items():
        for name, n in per.items():
            solver_launches[kname, name] = (
                solver_launches.get((kname, name), 0) + n)


def true_residual(A64, x, b) -> float:
    """``||b - A·x||`` recomputed in float64 by the plain SpMV, not by
    the kernel the solver ran."""
    ax = csr_spmv_plain(A64.rowptr, A64.colind, A64.values, x.double(),
                        A64.nrows)
    return float(torch.linalg.vector_norm(b.double() - ax))


def hold_spmv(what: str, mat, x) -> str:
    """The SpMV kernel of ``mat`` (CSR or BSR) against its plain version on
    the solver's matrix and right-hand side, entry by entry within
    ``TOL·(|A||x|)``; names the variant that ran and the max |err|."""
    if isinstance(mat, BsrMatrix):
        kname, n = "bsr_spmv", ()
        kern, plain = bsr_spmv, bsr_spmv_plain
        ptr, ind, vals = mat.indptr, mat.indices, mat.data
    else:
        kname, n = "csr_spmv", (mat.nrows,)
        kern, plain = csr_spmv, csr_spmv_plain
        ptr, ind, vals = mat.rowptr, mat.colind, mat.values
    before = dict(VARIANTS[kname])
    y = kern(ptr, ind, vals, x, *n)
    variant = ran_variant(VARIANTS[kname], before, f"{what} SpMV")
    err = (y - plain(ptr, ind, vals, x, *n)).abs()
    tol = TOL[str(x.dtype).removeprefix("torch.")]
    within(err, plain(ptr, ind, vals.abs(), x.abs(), *n), tol,
           f"{what} SpMV against its plain version")
    return (f"{kname}:{variant} == plain within {tol}·|A||x| (max |err| "
            f"{float(err.max()):.3e})")


def check_residual(what: str, A64, x, b, tol: float) -> float:
    resid = true_residual(A64, x, b)
    if not resid <= 1.01 * tol:
        raise AssertionError(f"{what}: ||b - A·x|| {resid:.4e} > 1.01 x tol "
                             f"{tol:.4e}")
    return resid


def check_paths(what: str, fn, prefix) -> str:
    """Run ``fn`` with the metrics recorder on; fail unless every product
    it recorded ran a kernel (``prefix``, a string or a tuple of them)."""
    rec = metrics.enable()
    rec.records.clear()
    try:
        fn()
        torch.cuda.synchronize()
        paths = sorted({r.path for r in rec.records})
    finally:
        metrics.disable()
        rec.records.clear()
    if not paths or not all(p.startswith(prefix) for p in paths):
        raise AssertionError(f"{what}: metrics paths {paths}, expected "
                             f"{prefix}*")
    return ", ".join(paths)


def launches_per_call(fn, calls: int):
    """Device operations (kernels, copies, fills) per call of ``fn`` and
    ms per call, from ``torch.profiler``; None where it saw none."""
    wall, _, per_name = profile_steps(fn, calls)
    if not per_name:
        return None, wall / calls
    return sum(n for _, (_, n) in per_name) / calls, wall / calls


def krylov_phase(device, card: str, solver_launches) -> None:
    """Phase 16: CG (Jacobi) on the 128**3 Laplacian in both dtypes, PCG
    with IC(0) against Jacobi on the 64**3 one, GMRES(32) and BiCGSTAB
    with ILU(0) on a 64**3 convection-diffusion matrix, CG with Chebyshev
    on the 128**3 Laplacian, and CG on the BSR form of the 64**3 one."""
    A64 = stencil_csr(KRYLOV_K, 3, device)
    n = A64.nrows
    print(f"phase 16: 7-point Laplacian {KRYLOV_K}^3: n={n} nnz={A64.nnz}")
    for name, (np_dtype, dtype) in DTYPES.items():
        A = A64 if name == "float64" else A64.astype(dtype)
        b = card_vector(n, np_dtype, 16, device)
        tol = CG_RTOL[name] * float(torch.linalg.vector_norm(b.double()))
        # the metrics check doubles as the warm-up: the SpMV plan and the
        # first use of each vector op in this dtype
        paths = check_paths(
            f"CG {name}",
            lambda: cg(A, b, maxiter=2, precondition="jacobi"),
            ("csr_spmv:cuda:", "diagonal:cuda", "cg_step:cuda:fused"))
        held = hold_spmv(f"CG {name}", A, b)
        # the Jacobi setup, the first residual and its dot products
        _, setup_s, _ = solver_run(
            lambda: cg(A, b, maxiter=0, precondition="jacobi"))
        res, sec, got = solver_run(
            lambda: cg(A, b, tol=tol, precondition="jacobi"))
        expect_counts(f"CG {name}", got,
                      {"csr_spmv": {name: res.iterations + 1},
                       "diagonal": {name: 1},
                       "cg_step": {name: step_launches(res.iterations)}},
                      solver_launches)
        resid = check_residual(f"CG {name}", A64, res.x, b, tol)
        spmv_ms = time_ms(lambda: A @ b, TIMED_LAUNCHES, spin=True)
        itemsize = A.values.element_size()
        spmv_bound = bound((itemsize + 4) * A.nse + itemsize * 2 * n
                           + 4 * (n + 1), 2 * A.nse, name)["bound_ms"]
        print(f"phase 16: CG+Jacobi {KRYLOV_K}^3 {name}: "
              f"{res.iterations} iterations, {sec * 1e3 / res.iterations:.4f}"
              f" ms/iteration ({sec:.3f} s, the Jacobi setup included; "
              f"maxiter=0 {setup_s * 1e3:.3f} ms), SpMV "
              f"kernel {spmv_ms:.4f} ms (bound {spmv_bound:.4f}; B1 launches "
              f"{res.iterations + 1} = iterations + 1; path {paths}; {held});"
              f" ||b - A·x|| (plain SpMV) = {resid / tol:.4f} x tol (tol "
              f"{CG_RTOL[name]}·||b||) | {card}")
        print_profile(f"phase 16: CG+Jacobi {name}, 20 iterations and the "
                      "Jacobi setup:",
                      lambda: cg(A, b, maxiter=20, precondition="jacobi"), 1)
        del A, b, res

    b = card_vector(n, np.float64, 17, device)
    tol = CG_RTOL["float64"] * float(torch.linalg.vector_norm(b))
    t0 = time.perf_counter()
    M = chebyshev(A64, degree=CHEBYSHEV_DEGREE)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    res, sec, got = solver_run(lambda: cg(A64, b, tol=tol, precondition=M))
    expect_launches("CG+Chebyshev", got, "csr_spmv", "float64",
                    (res.iterations + 1) * (CHEBYSHEV_DEGREE + 1),
                    solver_launches)
    resid = check_residual("CG+Chebyshev", A64, res.x, b, tol)
    print(f"phase 16: CG+Chebyshev(degree {CHEBYSHEV_DEGREE}) {KRYLOV_K}^3 "
          f"float64: lmax {M.lmax:.6f} (setup {build_s:.3f} s), "
          f"{res.iterations} iterations, {sec * 1e3 / res.iterations:.4f} "
          f"ms/iteration, {(res.iterations + 1) * (CHEBYSHEV_DEGREE + 1)} "
          f"SpMV; ||b - A·x|| (plain SpMV) = {resid / tol:.4f} x tol | "
          f"{card}")
    del A64, M, b, res
    free_memory()

    P64 = stencil_csr(PRECOND_K, 3, device)
    n = P64.nrows
    print(f"phase 16: 7-point Laplacian {PRECOND_K}^3: n={n} nnz={P64.nnz}")
    b = card_vector(n, np.float64, 18, device)
    tol = CG_RTOL["float64"] * float(torch.linalg.vector_norm(b))
    t0 = time.perf_counter()
    M = ic0(P64)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    if not (M.l_plan.use_device and M.u_plan.use_device):
        raise AssertionError(f"IC(0): {M.l_plan.n_levels} levels, past the "
                             "device cap")
    held = hold_spmv(f"PCG {PRECOND_K}^3", P64, b)   # and the SpMV plan
    cg(P64, b, maxiter=2, precondition="jacobi")      # warm-up
    jac, jsec, got = solver_run(
        lambda: cg(P64, b, tol=tol, precondition="jacobi"))
    expect_counts("PCG Jacobi", got,
                  {"csr_spmv": {"float64": jac.iterations + 1},
                   "diagonal": {"float64": 1},
                   "cg_step": {"float64": step_launches(jac.iterations)}},
                  solver_launches)
    res, sec, got = solver_run(lambda: cg(P64, b, tol=tol, precondition=M))
    expect_launches("PCG IC(0)", got, "csr_spmv", "float64",
                    res.iterations + 1, solver_launches)
    resid = check_residual("PCG IC(0)", P64, res.x, b, tol)
    ops, solve_ms = launches_per_call(lambda: M.solve(b), 3)
    print(f"phase 16: PCG+IC(0) {PRECOND_K}^3 float64: {res.iterations} "
          f"iterations against Jacobi's {jac.iterations}; "
          f"{sec * 1e3 / res.iterations:.4f} ms/iteration against "
          f"{jsec * 1e3 / jac.iterations:.4f}; IC(0) setup {build_s:.3f} s, "
          f"{M.l_plan.n_levels} + {M.u_plan.n_levels} levels (device path), "
          f"one application {solve_ms:.4f} ms, "
          f"{'not measured' if ops is None else f'{ops:.0f}'} device "
          f"operations; {held}; ||b - A·x|| (plain SpMV) = "
          f"{resid / tol:.4f} x tol | {card}")
    del M, jac, res

    B = P64.astype(torch.float32).to_bsr(8)
    b32 = b.float()
    tol32 = CG_RTOL["float32"] * float(torch.linalg.vector_norm(b32.double()))
    paths = check_paths("CG on BSR", lambda: cg(B, b32, maxiter=2),
                        ("bsr_spmv:cuda:", "cg_step:cuda:fused"))
    held = hold_spmv("CG on BSR", B, b32)
    res, sec, got = solver_run(lambda: cg(B, b32, tol=tol32))
    expect_counts("CG on BSR", got,
                  {"bsr_spmv": {"float32": res.iterations + 1},
                   "cg_step": {"float32": step_launches(res.iterations)}},
                  solver_launches)
    resid = check_residual("CG on BSR", P64, res.x, b32, tol32)
    spmv_ms = time_ms(lambda: B @ b32, TIMED_LAUNCHES, spin=True)
    print(f"phase 16: CG on csr.to_bsr(8) {PRECOND_K}^3 float32: "
          f"{res.iterations} iterations, {sec * 1e3 / res.iterations:.4f} "
          f"ms/iteration, BSR SpMV kernel {spmv_ms:.4f} ms (B4 launches "
          f"{res.iterations + 1} = iterations + 1; path {paths}; {held}); "
          f"||b - A·x|| (plain SpMV) = {resid / tol32:.4f} x tol | {card}")
    del B, b32, res, P64

    C = stencil_csr(PRECOND_K, 3, device, convection=CONVECTION)
    t0 = time.perf_counter()
    M = ilu0(C)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    if not (M.l_plan.use_device and M.u_plan.use_device):
        raise AssertionError("ILU(0): past the device cap")
    atol = max(CG_RTOL["float64"] * float(torch.linalg.vector_norm(b)),
               CG_RTOL["float64"])
    held = hold_spmv("convection-diffusion", C, b)   # and the SpMV plan
    for sname in ("gmres", "bicgstab"):
        if sname == "gmres":
            res, sec, got = solver_run(lambda: gmres(
                C, b, tol=CG_RTOL["float64"], restart=GMRES_RESTART, M=M))
            cycles = res.iterations // (GMRES_RESTART + 1)
            spmv = 1 + res.iterations + cycles
        else:
            res, sec, got = solver_run(lambda: bicgstab(
                C, b, tol=CG_RTOL["float64"], M=M))
            spmv = 1 + res.iterations
        expect_launches(sname, got, "csr_spmv", "float64", spmv,
                        solver_launches)
        resid = check_residual(f"{sname}+ILU(0)", C, res.x, b, atol)
        print(f"phase 16: {sname}{'(32)' if sname == 'gmres' else ''}"
              f"+ILU(0) convection-diffusion {PRECOND_K}^3 (upwind "
              f"{CONVECTION}) float64: {res.iterations} matvecs ({spmv} "
              f"SpMV), {sec * 1e3 / res.iterations:.4f} ms/matvec "
              f"({sec:.3f} s); ILU(0) setup {build_s:.3f} s; {held}; "
              f"||b - A·x|| (plain SpMV) = {resid / atol:.4f} x tol | {card}")
    del C, M, res, b
    free_memory()


def refactor_s(A) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cholesky(A, method="supernodal")
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def cholesky_phase(device, card: str) -> None:
    """Phase 17, config[3]: ``cholesky`` -> ``cholesky_solve`` on the
    512**2 Laplacian (the supernodal path) in both dtypes, and on the
    256**2 one (the banded path, against the supernodal solve)."""
    L = stencil_csr(CHOL_K, 2, device)
    n = L.nrows
    print(f"phase 17: 5-point Laplacian {CHOL_K}^2: n={n} nnz={L.nnz}")
    free_memory()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    for name in ("float64", "float32"):     # float64 builds the plan
        np_dtype, dtype = DTYPES[name]
        A = L if name == "float64" else L.astype(dtype)
        rec = metrics.enable()
        rec.records.clear()
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fac = cholesky(A)
            torch.cuda.synchronize()
            cold = time.perf_counter() - t0
            host = {r.op: r.seconds for r in rec.records
                    if r.op.startswith("chol_")}
        finally:
            metrics.disable()
            rec.records.clear()
        if fac.path != "supernodal":
            raise AssertionError(f"config[3] {name}: auto took the "
                                 f"{fac.path} path, not supernodal")
        plan = fac.snf.plan
        if not fac.snf.ok:
            raise AssertionError(f"config[3] {name}: a front was not "
                                 "positive definite")
        times = [refactor_s(A) for _ in range(REFACTORS)]
        refactor = sorted(times)[len(times) // 2]
        again = cholesky(A, method="supernodal")
        same = all(torch.equal(again.snf.panels[k], p)
                   for k, p in fac.snf.panels.items())
        worst = max(float((again.snf.panels[k] - p).abs().max()
                          / p.abs().max().clamp_min(1e-300))
                    for k, p in fac.snf.panels.items())
        if not same and not worst <= TOL[name]:
            raise AssertionError(f"config[3] {name}: two factors differ by "
                                 f"{worst:.3e} relative, past {TOL[name]}")
        ops, _ = launches_per_call(lambda: cholesky(A, method="supernodal"), 1)
        b = card_vector(n, np_dtype, 19, device)
        x = cholesky_solve(fac, b)
        solve_ms = time_ms(lambda: cholesky_solve(fac, b), SOLVES)
        rel = true_residual(L, x, b) / float(torch.linalg.vector_norm(
            b.double()))
        if not rel <= CHOL_RTOL[name]:
            raise AssertionError(f"config[3] {name}: ||A·x - b|| / ||b|| "
                                 f"{rel:.3e} > {CHOL_RTOL[name]}")
        nbk = sum(len(bks) for bks in plan.levels)
        hosts = ", ".join(f"{op.removeprefix('chol_')} {sec:.3f} s"
                          for op, sec in host.items()) or "cached"
        repeat = ("bitwise equal" if same else
                  f"equal within {worst:.3e} relative (index_add_ atomics)")
        print(f"phase 17: config[3] {CHOL_K}^2 {name}: auto -> "
              f"{fac.path}; host (ordering, symbolic, plan): {hosts}; cold "
              f"factor {cold:.3f} s; re-factor (plan cached) "
              f"{refactor * 1e3:.2f} ms (runs "
              f"{', '.join(f'{t * 1e3:.2f}' for t in times)}), "
              f"{plan.flops() / refactor / 1e9:.1f} GFLOP/s over "
              f"{plan.flops() / 1e9:.3f} GFLOP of fronts, "
              f"{'not measured' if ops is None else f'{ops:.0f}'} device "
              f"operations over {len(plan.levels)} levels, {nbk} buckets; "
              f"solve {solve_ms:.3f} ms; ||A·x - b|| / ||b|| = {rel:.3e}; "
              f"two factors {repeat} | {card}")
        del fac, again, x, b, A
    peak = torch.cuda.max_memory_allocated()
    print(f"phase 17: peak device memory {peak / 1e9:.3f} GB "
          f"({resident / 1e9:.3f} GB resident before) | {card}")
    del L
    free_memory()

    Bm = stencil_csr(BAND_K, 2, device)
    b = card_vector(Bm.nrows, np.float64, 20, device)
    out = {}
    for method in ("auto", "supernodal"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fac = cholesky(Bm, method=method)
        torch.cuda.synchronize()
        cold = time.perf_counter() - t0
        t0 = time.perf_counter()
        cholesky(Bm, method=method)
        torch.cuda.synchronize()
        warm = time.perf_counter() - t0
        x = cholesky_solve(fac, b)
        solve_ms = time_ms(lambda: cholesky_solve(fac, b), SOLVES)
        out[method] = (fac.path, x)
        print(f"phase 17: {BAND_K}^2 float64 method={method} -> {fac.path}:"
              f" factor {cold:.3f} s cold, {warm:.3f} s again; solve "
              f"{solve_ms:.3f} ms | {card}")
    if out["auto"][0] != "banded":
        raise AssertionError(f"{BAND_K}^2: auto took {out['auto'][0]}, not "
                             "the banded path")
    xb, xs = out["auto"][1], out["supernodal"][1]
    rel = float(torch.linalg.vector_norm(xb - xs)
                / torch.linalg.vector_norm(xs))
    if not rel <= BAND_MATCH:
        raise AssertionError(f"{BAND_K}^2: banded and supernodal solves "
                             f"differ by {rel:.3e} relative")
    print(f"phase 17: {BAND_K}^2 banded solve against supernodal: "
          f"{rel:.3e} relative (<= {BAND_MATCH})")
    del Bm, b, out, fac
    free_memory()


def hold_spmm(what: str, mat, X) -> str:
    """The SpMM kernel of ``mat`` on the operand ``X`` as a solver hands
    it over (a transposed view, a column slice, QR's layout), through the
    wrapper and through ``mat @ X``, against the plain version on a
    contiguous copy, entry by entry within ``TOL·(|A||X|)``."""
    n = mat.nrows
    ptr, ind, vals = mat.rowptr, mat.colind, mat.values
    before = dict(VARIANTS["csr_spmm"])
    Y = csr_spmm(ptr, ind, vals, X, n)
    variant = ran_variant(VARIANTS["csr_spmm"], before, f"{what} SpMM")
    Xc = X.contiguous()
    err = (Y - csr_spmm_plain(ptr, ind, vals, Xc, n)).abs()
    tol = TOL[str(X.dtype).removeprefix("torch.")]
    within(err, csr_spmm_plain(ptr, ind, vals.abs(), Xc.abs(), n), tol,
           f"{what} SpMM against its plain version")
    if not torch.equal(mat @ X, Y):
        raise AssertionError(f"{what}: mat @ X differs from the wrapper")
    layout = "contiguous" if X.is_contiguous() else f"strides {X.stride()}"
    return (f"csr_spmm:{variant} k={X.shape[1]} ({layout}) == plain within "
            f"{tol}·|A||X| (max |err| {float(err.max()):.3e})")


def hold_spgemm(what: str, a, b, c) -> str:
    """The SpGEMM numeric kernel's output ``c = a * b`` against the plain
    numeric phase on the same (cached) plan, slot by slot within
    ``TOL·Σ|a||b|``."""
    plan = spgemm_mod._cached_plan(a, b)
    args = (plan.gid, plan.a_idx, plan.b_idx)
    if not (torch.equal(c.rowptr, plan.rowptr)
            and torch.equal(c.colind, plan.colind)):
        raise AssertionError(f"{what}: A·B has another structure than its "
                             "plan")
    ref = spgemm_numeric_plain(*args, a.values, b.values, plan.n_out)
    err = (c.values - ref).abs()
    tol = TOL[str(c.dtype).removeprefix("torch.")]
    within(err, spgemm_numeric_plain(*args, a.values.abs(), b.values.abs(),
                                     plan.n_out), tol, f"{what} SpGEMM")
    return (f"spgemm ({plan.a_idx.numel()} terms, {plan.n_out} slots) == "
            f"plain within {tol}·Σ|a||b| (max |err| {float(err.max()):.3e})")


def gradient_csr(k: int, device, reg: float = GRAD_REG):
    """``[Dx; Dy; reg·I]`` of a k**2 grid (forward differences along the
    fast and the slow axis, then the regularising identity): 2k(k - 1) +
    k**2 rows, k**2 columns, float64 CSR through the validating
    constructor. Least squares on it reconstructs a field from its
    gradients."""
    n = k * k
    idx = np.arange(n, dtype=np.int64).reshape(k, k)
    dx = idx[:, :-1].ravel()                   # i·k + j, j < k - 1
    dy = idx[:-1, :].ravel()                   # i·k + j, i < k - 1
    m_d = dx.size
    rows = np.concatenate([np.arange(m_d), np.arange(m_d),
                           m_d + np.arange(m_d), m_d + np.arange(m_d),
                           2 * m_d + np.arange(n)])
    cols = np.concatenate([dx, dx + 1, dy, dy + k, np.arange(n)])
    vals = np.concatenate([np.full(m_d, -1.0), np.full(m_d, 1.0),
                           np.full(m_d, -1.0), np.full(m_d, 1.0),
                           np.full(n, reg)])
    order = np.lexsort((cols, rows))
    ptr = np.zeros(2 * m_d + n + 1, dtype=np.int64)
    np.add.at(ptr, rows + 1, 1)
    return CsrMatrix(2 * m_d + n, n, np.cumsum(ptr), cols[order],
                     vals[order], device=device)


def lu_refactor_ms(plan, svals) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    supernodal_lu_factor(plan, svals, perturb=True)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def factor_gap(a, b) -> tuple:
    """Whether two supernodal LU factors are bitwise equal, and their
    largest difference relative to each bucket's largest entry."""
    same, worst = True, 0.0
    for part in ("lu11", "l21", "u12"):
        for key, p in getattr(a, part).items():
            q = getattr(b, part)[key]
            if p.numel() == 0:
                continue
            same = same and torch.equal(p, q)
            worst = max(worst, float((p - q).abs().max()
                                     / p.abs().max().clamp_min(1e-300)))
    same = same and all(torch.equal(p, b.perm11[key])
                        for key, p in a.perm11.items())
    return same, worst


def relative_residual(A64, x, b) -> float:
    return true_residual(A64, x, b) / float(torch.linalg.vector_norm(
        b.double()))


def lu_phase(device, card: str, solver_launches) -> None:
    """Phase 18: ``lu`` on the upwind convection-diffusion of the 512**2
    grid in both dtypes (``auto`` -> supernodal through the slab guard);
    ``spsolve`` on the 256**2 convection-diffusion (LU, banded) and
    Laplacian (Cholesky); ``lstsq`` on the 512**2 gradient operator in
    both dtypes; ``qr_q_apply`` / ``qr_qt_apply`` / ``qr_r_dense`` at
    n = 4096."""
    C = stencil_csr(LU_K, 2, device, convection=CONVECTION)
    n = C.nrows
    nb = 64
    slab_gb = -(-n // nb) * (nb + LU_K) ** 2 * 8 / 1e9
    print(f"phase 18: upwind convection-diffusion {LU_K}^2 (convection "
          f"{CONVECTION}): n={n} nnz={C.nnz}; RCM band {LU_K}, float64 slab "
          f"stack {slab_gb:.2f} GB > {SLAB_LIMIT_BYTES / 1e9:.1f} GB")
    free_memory()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    for name in ("float64", "float32"):     # float64 builds the plan
        np_dtype, dtype = DTYPES[name]
        A = C if name == "float64" else C.astype(dtype)
        b = card_vector(n, np_dtype, 21, device)
        held = hold_spmv(f"LU {name}", A, b)
        rec = metrics.enable()
        rec.records.clear()
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fac = lu(A)
            torch.cuda.synchronize()
            cold = time.perf_counter() - t0
            host = {r.op: r.seconds for r in rec.records
                    if r.op.startswith("lu_")}
        finally:
            metrics.disable()
            rec.records.clear()
        if fac.path != "supernodal":
            raise AssertionError(f"LU {LU_K}^2 {name}: auto took the "
                                 f"{fac.path} path, not supernodal")
        plan, svals = fac.snlu.plan, fac.values
        times = [lu_refactor_ms(plan, svals) for _ in range(REFACTORS)]
        refactor = sorted(times)[len(times) // 2]
        again = supernodal_lu_factor(plan, svals, perturb=True)
        same, worst = factor_gap(fac.snlu, again)
        if not same and not worst <= TOL[name]:
            raise AssertionError(f"LU {name}: two factors differ by "
                                 f"{worst:.3e} relative, past {TOL[name]}")
        del again
        ops, _ = launches_per_call(
            lambda: supernodal_lu_factor(plan, svals, perturb=True), 1)
        x, _, got = solver_run(lambda: lu_solve(fac, b))
        expect_counts(f"LU solve {name} (refine=1)", got,
                      {"csr_spmv": {name: 1}}, solver_launches)
        solve_ms = time_ms(lambda: lu_solve(fac, b), SOLVES)
        rel = relative_residual(C, x, b)
        if not rel <= LU_RTOL[name]:
            raise AssertionError(f"LU {name}: ||b - A·x|| / ||b|| {rel:.3e}"
                                 f" > {LU_RTOL[name]}")
        nbk = sum(len(bks) for bks in plan.levels)
        hosts = ", ".join(f"{op.removeprefix('lu_')} {sec:.3f} s"
                          for op, sec in host.items()) or "cached"
        repeat = ("bitwise equal" if same else
                  f"equal within {worst:.3e} relative (index_add_ atomics)")
        print(f"phase 18: LU {LU_K}^2 {name}: auto -> {fac.path}; host "
              f"(symmetrize, ordering = AMD, etree = etree + postorder, "
              f"symbolic, plan): {hosts}; cold factor {cold:.3f} s; "
              f"re-factor supernodal_lu_factor(plan, values) {refactor:.2f} "
              f"ms (runs {', '.join(f'{t:.2f}' for t in times)}), "
              f"{plan.flops() / refactor / 1e6:.1f} GFLOP/s over "
              f"{plan.flops() / 1e9:.3f} GFLOP of padded fronts, "
              f"{'not measured' if ops is None else f'{ops:.0f}'} device "
              f"operations over {len(plan.levels)} levels, {nbk} buckets; "
              f"L+U entries {plan.lu_nnz}; solve (refine=1: one B1 launch) "
              f"{solve_ms:.3f} ms; ||b - A·x|| / ||b|| (plain SpMV) = "
              f"{rel:.3e}; two factors {repeat}; {held} | {card}")
        print_profile(f"phase 18: LU re-factor {name}:", lambda:
                      supernodal_lu_factor(plan, svals, perturb=True), 1)
        if name == "float64":
            print_profile("phase 18: LU solve float64 (refine=1):",
                          lambda: lu_solve(fac, b), 1)
        del fac, x, b, A, svals
    peak = torch.cuda.max_memory_allocated()
    print(f"phase 18: LU peak device memory {peak / 1e9:.3f} GB "
          f"({resident / 1e9:.3f} GB resident before) | {card}")
    del C
    free_memory()

    # spsolve: the convection-diffusion matrix (LU, banded) and the
    # Laplacian (Cholesky) of the 256**2 grid
    S = stencil_csr(SPSOLVE_K, 2, device, convection=CONVECTION)
    b = card_vector(S.nrows, np.float64, 22, device)
    rec = metrics.enable()
    rec.records.clear()
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fac = lu(S)
        torch.cuda.synchronize()
        band_s = time.perf_counter() - t0
        slab_s = sum(r.seconds for r in rec.records
                     if r.op == "lu_band_slabs")
    finally:
        metrics.disable()
        rec.records.clear()
    if fac.path != "banded":
        raise AssertionError(f"spsolve {SPSOLVE_K}^2: lu's auto took "
                             f"{fac.path}, not the banded path")
    x_band = lu_solve(fac, b)
    band_ms = time_ms(lambda: lu_solve(fac, b), 1)
    del fac
    x, sp_s, got = solver_run(lambda: spsolve(S, b))
    expect_counts("spsolve convection-diffusion", got, {}, solver_launches)
    gap = float(torch.linalg.vector_norm(x - x_band)
                / torch.linalg.vector_norm(x_band))
    fac_sn = lu(S, method="supernodal")
    x_sn = lu_solve(fac_sn, b)
    del fac_sn
    rel_sn = float(torch.linalg.vector_norm(x - x_sn)
                   / torch.linalg.vector_norm(x_sn))
    rel = relative_residual(S, x, b)
    if not (gap <= BAND_MATCH and rel_sn <= BAND_MATCH
            and rel <= LU_RTOL["float64"]):
        raise AssertionError(f"spsolve {SPSOLVE_K}^2: against lu {gap:.3e},"
                             f" against supernodal {rel_sn:.3e}, residual "
                             f"{rel:.3e}")
    print(f"phase 18: spsolve convection-diffusion {SPSOLVE_K}^2 float64: "
          f"auto -> LU -> banded (lu alone {band_s:.3f} s, of it the host "
          f"slabs {slab_s:.3f} s and {-(-S.nrows // 64)} panels of 64 "
          f"Doolittle steps; its solve "
          f"{band_ms:.3f} ms; no kernel launch: the banded path does not "
          f"refine); spsolve {sp_s:.3f} s, {gap:.3e} from lu_solve, "
          f"{rel_sn:.3e} from lu(method='supernodal'); ||b - A·x|| / ||b|| "
          f"(plain SpMV) = {rel:.3e} | {card}")
    del S, x, x_band, x_sn
    Lap = stencil_csr(SPSOLVE_K, 2, device)
    x, sp_s, got = solver_run(lambda: spsolve(Lap, b))
    expect_counts("spsolve Laplacian", got, {}, solver_launches)
    rel = relative_residual(Lap, x, b)
    if not rel <= CHOL_RTOL["float64"]:
        raise AssertionError(f"spsolve Laplacian: residual {rel:.3e}")
    print(f"phase 18: spsolve Laplacian {SPSOLVE_K}^2 float64: auto -> "
          f"symmetric -> Cholesky (banded) + probe solve; {sp_s:.3f} s; "
          f"||b - A·x|| / ||b|| (plain SpMV) = {rel:.3e} | {card}")
    del Lap, x, b
    free_memory()

    # lstsq: the regularised gradient operator of the 512**2 grid
    G64 = gradient_csr(LSQ_K, device)
    print(f"phase 18: gradient operator [Dx; Dy; {GRAD_REG}·I] of {LSQ_K}^2: "
          f"{G64.nrows} x {G64.ncols}, nnz={G64.nnz}")
    for name in ("float64", "float32"):
        np_dtype, dtype = DTYPES[name]
        G = G64 if name == "float64" else G64.astype(dtype)
        b = card_vector(G.nrows, np_dtype, 23, device)
        t0 = time.perf_counter()
        fac = qr(G)                     # warm: SpGEMM plan, Cholesky plan
        torch.cuda.synchronize()
        cold = time.perf_counter() - t0
        held = (hold_spmv(f"lstsq {name} A", G, fac.at @ b) + "; "
                + hold_spmv(f"lstsq {name} Aᵀ", fac.at, b) + "; "
                + hold_spgemm(f"lstsq {name} AᵀA", fac.at, G, fac.gram))
        if fac.chol.path != "supernodal":
            raise AssertionError(f"lstsq {name}: AᵀA took {fac.chol.path}")
        del fac
        x, sec, got = solver_run(lambda: lstsq(G, b))
        expect_counts(f"lstsq {name}", got,
                      {"spgemm": {name: 1}, "csr_spmv": {name: 3}},
                      solver_launches)
        at = G.transpose()
        r = b.double() - csr_spmv_plain(G64.rowptr, G64.colind, G64.values,
                                        x.double(), G64.nrows)
        ne = float(torch.linalg.vector_norm(csr_spmv_plain(
            at.rowptr, at.colind, at.values.double(), r, G64.ncols))
            / torch.linalg.vector_norm(csr_spmv_plain(
                at.rowptr, at.colind, at.values.double(), b.double(),
                G64.ncols)))
        if not ne <= LSQ_RTOL[name]:
            raise AssertionError(f"lstsq {name}: ||Aᵀ(b - A·x)|| / ||Aᵀb|| "
                                 f"{ne:.3e} > {LSQ_RTOL[name]}")
        print(f"phase 18: lstsq {LSQ_K}^2 {name}: qr with plans cold "
              f"{cold:.3f} s; lstsq (plans cached: AᵀA by one B3 launch, "
              f"Cholesky, qr_solve refine=1 by three B1 launches) "
              f"{sec:.3f} s; ||Aᵀ(b - A·x)|| / ||Aᵀb|| (plain SpMV) = "
              f"{ne:.3e}; {held} | {card}")
        del G, b, x, at, r
    free_memory()

    # the explicit R and the implicit Q at n = 4096
    Gs = gradient_csr(QR_APPLY_K, device)
    k = QR_APPLY_COLS
    rng_y = card_vector(Gs.ncols * k, np.float64, 24, device)
    Y = rng_y.view(k, Gs.ncols).mT               # (n, k), transposed view
    fac, _, got = solver_run(lambda: qr(Gs, method="sparse"))
    expect_counts("qr (n = 4096)", got, {"spgemm": {"float64": 1}},
                  solver_launches)
    held = hold_spgemm(f"qr n={Gs.ncols} AᵀA", fac.at, Gs, fac.gram)
    R = qr_r_dense(fac)
    gram = fac.gram.to_dense()
    r_err = float((R.mT @ R - gram).abs().max() / gram.abs().max())
    QY, _, got = solver_run(lambda: qr_q_apply(fac, Y))
    expect_counts("qr_q_apply", got, {"csr_spmm": {"float64": 1}},
                  solver_launches)
    back, _, got = solver_run(lambda: qr_qt_apply(fac, QY))
    expect_counts("qr_qt_apply", got, {"csr_spmm": {"float64": 1}},
                  solver_launches)
    trip = float((back - Y).abs().max() / Y.abs().max())
    held += "; " + "; ".join((
        hold_spmm("qr_q_apply", Gs, torch.linalg.solve_triangular(
            R, Y, upper=True)), hold_spmm("qr_qt_apply", fac.at, QY)))
    if not (r_err <= QR_RTOL and trip <= QR_RTOL):
        raise AssertionError(f"qr n={Gs.ncols}: RᵀR against AᵀA {r_err:.3e},"
                             f" Qᵀ(Qy) against y {trip:.3e}")
    print(f"phase 18: qr of the {QR_APPLY_K}^2 gradient operator "
          f"({Gs.nrows} x {Gs.ncols}): qr_r_dense RᵀR == AᵀA within "
          f"{r_err:.3e} relative; qr_qt_apply(qr_q_apply(Y)) == Y within "
          f"{trip:.3e} (k={k}, Y a transposed view; one B3 launch for AᵀA, "
          f"one B2 launch each apply); "
          f"{held} | {card}")
    del Gs, fac, R, gram, QY, back, Y
    free_memory()


def laplacian_modes(k: int, count: int, dims: int = 2) -> np.ndarray:
    """The ``count`` smallest eigenvalues of the (2·dims + 1)-point
    Dirichlet Laplacian of a k**dims grid, ascending."""
    mu = 2.0 - 2.0 * np.cos(np.pi * np.arange(1, k + 1) / (k + 1))
    lam = mu[:, None] + mu[None, :]
    return np.sort(lam.ravel())[:count]


def plain_expm(A64, b, t: float) -> torch.Tensor:
    """``exp(t·A) b`` by scaling and squaring with a Taylor series, every
    product the plain SpMV: an independent reference for
    ``expm_multiply`` (``||t·A|| / EXPM_STEPS <= 0.5`` here)."""
    x = b.double()
    for _ in range(EXPM_STEPS):
        term, acc = x, x.clone()
        for j in range(1, EXPM_TERMS + 1):
            term = csr_spmv_plain(A64.rowptr, A64.colind, A64.values, term,
                                  A64.nrows) * (t / EXPM_STEPS / j)
            acc += term
        x = acc
    return x


def plain_lanczos(matvec, v0, m: int):
    """Reference Lanczos for the eigensolver gates: ``m`` steps from
    ``v0``, each product ``matvec`` (plain SpMVs), each new vector
    reorthogonalised against the whole basis by classical Gram-Schmidt
    twice. Returns the Ritz values (ascending) and unit Ritz vectors."""
    V = v0.new_zeros((m, v0.numel()))
    V[0] = v0 / torch.linalg.vector_norm(v0)
    T = v0.new_zeros((m, m))
    for i in range(m):
        w = matvec(V[i])
        T[i, i] = torch.dot(V[i], w)
        for _ in range(2):
            w = w - V[:i + 1].mT @ (V[:i + 1] @ w)
        if i + 1 < m:
            T[i, i + 1] = T[i + 1, i] = torch.linalg.vector_norm(w)
            V[i + 1] = w / T[i, i + 1]
    theta, y = torch.linalg.eigh(T)
    X = V.mT @ y
    return theta, X / torch.linalg.vector_norm(X, dim=0, keepdim=True)


def plain_spmm(A, X) -> torch.Tensor:
    return csr_spmm_plain(A.rowptr, A.colind, A.values, X.contiguous(),
                          A.nrows)


def lobpcg_run(what: str, A, k: int, iters: int, solver_launches):
    """``lobpcg(A, k=k, maxiter=iters)`` once, with its exact SpMM launches
    (``iters + 1`` at k, ``iters`` at 3k, by the recorder's flops) and
    its outputs held against the plain SpMM: orthonormal Ritz vectors,
    Ritz values their Rayleigh quotients, the reported residuals
    ``||A·x - θ·x||`` the plain ones. Returns ``(w, plain residuals,
    seconds, widths, largest gap of a reported residual)``."""
    rec = metrics.enable()
    rec.records.clear()
    try:
        (w, X, resid), sec, got = solver_run(
            lambda: lobpcg(A, k=k, maxiter=iters))
        widths = {}
        for r in rec.records:
            if r.op == "csr_spmm":
                kk = r.flops // (2 * A.nse)
                widths[kk] = widths.get(kk, 0) + 1
    finally:
        metrics.disable()
        rec.records.clear()
    want = {k: iters + 1, 3 * k: iters}
    if widths != want:
        raise AssertionError(f"{what}: SpMM launches by k {widths}, "
                             f"expected {want}")
    expect_counts(what, got, {"csr_spmm": {"float64": 2 * iters + 1}},
                  solver_launches)
    AX = plain_spmm(A, X)
    orth = float((X.mT @ X - torch.eye(k, dtype=X.dtype, device=X.device))
                 .abs().max())
    rq = float(((X * AX).sum(0) - w).abs().max() / w.abs().max())
    res = torch.linalg.vector_norm(AX - X * w[None, :], dim=0)
    gap = float((resid - res).abs().max())
    if not (orth <= 1e-10 and rq <= 1e-10 and gap <= RESID_ATOL):
        raise AssertionError(f"{what}: XᵀX - I {orth:.3e}, Ritz values "
                             f"against xᵀAx {rq:.3e}, reported residuals "
                             f"{gap:.3e} from the plain ones")
    return w, res, sec, widths, gap


def eigen_phase(device, card: str, solver_launches) -> None:
    """Phase 19: shift-invert block ``eigsh`` on the 512**2 Laplacian (LU),
    ``eigsh`` LA on phase 16's 128**3 Laplacian, ``lobpcg`` on the 512**2
    Laplacian and to convergence on a 32**2 one, ``svds`` on phase 18's
    gradient operator and ``expm_multiply`` on the 512**2 Laplacian, all
    float64. eigsh LA and svds are held against a plain Lanczos from the
    same start vector."""
    L = stencil_csr(EIG_K, 2, device)
    n = L.nrows
    b = card_vector(n, np.float64, 25, device)
    held = hold_spmv("eigsh sigma=0", L, b)
    # the SpMM operands of lobpcg, block Lanczos and svds, as they come
    basis = card_vector(24 * n, np.float64, 26, device).view(24, n)
    Q, _ = torch.linalg.qr(basis.mT)
    spmm_held = "; ".join(
        hold_spmm(f"{EIG_K}^2 Laplacian {label}", L, X) for label, X in (
            ("blk.T", basis[2:4].mT), ("Q", Q), ("X", Q[:, 8:16]),
            ("X (k = 8, copy)", Q[:, :8].contiguous())))
    del basis, Q
    ref = laplacian_modes(EIG_K, EIG_SI_K)
    (w, v), sec, got = solver_run(
        lambda: eigsh(L, k=EIG_SI_K, sigma=0.0, block=EIG_BLOCK))
    solves = 2 * EIG_SI_STEPS * EIG_BLOCK    # block Lanczos, then op @ V.T
    expect_counts("eigsh sigma=0", got, {"csr_spmv": {"float64": solves}},
                  solver_launches)
    err = float(np.abs(w.cpu().numpy() - ref).max() / ref.max())
    res = max(float(torch.linalg.vector_norm(csr_spmv_plain(
        L.rowptr, L.colind, L.values, v[:, j], n) - w[j] * v[:, j]))
        for j in range(EIG_SI_K))
    if not (err <= EIG_RTOL and res / 8.0 <= EIG_RESID):
        raise AssertionError(f"eigsh sigma=0: eigenvalues {err:.3e} from "
                             f"4 - 2cos(πi/{EIG_K + 1}) - 2cos(πj/"
                             f"{EIG_K + 1}), Ritz residual {res:.3e}")
    print(f"phase 19: eigsh(L, k={EIG_SI_K}, sigma=0, block={EIG_BLOCK}) "
          f"{EIG_K}^2 float64: {sec:.3f} s (the LU: supernodal; {solves} "
          f"lu_solve with refine=1, one B1 launch each); eigenvalues "
          f"{', '.join(f'{x:.12e}' for x in w.tolist())}, max {err:.3e} "
          f"relative from 4 - 2cos(πi/{EIG_K + 1}) - 2cos(πj/{EIG_K + 1});"
          f" ||L·v - λ·v|| (plain SpMV) <= {res:.3e}; {held}; {spmm_held} |"
          f" {card}")
    del w, v

    # eigsh LA on phase 16's 128**3 Laplacian: 64 Lanczos steps
    K = stencil_csr(KRYLOV_K, 3, device)
    v0 = card_vector(K.nrows, np.float64, 27, device)
    hold = hold_spmv("eigsh LA", K, v0)
    (w, v), sec, got = solver_run(lambda: eigsh(K, k=1, which="LA",
                                                m=LANCZOS_M, v0=v0))
    expect_counts("eigsh LA", got, {"csr_spmv": {"float64": LANCZOS_M}},
                  solver_launches)

    def k_plain(x):
        return csr_spmv_plain(K.rowptr, K.colind, K.values, x, K.nrows)

    lam_max = 6.0 + 6.0 * np.cos(np.pi / (KRYLOV_K + 1))
    res = float(torch.linalg.vector_norm(k_plain(v[:, 0]) - w[0] * v[:, 0]))
    theta, y = plain_lanczos(k_plain, v0, LANCZOS_M)
    t_ref, y_ref = float(theta[-1]), y[:, -1]
    res_ref = float(torch.linalg.vector_norm(k_plain(y_ref) - t_ref * y_ref))
    del y, y_ref
    d_val = abs(float(w[0]) - t_ref) / t_ref
    d_res = abs(res - res_ref) / max(res_ref, RESID_ATOL / RITZ_RESID_RTOL)
    if not (lam_max - 0.01 <= float(w[0]) <= lam_max + 1e-9
            and d_val <= RITZ_RTOL and d_res <= RITZ_RESID_RTOL):
        raise AssertionError(
            f"eigsh LA: Ritz value {float(w[0])!r} (λ_max {lam_max!r}), "
            f"{d_val:.3e} from plain Lanczos; residual {res:.3e}, "
            f"{d_res:.3e} from the reference's {res_ref:.3e}")
    print(f"phase 19: eigsh(k=1, which='LA', m={LANCZOS_M}) {KRYLOV_K}^3 "
          f"Laplacian float64: {sec:.3f} s, {sec * 1e3 / LANCZOS_M:.3f} ms a "
          f"step ({LANCZOS_M} B1 launches); Ritz value {float(w[0]):.10f} "
          f"against λ_max {lam_max:.10f} ({lam_max - float(w[0]):.3e} "
          f"below); Ritz residual ||A·v - θ·v|| (plain SpMV) {res:.3e}; "
          f"plain Lanczos from the same v0: Ritz value {d_val:.3e} and "
          f"residual {d_res:.3e} relative away; {hold} | {card}")
    del K, w, v, v0
    free_memory()

    # lobpcg: B2 at k and 3k, 40 steps on the 512**2 Laplacian (far from
    # converged with no preconditioner), then to convergence on a 32**2 one
    k = LOBPCG_K
    w, res, sec, widths, gap = lobpcg_run("lobpcg", L, k, LOBPCG_ITERS,
                                          solver_launches)
    ref = laplacian_modes(EIG_K, k)
    wl = w.cpu().numpy()
    if not np.all(wl >= ref - 1e-9):
        raise AssertionError(f"lobpcg: Ritz values {wl} below the "
                             f"eigenvalues {ref}")
    print(f"phase 19: lobpcg(k={k}, maxiter={LOBPCG_ITERS}) {EIG_K}^2 "
          f"Laplacian float64: {sec:.3f} s, {sec * 1e3 / LOBPCG_ITERS:.3f} ms"
          f" a step; B2 launches by k {widths}; Ritz values / exact "
          f"{', '.join(f'{a / e:.4f}' for a, e in zip(wl, ref))}; residuals "
          f"||A·x - θ·x|| (plain SpMM) "
          f"{', '.join(f'{x:.3e}' for x in res.tolist())}, the reported "
          f"ones within {gap:.3e} (<= {RESID_ATOL}) | {card}")
    S = stencil_csr(LOBPCG_CONV_K, 2, device)
    basis = card_vector(3 * k * S.nrows, np.float64, 28, device).view(
        3 * k, S.nrows)
    Q, _ = torch.linalg.qr(basis.mT)
    conv_held = "; ".join(
        hold_spmm(f"{LOBPCG_CONV_K}^2 Laplacian {label}", S, X)
        for label, X in (("Q", Q), ("X", Q[:, :k])))
    w, res, sec, widths, gap = lobpcg_run("lobpcg (converged)", S, k,
                                          LOBPCG_CONV_ITERS, solver_launches)
    ref = laplacian_modes(LOBPCG_CONV_K, k)
    err = float(np.abs(w.cpu().numpy() - ref).max() / ref.max())
    if not (err <= LOBPCG_RTOL and float(res.max()) <= LOBPCG_RESID):
        raise AssertionError(f"lobpcg {LOBPCG_CONV_K}^2: Ritz values "
                             f"{err:.3e} from the exact ones, residuals up "
                             f"to {float(res.max()):.3e}")
    print(f"phase 19: lobpcg(k={k}, maxiter={LOBPCG_CONV_ITERS}) "
          f"{LOBPCG_CONV_K}^2 Laplacian float64: {sec:.3f} s; B2 launches by"
          f" k {widths}; Ritz values max {err:.3e} relative from the exact "
          f"ones (<= {LOBPCG_RTOL}); residuals (plain SpMM) <= "
          f"{float(res.max()):.3e} (<= {LOBPCG_RESID}), the reported ones "
          f"within {gap:.3e}; {conv_held} | {card}")
    del w, res, S, basis, Q

    # svds on the gradient operator of the 512**2 grid
    G = gradient_csr(LSQ_K, device)
    at = G.transpose()
    held_g = (hold_spmv("svds A", G, card_vector(G.ncols, np.float64, 29,
                                                  device)) + "; "
              + hold_spmv("svds Aᵀ", at, card_vector(G.nrows, np.float64,
                                                     30, device)))
    (u, s, vt), sec, got = solver_run(lambda: svds(G, k=SVDS_K))
    expect_counts("svds", got, {"csr_spmv": {"float64": 2 * SVDS_M},
                                "csr_spmm": {"float64": 1}}, solver_launches)
    v = vt.mT                                 # the recovery SpMM's operand
    held_g += "; " + hold_spmm("svds A·v", G, v)
    u_plain = plain_spmm(G, v)
    within((u - u_plain / s[None, :]).abs(),
           csr_spmm_plain(G.rowptr, G.colind, G.values.abs(),
                          v.abs().contiguous(), G.nrows) / s[None, :],
           TOL["float64"], "svds u = A·v / s")

    def at_plain(x):
        return csr_spmv_plain(at.rowptr, at.colind, at.values, x, G.ncols)

    def gram_plain(x):
        return at_plain(csr_spmv_plain(G.rowptr, G.colind, G.values, x,
                                       G.nrows))

    # svds's start vector: eigsh's draw, seed 0, on the operand's device
    v0 = torch.randn((G.ncols,), dtype=torch.float64, device=G.values.device,
                     generator=torch.Generator(
                         device=G.values.device).manual_seed(0))
    theta, y = plain_lanczos(gram_plain, v0, SVDS_M)
    s_ref = torch.sqrt(theta[-SVDS_K:].flip(0))
    y_ref = y[:, -SVDS_K:].flip(1)
    del y
    res = torch.stack([torch.linalg.vector_norm(at_plain(u[:, j].contiguous())
                                                - s[j] * v[:, j])
                       for j in range(SVDS_K)])
    res_ref = torch.stack([torch.linalg.vector_norm(
        gram_plain(y_ref[:, j].contiguous()) / s_ref[j] - s_ref[j]
        * y_ref[:, j]) for j in range(SVDS_K)])
    d_val = float(((s - s_ref).abs() / s_ref).max())
    d_res = float(((res - res_ref).abs()
                   / res_ref.clamp_min(RESID_ATOL / RITZ_RESID_RTOL)).max())
    mu = 2.0 - 2.0 * np.cos(np.pi * np.arange(LSQ_K) / LSQ_K)
    sig = np.sqrt(np.sort((mu[:, None] + mu[None, :]).ravel())[::-1][:SVDS_K]
                  + GRAD_REG ** 2)
    sl = s.cpu().numpy()
    # Ritz values interlace: the j-th largest is at most the exact one
    if not (np.all(np.diff(sl) <= 0) and np.all(sl <= sig * (1 + 1e-12))
            and d_val <= RITZ_RTOL and d_res <= RITZ_RESID_RTOL):
        raise AssertionError(f"svds: singular values {sl} against {sig}, "
                             f"{d_val:.3e} from plain Lanczos; residuals "
                             f"{d_res:.3e} from the reference's")
    print(f"phase 19: svds(A, k={SVDS_K}) gradient operator {LSQ_K}^2 "
          f"float64: {sec:.3f} s ({2 * SVDS_M} B1 launches: {SVDS_M} Lanczos "
          f"steps on AᵀA, matrix-free; one B2 launch at k={SVDS_K}); "
          f"s / exact {', '.join(f'{a / e:.6f}' for a, e in zip(sl, sig))};"
          f" ||Aᵀu - s·v|| (plain SpMV) "
          f"{', '.join(f'{x:.3e}' for x in res.tolist())}; plain Lanczos on "
          f"AᵀA from the same start: s {d_val:.3e} and residuals {d_res:.3e}"
          f" relative away; u == A·v / s (plain SpMM) within "
          f"{TOL['float64']}·|A||v| / s; {held_g} | {card}")
    del G, u, s, vt, v, at, u_plain, y_ref, v0

    # expm_multiply: 32 Arnoldi steps on -L
    N = -L
    held = hold_spmv("expm_multiply -L", N, b)
    x, sec, got = solver_run(lambda: expm_multiply(N, b, m=EXPM_M))
    expect_counts("expm_multiply", got, {"csr_spmv": {"float64": EXPM_M}},
                  solver_launches)
    want = plain_expm(N, b, 1.0)
    rel = float(torch.linalg.vector_norm(x - want)
                / torch.linalg.vector_norm(want))
    if not rel <= EXPM_RTOL:
        raise AssertionError(f"expm_multiply: {rel:.3e} from the plain "
                             "Taylor reference")
    print(f"phase 19: expm_multiply(-L, b, m={EXPM_M}) {EIG_K}^2 float64: "
          f"{sec * 1e3:.3f} ms ({EXPM_M} B1 launches); {rel:.3e} relative "
          f"from scaling and squaring ({EXPM_STEPS} x {EXPM_TERMS} Taylor "
          f"terms, plain SpMV); {held} | {card}")
    del L, N, b, x, want
    free_memory()


def laplacian5(k: int, device):
    """BASELINE config[4]: the 5-point Laplacian of a k x k grid in
    float64, its rowptr, colind and values by formula (vectorised NumPy;
    no COO -> CSR), through the validating constructor."""
    n = k * k
    i = np.arange(n, dtype=np.int64)
    r, c = i // k, i % k
    ok = np.stack([r > 0, c > 0, np.ones(n, dtype=bool), c < k - 1,
                   r < k - 1], axis=1)
    ptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(ok.sum(axis=1), out=ptr[1:])
    cols = (i[:, None] + np.array([-k, -1, 0, 1, k]))[ok]
    vals = np.broadcast_to(np.array([-1.0, -1.0, 4.0, -1.0, -1.0]),
                           ok.shape)[ok]
    return CsrMatrix(n, n, ptr, cols, vals, device=device)


def plain_spmm_within(A, X, Y, tol: float, what: str) -> float:
    """``Y`` against the plain SpMM of ``A`` on ``X``, entry by entry
    within ``tol·(|A||X|)``, eight columns at a time (the plain version
    gathers a row of X for every entry: 25.6 GB at once for config[4]'s
    f64 operand at k = 64). Returns the max |err|."""
    ptr, ind, vals = A.rowptr, A.colind, A.values
    worst = 0.0
    for j in range(0, X.shape[1], 8):
        Xj = X[:, j:j + 8].contiguous()
        err = (Y[:, j:j + 8] - csr_spmm_plain(ptr, ind, vals, Xj,
                                              A.nrows)).abs()
        within(err, csr_spmm_plain(ptr, ind, vals.abs(), Xj.abs(), A.nrows),
               tol, what)
        worst = max(worst, float(err.max()))
        del Xj, err
    return worst


def counted_run(what: str, fn, want, counts):
    """Run ``fn`` once between a reset and a read of the launch counts;
    fail unless they are exactly ``want``; add them to ``counts`` (the
    kernel line's ``dist_launches`` or ``io_launches``). Returns
    ``(result, seconds)``."""
    out, sec, got = solver_run(fn)
    expect_counts(what, got, want, counts)
    return out, sec


def dist_config4(mesh, device, card: str, dist_launches) -> None:
    """config[4] at one rank: partition_csr (host seconds), dist_spmv in
    both comm modes and dist_spmm at k = DIST_KMM, each against the
    single-card product, and their times beside it. Each result is held
    against the plain version on the whole matrix (``csr_spmv_plain``,
    ``csr_spmm_plain``), not against ``A @ x``, which runs the same
    kernel."""
    t0 = time.perf_counter()
    A64 = laplacian5(DIST_K, device)
    torch.cuda.synchronize()
    n = A64.nrows
    print(f"phase 20: config[4] 5-point Laplacian {DIST_K}^2: n={n} "
          f"nnz={A64.nnz}, built (NumPy by formula + CsrMatrix) in "
          f"{time.perf_counter() - t0:.2f} s")
    gen = torch.Generator(device=device).manual_seed(20)
    for name in ("float64", "float32"):
        np_dtype, dtype = DTYPES[name]
        A = A64 if name == "float64" else A64.astype(dtype)
        tol = TOL[name]
        dists, part_s = {}, {}
        for comm in ("halo", "allgather"):
            t0 = time.perf_counter()
            dists[comm] = partition_csr(A, mesh, comm=comm)
            torch.cuda.synchronize()
            part_s[comm] = time.perf_counter() - t0
        x = card_vector(n, np_dtype, 20, device)
        y1 = A @ x
        y_p = csr_spmv_plain(A.rowptr, A.colind, A.values, x, n)
        scale = csr_spmv_plain(A.rowptr, A.colind, A.values.abs(), x.abs(),
                               n)
        single_ms = None
        for comm, d in dists.items():
            xl = shard_vector(x, d)
            y, sec = counted_run(f"dist_spmv {comm} {name}",
                                 lambda: dist_spmv(d, xl),
                                 {"csr_spmv": {name: 1}}, dist_launches)
            y = unshard_vector(y, d)
            err = (y - y_p).abs()
            within(err, scale, tol, f"config[4] dist_spmv {comm} {name} "
                   "against the plain SpMV")
            dist_ms, single_ms, _ = turns(lambda: dist_spmv(d, xl),
                                          lambda: A @ x, TIMED_LAUNCHES,
                                          TIMED_LAUNCHES, spin=True)
            gather_ms = time_ms(lambda: gather_rows(xl, mesh),
                                TIMED_LAUNCHES, spin=True)
            print(f"phase 20: config[4] {name} dist_spmv comm={comm} "
                  f"(halo width {d.halo_width}): partition_csr "
                  f"{part_s[comm]:.3f} s on the host; 1 B1 launch; max |err| "
                  f"against the plain SpMV {float(err.max()):.3e} within "
                  f"{tol}·|A||x|, bitwise equal to csr @ x: "
                  f"{torch.equal(y, y1)}; "
                  f"dist_spmv {dist_ms:.4f} ms against csr @ x "
                  f"{single_ms:.4f} ms (tier overhead "
                  f"{dist_ms - single_ms:+.4f} ms; an all-gather of x "
                  f"alone {gather_ms:.4f} ms) | {card}")
            del y, err, xl
        del x, y1, y_p, scale
        free_memory()

        X = torch.randn((n, DIST_KMM), generator=gen, dtype=dtype,
                        device=device)
        Xl = shard_matrix_rows(X, dists["halo"])
        del X
        if Xl.shape[0] != n:
            raise AssertionError("one rank: the local rows are all rows")
        Y1 = A @ Xl
        for comm, d in dists.items():
            Y, sec = counted_run(f"dist_spmm {comm} {name}",
                                 lambda: dist_spmm(d, Xl),
                                 {"csr_spmm": {name: 1}}, dist_launches)
            # one rank: its rows are the global rows (unshard_vector would
            # copy 5 GB to say so)
            worst = plain_spmm_within(
                A, Xl, Y, tol, f"config[4] dist_spmm {comm} {name} against "
                "the plain SpMM")
            same = torch.equal(Y, Y1)
            del Y
            dist_ms, single_ms, _ = turns(lambda: dist_spmm(d, Xl),
                                          lambda: A @ Xl, TIMED_LAUNCHES // 4,
                                          TIMED_LAUNCHES // 4, spin=True)
            print(f"phase 20: config[4] {name} dist_spmm k={DIST_KMM} "
                  f"comm={comm}: 1 B2 launch; max |err| against the plain "
                  f"SpMM {worst:.3e} within {tol}·|A||X|, bitwise equal to "
                  f"csr @ X: {same}; dist_spmm "
                  f"{dist_ms:.4f} ms against csr @ X {single_ms:.4f} ms "
                  f"(tier overhead {dist_ms - single_ms:+.4f} ms) | {card}")
        del Xl, Y1, dists, A
        free_memory()
    del A64
    free_memory()


def dist_cg(mesh, device, card: str, dist_launches) -> None:
    """CG with Jacobi on a DistCsr of phase 16's 128**3 Laplacian against
    ``cg`` on the CsrMatrix: the same iteration count, one B1 launch a
    step, one for the first residual and one for each of the ``AHEAD``
    steps the loop runs ahead of its test and drops at convergence, one
    diagonal launch for the Jacobi set-up, three CG-step launches for each
    step enqueued and one for the first residual's dots."""
    from spalinalg_tpu_torch.linalg.cg import AHEAD

    A = stencil_csr(KRYLOV_K, 3, device)
    n = A.nrows
    d = partition_csr(A, mesh)
    b = card_vector(n, np.float64, 16, device)
    tol = CG_RTOL["float64"] * float(torch.linalg.vector_norm(b))
    bl = shard_vector(b, d)
    cg(A, b, maxiter=2, precondition="jacobi")          # warm-up
    cg(d, bl, maxiter=2, precondition="jacobi")
    ref, ref_s, _ = solver_run(
        lambda: cg(A, b, tol=tol, precondition="jacobi"))
    res, sec = counted_run("DistCsr CG", lambda: cg(d, bl, tol=tol,
                                                    precondition="jacobi"),
                           {"csr_spmv": {"float64": ref.iterations + 1
                                         + AHEAD},
                            "diagonal": {"float64": 1},
                            "cg_step": {"float64": step_launches(
                                ref.iterations + AHEAD)}}, dist_launches)
    if res.iterations != ref.iterations:
        raise AssertionError(f"DistCsr CG: {res.iterations} iterations, "
                             f"cg on the CsrMatrix {ref.iterations}")
    resid = check_residual("DistCsr CG", A, unshard_vector(res.x, d), b, tol)
    dot_ms = time_ms(lambda: dist_dot(bl, bl, d), TIMED_LAUNCHES)
    print(f"phase 20: DistCsr CG+Jacobi {KRYLOV_K}^3 float64 (comm "
          f"{d.comm}): {res.iterations} iterations = cg(csr)'s, "
          f"{res.iterations + 1 + AHEAD} B1 launches; "
          f"{sec * 1e3 / res.iterations:.4f}"
          f" ms/iteration against {ref_s * 1e3 / ref.iterations:.4f}; "
          f"dist_dot (an all_reduce) {dot_ms:.4f} ms; ||b - A·x|| (plain "
          f"SpMV) = {resid / tol:.4f} x tol | {card}")
    del A, d, b, bl, ref, res
    free_memory()


def banded8_matrices(device):
    """config[1]'s banded matrix (offsets -16..16, n = 2**19) through
    ``to_bsr(8)``, in both dtypes."""
    structures, rng = spmm_structures()
    rowptr, colind = structures["banded"]
    vals = rng.normal(size=colind.size)
    return {name: CsrMatrix(N_MM, N_MM, rowptr, colind,
                            vals.astype(np_dtype), device=device
                            ).to_bsr(BAND_BS)
            for name, (np_dtype, _) in DTYPES.items()}


def dist_bsr(mesh, device, card: str, dist_launches) -> None:
    """dist_bsr_spmv on tri128 and banded8 in both dtypes against the
    plain BSR SpMV (``bsr_spmv_plain``), timed beside ``bsr @ x``."""
    gen = torch.Generator(device=device).manual_seed(21)
    tri = tri128_matrices(device, gen)
    shapes = {"tri128": {name: tri[name] for name in DTYPES},
              "banded8": banded8_matrices(device)}
    del tri
    for shape, by_dtype in shapes.items():
        for name, bsr in by_dtype.items():
            acc = torch.float64 if name == "float64" else torch.float32
            t0 = time.perf_counter()
            d = partition_bsr(bsr, mesh)
            torch.cuda.synchronize()
            part_s = time.perf_counter() - t0
            x = torch.randn(bsr.ncols, generator=gen, dtype=acc,
                            device=device)
            xl = shard_bsr_vector(x, d)
            y1 = bsr @ x
            y, sec = counted_run(f"dist_bsr_spmv {shape} {name}",
                                 lambda: dist_bsr_spmv(d, xl),
                                 {"bsr_spmv": {name: 1}}, dist_launches)
            y = unshard_vector(y, d)
            ip, ix, data = bsr.indptr, bsr.indices, bsr.data
            err = (y - bsr_spmv_plain(ip, ix, data, x)).abs()
            within(err, bsr_spmv_plain(ip, ix, data.abs(), x.abs()),
                   TOL[name], f"dist_bsr_spmv {shape} {name} against the "
                   "plain BSR SpMV")
            dist_ms, single_ms, _ = turns(lambda: dist_bsr_spmv(d, xl),
                                          lambda: bsr @ x, TIMED_LAUNCHES,
                                          TIMED_LAUNCHES, spin=True)
            print(f"phase 20: dist_bsr_spmv {shape} {name} "
                  f"(blocks {bsr.blocksize}, {d.nblk_per_shard} a shard): "
                  f"partition_bsr {part_s:.3f} s; 1 B4/B6 launch; max |err| "
                  f"against the plain BSR SpMV {float(err.max()):.3e} "
                  f"within {TOL[name]}·|A||x|, bitwise equal to bsr @ x: "
                  f"{torch.equal(y, y1)}"
                  f"; {dist_ms:.4f} ms against bsr @ x {single_ms:.4f} ms "
                  f"| {card}")
            del d, x, xl, y, y1, err
        free_memory()
    del shapes
    free_memory()


def dist_spgemm(mesh, device, card: str, dist_launches) -> None:
    """DistCsr * DistCsr on phase 7's power-law generator at n =
    DIST_GEMM_N, gathered, against the plain numeric phase on the
    single-card plan of ``a * a`` (``hold_spgemm``): the same structure,
    values within tol, one B3 launch."""
    for name, a in power_law(device, DIST_GEMM_N).items():
        da = partition_csr(a, mesh)
        c, sec = counted_run(f"DistCsr * DistCsr {name}", lambda: da * da,
                             {"spgemm": {name: 1}}, dist_launches)
        whole = c.to_csr()
        held = hold_spgemm(f"DistCsr * DistCsr {name}", a, a, whole)
        print(f"phase 20: DistCsr * DistCsr power-law n={DIST_GEMM_N} "
              f"nnz={a.nnz} {name} (comm {da.comm}): nnz(C)={whole.nnz}, "
              f"structure equal to the plan of a * a, {held}; 1 B3 launch; "
              f"{sec:.3f} s with the host symbolic phase | {card}")
        del da, c, whole
    free_memory()


def dist_supernodal(mesh, device, card: str) -> None:
    """supernodal_factor_sharded on config[3]'s 512**2 Laplacian: its
    solve's residual equals supernodal_factor's within 1e-10."""
    L = stencil_csr(CHOL_K, 2, device)
    fac = cholesky(L, method="supernodal")
    plan = fac.snf.plan
    pm = permute_csr(L, fac.perm) if fac.perm is not None else L
    b = card_vector(L.nrows, np.float64, 22, device)
    out = {}
    for what, factor in (("supernodal_factor", lambda: supernodal_factor(
            plan, pm.values)), ("supernodal_factor_sharded",
                                lambda: supernodal_factor_sharded(
                                    plan, pm.values, mesh))):
        factor()                                       # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        f = factor()
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        x = supernodal_solve(f, b, perm=fac.perm)
        out[what] = (relative_residual(L, x, b), sec, f.ok)
    (r1, s1, _), (r2, s2, ok) = out.values()
    if not (ok and r2 <= CHOL_RTOL["float64"] and abs(r2 - r1) <= 1e-10):
        raise AssertionError(f"supernodal_factor_sharded: residual {r2:.3e} "
                             f"(ok {ok}) against {r1:.3e}")
    print(f"phase 20: supernodal_factor_sharded config[3] {CHOL_K}^2 "
          f"float64, {mesh.size()} rank(s): ||A·x - b|| / ||b|| {r2:.3e} "
          f"against supernodal_factor's {r1:.3e}; factor {s2 * 1e3:.2f} ms "
          f"against {s1 * 1e3:.2f} ms | {card}")
    del L, fac, pm, b, out
    free_memory()


def dist_phase(device, card: str, dist_launches, tmpdir: str,
               io_launches) -> None:
    """Phase 20: the distributed tier on a one-rank NCCL group; phase 21's
    DistCsr checkpoint on the same group."""
    import torch.distributed as tdist

    mesh = make_row_mesh(device=device)
    try:
        backend = tdist.get_backend()
        if device.type == "cuda" and backend != "nccl":
            raise AssertionError(f"the process group's backend is "
                                 f"{backend}, not nccl")
        beat = multihost.heartbeat()
        print(f"phase 20: make_row_mesh(): {backend} group of "
              f"{tdist.get_world_size()} rank(s), mesh "
              f"{mesh.mesh_dim_names} on {mesh_device(mesh)}; "
              f"{multihost.global_device_summary()}; heartbeat "
              f"{beat * 1e3:.3f} ms | {card}")
        dist_config4(mesh, device, card, dist_launches)
        dist_cg(mesh, device, card, dist_launches)
        dist_bsr(mesh, device, card, dist_launches)
        dist_spgemm(mesh, device, card, dist_launches)
        dist_supernodal(mesh, device, card)
        print(f"phase 20: heartbeat {multihost.heartbeat() * 1e3:.3f} ms | "
              f"{card}")
        with phase("phase 21 DistCsr checkpoint"):
            dist_checkpoint(mesh, device, card, tmpdir, io_launches)
    finally:
        tdist.destroy_process_group()


# ---- phase 21: IO and utils -------------------------------------------


def timed(fn):
    """``(fn(), seconds to the card's completion)``."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


@contextlib.contextmanager
def plan_cache_at(path: str):
    """``SPALINALG_PLAN_CACHE`` at ``path`` for a block."""
    saved = os.environ["SPALINALG_PLAN_CACHE"]
    os.environ["SPALINALG_PLAN_CACHE"] = path
    try:
        yield
    finally:
        os.environ["SPALINALG_PLAN_CACHE"] = saved


@contextlib.contextmanager
def deterministic():
    """torch's deterministic kernels (``index_add_`` without atomics) for
    a block; where an op has none, it warns, silenced here."""
    prev = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            yield
    finally:
        torch.use_deterministic_algorithms(prev[0], warn_only=prev[1])


def hold_product(what: str, mat, x, y) -> float:
    """``y`` (a product of ``mat``'s kernel) against the plain version of
    that kernel on ``mat``'s arrays, entry by entry within ``TOL·|A||x|``;
    returns the max |err|. CSC runs the CSR kernel on its CSR form."""
    if isinstance(mat, BsrMatrix):
        def plain(vals, v):
            return bsr_spmv_plain(mat.indptr, mat.indices, vals, v)
        vals = mat.data
    elif isinstance(mat, DiaMatrix):
        def plain(vals, v):
            return dia_spmv_plain(mat.offsets, vals, v, mat.nrows, mat.ncols)
        vals = mat.data
    else:
        csr = mat.to_csr() if isinstance(mat, CscMatrix) else mat

        def plain(vals, v):
            return csr_spmv_plain(csr.rowptr, csr.colind, vals, v, csr.nrows)
        vals = csr.values
    err = (y - plain(vals, x)).abs()
    within(err, plain(vals.abs(), x.abs()),
           TOL[str(x.dtype).removeprefix("torch.")], what)
    return float(err.max())


def matrix_market_phase(device, card: str, tmpdir: str, io_launches) -> None:
    """config[3]'s 512**2 Laplacian written as .mtx and .mtx.gz and read
    back, then CSR on the card -> csr @ x (B1c, held against the plain
    SpMV) -> cholesky -> solve."""
    L = stencil_csr(CHOL_K, 2, device)
    want = L.to_coo().to_arrays()
    for name in ("config3.mtx", "config3.mtx.gz"):
        path = os.path.join(tmpdir, name)
        _, write_s = timed(lambda: write_matrix_market(path, L))
        back, read_s = timed(lambda: read_matrix_market(path))
        if not all(np.array_equal(g, w) for g, w in zip(back.to_arrays(),
                                                        want)):
            raise AssertionError(f"{name}: the triplets read back differ "
                                 "from the matrix written")
        print(f"phase 21: Matrix Market {name} config[3] {CHOL_K}^2 "
              f"({back.nnz} entries, {os.path.getsize(path)} bytes): write "
              f"{write_s:.3f} s, read {read_s:.3f} s, triplets equal | {card}")
    A = CsrMatrix.from_coo(back, device=device)
    if not (torch.equal(A.rowptr, L.rowptr) and torch.equal(A.colind, L.colind)
            and torch.equal(A.values, L.values)):
        raise AssertionError("the .mtx round trip changed the CSR arrays")
    x = card_vector(A.nrows, np.float64, 23, device)
    y, _ = counted_run("Matrix Market csr @ x", lambda: A @ x,
                       {"csr_spmv": {"float64": 1}}, io_launches)
    err = hold_product("Matrix Market csr @ x", A, x, y)
    b = card_vector(A.nrows, np.float64, 24, device)

    def factor_and_solve():
        fac = cholesky(A)
        return fac, cholesky_solve(fac, b)

    (fac, xs), sec, got = solver_run(factor_and_solve)
    expect_counts("Matrix Market cholesky + solve", got, {}, io_launches)
    rel = true_residual(A, xs, b) / float(torch.linalg.vector_norm(b))
    if not rel <= CHOL_RTOL["float64"]:
        raise AssertionError(f"Matrix Market cholesky: ||A·x - b|| / ||b|| "
                             f"{rel:.3e}")
    print(f"phase 21: .mtx.gz -> CsrMatrix.from_coo (arrays equal to the "
          f"original's) -> csr @ x: 1 B1c launch == plain within "
          f"{TOL['float64']}·|A||x| (max |err| {err:.3e}); cholesky "
          f"({fac.path}) + solve {sec:.3f} s, no kernel launch, ||A·x - b|| "
          f"/ ||b|| = {rel:.3e} | {card}")
    del L, A, back, fac, x, y, b, xs
    free_memory()


def compress_phase(device, card: str) -> CsrMatrix:
    """The float64 triplets of csr_random (n = 2**21, 67,108,864 entries)
    through ``compress_host``: the native sort and merge, then the NumPy
    path on the same triplets, once each; equal arrays. Returns the CSR
    on the card."""
    rows, cols, vals = csr_random_triplets(np.float64, np.random.default_rng(1))
    native_calls = []
    native_compress = native_lib.compress

    def counting(*args, **kwargs):
        native_calls.append(1)
        return native_compress(*args, **kwargs)

    native_lib.compress = counting
    try:
        nat, nat_s = timed(lambda: engine.compress_host(
            rows, cols, vals, N_BIG, dedup=True, drop_zeros=True))
    finally:
        native_lib.compress = native_compress
    gate = engine.NATIVE_ABOVE
    engine.NATIVE_ABOVE = np.iinfo(np.int64).max
    try:
        npy, npy_s = timed(lambda: engine.compress_host(
            rows, cols, vals, N_BIG, dedup=True, drop_zeros=True))
    finally:
        engine.NATIVE_ABOVE = gate
    if native_calls != [1]:
        raise AssertionError(f"compress_host made {len(native_calls)} native "
                             "calls, expected 1")
    if not (all(np.array_equal(a, b) for a, b in zip(nat, npy))
            and np.array_equal(np.signbit(nat[2]), np.signbit(npy[2]))):
        raise AssertionError("native and NumPy compress differ")
    print(f"phase 21: compress_host float64 csr_random n={N_BIG} "
          f"{rows.size} triplets: native {nat_s:.2f} s, NumPy {npy_s:.2f} s "
          f"(x{npy_s / nat_s:.1f}), arrays equal (sign bits too); before "
          f"the native path (PERF.md §5), COO build + from_coo all in "
          f"NumPy: 53.95 s float32, 61.69 s float64 | {card}")
    del rows, cols, vals, npy
    big = CsrMatrix._from_host(N_BIG, N_BIG, *nat, device)
    torch.cuda.synchronize()
    return big


def checkpoint_phase(device, card: str, tmpdir: str, io_launches) -> None:
    """config[3]'s matrix saved and loaded as COO, DOK, CSR, CSC, BSR(8)
    and DIA in both dtypes: the loaded matrix's product (one launch of
    B1c / B1a, B6 / B4, B8 / B7) bitwise the original's, and held against
    its plain version."""
    L = stencil_csr(CHOL_K, 2, device)
    kernel = {"bsr": "bsr_spmv", "dia": "dia_spmv"}
    ids = {("csr_spmv", "float64"): "B1c", ("csr_spmv", "float32"): "B1a",
           ("bsr_spmv", "float64"): "B6", ("bsr_spmv", "float32"): "B4",
           ("dia_spmv", "float64"): "B8", ("dia_spmv", "float32"): "B7"}
    for name in ("float64", "float32"):
        np_dtype, dtype = DTYPES[name]
        A = L if name == "float64" else L.astype(dtype)
        x = card_vector(A.nrows, np_dtype, 25, device)
        mats = {"coo": A.to_coo(), "dok": A.to_dok(), "csr": A,
                "csc": A.to_csc(), "bsr": A.to_bsr(BAND_BS),
                "dia": DiaMatrix.from_csr(A)}
        for fmt, mat in mats.items():
            path = os.path.join(tmpdir, f"{fmt}_{name}.npz")
            _, save_s = timed(lambda: save_npz(path, mat))
            back, load_s = timed(lambda: load_npz(path, device=device))
            if fmt in ("coo", "dok"):             # host formats: via CSR
                build = (CsrMatrix.from_coo if fmt == "coo"
                         else CsrMatrix.from_dok)
                orig_op, back_op = (build(mat, device=device),
                                    build(back, device=device))
            else:
                orig_op, back_op = mat, back
            kname = kernel.get(fmt, "csr_spmv")
            y, _ = counted_run(f"checkpoint {fmt} {name}", lambda: back_op @ x,
                               {kname: {name: 1}}, io_launches)
            if not torch.equal(y, orig_op @ x):
                raise AssertionError(f"checkpoint {fmt} {name}: the loaded "
                                     "matrix's product differs from the "
                                     "original's")
            err = hold_product(f"checkpoint {fmt} {name}", back_op, x, y)
            print(f"phase 21: checkpoint {fmt} {name}: save {save_s:.3f} s, "
                  f"{os.path.getsize(path)} bytes, load {load_s:.3f} s; product "
                  f"({ids[kname, name]}, 1 launch) bitwise the original's, == plain (max |err| "
                  f"{err:.3e}) | {card}")
        del mats, A, x
    del L
    free_memory()


def plan_cache_phase(device, card: str, tmpdir: str) -> None:
    """Under a fresh plan cache: cholesky of config[3] builds the plan and
    writes it; after ``_SYMBOLIC.clear()`` cholesky loads it from disk.
    Host times, the file's size, bitwise equal factors and solves."""
    plan_dir = os.path.join(tmpdir, "plans_cold")
    with plan_cache_at(plan_dir):
        L = stencil_csr(CHOL_K, 2, device)
        b = card_vector(L.nrows, np.float64, 26, device)
        runs = []
        for _ in range(2):
            chol_mod._SYMBOLIC.clear()
            rec = metrics.enable()
            rec.records.clear()
            try:
                fac, sec = timed(lambda: cholesky(L))
                host = [(r.path, r.seconds) for r in rec.records
                        if r.op.startswith("chol_")]
            finally:
                metrics.disable()
                rec.records.clear()
            runs.append((fac, sec, host, cholesky_solve(fac, b)))
        (fac1, cold_s, host1, x1), (fac2, warm_s, host2, x2) = runs
        if [p for p, _ in host1] != ["chol_ordering:host", "chol_symbolic:host",
                                     "chol_plan:host"]:
            raise AssertionError(f"first cholesky: host phases {host1}")
        if [p for p, _ in host2] != ["chol_plan:disk"]:
            raise AssertionError(f"second cholesky: host phases {host2}, "
                                 "expected one chol_plan:disk")
        if not np.array_equal(fac1.perm, fac2.perm):
            raise AssertionError("the disk plan's ordering differs")
        # The factor's extend-add sums through index_add_ atomics, so two
        # factors on the card differ in the last bits (phase 17); the two
        # plans are held against each other with deterministic kernels.
        gap = max(float((fac2.snf.panels[k] - p).abs().max()
                        / p.abs().max().clamp_min(1e-300))
                  for k, p in fac1.snf.panels.items())
        values = permute_csr(L, fac1.perm).values
        with deterministic():
            f1, f2 = (supernodal_factor(f.snf.plan, values)
                      for f in (fac1, fac2))
            y1, y2 = (supernodal_solve(f, b, perm=fac1.perm)
                      for f in (f1, f2))
        same = (f1.panels.keys() == f2.panels.keys() and all(
            torch.equal(f2.panels[k], p) for k, p in f1.panels.items())
            and torch.equal(y1, y2))
        if not same:
            raise AssertionError("the disk plan's factor or solve differs")
        rel = true_residual(L, x2, b) / float(torch.linalg.vector_norm(b))
        if not rel <= CHOL_RTOL["float64"]:
            raise AssertionError(f"disk plan: ||A·x - b|| / ||b|| {rel:.3e}")
        times = sorted(refactor_s(L) for _ in range(REFACTORS))
        refactor = times[len(times) // 2]
        files = os.listdir(os.path.join(plan_dir, "torch"))
        size = sum(os.path.getsize(os.path.join(plan_dir, "torch", f))
                   for f in files)
        print(f"phase 21: plan cache config[3] {CHOL_K}^2 float64: cold "
              f"host plan {sum(t for _, t in host1):.3f} s (ordering, "
              f"symbolic, plan: {', '.join(f'{t:.3f}' for _, t in host1)}), "
              f"cholesky {cold_s:.3f} s; after _SYMBOLIC.clear() the plan "
              f"from disk {host2[0][1]:.3f} s, cholesky {warm_s:.3f} s; "
              f"re-factor (plan in memory) {refactor:.3f} s; {len(files)} "
              f"file, {size} bytes; the same ordering; with deterministic "
              f"kernels both plans' factors and solves bitwise equal "
              f"(without: {gap:.3e} relative, index_add_ atomics); "
              f"||A·x - b|| / ||b|| = {rel:.3e} | {card}")
        del L, b, runs, fac1, fac2, x1, x2, f1, f2, y1, y2, values
    free_memory()


def utils_phase(big, card: str, tmpdir: str, io_launches) -> None:
    """On the 2**21 CSR: checked_structure; checked_call refusing a copy
    with one out-of-range colind before any launch; determinism_audit of
    B1c; trace_to around three annotated SpMVs; a to_sparse_csr /
    from_sparse_coo round trip; heartbeat() with no process group."""
    import torch.distributed as tdist

    x = card_vector(N_BIG, np.float64, 27, big.device)
    check = checked_structure(big)
    check()                                                  # warm-up
    err, check_s = timed(check)
    if err.get() is not None:
        raise AssertionError(f"checked_structure: {err.get()}")
    colind = big.colind.clone()
    colind[12345] = N_BIG
    bad = CsrMatrix._from_parts(N_BIG, N_BIG, big.rowptr, colind, big.values)
    (bad_err, out), _, got = solver_run(
        lambda: checked_call(lambda a, v: a @ v, bad, x))
    expect_counts("checked_call on a bad colind", got, {}, io_launches)
    if out is not None or bad_err.get() != "minor index out of range":
        raise AssertionError(f"checked_call: {bad_err.get()!r}, out {out}")
    try:
        bad_err.throw()
        raise AssertionError("the check's throw() did not raise")
    except StructureError:
        pass
    del bad, colind
    same, _ = counted_run("determinism_audit", lambda: determinism_audit(
        lambda v: big @ v, x), {"csr_spmv": {"float64": 3}}, io_launches)
    if not same:
        raise AssertionError("determinism_audit of B1c: results differ")
    logdir = os.path.join(tmpdir, "trace")
    pad = torch.zeros(1, device=big.device)

    def traced():
        with trace_to(logdir):
            # Later in a process, a torch.profiler session loses its first
            # kernel records (PERF.md §7): tiny kernels go first.
            for _ in range(TRACE_PAD):
                pad.add_(1)
            with annotate("spalinalg_io_phase"):
                for _ in range(3):
                    big @ x
            torch.cuda.synchronize()

    counted_run("trace_to", traced, {"csr_spmv": {"float64": 3}}, io_launches)
    (trace,) = os.listdir(logdir)
    with open(os.path.join(logdir, trace)) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    records = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    kernels = sorted({n for n in records if "csr_spmv" in n})
    if "spalinalg_io_phase" not in names or not kernels:
        raise AssertionError(f"trace {trace} lacks the region or the "
                             f"csr_spmv kernel ({kernels})")
    (rt, rt_s), _, got = solver_run(lambda: timed(lambda: from_sparse_coo(
        to_sparse_csr(big).to_sparse_coo())))
    expect_counts("to_sparse_csr / from_sparse_coo", got, {}, io_launches)
    if not (rt.device == big.device and torch.equal(rt.rowptr, big.rowptr)
            and torch.equal(rt.colind, big.colind)
            and torch.equal(rt.values, big.values)):
        raise AssertionError("the torch.sparse round trip changed the CSR")
    if tdist.is_initialized():
        raise AssertionError("a process group is still up")
    beat = multihost.heartbeat()
    print(f"phase 21: n={N_BIG} nnz={big.nnz} float64: checked_structure "
          f"{check_s * 1e3:.2f} ms, sound; a copy with colind[12345] = "
          f"{N_BIG}: checked_call -> {bad_err.get()!r}, no launch; "
          f"determinism_audit of B1c (3 launches) True; trace_to "
          f"{os.path.getsize(os.path.join(logdir, trace))} bytes names "
          f"'spalinalg_io_phase' and {', '.join(kernels)} (3 launches; "
          f"{len(records)} kernel records of {TRACE_PAD + 3} launched); "
          f"to_sparse_csr -> to_sparse_coo -> from_sparse_coo on "
          f"{rt.device} {rt_s:.3f} s, arrays equal; heartbeat() with no "
          f"process group {beat * 1e3:.3f} ms | {card}")
    del rt, x
    free_memory()


def dist_checkpoint(mesh, device, card: str, tmpdir: str,
                    io_launches) -> None:
    """A DistCsr of phase 16's 128**3 Laplacian saved shard by shard and
    loaded on the same one-rank group: its dist_spmv (one B1c launch)
    bitwise the original's and held against the plain SpMV of the whole
    matrix."""
    A = stencil_csr(KRYLOV_K, 3, device)
    d = partition_csr(A, mesh)
    path = os.path.join(tmpdir, "dist_lap3d.npz")
    _, save_s = timed(lambda: save_npz(path, d))
    back, load_s = timed(lambda: load_npz(path, mesh=mesh))
    x = card_vector(A.nrows, np.float64, 28, device)
    xl = shard_vector(x, d)
    y, _ = counted_run("DistCsr checkpoint dist_spmv",
                       lambda: dist_spmv(back, xl),
                       {"csr_spmv": {"float64": 1}}, io_launches)
    if not torch.equal(y, dist_spmv(d, xl)):
        raise AssertionError("DistCsr checkpoint: the loaded shard's product "
                             "differs from the original's")
    err = hold_product("DistCsr checkpoint", A, x, unshard_vector(y, d))
    print(f"phase 21: DistCsr checkpoint {KRYLOV_K}^3 float64 on "
          f"{mesh.size()} rank(s) (comm {back.comm}): save {save_s:.3f} s, "
          f"{os.path.getsize(shard_path(path, d.rank))} bytes, load {load_s:.3f} s;"
          f" dist_spmv (1 B1c launch) bitwise the original's, == plain "
          f"(max |err| {err:.3e}) | {card}")
    del A, d, back, x, xl, y
    free_memory()


def io_phase(device, card: str, tmpdir: str, io_launches):
    """Phase 21 on one card (the DistCsr checkpoint runs in phase 20's
    group: ``dist_checkpoint``). Its Cholesky plans go to directories of
    their own, so phase 17 still builds its plan cold."""
    with phase("phase 21 Matrix Market"), plan_cache_at(
            os.path.join(tmpdir, "plans_io")):
        matrix_market_phase(device, card, tmpdir, io_launches)
    with phase("phase 21 native compress"):
        big = compress_phase(device, card)
    with phase("phase 21 checks, profiling, interop, heartbeat"):
        utils_phase(big, card, tmpdir, io_launches)
    del big
    free_memory()
    with phase("phase 21 checkpoints"):
        checkpoint_phase(device, card, tmpdir, io_launches)
    with phase("phase 21 plan cache"):
        plan_cache_phase(device, card, tmpdir)


def kernel_line(launches, report, seen, solver_launches,
                dist_launches, io_launches) -> list:
    """One row per kernel and dtype (its launches over every main path),
    and the rows of EXTRA_ROWS (the launches of their own matrix's main
    path); each row of a kernel with variants names the variants its
    launches ran; the rows of the kernels the solvers of phases 16, 18
    and 19 ran carry those launches as ``solver_launches``, those the
    distributed tier of phase 20 ran as ``dist_launches``, and those of
    phase 21 (IO and utils) as ``io_launches``."""
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
            if (kname, name) in solver_launches:
                row["solver_launches"] = solver_launches[kname, name]
            if (kname, name) in dist_launches:
                row["dist_launches"] = dist_launches[kname, name]
            if (kname, name) in io_launches:
                row["io_launches"] = io_launches[kname, name]
            rows.append(row)
    for (kname, suffix), (shape, names) in EXTRA_ROWS.items():
        for name in names:
            per = variants(kname, name, (shape,))
            row = {"name": f"{kname}_{name}_{suffix}", "route": "cuda",
                   "source": KERNELS[kname][0],
                   "replaces": REPLACES[kname, name],
                   "launches": sum(per.values()),
                   **report[kname, f"{name}_{suffix}"]}
            if kname in VARIANTS:
                row["variants"] = per
            rows.append(row)
    for kname in AT_ROWS:
        for name in ("float32", "float64"):
            per = variants(f"{kname}_at", name)
            rows.append({"name": f"{kname}_{name}_at", "route": "cuda",
                         "source": KERNELS[kname][0],
                         "replaces": AT_REPLACES,
                         "launches": sum(per.values()),
                         **report[kname, f"{name}_at"], "routes": per})
    return rows


def main() -> int:
    # ---- phase 0: the machine ----------------------------------------
    warnings.filterwarnings("ignore", message="Sparse", category=UserWarning)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    # A fresh temporary directory, removed at the end: the on-disk plan
    # cache (so phases 17-18 measure cold host plans) and phase 21's files.
    tmpdir = tempfile.mkdtemp(prefix="spalinalg_smoke_")
    os.environ["SPALINALG_PLAN_CACHE"] = os.path.join(tmpdir, "plans")
    try:
        return run(t_start, tmpdir)
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)


def run(t_start: float, tmpdir: str) -> int:
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
    main_out.update(drive("SpGEMM", lambda: run_spgemm(gemm),
                          launches))

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
    with phase("phase 22"):
        check_staged_csr(mats, rhs, device)
    with phase("phase 7"):
        check_spgemm(gemm, plan, main_out, report)
        spgemm_edge_structures(device)
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
    # ex56's bsr @ x: the stream SpMV's main path, checked and timed
    with phase("inputs: BSR ex56"):
        ex56 = ex56_inputs(device)
    ex56_y = drive("BSR ex56 bsr @ x", lambda: run_ex56(*ex56, seen),
                   launches)
    check_variants("BSR ex56 bsr @ x", "bsr_spmv", seen)
    with phase("phase 11 ex56"):
        check_ex56(*ex56, ex56_y, report, card)
    del ex56_y
    free_memory()
    # the Jacobi diagonal: HPCG's operator and ex56's blocks
    with phase("inputs: HPCG 256^3"):
        hpcg = hpcg_inputs(device)
    diag_out = drive("Jacobi diagonal",
                     lambda: run_diagonal(hpcg, ex56[0], seen), launches)
    with phase("phase 11 diagonal"):
        check_diagonal(hpcg, ex56[0], diag_out, report, card)
    del ex56, hpcg, diag_out
    free_memory()
    # the CG step's three passes: HPCG's 256^3 unknowns and ex56's
    with phase("inputs: CG step vectors"):
        step_in = cg_step_inputs(device)
    step_out = drive("CG step", lambda: run_cg_step(step_in, seen), launches)
    with phase("phase 11 CG step"):
        check_cg_step(step_in, step_out, report, card)
    del step_in, step_out
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
    del probe_out
    free_memory()

    # ---- IO and utils (phase 21): here, so its heartbeat runs before
    # phase 20 makes a process group; its DistCsr checkpoint runs in
    # phase 20's group.
    io_launches = {}
    with phase("phase 21"):
        io_phase(device, card, tmpdir, io_launches)

    # ---- the solver tier: Krylov solvers (phase 16), config[3] (17) ----
    solver_launches = {}
    with phase("phase 16"):
        krylov_phase(device, card, solver_launches)
    with phase("phase 17"):
        cholesky_phase(device, card)
    # ---- the linalg tier: LU, spsolve, QR (18), eigen and funm (19) ----
    with phase("phase 18"):
        lu_phase(device, card, solver_launches)
    with phase("phase 19"):
        eigen_phase(device, card, solver_launches)
    # ---- the distributed tier on a one-rank NCCL group (phase 20) -------
    dist_launches = {}
    with phase("phase 20"):
        dist_phase(device, card, dist_launches, tmpdir, io_launches)
    print(f"total: {time.perf_counter() - t_start:.2f} s")

    kernels = kernel_line(launches, report, seen, solver_launches,
                          dist_launches, io_launches)
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
