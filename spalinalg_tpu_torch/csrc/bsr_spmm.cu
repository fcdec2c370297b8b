// BSR sparse matrix times dense matrix for Hopper (sm_90a): Y = A X.
//
// A is block-sparse-row: indptr (nbr + 1), indices (nblocks), data
// (nblocks, br, bc) row-major dense blocks. X is (ncols, k) and Y is
// (nbr * br, k), both row-major and contiguous. Scalar row r = bi * br + ii:
//
//   Y[r, c] = sum over k in [indptr[bi], indptr[bi+1]) and j < bc of
//             data[k, ii, j] * X[indices[k] * bc + j, c]
//
// Replaces the Pallas kernels of the JAX package's BSR SpMM:
//   spalinalg_tpu/ops/kernels/bsr_stream.py  _kernel_v2  (B5)
//   spalinalg_tpu/ops/kernels/bsr_spmv.py    _kernel     (B9, its K > 1 role)
// Their per-block grid steps, the revisited (br, K) output tile, the mask
// pass over empty block rows and the chunk DMAs follow from VMEM and the
// sequential TPU grid. This source reads the block arrays directly, takes
// any k >= 1 and is instantiated for float, __nv_bfloat16 (widened
// exactly, accumulated in float) and double. X and Y are in the
// accumulation type.
//
// What bounds it on this card: with large blocks, the arithmetic. A
// 128 x 128 block is used k times, so at k = 64 the product does 32 FMAs
// per byte of A: bound by the FMA rate (67 TFLOP/s in float outside the
// tensor cores), as long as each FMA does not need its own load. A kernel
// that gives each value its own load instruction (the register variant
// below: 10 loads for 16 FMAs) is bound by load instructions instead and
// ran at 11.4 TFLOP/s in float on the H100. With small blocks (8 x 8 at k
// = 64) the product does 2 FMAs per byte of A and is bound by device
// memory; but each slab of X (the bc rows a block column multiplies) is
// read by every block row with a block in that column, five times on a
// banded matrix, and if every read comes from L2 the traffic from L2 to
// the SMs is five times X's bytes, which bounds the register variant and
// any kernel that reads X per block.
//
// Three variants; the caller names one (the wrapper's bsr_spmm_variant)
// and the entry point refuses arguments that do not suit it. Tiled and
// staged need bc * sizeof(T) and k * sizeof(A) to be multiples of 16 bytes
// and data, X and Y to be 16-byte aligned.
//
// tiled (br >= 32, bc >= 16, k >= 16 (32 in double); its
// tile computes 64 columns whatever k is, so below these the register
// variant is as fast or faster, PERF.md): a CUDA-core GEMM
// tile. A CTA of 256 threads owns one output tile, a row tile of up to
// BM = 16 * TM rows of one block row by a column tile of BN = 64 columns.
// It walks the block row's blocks in storage order and each block's bc in
// steps of BK (32 for float and bf16 blocks, 16 for double); per step the
// A tile (BM x BK of the block, in its storage type, so bf16 halves its
// bytes) and the X tile (BK rows of X[indices[blk] * bc + j, c0 ...] x 64
// columns) go to shared memory with 16-byte cp.async copies, three stages
// deep, so that the next steps' copies overlap this step's FMAs. The
// stages take 55-80 KB, above the 48 KB default, so each launch raises the
// kernel's dynamic shared memory limit first. Each thread keeps a TM x 4
// tile of accumulators (rows ty + 16 i, columns 4 tx .. 4 tx + 3) and reads
// its fragments with wide shared loads: JS consecutive values of each of
// its TM rows (a float4, a double2, or four bf16 as a uint2) and 4 values
// of each of JS rows of the X tile, TM + JS (or 2 JS in double) loads for
// TM * 4 * JS FMAs, against 10 loads for 16 FMAs in the register variant.
// The A tile's rows are padded by 16 bytes, so the two rows a warp reads
// at once fall in different banks. Accumulation is a plain FMA in the
// accumulation type, each output summing its blocks in storage order and
// each block's bc values in order (TF32 would be another function). Ragged
// edges are masked in the kernel: copies of rows past br, of columns past
// bc and of X columns past k fill zeros, and stores past br or k are
// skipped.
//
// staged (2 <= br <= 16, bc <= 16; the wrapper also asks k >= 8, the
// smallest k measured): the small blocks of FEM and multi-component PDE
// codes. A CTA of up to 128 threads owns a run of consecutive block rows
// (as many as fill about 48 KB of shared memory at the mean blocks a row,
// at least two) and a column tile of up to 32 16-byte groups (128 float or
// 64 double columns; wider k takes several tiles, as even as they go, so
// a k of 68 is 17 or 34 groups, not a masked 32 or 64). It copies the
// run's blocks, which are contiguous in data, and the window of X's rows
// from its smallest to its largest block column, into shared memory with
// 16-byte cp.async copies, once; so neighbouring block rows share the
// slabs of X they both read, and a banded matrix's X comes from L2 about
// (rows + 4) / rows times instead of five times. The CTA takes the shared
// memory its launch needs (about 48 KB; each launch raises the limit),
// so several CTAs an SM overlap one's copies with another's FMAs. A thread
// owns RT = 2, 4 or 8 rows of a block row (two row tiles for br > 8) and
// 16 bytes of columns (4 floats or 2 doubles): per JS values of a block
// row (one 16-byte shared load: 4 float, 8 bf16, 2 double) it loads RT
// values of the block and JS rows of X and does RT * JS * CW FMAs, in the
// register variant's order, one fma a term, so the two give the same bits.
// A CTA whose blocks or window would not fit (block columns spread wide,
// rows far longer than the mean) reads the same 16-byte vectors from
// device memory instead, in the same order. Rows past br in a tile reread
// row q0 and write nothing; columns past k are zero-filled and not written.
// The column range is a min / max over the CTA's indices (integer
// reductions: no effect on the sums).
//
// register (everything else: narrow k, odd widths, 1-row blocks,
// misaligned views). The first design, kept for those shapes, where the
// tile would be mostly masked: a group of G lanes owns a tile of RT rows
// of one block row (RT = 1, 4 or 8 by br) and a range of the k columns, G
// the power of two from 1 to 32 that covers k, and NT = 2 column tiles a
// lane for k > 32 (then passes over column blocks of 64). For each stored
// value position (block, j) the group loads one row of X once and applies
// it to its RT rows, whose values every lane of the group reads at one
// address (a broadcast); the RT x NT sums stay in registers. Double's
// instance is capped at 128 registers (two CTAs an SM, no spills), which
// took the 128 x 128, k = 64 product from 4.89 to 3.57 ms on the H100; the
// same cap slows float, so float has none. Lanes past k read a valid
// column and write nothing; rows past br in the last tile read row q0 and
// write nothing.
//
// All: no shuffles and no atomics on values, so a result is bitwise the
// same from run to run. Every row is written, rows of empty block rows
// with 0. Blocks at or past min(indptr[nbr], nblocks) are never read.
// Offsets into data, X and Y are 64-bit. Registers (ptxas -v, nvcc 12.9,
// sm_90a), no spills: tiled 117 (float), 127 (bf16), 128 (double, at the
// cap of two CTAs an SM); register 128 (float, 32 lanes, 2 column tiles, 8
// rows) and 126 (double, capped); staged 121 / 72 / 56 (float, RT = 8 /
// 4 / 2), 128 / 72 / 56 (bf16) and 128 / 72 / 56 (double), with small
// spills in three instances the main path does not run: 4 bytes (float,
// RT = 2; bf16, RT = 8) and 16 (double, RT = 4). A minimum of four CTAs
// an SM with the j loop not unrolled removes them, but ran slower on 4 x
// 4 and 16 x 16 double blocks. The tile shape was chosen on the H100
// among 8 x 4 and 8 x 8 accumulators a thread and three or four stages
// (spalinalg_tpu_torch/tools/bench_bsr.py, tri128 at k = 64): 8 x 8 took
// 0.774 / 2.007 / 0.762 ms in float / double / bf16 against 0.719 / 1.473
// / 0.777 for 8 x 4; a fourth stage moved none by more than 1.4 %.
//
// Measured on "NVIDIA H100 80GB HBM3, 700.00 W" (bench_bsr.py, parent
// against change in one session): banded8 (8 x 8 blocks, 327,674 of them,
// k = 64) took 0.3484 / 0.4278 ms in float / double with the register
// variant and 0.1689 / 0.3097 ms staged, against bounds of 0.1056 /
// 0.2108 ms (bytes); the staged variant beat register at every square
// block of 2 to 16 and k of 8 to 64 (bench_bsr.py --sweep). What still
// holds it back: a CTA copies, then computes, so its copies and its FMAs
// do not overlap within it, and at 128 registers a thread only four CTAs
// share an SM; in double the FP64 pipe alone needs about 90 us of the
// 0.31 ms. A version that copied the next run of block rows while
// computing this one needed two buffers, halved the CTAs an SM and ran
// slower in double; tensor cores (DMMA fits an 8 x 8 double block) are
// later work.
// Tensor cores (bf16 with the f32 operand split into bf16 parts on
// mma/wgmma, f64 DMMA) are later work.
//
// C interface: one entry point per storage type, with the variant as an
// int (0 register, 1 tiled, 2 staged). Each launches on the given stream,
// allocates nothing, does not synchronise, and returns cudaGetLastError()
// (or the error of raising the shared memory limit), or
// cudaErrorInvalidValue for arguments the variant does not take. nbr == 0
// or k == 0 launches nothing.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRegister = 0;
constexpr int kTiled = 1;
constexpr int kStaged = 2;

__device__ __forceinline__ float load_acc(const float* p) { return __ldg(p); }

__device__ __forceinline__ double load_acc(const double* p) { return __ldg(p); }

__device__ __forceinline__ float load_acc(const __nv_bfloat16* p) {
  const unsigned short bits = __ldg(reinterpret_cast<const unsigned short*>(p));
  return __bfloat162float(__ushort_as_bfloat16(bits));
}

// ---------------------------------------------------------------- tiled

// Per storage type: the depth of a step (BK), the values of a row read at
// once from the A tile (JS), the rows and columns a thread owns (TM, TN),
// the threads along the columns and the rows (TX, TY), and the CTAs an SM
// the launch bound asks for (MINB).
template <typename T>
struct Tiled;

template <>
struct Tiled<float> {
  static constexpr int BK = 32, JS = 4, TM = 8, TN = 4, TX = 16, TY = 16,
                       MINB = 2;
};

template <>
struct Tiled<__nv_bfloat16> {
  static constexpr int BK = 32, JS = 4, TM = 8, TN = 4, TX = 16, TY = 16,
                       MINB = 2;
};

template <>
struct Tiled<double> {
  static constexpr int BK = 16, JS = 2, TM = 8, TN = 4, TX = 16, TY = 16,
                       MINB = 2;
};

constexpr int kStages = 3;

template <typename T, typename A>
struct TileShape {
  using C = Tiled<T>;
  static constexpr int NT = C::TX * C::TY;     // threads
  static constexpr int BM = C::TY * C::TM;
  static constexpr int BN = C::TX * C::TN;
  static constexpr int LDA = C::BK + 16 / static_cast<int>(sizeof(T));
  static constexpr int LDX = BN + 16 / static_cast<int>(sizeof(A));
  static constexpr int A_STAGE = BM * LDA;      // elements of T
  static constexpr int X_STAGE = C::BK * LDX;   // elements of A
  static constexpr size_t SMEM =
      kStages * (A_STAGE * sizeof(T) + X_STAGE * sizeof(A));
  static constexpr int A_CHUNKS = BM * C::BK * sizeof(T) / 16;
  static constexpr int X_CHUNKS = C::BK * BN * sizeof(A) / 16;
  static_assert(A_CHUNKS % NT == 0 && X_CHUNKS % NT == 0,
                "whole copies per thread");
  static_assert(C::TN % 4 == 0, "whole 4-value loads of an X row");
  static_assert((kStages * A_STAGE * sizeof(T)) % 16 == 0,
                "the X stages start 16-byte aligned");
};

// 16 bytes from global to shared memory, or 16 zero bytes when !full (the
// source is then not read).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool full) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int src_bytes = full ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// JS consecutive values of an A tile row, in the accumulation type.
__device__ __forceinline__ void load_a(const float* p, float (&a)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  a[0] = v.x;
  a[1] = v.y;
  a[2] = v.z;
  a[3] = v.w;
}

__device__ __forceinline__ void load_a(const __nv_bfloat16* p,
                                       float (&a)[4]) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  a[0] = __uint_as_float(w.x << 16);  // a bf16 is the high half of a float
  a[1] = __uint_as_float(w.x & 0xffff0000u);
  a[2] = __uint_as_float(w.y << 16);
  a[3] = __uint_as_float(w.y & 0xffff0000u);
}

__device__ __forceinline__ void load_a(const double* p, double (&a)[2]) {
  const double2 v = *reinterpret_cast<const double2*>(p);
  a[0] = v.x;
  a[1] = v.y;
}

// Four consecutive values of an X tile row, and four into a row of Y.
__device__ __forceinline__ void load4(const float* p, float* v) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}

__device__ __forceinline__ void load4(const double* p, double* v) {
  const double2 q0 = *reinterpret_cast<const double2*>(p);
  const double2 q1 = *reinterpret_cast<const double2*>(p + 2);
  v[0] = q0.x;
  v[1] = q0.y;
  v[2] = q1.x;
  v[3] = q1.y;
}

__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(double* p, const double* v) {
  *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
  *reinterpret_cast<double2*>(p + 2) = make_double2(v[2], v[3]);
}

template <typename T, typename A>
__global__ void __launch_bounds__(TileShape<T, A>::NT, Tiled<T>::MINB)
bsr_spmm_tiled(const int* __restrict__ indptr, const int* __restrict__ indices,
               const T* __restrict__ data, const A* __restrict__ X,
               A* __restrict__ Y, int br, int bc, long long nblocks,
               long long k) {
  using C = Tiled<T>;
  using S = TileShape<T, A>;
  constexpr int BK = C::BK, JS = C::JS, TM = C::TM, TN = C::TN;
  constexpr int BM = S::BM, BN = S::BN, NT = S::NT;
  constexpr int VA = 16 / sizeof(T);  // elements of a 16-byte copy
  constexpr int VX = 16 / sizeof(A);
  extern __shared__ __align__(16) unsigned char smem[];
  T* As = reinterpret_cast<T*>(smem);
  A* Xs = reinterpret_cast<A*>(smem + kStages * S::A_STAGE * sizeof(T));

  const int row_tiles = (br + BM - 1) / BM;
  const long long col_tiles = (k + BN - 1) / BN;
  long long t = blockIdx.x;
  const long long c0 = (t % col_tiles) * BN;
  t /= col_tiles;
  const int r0 = static_cast<int>(t % row_tiles) * BM;
  const long long bi = t / row_tiles;
  long long ke = indptr[bi + 1];
  ke = ke < nblocks ? ke : nblocks;
  long long kb = indptr[bi];
  kb = kb < ke ? kb : ke;
  const int ksteps = (bc + BK - 1) / BK;
  const long long steps = (ke - kb) * ksteps;
  const int tid = threadIdx.x;
  const int tx = tid % C::TX;
  const int ty = tid / C::TX;

  // Step s: block kb + s / ksteps, columns j0 .. j0 + BK of it.
  auto copy_step = [&](long long s, int slot) {
    const long long blk = kb + s / ksteps;
    const int j0 = static_cast<int>(s % ksteps) * BK;
    const long long col = __ldg(indices + blk);
    T* as = As + slot * S::A_STAGE;
    A* xs = Xs + slot * S::X_STAGE;
    const T* ab = data + (blk * br + r0) * static_cast<long long>(bc) + j0;
#pragma unroll
    for (int i = 0; i < S::A_CHUNKS / NT; ++i) {
      const int c = tid + i * NT;
      const int r = c / (BK / VA);
      const int q = (c % (BK / VA)) * VA;
      const bool full = r0 + r < br && j0 + q < bc;
      cp_async16(as + r * S::LDA + q,
                 full ? ab + static_cast<long long>(r) * bc + q : data, full);
    }
    const A* xb = X + (col * bc + j0) * k + c0;
#pragma unroll
    for (int i = 0; i < S::X_CHUNKS / NT; ++i) {
      const int c = tid + i * NT;
      const int jj = c / (BN / VX);
      const int q = (c % (BN / VX)) * VX;
      const bool full = j0 + jj < bc && c0 + q < k;
      cp_async16(xs + jj * S::LDX + q, full ? xb + jj * k + q : X, full);
    }
  };

  A acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int n = 0; n < TN; ++n) {
      acc[i][n] = A(0);
    }
  }
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) {
      copy_step(s, s);
    }
    cp_async_commit();
  }
  for (long long s = 0; s < steps; ++s) {
    // Step s has landed; every thread is done with step s - 1, whose slot
    // the copies issued next overwrite.
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const long long next = s + kStages - 1;
    if (next < steps) {
      copy_step(next, static_cast<int>(next % kStages));
    }
    cp_async_commit();
    const int slot = static_cast<int>(s % kStages);
    const T* as = As + slot * S::A_STAGE + ty * S::LDA;
    const A* xs = Xs + slot * S::X_STAGE + tx * TN;
#pragma unroll
    for (int j = 0; j < BK; j += JS) {
      A a[TM][JS];
      A xv[JS][TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        load_a(as + i * C::TY * S::LDA + j, a[i]);
      }
#pragma unroll
      for (int jj = 0; jj < JS; ++jj) {
#pragma unroll
        for (int n = 0; n < TN; n += 4) {
          load4(xs + (j + jj) * S::LDX + n, xv[jj] + n);
        }
      }
#pragma unroll
      for (int jj = 0; jj < JS; ++jj) {
#pragma unroll
        for (int i = 0; i < TM; ++i) {
#pragma unroll
          for (int n = 0; n < TN; ++n) {
            acc[i][n] += a[i][jj] * xv[jj][n];
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  const long long c = c0 + tx * TN;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = r0 + ty + i * C::TY;
    if (r < br) {
      A* yr = Y + (bi * br + r) * k + c;
#pragma unroll
      for (int n = 0; n < TN; n += 4) {
        if (c + n + 4 <= k) {
          store4(yr + n, acc[i] + n);
        } else {
#pragma unroll
          for (int m = n; m < n + 4; ++m) {
            if (c + m < k) {
              yr[m] = acc[i][m];
            }
          }
        }
      }
    }
  }
}

template <typename T, typename A>
int launch_tiled(const void* indptr, const void* indices, const void* data,
                 const void* X, void* Y, long long nbr, int br, int bc,
                 long long nblocks, long long k, cudaStream_t stream) {
  using S = TileShape<T, A>;
  const long long blocks =
      nbr * ((br + S::BM - 1) / S::BM) * ((k + S::BN - 1) / S::BN);
  if (blocks > 2147483647LL) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const cudaError_t raised = cudaFuncSetAttribute(
      bsr_spmm_tiled<T, A>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(S::SMEM));
  if (raised != cudaSuccess) {
    return static_cast<int>(raised);
  }
  bsr_spmm_tiled<T, A><<<static_cast<unsigned>(blocks), S::NT, S::SMEM,
                         stream>>>(
      static_cast<const int*>(indptr), static_cast<const int*>(indices),
      static_cast<const T*>(data), static_cast<const A*>(X),
      static_cast<A*>(Y), br, bc, nblocks, k);
  return static_cast<int>(cudaGetLastError());
}

// Values of a block row that one 16-byte load brings, by storage type.
template <typename T>
struct RowChunk;

template <>
struct RowChunk<float> {
  static constexpr int JS = 4;
};

template <>
struct RowChunk<__nv_bfloat16> {
  static constexpr int JS = 8;
};

template <>
struct RowChunk<double> {
  static constexpr int JS = 2;
};

// JS consecutive values of a block row from device memory, widened to the
// accumulation type.
__device__ __forceinline__ void load_row(const float* p, float (&a)[4]) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  a[0] = v.x;
  a[1] = v.y;
  a[2] = v.z;
  a[3] = v.w;
}

__device__ __forceinline__ void load_row(const __nv_bfloat16* p,
                                         float (&a)[8]) {
  const uint4 w = __ldg(reinterpret_cast<const uint4*>(p));
  a[0] = __uint_as_float(w.x << 16);  // a bf16 is the high half of a float
  a[1] = __uint_as_float(w.x & 0xffff0000u);
  a[2] = __uint_as_float(w.y << 16);
  a[3] = __uint_as_float(w.y & 0xffff0000u);
  a[4] = __uint_as_float(w.z << 16);
  a[5] = __uint_as_float(w.z & 0xffff0000u);
  a[6] = __uint_as_float(w.w << 16);
  a[7] = __uint_as_float(w.w & 0xffff0000u);
}

__device__ __forceinline__ void load_row(const double* p, double (&a)[2]) {
  const double2 v = __ldg(reinterpret_cast<const double2*>(p));
  a[0] = v.x;
  a[1] = v.y;
}

// 16 bytes of a row of X (4 floats or 2 doubles), and of a row of Y.
__device__ __forceinline__ void load_cols(const float* p, float (&v)[4]) {
  const float4 q = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}

__device__ __forceinline__ void load_cols(const double* p, double (&v)[2]) {
  const double2 q = __ldg(reinterpret_cast<const double2*>(p));
  v[0] = q.x;
  v[1] = q.y;
}

__device__ __forceinline__ void store_cols(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store_cols(double* p, const double (&v)[2]) {
  *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
}

// One rounding, as the register variant's contracted `acc += v * x`.
__device__ __forceinline__ float fma_rn(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}

__device__ __forceinline__ double fma_rn(double a, double b, double c) {
  return __fma_rn(a, b, c);
}

// One step of a thread: JS values of each of its RT rows of a block (a[q])
// and the JS rows of X they multiply, CW columns each (x[jj]).
template <typename A, int RT, int JS, int CW>
struct Step {
  A a[RT][JS];
  A x[JS][CW];
};

template <typename A, int RT, int JS, int CW>
__device__ __forceinline__ void mac(const Step<A, RT, JS, CW>& st,
                                    A (&acc)[RT][CW]) {
#pragma unroll
  for (int jj = 0; jj < JS; ++jj) {
#pragma unroll
    for (int q = 0; q < RT; ++q) {
#pragma unroll
      for (int c = 0; c < CW; ++c) {
        acc[q][c] = fma_rn(st.a[q][jj], st.x[jj][c], acc[q][c]);
      }
    }
  }
}

// --------------------------------------------------------------- staged

constexpr int kStagedThreads = 128;
constexpr int kStagedGroups = 32;         // 16-byte column groups of a CTA
constexpr int kStagedTarget = 48 * 1024;  // shared memory a CTA aims at
constexpr int kMaxShared = 232448;        // what a CTA may hold on an H100

// 16 bytes of shared memory as values of the accumulation type.
__device__ __forceinline__ void lds16(const float* p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}

__device__ __forceinline__ void lds16(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 w = *reinterpret_cast<const uint4*>(p);
  v[0] = __uint_as_float(w.x << 16);
  v[1] = __uint_as_float(w.x & 0xffff0000u);
  v[2] = __uint_as_float(w.y << 16);
  v[3] = __uint_as_float(w.y & 0xffff0000u);
  v[4] = __uint_as_float(w.z << 16);
  v[5] = __uint_as_float(w.z & 0xffff0000u);
  v[6] = __uint_as_float(w.w << 16);
  v[7] = __uint_as_float(w.w & 0xffff0000u);
}

__device__ __forceinline__ void lds16(const double* p, double (&v)[2]) {
  const double2 q = *reinterpret_cast<const double2*>(p);
  v[0] = q.x;
  v[1] = q.y;
}

template <typename T, typename A, int RT>
__global__ void __launch_bounds__(kStagedThreads)
bsr_spmm_staged(const int* __restrict__ indptr,
                const int* __restrict__ indices, const T* __restrict__ data,
                const A* __restrict__ X, A* __restrict__ Y, long long nbr,
                int rows, int gt, int tpb, int br, int bc, long long nblocks,
                long long k, long long shared) {
  constexpr int JS = RowChunk<T>::JS;
  constexpr int CW = 16 / sizeof(A);
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_lo, s_hi;
  const int group = tpb * gt;  // threads of a block row
  const long long bi0 = static_cast<long long>(blockIdx.x) * rows;
  const long long bie = bi0 + rows < nbr ? bi0 + rows : nbr;
  const long long xc0 = static_cast<long long>(blockIdx.y) * gt * CW;
  const int tid = threadIdx.x;
  const int lig = tid % group;
  const long long bi = bi0 + tid / group;
  const bool active = bi < bie;
  const int tq = lig / gt;
  const int cg = lig - tq * gt;
  const long long c0 = xc0 + cg * CW;
  const int q0 = tq * RT;
  long long ke1 = indptr[bie];
  ke1 = ke1 < nblocks ? ke1 : nblocks;
  long long kb0 = indptr[bi0];
  kb0 = kb0 < ke1 ? kb0 : ke1;
  long long kb = 0, ke = 0;
  if (active) {
    ke = indptr[bi + 1];
    ke = ke < nblocks ? ke : nblocks;
    kb = indptr[bi];
    kb = kb < ke ? kb : ke;
  }
  const long long nb = ke1 - kb0;  // the CTA's blocks, kb0 .. ke1
  const long long bsize = static_cast<long long>(br) * bc;
  const long long a_bytes = bsize * sizeof(T);
  const int x_ld = gt * CW;  // elements of a staged row of X
  const long long slab = static_cast<long long>(bc) * x_ld * sizeof(A);
  const long long idx_bytes = (4 * nb + 15) / 16 * 16;
  int* idx_s = reinterpret_cast<int*>(smem);

  // 1. The CTA's column indices into shared memory, and their range.
  if (tid == 0) {
    s_lo = 0x7fffffff;
    s_hi = -1;
  }
  __syncthreads();
  const bool fits = idx_bytes + nb * a_bytes <= shared;
  int lo = 0x7fffffff, hi = -1;
  if (fits) {
    for (long long i = tid; i < nb; i += blockDim.x) {
      const int c = __ldg(indices + kb0 + i);
      idx_s[i] = c;
      lo = c < lo ? c : lo;
      hi = c > hi ? c : hi;
    }
  }
  lo = __reduce_min_sync(0xffffffffu, lo);
  hi = __reduce_max_sync(0xffffffffu, hi);
  if (tid % 32 == 0) {
    atomicMin(&s_lo, lo);
    atomicMax(&s_hi, hi);
  }
  __syncthreads();
  lo = s_lo;
  const long long win = nb > 0 ? static_cast<long long>(s_hi) - lo + 1 : 0;

  int roff[RT];
#pragma unroll
  for (int q = 0; q < RT; ++q) {
    roff[q] = (q0 + q < br ? q0 + q : q0) * bc;
  }
  A acc[RT][CW];
#pragma unroll
  for (int q = 0; q < RT; ++q) {
#pragma unroll
    for (int c = 0; c < CW; ++c) {
      acc[q][c] = A(0);
    }
  }
  if (fits && idx_bytes + nb * a_bytes + win * slab <= shared) {
    // 2. The blocks (contiguous in data) and the window of X's slabs the
    // CTA reads, once, with 16-byte copies; columns past k zero-filled.
    // Both counts are below shared / 16, so 32-bit indices do.
    unsigned char* as = smem + idx_bytes;
    unsigned char* xs = as + nb * a_bytes;
    const unsigned char* ga =
        reinterpret_cast<const unsigned char*>(data + kb0 * bsize);
    const int a_chunks = static_cast<int>(nb * a_bytes / 16);
    for (int i = tid; i < a_chunks; i += blockDim.x) {
      cp_async16(as + 16 * i, ga + 16 * i, true);
    }
    const int x_chunks = static_cast<int>(win * bc * gt);
    const A* xw = X + lo * static_cast<long long>(bc) * k + xc0;
    for (int i = tid; i < x_chunks; i += blockDim.x) {
      const int row = i / gt;  // of the window: slab * bc + j
      const int q = i - row * gt;
      const bool full = xc0 + q * CW < k;
      cp_async16(xs + (row * x_ld + q * CW) * sizeof(A),
                 full ? xw + row * k + q * CW : X, full);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    // 3. Every block of the thread's block row from shared memory.
    for (long long blk = kb; blk < ke; ++blk) {
      const T* sa = reinterpret_cast<const T*>(as) + (blk - kb0) * bsize;
      const A* sx = reinterpret_cast<const A*>(xs) +
                    (idx_s[blk - kb0] - lo) * static_cast<long long>(bc) *
                        x_ld +
                    cg * CW;
      for (int j0 = 0; j0 < bc; j0 += JS) {
        Step<A, RT, JS, CW> st;
#pragma unroll
        for (int q = 0; q < RT; ++q) {
          lds16(sa + roff[q] + j0, st.a[q]);
        }
#pragma unroll
        for (int jj = 0; jj < JS; ++jj) {
          lds16(sx + (j0 + jj) * x_ld, st.x[jj]);
        }
        mac(st, acc);
      }
    }
  } else {
    // The CTA's blocks or window do not fit: 16-byte loads from device
    // memory, in the same order. Lanes past k read the last columns.
    const A* xc = X + (c0 < k ? c0 : k - CW);
    for (long long blk = kb; blk < ke; ++blk) {
      const T* d = data + blk * bsize;
      const A* xb =
          xc + static_cast<long long>(__ldg(indices + blk)) * bc * k;
      for (int j0 = 0; j0 < bc; j0 += JS) {
        Step<A, RT, JS, CW> st;
#pragma unroll
        for (int q = 0; q < RT; ++q) {
          load_row(d + roff[q] + j0, st.a[q]);
        }
#pragma unroll
        for (int jj = 0; jj < JS; ++jj) {
          load_cols(xb + (j0 + jj) * k, st.x[jj]);
        }
        mac(st, acc);
      }
    }
  }
  if (active && c0 < k) {
#pragma unroll
    for (int q = 0; q < RT; ++q) {
      if (q0 + q < br) {
        store_cols(Y + (bi * br + q0 + q) * k + c0, acc[q]);
      }
    }
  }
}

template <typename T, typename A, int RT>
int launch_staged_rt(const void* indptr, const void* indices,
                     const void* data, const void* X, void* Y, long long nbr,
                     int br, int bc, long long nblocks, long long k, int tpb,
                     cudaStream_t stream) {
  constexpr int CW = 16 / sizeof(A);
  const long long g = k / CW;  // 16-byte column groups of a row of X
  // Column tiles of at most kStagedGroups groups, as even as they go.
  const long long col_tiles = (g + kStagedGroups - 1) / kStagedGroups;
  const int gt = static_cast<int>((g + col_tiles - 1) / col_tiles);
  const int group = tpb * gt;
  // Block rows of a CTA: as many as fill kStagedTarget bytes with their
  // blocks (at the mean count a row, rounded up) and X slabs, four slabs
  // to spare for the window's ends; at least two (where the threads hold
  // them), at most what the threads hold. The CTA takes the shared memory
  // that needs, and a CTA whose blocks or window need more falls back to
  // reading device memory.
  const long long slab = static_cast<long long>(bc) * gt * 16;
  const long long per_row =
      (nblocks + nbr - 1) / nbr *
          (static_cast<long long>(br) * bc * sizeof(T) + 4) +
      slab;
  const long long most = kStagedThreads / group > 0 ? kStagedThreads / group : 1;
  long long rows = (kStagedTarget - 4 * slab) / per_row;
  rows = rows > 2 ? rows : 2;
  rows = rows < most ? rows : most;
  long long shared = rows * per_row + 4 * slab + 16;
  shared = shared < kMaxShared ? shared : kMaxShared;
  const long long blocks = (nbr + rows - 1) / rows;
  if (blocks > 2147483647LL || col_tiles > 65535) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const cudaError_t raised = cudaFuncSetAttribute(
      bsr_spmm_staged<T, A, RT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(shared));
  if (raised != cudaSuccess) {
    return static_cast<int>(raised);
  }
  const dim3 grid(static_cast<unsigned>(blocks),
                  static_cast<unsigned>(col_tiles));
  // whole warps: the warp reductions take every lane
  const unsigned threads = static_cast<unsigned>((rows * group + 31) / 32 * 32);
  bsr_spmm_staged<T, A, RT><<<grid, threads, static_cast<size_t>(shared),
                              stream>>>(
      static_cast<const int*>(indptr), static_cast<const int*>(indices),
      static_cast<const T*>(data), static_cast<const A*>(X),
      static_cast<A*>(Y), nbr, static_cast<int>(rows), gt, tpb, br, bc,
      nblocks, k, shared);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename A>
int launch_staged(const void* indptr, const void* indices, const void* data,
                  const void* X, void* Y, long long nbr, int br, int bc,
                  long long nblocks, long long k, cudaStream_t s) {
  if (br <= 2) return launch_staged_rt<T, A, 2>(indptr, indices, data, X, Y, nbr, br, bc, nblocks, k, 1, s);
  if (br <= 4) return launch_staged_rt<T, A, 4>(indptr, indices, data, X, Y, nbr, br, bc, nblocks, k, 1, s);
  return launch_staged_rt<T, A, 8>(indptr, indices, data, X, Y, nbr, br, bc, nblocks, k, br <= 8 ? 1 : 2, s);
}

// ------------------------------------------------------------- register

template <typename T, typename A, int G, int NT, int RT>
__device__ __forceinline__ void spmm_tile(
    const int* __restrict__ indptr, const int* __restrict__ indices,
    const T* __restrict__ data, const A* __restrict__ X, A* __restrict__ Y,
    long long ntiles, int tiles_per_brow, int br, int bc, long long nblocks,
    long long k) {
  const long long tile =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) / G;
  if (tile >= ntiles) {
    return;  // nothing below is warp-synchronous
  }
  const int c0 = threadIdx.x % G;
  const long long bi = tile / tiles_per_brow;
  const int q0 = static_cast<int>(tile - bi * tiles_per_brow) * RT;
  long long ke = indptr[bi + 1];
  ke = ke < nblocks ? ke : nblocks;
  long long kb = indptr[bi];
  kb = kb < ke ? kb : ke;
  // Row offsets of the tile within a block; a row past br rereads row q0.
  int roff[RT];
#pragma unroll
  for (int q = 0; q < RT; ++q) {
    roff[q] = (q0 + q < br ? q0 + q : q0) * bc;
  }
  for (long long cb = 0; cb < k; cb += G * NT) {
    long long col[NT];  // this lane's columns, clamped into [0, k)
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const long long c = cb + c0 + t * G;
      col[t] = c < k ? c : k - 1;
    }
    A acc[RT][NT];
#pragma unroll
    for (int q = 0; q < RT; ++q) {
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        acc[q][t] = A(0);
      }
    }
    for (long long blk = kb; blk < ke; ++blk) {
      const A* xb = X + static_cast<long long>(__ldg(indices + blk)) * bc * k;
      const T* d = data + blk * br * bc;
#pragma unroll 4
      for (int j = 0; j < bc; ++j) {
        A xv[NT];
#pragma unroll
        for (int t = 0; t < NT; ++t) {
          xv[t] = __ldg(xb + j * k + col[t]);
        }
#pragma unroll
        for (int q = 0; q < RT; ++q) {
          const A v = load_acc(d + roff[q] + j);
#pragma unroll
          for (int t = 0; t < NT; ++t) {
            acc[q][t] += v * xv[t];
          }
        }
      }
    }
#pragma unroll
    for (int q = 0; q < RT; ++q) {
      if (q0 + q < br) {
        A* yr = Y + (bi * br + q0 + q) * k + cb + c0;
#pragma unroll
        for (int t = 0; t < NT; ++t) {
          if (cb + c0 + t * G < k) {
            yr[t * G] = acc[q][t];
          }
        }
      }
    }
  }
}

// float accumulators (float and bfloat16 blocks): no minimum of CTAs an SM.
// An explicit minimum of 1 lets ptxas take 165 registers, which runs slower
// than leaving it out (128 registers).
template <typename T, typename A, int G, int NT, int RT>
__global__ void __launch_bounds__(kThreads)
bsr_spmm_register(const int* __restrict__ indptr,
                  const int* __restrict__ indices,
                  const T* __restrict__ data, const A* __restrict__ X,
                  A* __restrict__ Y, long long ntiles, int tiles_per_brow,
                  int br, int bc, long long nblocks, long long k) {
  spmm_tile<T, A, G, NT, RT>(indptr, indices, data, X, Y, ntiles,
                             tiles_per_brow, br, bc, nblocks, k);
}

// double: two CTAs an SM, so at most 128 registers (see the note above).
template <typename T, typename A, int G, int NT, int RT>
__global__ void __launch_bounds__(kThreads, 2)
bsr_spmm_register_f64(const int* __restrict__ indptr,
                      const int* __restrict__ indices,
                      const T* __restrict__ data, const A* __restrict__ X,
                      A* __restrict__ Y, long long ntiles, int tiles_per_brow,
                      int br, int bc, long long nblocks, long long k) {
  spmm_tile<T, A, G, NT, RT>(indptr, indices, data, X, Y, ntiles,
                             tiles_per_brow, br, bc, nblocks, k);
}

template <typename T, typename A, int G, int NT, int RT>
int launch_rt(const void* indptr, const void* indices, const void* data,
              const void* X, void* Y, long long nbr, int br, int bc,
              long long nblocks, long long k, cudaStream_t stream) {
  const int tiles_per_brow = (br + RT - 1) / RT;
  const long long ntiles = nbr * tiles_per_brow;
  const long long blocks = (ntiles * G + kThreads - 1) / kThreads;
  if (blocks > 2147483647LL) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  void (*kernel)(const int*, const int*, const T*, const A*, A*, long long,
                 int, int, int, long long, long long);
  if constexpr (sizeof(A) == 8) {
    kernel = bsr_spmm_register_f64<T, A, G, NT, RT>;
  } else {
    kernel = bsr_spmm_register<T, A, G, NT, RT>;
  }
  kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const int*>(indptr), static_cast<const int*>(indices),
      static_cast<const T*>(data), static_cast<const A*>(X),
      static_cast<A*>(Y), ntiles, tiles_per_brow, br, bc, nblocks, k);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename A, int G, int NT>
int launch_g(const void* indptr, const void* indices, const void* data,
             const void* X, void* Y, long long nbr, int br, int bc,
             long long nblocks, long long k, cudaStream_t s) {
  if (br == 1) return launch_rt<T, A, G, NT, 1>(indptr, indices, data, X, Y, nbr, br, bc, nblocks, k, s);
  if (br <= 4) return launch_rt<T, A, G, NT, 4>(indptr, indices, data, X, Y, nbr, br, bc, nblocks, k, s);
  return launch_rt<T, A, G, NT, 8>(indptr, indices, data, X, Y, nbr, br, bc, nblocks, k, s);
}

template <typename T, typename A>
int launch_register(const void* indptr, const void* indices,
                    const void* data, const void* X, void* Y, long long nbr,
                    int br, int bc, long long nblocks, long long k,
                    cudaStream_t s) {
  if (k == 1) return launch_g<T, A, 1, 1>(indptr, indices, data, X, Y, nbr, br, bc, nblocks, k, s);
  if (k == 2) return launch_g<T, A, 2, 1>(indptr, indices, data, X, Y, nbr, br, bc, nblocks, k, s);
  if (k <= 4) return launch_g<T, A, 4, 1>(indptr, indices, data, X, Y, nbr, br, bc, nblocks, k, s);
  if (k <= 8) return launch_g<T, A, 8, 1>(indptr, indices, data, X, Y, nbr, br, bc, nblocks, k, s);
  if (k <= 16) return launch_g<T, A, 16, 1>(indptr, indices, data, X, Y, nbr, br, bc, nblocks, k, s);
  if (k <= 32) return launch_g<T, A, 32, 1>(indptr, indices, data, X, Y, nbr, br, bc, nblocks, k, s);
  return launch_g<T, A, 32, 2>(indptr, indices, data, X, Y, nbr, br, bc, nblocks, k, s);
}

bool aligned16(const void* p) {
  return reinterpret_cast<std::uintptr_t>(p) % 16 == 0;
}

template <typename T, typename A>
int launch(const void* indptr, const void* indices, const void* data,
           const void* X, void* Y, long long nbr, int br, int bc,
           long long nblocks, long long k, int variant, void* stream) {
  if (nbr < 0 || br < 1 || bc < 1 || nblocks < 0 || k < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool rows16 = (static_cast<long long>(bc) * sizeof(T)) % 16 == 0 &&
                      (k * static_cast<long long>(sizeof(A))) % 16 == 0 &&
                      aligned16(data) && aligned16(X) && aligned16(Y);
  const bool tiled_ok =
      rows16 && br >= 32 && bc >= 16 && k >= (sizeof(A) == 8 ? 32 : 16);
  const bool staged_ok = rows16 && br <= 16 && bc <= 16;
  if (variant != kRegister && !(variant == kTiled && tiled_ok) &&
      !(variant == kStaged && staged_ok)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (nbr == 0 || k == 0) {
    return static_cast<int>(cudaSuccess);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant == kTiled) {
    return launch_tiled<T, A>(indptr, indices, data, X, Y, nbr, br, bc,
                              nblocks, k, s);
  }
  if (variant == kStaged) {
    return launch_staged<T, A>(indptr, indices, data, X, Y, nbr, br, bc,
                               nblocks, k, s);
  }
  return launch_register<T, A>(indptr, indices, data, X, Y, nbr, br, bc,
                               nblocks, k, s);
}

}  // namespace

extern "C" int spal_bsr_spmm_f32(const void* indptr, const void* indices,
                                 const void* data, const void* X, void* Y,
                                 long long nbr, int br, int bc,
                                 long long nblocks, long long k, int variant,
                                 void* stream) {
  return launch<float, float>(indptr, indices, data, X, Y, nbr, br, bc,
                              nblocks, k, variant, stream);
}

extern "C" int spal_bsr_spmm_bf16(const void* indptr, const void* indices,
                                  const void* data, const void* X, void* Y,
                                  long long nbr, int br, int bc,
                                  long long nblocks, long long k, int variant,
                                  void* stream) {
  return launch<__nv_bfloat16, float>(indptr, indices, data, X, Y, nbr, br,
                                      bc, nblocks, k, variant, stream);
}

extern "C" int spal_bsr_spmm_f64(const void* indptr, const void* indices,
                                 const void* data, const void* X, void* Y,
                                 long long nbr, int br, int bc,
                                 long long nblocks, long long k, int variant,
                                 void* stream) {
  return launch<double, double>(indptr, indices, data, X, Y, nbr, br, bc,
                                nblocks, k, variant, stream);
}
