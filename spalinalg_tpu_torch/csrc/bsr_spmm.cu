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
// ran at 11.4 TFLOP/s in float on the H100.
//
// Two variants; the caller names one (the wrapper's bsr_spmm_variant) and
// the entry point refuses arguments that do not suit it:
//
// tiled (br >= 32, bc >= 16, k >= 16 (32 in double), bc * sizeof(T) and
// k * sizeof(A) multiples of 16 bytes, data, X and Y 16-byte aligned; its
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
// register (everything else: 8 x 8 blocks, narrow k, odd widths,
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
// Both: no shuffles and no atomics, so a result is bitwise the same from
// run to run. Every row is written, rows of empty block rows with 0.
// Blocks at or past min(indptr[nbr], nblocks) are never read. Offsets into
// data, X and Y are 64-bit. Registers (ptxas -v, nvcc 12.9, sm_90a), no
// spills: tiled 117 (float), 127 (bf16), 128 (double, at the cap of two
// CTAs an SM); register 128 (float, 32 lanes, 2 column tiles, 8 rows) and
// 126 (double, capped). The tile shape was chosen on the H100 among 8 x 4
// and 8 x 8 accumulators a thread and three or four stages
// (spalinalg_tpu_torch/tools/bench_bsr.py, tri128 at k = 64): 8 x 8 took
// 0.774 / 2.007 / 0.762 ms in float / double / bf16 against 0.719 / 1.473
// / 0.777 for 8 x 4; a fourth stage moved none by more than 1.4 %.
// Tensor cores (bf16 with the f32 operand split into bf16 parts on
// mma/wgmma, f64 DMMA) are later work.
//
// C interface: one entry point per storage type, with the variant as an
// int (0 register, 1 tiled). Each launches on the given stream, allocates
// nothing, does not synchronise, and returns cudaGetLastError() (or the
// error of raising the shared memory limit), or cudaErrorInvalidValue for
// arguments the variant does not take. nbr == 0 or k == 0 launches
// nothing.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRegister = 0;
constexpr int kTiled = 1;

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
  const bool tiled_ok =
      br >= 32 && bc >= 16 && k >= (sizeof(A) == 8 ? 32 : 16) &&
      (static_cast<long long>(bc) * sizeof(T)) % 16 == 0 &&
      (k * static_cast<long long>(sizeof(A))) % 16 == 0 && aligned16(data) &&
      aligned16(X) && aligned16(Y);
  if (variant != kRegister && !(variant == kTiled && tiled_ok)) {
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
