// CSR sparse matrix times dense matrix for Hopper (sm_90a): Y = A X.
//
//   Y[i, c] = sum over p in [rowptr[i], rowptr[i+1]) of values[q(p)] * X[colind[p], c]
//
// with q(p) = p, or q(p) = perm[p] when a perm array is given (the
// backward's Aᵀ·G reads the forward's values through the cached transpose
// permutation, or the values bucketed by column block through bperm:
// csr_transpose.cu's bucket route; not a gathered copy). X is (ncols, k)
// and Y is
// (nrows, k), both row-major and contiguous.
//
// Replaces the two Pallas kernels of the JAX package's CSR SpMM:
//   spalinalg_tpu/ops/kernels/csr_route.py  _route_spmm_kernel     (B2a)
//   spalinalg_tpu/ops/kernels/csr_route.py  _route_spmm_kernel_pk  (B2b, packed pages)
// Their routing plan, lane-gather tables, spill recursion and the 1 <= k <= 64
// limit (a VMEM budget for the per-page X tile) work around TPU limits.
// Hopper gathers rows of X natively, so this source reads
// rowptr/colind/values directly, takes any k, and is instantiated for float
// and double. It accumulates in its own type.
//
// What bounds it on this card: bytes, and above all the gathers. Every
// stored entry streams its value and column index once (sizeof(T) + 4
// bytes) and gathers one row of X, k * sizeof(T) bytes (256 B at k = 64 in
// float), from L2 or device memory. On a random matrix whose X is larger
// than the 50 MB L2 (csr_random at n = 2^19: 134 / 268 MB) those gathers
// are 4.29 / 8.59 GB a product, 1.28 / 2.56 ms at 3.35 TB/s if none hits
// L2, far above the 0.12 / 0.22 ms of the compulsory bytes, which count X
// once; on a banded matrix X is read about once. Two flops per gathered
// element are far below the card's arithmetic rate.
//
// Two variants; the caller names one (the wrapper's csr_spmm_variant) and
// the entry point refuses arguments that do not suit it. In both, one warp
// owns one row, loads 32 entries (index and value) cooperatively and hands
// each round with __shfl_sync; where a perm is given, an instance of its
// own reads the values through it.
//
// Long rows, in both (the wrapper's row_pieces: where one row holds more
// entries than a resident warp's share of the launch's, so that its walk
// alone would set the launch's time). A warp a row walks a row of L
// entries in L / 32 batches, one after another: on a power-law graph at k
// = 256 a 163,243-entry row took as long as the other 132M entries
// together. There the wrapper passes the SpMV's long-row plan (csr_spmv.cu;
// every row longer than `budget` entries cut into pieces of `budget`
// entries, the last shorter) and scratch for a partial row a piece. The
// first npieces warps of the grid each walk one piece with the variant's
// own loop (the same gathers, perm and column blocks, stopping at the
// row's end, so padding slots are never read) and write its partial row;
// warp npieces + r walks row r as before, except a long row, which it
// leaves to its pieces. Pieces come first, so none waits in the last wave.
// A second kernel (csr_spmm_finish) then adds each long row's partials in
// piece order, a warp a row and 32 columns, a lane a column. Whether a
// launch has pieces is a template parameter (PIECES), and the piece
// arguments come last, so the unsplit instances keep the code of a warp a
// row: a run-time test in one instance slowed the unsplit register kernel
// 11 % (csr_random, k = 64) to 24 % (rows of eight) in double on the H100.
//
// vector (float, k a multiple of 4, X and Y 16-byte aligned). A group of S
// lanes reads a row of X in 16-byte vectors (float4; S the power of two
// covering the row's vectors, at most 32, NV <= 2 vectors a lane, wider
// rows in column blocks): at k = 64 a half warp a row. The 32 / S groups
// of a warp take different entries of the batch, U = min(S, 4) at a time
// (8 entries' rows in flight a warp at k = 64); the next batch's indices
// and values are loaded (__ldcs, streamed) before the current one's
// gathers (__ldg). A group sums its entries in order; a fixed
// __shfl_xor_sync tree over the groups ends the row, which is stored with
// __stcs. In double the variant ran slower than the register one at k = 64
// (see Vec below), so double keeps the register variant.
//
// register (double; float with k not a multiple of 4 or X off a 16-byte
// boundary). The first design, kept for those shapes: lanes cover the k
// columns in groups of G lanes, G the power of two from 1 to 32 that
// covers k, one element a lane; for k > 32 a lane holds NT = 2
// column tiles and passes over column blocks of 64; for k < 32 the warp
// splits into 32 / G sub-groups that take different entries of the row at
// once. Sub-group sums meet in a fixed __shfl_down_sync tree.
//
// staged (X starts on a 16-byte boundary; a tile plan built once per
// structure, the wrapper's csr_tile_plan; the wrapper's csr_spmm_variant
// takes it where the widest window fits STAGE_BUDGET). On a banded matrix
// the register variant gathers a whole row of X from L2 for every stored
// entry: 33 entries a row x 512 B (double, k = 64) x 2^19 rows, 8.9 GB of
// L2-to-SM traffic a product, though each row of X is needed by only 33
// neighbouring rows. Here a CTA of 256 threads owns a tile of kTileRows =
// 64 consecutive rows, whose entries read only the rows [c0, c0 + w) of X
// (the plan's window: 96 rows on the banded matrix, 48 KB at k = 64 in
// double). It copies that range, one contiguous run of w * k elements,
// into dynamic shared memory with 16-byte cp.async pieces (from the
// 16-byte boundary below it), waits, and then runs the tile's rows with
// the rows of X read from shared memory, so the 33-fold reuse of a row of
// X comes from shared memory instead of L2. Two row loops, each giving
// the register kernel's bits:
// - where a row of X is a whole number of 16-byte vectors and k >= 17
//   (the register kernel's G = 32, which sums each element of Y over its
//   row's entries in order, one after another): a group of L = 8 or 16
//   lanes owns a row, 32 / L rows a warp at once, and a lane owns NV
//   16-byte vectors of a column block (double2 or float4). A lane of each
//   group loads one entry's column id and value of a batch of L, and one
//   shuffle round hands the groups an entry each: at k = 64 in double a
//   round's three shuffles serve two entries instead of one, and a lane
//   reads its row of X with two 16-byte shared-memory loads. Shuffles and
//   shared-memory loads share a path of one wavefront a clock an SM,
//   which bounds this loop: 4 wavefronts of X an entry (512 B) and 1.5 of
//   shuffles at k = 64 in double;
// - otherwise the register kernel's own loop (a warp a row, the same
//   lanes, rounds and tree), with a batch that stops at the row's end.
// An empty tile copies nothing and writes its rows' zeros. Shared memory a
// CTA: the widest window's w * k elements and 32 bytes of alignment slack;
// the entry point refuses a launch that would need more than a CTA may
// hold (232,448 bytes) or an X off a 16-byte boundary. Slots past
// rowptr[nrows] are in no tile. PERF.md has its times beside the other
// variants' (spalinalg_tpu_torch/tools/bench_csr.py --variants).
//
// All: no atomics, and the summation order depends only on the structure,
// k and the piece plan, so a result is bitwise the same from run to run;
// without pieces the bits are those of a warp a row. Slots past
// rowptr[nrows] are never read; an empty row gives 0. Offsets into X and Y
// are 64-bit, since ncols * k passes 2^31 well inside the card's memory.
// Registers (ptxas -v, nvcc 12.9, sm_90a): the vector kernel at k = 64
// (float, S = 16) 64 with 8 bytes of spill stores, at k = 256 (S = 32, NV
// = 2) 80 with 20; its other instances 40-78, spilling 0-8 bytes; the
// register kernel at k = 64 38 (double) and 32 (float, 4 bytes), its other
// instances 32-62, 0-12 bytes; their pieced instances within 16 registers
// of these (at k = 64 40 and 38; the vector kernel at k = 256 80 with 32
// bytes); the finishing kernel 32 (float) and 34 (double), no spills; the
// staged kernel's split rows at k = 64 55 (double, L = 16, NV = 2) and 46
// (float, NV = 1), its other instances 43-76, its register-loop instances
// 30-48, no spills but 16 bytes at G = 16 in double.
//
// C interface: one entry point per type, with the variant as an int (0
// register, 1 vector, 2 staged; staged also takes the tile plan, its tile
// count and its widest window; register and vector take the piece plan:
// each piece's row, then each piece's first entry, the long rows and the
// first piece of each, as one int32 array, with their counts, the budget
// and scratch of npieces * k elements; npieces == 0 walks a row a warp).
// Each launches on the given stream, allocates nothing, does not
// synchronise, and returns cudaGetLastError(), or cudaErrorInvalidValue for
// arguments the variant does not take. nrows == 0 or k == 0 launches
// nothing.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarp = 32;
constexpr int kRowsPerBlock = kThreads / kWarp;
constexpr int kRegister = 0;
constexpr int kVector = 1;
constexpr int kStaged = 2;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kTileRows = 64;            // TILE_ROWS in ops/kernels/csr_spmv.py
constexpr long long kMaxShared = 232448; // what a CTA may hold on an H100

// The value of slot p: values[p], or values[perm[p]] (PERM), chosen at
// compile time: a run-time test in the register kernel's load slowed the
// float64 kernel in trials on the H100.
template <bool PERM, typename T>
__device__ __forceinline__ T slot_value(const T* values, const int* perm,
                                        long long p) {
  return PERM ? __ldg(values + __ldcs(perm + p)) : __ldcs(values + p);
}

// The piece plan: piece_row (npieces), piece_start (npieces), then the
// finishing kernel's long rows (nlong) and first pieces (nlong + 1).
struct Pieces {
  const int* plan;
  long long npieces;
  long long nlong;
  long long budget;
};

// The slots [start, end) of this warp and the row it writes: row `orow`
// of `base` (Y or partial), `width` elements (T or 16-byte vectors) a row,
// which starts at `out`. With PIECES, warp w < npieces walks piece w
// (budget slots from its first, fewer at its row's end) into row w of
// partial, and warp npieces + r row r of Y unless that row is longer than
// the budget; without, warp r row r of Y. False: the warp writes nothing.
// The same for every lane of a warp. Both forms of the row are given
// because nvcc 12.9 compiled each kernel best with its own: the register
// kernel's stores from base and orow keep its unsplit instances' code; the
// vector kernel from base and orow took 140 registers (80 with `out`) in
// its pieced instance at k = 256.
template <bool PIECES, typename P>
__device__ __forceinline__ bool warp_work(const int* __restrict__ rowptr,
                                          Pieces pc, P* Y, P* partial,
                                          long long nrows, long long width,
                                          P*& base, long long& orow, P*& out,
                                          long long& start, long long& end) {
  const long long w =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) / kWarp;
  if (PIECES && w < pc.npieces) {
    start = pc.plan[pc.npieces + w];
    const long long row_end = rowptr[pc.plan[w] + 1];
    end = start + pc.budget < row_end ? start + pc.budget : row_end;
    base = partial;
    orow = w;
    out = partial + w * width;
    return true;
  }
  const long long row = PIECES ? w - pc.npieces : w;
  if (row >= nrows) {
    return false;
  }
  start = rowptr[row];
  end = rowptr[row + 1];
  base = Y;
  orow = row;
  out = Y + row * width;
  return !PIECES || end - start <= pc.budget;  // else its pieces write it
}

template <typename T, int G, int NT, bool PERM, bool PIECES>
__global__ void __launch_bounds__(kThreads)
csr_spmm_kernel(const int* __restrict__ rowptr, const int* __restrict__ colind,
                const T* __restrict__ values, const int* __restrict__ perm,
                const T* __restrict__ X, T* __restrict__ Y, long long nrows,
                long long k, Pieces pc, T* __restrict__ partial) {
  constexpr int S = kWarp / G;  // sub-groups: entries in flight per warp
  T *base, *out;
  long long orow, start, end;
  if (!warp_work<PIECES>(rowptr, pc, Y, partial, nrows, k, base, orow, out,
                         start, end)) {
    return;  // the whole warp leaves together
  }
  const int lane = threadIdx.x & (kWarp - 1);
  const int sub = lane / G;
  const int c0 = lane % G;
  for (long long cb = 0; cb < k; cb += G * NT) {
    T acc[NT];
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      acc[t] = T(0);
    }
    for (long long p0 = start; p0 < end; p0 += kWarp) {
      int col = 0;
      T v = T(0);
      if (p0 + lane < end) {
        col = colind[p0 + lane];
        v = PERM ? __ldg(values + perm[p0 + lane]) : values[p0 + lane];
      }
#pragma unroll
      for (int i = 0; i < G; ++i) {
        const int j = i * S + sub;  // this sub-group's i-th entry of the batch
        const int cj = __shfl_sync(0xffffffffu, col, j);
        const T vj = __shfl_sync(0xffffffffu, v, j);
        if (p0 + j < end) {
          const T* xr = X + static_cast<long long>(cj) * k + cb + c0;
#pragma unroll
          for (int t = 0; t < NT; ++t) {
            if (cb + c0 + t * G < k) {
              acc[t] += vj * __ldg(xr + t * G);
            }
          }
        }
      }
    }
    // Every lane of the warp reaches the shuffles; offsets are multiples of
    // G, so lane l adds the partial of the same column from another
    // sub-group.
#pragma unroll
    for (int off = kWarp / 2; off >= G; off >>= 1) {
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        acc[t] += __shfl_down_sync(0xffffffffu, acc[t], off);
      }
    }
    if (sub == 0) {
      T* yr = base + orow * k + cb + c0;
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        if (cb + c0 + t * G < k) {
          yr[t * G] = acc[t];
        }
      }
    }
  }
}

// Y of each long row: its pieces' partials (rows of partial, k wide) added
// in piece order. A warp takes a long row and a block of 32 columns, a lane
// a column.
template <typename T>
__global__ void __launch_bounds__(kThreads)
csr_spmm_finish(const int* __restrict__ long_rows,
                const int* __restrict__ first_piece,
                const T* __restrict__ partial, T* __restrict__ Y,
                long long nlong, long long k) {
  const long long cblocks = (k + kWarp - 1) / kWarp;
  const long long w =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) / kWarp;
  const long long c = (w % cblocks) * kWarp + (threadIdx.x & (kWarp - 1));
  const long long i = w / cblocks;
  if (i >= nlong || c >= k) {
    return;
  }
  T sum = T(0);
  const long long p1 = first_piece[i + 1];
#pragma unroll 8
  for (long long p = first_piece[i]; p < p1; ++p) {
    sum += __ldcs(partial + p * k + c);
  }
  Y[static_cast<long long>(long_rows[i]) * k + c] = sum;
}

// 16 bytes from global to shared memory.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem));
}

// Copy the elements [first, first + count) of src (16-byte aligned) into
// smem with 16-byte pieces from the 16-byte boundary at or below them, wait
// for every thread's pieces, and return where element `first` landed.
// Takes every thread of the CTA.
template <typename T>
__device__ const T* stage_run(unsigned char* smem, const T* src,
                              long long first, long long count) {
  const long long b0 = first * static_cast<long long>(sizeof(T));
  const long long a0 = b0 & ~15LL;
  const long long pieces =
      count > 0 ? (b0 + count * static_cast<long long>(sizeof(T)) - a0 + 15) >> 4
                : 0;
  const unsigned char* from = reinterpret_cast<const unsigned char*>(src) + a0;
  for (long long i = threadIdx.x; i < pieces; i += blockDim.x) {
    cp_async16(smem + 16 * i, from + 16 * i);
  }
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();
  return reinterpret_cast<const T*>(smem + (b0 - a0));
}

// The register kernel's row loop over a tile whose window of X sits in
// shared memory: the same lanes, the same rounds and the same tree, so the
// same bits. plan holds (first slot, end slot, c0, w) a tile.
template <typename T, int G, int NT, bool PERM>
__global__ void __launch_bounds__(kThreads)
csr_spmm_staged(const int* __restrict__ rowptr, const int* __restrict__ colind,
                const T* __restrict__ values, const int* __restrict__ perm,
                const T* __restrict__ X, T* __restrict__ Y,
                const int4* __restrict__ plan, long long nrows, long long k) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int S = kWarp / G;
  const int4 tile = plan[blockIdx.x];
  const long long c0 = tile.z;
  const T* xs = stage_run(smem, X, c0 * k, static_cast<long long>(tile.w) * k);
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x & (kWarp - 1);
  const int sub = lane / G;
  const int cl = lane % G;
  const long long r0 = static_cast<long long>(blockIdx.x) * kTileRows;
  const long long r1 = r0 + kTileRows < nrows ? r0 + kTileRows : nrows;
  for (long long row = r0 + warp; row < r1; row += kRowsPerBlock) {
    const long long start = rowptr[row];
    const long long end = rowptr[row + 1];
    for (long long cb = 0; cb < k; cb += G * NT) {
      T acc[NT];
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        acc[t] = T(0);
      }
      for (long long p0 = start; p0 < end; p0 += kWarp) {
        int col = 0;
        T v = T(0);
        if (p0 + lane < end) {
          col = colind[p0 + lane];
          v = PERM ? __ldg(values + perm[p0 + lane]) : values[p0 + lane];
        }
        const long long n = end - p0;  // entries left, uniform in the warp
#pragma unroll
        for (int i = 0; i < G; ++i) {
          if (i * S >= n) {
            break;  // no sub-group has an entry in this or a later round
          }
          const int j = i * S + sub;
          const int cj = __shfl_sync(kFull, col, j);
          const T vj = __shfl_sync(kFull, v, j);
          if (j < n) {
            const T* xr = xs + (cj - c0) * k + cb + cl;
#pragma unroll
            for (int t = 0; t < NT; ++t) {
              if (cb + cl + t * G < k) {
                acc[t] += vj * xr[t * G];
              }
            }
          }
        }
      }
#pragma unroll
      for (int off = kWarp / 2; off >= G; off >>= 1) {
#pragma unroll
        for (int t = 0; t < NT; ++t) {
          acc[t] += __shfl_down_sync(kFull, acc[t], off);
        }
      }
      if (sub == 0) {
        T* yr = Y + row * k + cb + cl;
#pragma unroll
        for (int t = 0; t < NT; ++t) {
          if (cb + cl + t * G < k) {
            yr[t * G] = acc[t];
          }
        }
      }
    }
  }
}

// 16 bytes of X or Y and the multiply-add of one value into them, for the
// staged variant's split rows: each element as the register kernel adds
// it (acc += v * x), so the same bits.
template <typename T>
struct Vec16;

template <>
struct Vec16<float> {
  using V = float4;
  static constexpr int kWidth = 4;
  static __device__ __forceinline__ void mac(V& acc, float v, const V& x) {
    acc.x += v * x.x;
    acc.y += v * x.y;
    acc.z += v * x.z;
    acc.w += v * x.w;
  }
};

template <>
struct Vec16<double> {
  using V = double2;
  static constexpr int kWidth = 2;
  static __device__ __forceinline__ void mac(V& acc, double v, const V& x) {
    acc.x += v * x.x;
    acc.y += v * x.y;
  }
};

// The staged variant where a row of X is a whole number of 16-byte
// vectors and k >= 17 (the register kernel's G = 32: each element of Y is
// its row's entries summed in order, one after another). A group of L
// lanes owns a row, 32 / L rows a warp at once, and a lane owns NV
// 16-byte vectors of a column block of L * NV vectors: a lane of each
// group loads one entry's column id and value of a batch of L, and one
// shuffle round hands an entry to every group, so a round's shuffles
// serve 32 / L entries and each lane reads its columns of X with 16-byte
// shared-memory loads. The adds per element are the register kernel's.
template <typename T, int L, int NV, bool PERM>
__global__ void __launch_bounds__(kThreads)
csr_spmm_staged_rows(const int* __restrict__ rowptr,
                     const int* __restrict__ colind,
                     const T* __restrict__ values,
                     const int* __restrict__ perm, const T* __restrict__ X,
                     T* __restrict__ Y, const int4* __restrict__ plan,
                     long long nrows, long long k) {
  using Op = Vec16<T>;
  using V = typename Op::V;
  constexpr int RW = kWarp / L;  // rows a warp at once
  extern __shared__ __align__(16) unsigned char smem[];
  const int4 tile = plan[blockIdx.x];
  const long long c0 = tile.z;
  // k * sizeof(T) is a multiple of 16: the window starts on a 16-byte
  // boundary of shared memory.
  const V* xs = reinterpret_cast<const V*>(
      stage_run(smem, X, c0 * k, static_cast<long long>(tile.w) * k));
  const long long nvec = k / Op::kWidth;
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x & (kWarp - 1);
  const int group = lane & ~(L - 1);  // the group's first lane
  const int gl = lane & (L - 1);
  const long long r0 = static_cast<long long>(blockIdx.x) * kTileRows;
  const long long r1 = r0 + kTileRows < nrows ? r0 + kTileRows : nrows;
  for (long long base = r0 + static_cast<long long>(warp) * RW; base < r1;
       base += static_cast<long long>(kRowsPerBlock) * RW) {
    const long long row = base + lane / L;
    long long start = 0, n = 0;
    if (row < r1) {
      start = rowptr[row];
      n = rowptr[row + 1] - start;
    }
    long long most = n;  // the longest row of the warp's
#pragma unroll
    for (int off = L; off < kWarp; off <<= 1) {
      const long long other = __shfl_xor_sync(kFull, most, off);
      most = other > most ? other : most;
    }
    for (long long vb = 0; vb < nvec; vb += L * NV) {
      V acc[NV];
#pragma unroll
      for (int t = 0; t < NV; ++t) {
        acc[t] = V{};
      }
      for (long long q = 0; q < most; q += L) {
        int col = 0;
        T v = T(0);
        if (q + gl < n) {
          col = colind[start + q + gl];
          v = PERM ? __ldg(values + perm[start + q + gl])
                   : values[start + q + gl];
        }
        const long long m = most - q < L ? most - q : L;  // uniform
        for (int i = 0; i < m; ++i) {
          const int cj = __shfl_sync(kFull, col, group | i);
          const T vj = __shfl_sync(kFull, v, group | i);
          if (q + i < n) {
            const V* xr = xs + (cj - c0) * nvec + vb + gl;
#pragma unroll
            for (int t = 0; t < NV; ++t) {
              if (vb + gl + t * L < nvec) {
                Op::mac(acc[t], vj, xr[t * L]);
              }
            }
          }
        }
      }
      if (row < r1) {
        V* yr = reinterpret_cast<V*>(Y + row * k) + vb + gl;
#pragma unroll
        for (int t = 0; t < NV; ++t) {
          if (vb + gl + t * L < nvec) {
            yr[t * L] = acc[t];
          }
        }
      }
    }
  }
}

// 16 bytes of X or Y (float4) and their multiply-add. The vector variant is
// float only: in double at k = 64 it ran 6 % (csr_random) and 21 % (banded)
// slower than the register variant on the H100
// (spalinalg_tpu_torch/tools/bench_csr.py), which keeps double.
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  using V = float4;
  static constexpr int kWidth = 4;
  static __device__ __forceinline__ void fma(V& acc, float v, const V& x) {
    acc.x += v * x.x;
    acc.y += v * x.y;
    acc.z += v * x.z;
    acc.w += v * x.w;
  }
  static __device__ __forceinline__ void add_xor(V& acc, int off) {
    acc.x += __shfl_xor_sync(kFull, acc.x, off);
    acc.y += __shfl_xor_sync(kFull, acc.y, off);
    acc.z += __shfl_xor_sync(kFull, acc.z, off);
    acc.w += __shfl_xor_sync(kFull, acc.w, off);
  }
};

template <typename T, int S, int NV, bool PERM, bool PIECES>
__global__ void __launch_bounds__(kThreads)
csr_spmm_vector(const int* __restrict__ rowptr, const int* __restrict__ colind,
                const T* __restrict__ values, const int* __restrict__ perm,
                const T* __restrict__ X, T* __restrict__ Y, long long nrows,
                long long nvec, Pieces pc, T* __restrict__ partial) {
  using Op = Vec<T>;
  using V = typename Op::V;
  constexpr int SG = kWarp / S;  // groups: each takes S entries of a batch
  constexpr int U = S < 4 ? S : 4;  // entries a group a step
  V *base, *y;
  long long orow, start, end;
  if (!warp_work<PIECES>(rowptr, pc, reinterpret_cast<V*>(Y),
                         reinterpret_cast<V*>(partial), nrows, nvec, base,
                         orow, y, start, end)) {
    return;  // the whole warp leaves together
  }
  const int lane = threadIdx.x & (kWarp - 1);
  const int sub = lane / S;
  const int c0 = lane % S;
  const V* x = reinterpret_cast<const V*>(X);
  for (long long cb = 0; cb < nvec; cb += S * NV) {
    V acc[NV];
#pragma unroll
    for (int t = 0; t < NV; ++t) {
      acc[t] = V{};
    }
    int col = 0;
    T v = T(0);
    if (start + lane < end) {
      col = __ldcs(colind + start + lane);
      v = slot_value<PERM>(values, perm, start + lane);
    }
    for (long long p0 = start; p0 < end; p0 += kWarp) {
      // The next batch's index and value, in flight behind this batch.
      int col_next = 0;
      T v_next = T(0);
      if (p0 + kWarp + lane < end) {
        col_next = __ldcs(colind + p0 + kWarp + lane);
        v_next = slot_value<PERM>(values, perm, p0 + kWarp + lane);
      }
      const long long n = end - p0;
#pragma unroll
      for (int i0 = 0; i0 < S; i0 += U) {
        int cj[U];
        T vj[U];
        V xv[U][NV];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int j = (i0 + u) * SG + sub;  // this group's entry
          cj[u] = __shfl_sync(kFull, col, j);
          vj[u] = __shfl_sync(kFull, v, j);
#pragma unroll
          for (int t = 0; t < NV; ++t) {
            const long long c = cb + c0 + t * S;
            if (j < n && c < nvec) {
              xv[u][t] = __ldg(x + static_cast<long long>(cj[u]) * nvec + c);
            }
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int j = (i0 + u) * SG + sub;
#pragma unroll
          for (int t = 0; t < NV; ++t) {
            if (j < n && cb + c0 + t * S < nvec) {
              Op::fma(acc[t], vj[u], xv[u][t]);
            }
          }
        }
      }
      col = col_next;
      v = v_next;
    }
    // Every lane reaches the shuffles; offsets of S and above pair lane l
    // with the lane of the same columns in another group.
#pragma unroll
    for (int off = kWarp / 2; off >= S; off >>= 1) {
#pragma unroll
      for (int t = 0; t < NV; ++t) {
        Op::add_xor(acc[t], off);
      }
    }
    if (sub == 0) {
#pragma unroll
      for (int t = 0; t < NV; ++t) {
        const long long c = cb + c0 + t * S;
        if (c < nvec) {
          __stcs(y + c, acc[t]);
        }
      }
    }
  }
}

// Blocks of the register and vector kernels: a warp a piece and a row.
long long walk_blocks(long long nrows, const Pieces& pc) {
  return (pc.npieces + nrows + kRowsPerBlock - 1) / kRowsPerBlock;
}

template <typename T, int S, int NV, bool PERM>
int launch_vec(const void* rowptr, const void* colind, const void* values,
               const void* perm, const void* X, void* Y, Pieces pc,
               void* partial, long long nrows, long long nvec,
               cudaStream_t stream) {
  const long long blocks = walk_blocks(nrows, pc);
  if (blocks > 2147483647LL) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  auto* const kernel = pc.npieces > 0 ? csr_spmm_vector<T, S, NV, PERM, true>
                                      : csr_spmm_vector<T, S, NV, PERM, false>;
  kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const int*>(rowptr), static_cast<const int*>(colind),
      static_cast<const T*>(values), static_cast<const int*>(perm),
      static_cast<const T*>(X), static_cast<T*>(Y), nrows, nvec, pc,
      static_cast<T*>(partial));
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) {
  return reinterpret_cast<std::uintptr_t>(p) % 16 == 0;
}

template <typename T, int G, int NT, bool PERM>
int launch_g(const void* rowptr, const void* colind, const void* values,
             const void* perm, const void* X, void* Y, Pieces pc,
             void* partial, long long nrows, long long k,
             cudaStream_t stream) {
  const long long blocks = walk_blocks(nrows, pc);
  if (blocks > 2147483647LL) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  auto* const kernel = pc.npieces > 0 ? csr_spmm_kernel<T, G, NT, PERM, true>
                                      : csr_spmm_kernel<T, G, NT, PERM, false>;
  kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const int*>(rowptr), static_cast<const int*>(colind),
      static_cast<const T*>(values), static_cast<const int*>(perm),
      static_cast<const T*>(X), static_cast<T*>(Y), nrows, k, pc,
      static_cast<T*>(partial));
  return static_cast<int>(cudaGetLastError());
}

// The long rows' sums from their pieces' partials (after the walk, on the
// same stream).
template <typename T>
int launch_finish(const Pieces& pc, const void* partial, void* Y,
                  long long k, cudaStream_t stream) {
  const long long warps = pc.nlong * ((k + kWarp - 1) / kWarp);
  const long long blocks = (warps + kRowsPerBlock - 1) / kRowsPerBlock;
  if (blocks > 2147483647LL) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const int* long_rows = pc.plan + 2 * pc.npieces;
  csr_spmm_finish<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      long_rows, long_rows + pc.nlong, static_cast<const T*>(partial),
      static_cast<T*>(Y), pc.nlong, k);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int G, int NT, bool PERM>
int launch_st(const void* rowptr, const void* colind, const void* values,
              const void* perm, const void* X, void* Y, const void* plan,
              long long ntiles, long long shared, long long nrows,
              long long k, cudaStream_t stream) {
  const cudaError_t raised = cudaFuncSetAttribute(
      csr_spmm_staged<T, G, NT, PERM>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(shared));
  if (raised != cudaSuccess) {
    return static_cast<int>(raised);
  }
  csr_spmm_staged<T, G, NT, PERM><<<static_cast<unsigned>(ntiles), kThreads,
                                    static_cast<size_t>(shared), stream>>>(
      static_cast<const int*>(rowptr), static_cast<const int*>(colind),
      static_cast<const T*>(values), static_cast<const int*>(perm),
      static_cast<const T*>(X), static_cast<T*>(Y),
      static_cast<const int4*>(plan), nrows, k);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int L, int NV, bool PERM>
int launch_rows(const void* rowptr, const void* colind, const void* values,
                const void* perm, const void* X, void* Y, const void* plan,
                long long ntiles, long long shared, long long nrows,
                long long k, cudaStream_t stream) {
  const cudaError_t raised = cudaFuncSetAttribute(
      csr_spmm_staged_rows<T, L, NV, PERM>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(shared));
  if (raised != cudaSuccess) {
    return static_cast<int>(raised);
  }
  csr_spmm_staged_rows<T, L, NV, PERM><<<static_cast<unsigned>(ntiles),
                                         kThreads,
                                         static_cast<size_t>(shared),
                                         stream>>>(
      static_cast<const int*>(rowptr), static_cast<const int*>(colind),
      static_cast<const T*>(values), static_cast<const int*>(perm),
      static_cast<const T*>(X), static_cast<T*>(Y),
      static_cast<const int4*>(plan), nrows, k);
  return static_cast<int>(cudaGetLastError());
}

// The staged variant: refuses an X off 16 bytes, a plan that does not
// cover the rows, or a window that needs more shared memory than a CTA
// may hold.
template <typename T, bool PERM>
int launch_staged(const void* rowptr, const void* colind, const void* values,
                  const void* perm, const void* X, void* Y, long long nrows,
                  long long k, const void* plan, long long ntiles,
                  long long max_window, cudaStream_t s) {
  const long long shared =
      max_window * k * static_cast<long long>(sizeof(T)) + 32;
  if (!aligned16(X) || plan == nullptr || max_window < 0 ||
      ntiles != (nrows + kTileRows - 1) / kTileRows || shared > kMaxShared) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (k >= 17 && (k * static_cast<long long>(sizeof(T))) % 16 == 0) {
    // whole 16-byte rows: L lanes a row, NV vectors a lane
    const long long nvec = k / Vec16<T>::kWidth;
    if (nvec <= 8) return launch_rows<T, 8, 1, PERM>(rowptr, colind, values, perm, X, Y, plan, ntiles, shared, nrows, k, s);
    if (nvec <= 16) return launch_rows<T, 16, 1, PERM>(rowptr, colind, values, perm, X, Y, plan, ntiles, shared, nrows, k, s);
    if (nvec <= 32) return launch_rows<T, 16, 2, PERM>(rowptr, colind, values, perm, X, Y, plan, ntiles, shared, nrows, k, s);
    return launch_rows<T, 16, 4, PERM>(rowptr, colind, values, perm, X, Y, plan, ntiles, shared, nrows, k, s);
  }
  if (k == 1) return launch_st<T, 1, 1, PERM>(rowptr, colind, values, perm, X, Y, plan, ntiles, shared, nrows, k, s);
  if (k == 2) return launch_st<T, 2, 1, PERM>(rowptr, colind, values, perm, X, Y, plan, ntiles, shared, nrows, k, s);
  if (k <= 4) return launch_st<T, 4, 1, PERM>(rowptr, colind, values, perm, X, Y, plan, ntiles, shared, nrows, k, s);
  if (k <= 8) return launch_st<T, 8, 1, PERM>(rowptr, colind, values, perm, X, Y, plan, ntiles, shared, nrows, k, s);
  if (k <= 16) return launch_st<T, 16, 1, PERM>(rowptr, colind, values, perm, X, Y, plan, ntiles, shared, nrows, k, s);
  if (k <= 32) return launch_st<T, 32, 1, PERM>(rowptr, colind, values, perm, X, Y, plan, ntiles, shared, nrows, k, s);
  return launch_st<T, 32, 2, PERM>(rowptr, colind, values, perm, X, Y, plan, ntiles, shared, nrows, k, s);
}

// The register or vector walk (with pieces where pc has some).
template <typename T, bool PERM>
int launch_walk(const void* rowptr, const void* colind, const void* values,
                const void* perm, const void* X, void* Y, long long nrows,
                long long k, int variant, Pieces pc, void* partial,
                cudaStream_t s) {
  if (variant == kVector) {
    if constexpr (sizeof(T) != sizeof(float)) {
      return static_cast<int>(cudaErrorInvalidValue);
    } else {
      if (k % Vec<T>::kWidth || !aligned16(X) || !aligned16(Y) ||
          (pc.npieces > 0 && !aligned16(partial))) {
        return static_cast<int>(cudaErrorInvalidValue);
      }
      const long long nv = k / Vec<T>::kWidth;
      if (nv == 1) return launch_vec<T, 1, 1, PERM>(rowptr, colind, values, perm, X, Y, pc, partial, nrows, nv, s);
      if (nv == 2) return launch_vec<T, 2, 1, PERM>(rowptr, colind, values, perm, X, Y, pc, partial, nrows, nv, s);
      if (nv <= 4) return launch_vec<T, 4, 1, PERM>(rowptr, colind, values, perm, X, Y, pc, partial, nrows, nv, s);
      if (nv <= 8) return launch_vec<T, 8, 1, PERM>(rowptr, colind, values, perm, X, Y, pc, partial, nrows, nv, s);
      if (nv <= 16) return launch_vec<T, 16, 1, PERM>(rowptr, colind, values, perm, X, Y, pc, partial, nrows, nv, s);
      if (nv <= 32) return launch_vec<T, 32, 1, PERM>(rowptr, colind, values, perm, X, Y, pc, partial, nrows, nv, s);
      return launch_vec<T, 32, 2, PERM>(rowptr, colind, values, perm, X, Y, pc, partial, nrows, nv, s);
    }
  }
  if (variant != kRegister) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (k == 1) return launch_g<T, 1, 1, PERM>(rowptr, colind, values, perm, X, Y, pc, partial, nrows, k, s);
  if (k == 2) return launch_g<T, 2, 1, PERM>(rowptr, colind, values, perm, X, Y, pc, partial, nrows, k, s);
  if (k <= 4) return launch_g<T, 4, 1, PERM>(rowptr, colind, values, perm, X, Y, pc, partial, nrows, k, s);
  if (k <= 8) return launch_g<T, 8, 1, PERM>(rowptr, colind, values, perm, X, Y, pc, partial, nrows, k, s);
  if (k <= 16) return launch_g<T, 16, 1, PERM>(rowptr, colind, values, perm, X, Y, pc, partial, nrows, k, s);
  if (k <= 32) return launch_g<T, 32, 1, PERM>(rowptr, colind, values, perm, X, Y, pc, partial, nrows, k, s);
  return launch_g<T, 32, 2, PERM>(rowptr, colind, values, perm, X, Y, pc, partial, nrows, k, s);
}

// The staged variant, or the walk and, with pieces, the finishing kernel.
// Refuses pieces with the staged variant, a piece plan without its long
// rows, budget or scratch, and negative counts.
template <typename T, bool PERM>
int launch_variant(const void* rowptr, const void* colind, const void* values,
                   const void* perm, const void* X, void* Y, long long nrows,
                   long long k, int variant, const void* plan,
                   long long ntiles, long long max_window, Pieces pc,
                   void* partial, cudaStream_t s) {
  if (pc.npieces < 0 || pc.nlong < 0 ||
      (pc.npieces > 0 &&
       (variant == kStaged || pc.plan == nullptr || pc.nlong == 0 ||
        pc.budget < 1 || partial == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (variant == kStaged) {
    return launch_staged<T, PERM>(rowptr, colind, values, perm, X, Y, nrows,
                                  k, plan, ntiles, max_window, s);
  }
  const int walked = launch_walk<T, PERM>(rowptr, colind, values, perm, X, Y,
                                          nrows, k, variant, pc, partial, s);
  if (walked != 0 || pc.npieces == 0) {
    return walked;
  }
  return launch_finish<T>(pc, partial, Y, k, s);
}

template <typename T>
int launch(const void* rowptr, const void* colind, const void* values,
           const void* perm, const void* X, void* Y, long long nrows,
           long long k, int variant, const void* plan, long long ntiles,
           long long max_window, const void* pieces, long long npieces,
           long long nlong, long long budget, void* partial, void* stream) {
  if (nrows < 0 || k < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (nrows == 0 || k == 0) {
    return static_cast<int>(cudaSuccess);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Pieces pc{static_cast<const int*>(pieces), npieces, nlong, budget};
  if (perm != nullptr) {
    return launch_variant<T, true>(rowptr, colind, values, perm, X, Y, nrows,
                                   k, variant, plan, ntiles, max_window, pc,
                                   partial, s);
  }
  return launch_variant<T, false>(rowptr, colind, values, perm, X, Y, nrows,
                                  k, variant, plan, ntiles, max_window, pc,
                                  partial, s);
}

}  // namespace

extern "C" int spal_csr_spmm_f32(const void* rowptr, const void* colind,
                                 const void* values, const void* perm,
                                 const void* X, void* Y, long long nrows,
                                 long long k, int variant, const void* plan,
                                 long long ntiles, long long max_window,
                                 const void* pieces, long long npieces,
                                 long long nlong, long long budget,
                                 void* partial, void* stream) {
  return launch<float>(rowptr, colind, values, perm, X, Y, nrows, k, variant,
                       plan, ntiles, max_window, pieces, npieces, nlong,
                       budget, partial, stream);
}

extern "C" int spal_csr_spmm_f64(const void* rowptr, const void* colind,
                                 const void* values, const void* perm,
                                 const void* X, void* Y, long long nrows,
                                 long long k, int variant, const void* plan,
                                 long long ntiles, long long max_window,
                                 const void* pieces, long long npieces,
                                 long long nlong, long long budget,
                                 void* partial, void* stream) {
  return launch<double>(rowptr, colind, values, perm, X, Y, nrows, k, variant,
                        plan, ntiles, max_window, pieces, npieces, nlong,
                        budget, partial, stream);
}
