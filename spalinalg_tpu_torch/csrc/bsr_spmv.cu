// BSR sparse matrix-vector product for Hopper (sm_90a): y = A x.
//
// A is block-sparse-row: indptr (nbr + 1) over block rows, indices
// (nblocks) block columns, data (nblocks, br, bc) row-major dense blocks.
// Scalar row r = bi * br + ii of the product is a CSR-like row:
//
//   y[r] = sum over k in [indptr[bi], indptr[bi+1]) and j < bc of
//          data[k, ii, j] * x[indices[k] * bc + j]
//
// Replaces the Pallas kernels of the JAX package's BSR SpMV:
//   spalinalg_tpu/ops/kernels/bsr_stream.py  _kernel_v3  (B4, f32 or bf16 blocks)
//   spalinalg_tpu/ops/kernels/bsr_stream.py  _kernel_v2  (B5, its K = 1 role)
//   spalinalg_tpu/ops/kernels/bsr_df.py      _kernel_df  (B6, f64 as (hi, lo) f32)
//   spalinalg_tpu/ops/kernels/bsr_spmv.py    _kernel     (B9, its K = 1 role)
// Their windows of G blocks, the y accumulator held whole in VMEM, the
// revisit pattern, the mask pass over empty block rows, the chunk DMAs and
// the transposed double-float planes exist because of VMEM and the
// sequential TPU grid. Hopper runs blocks in parallel and has fp64, so one
// source reads indptr/indices/data directly and is instantiated for three
// storage types: float, __nv_bfloat16 (widened exactly, accumulated in
// float) and double. x and y are in the accumulation type.
//
// What bounds it on this card: bytes. Every stored block streams once
// (br * bc * sizeof(T) bytes) with its block-column index; x, re-read by the
// br rows of a block row, is served from L1/L2. One FMA per stored value is
// far below the card's arithmetic rate. What keeps a simple kernel from the
// bandwidth is the number of bytes each load instruction moves and the
// number of loads in flight: one 4-byte value a lane, one block at a time
// behind its index load, streamed 28.6 % of 3.35 TB/s with 8 x 8 float
// blocks on the H100.
//
// Three variants; the caller names one (the wrapper's bsr_spmv_variant)
// and the entry point refuses arguments that do not suit it:
//
// vector (bc * sizeof(T) a multiple of 16 bytes, data and x 16-byte
// aligned). Every load moves 16 bytes: a float4, a double2 or 8 bf16 values
// as a uint4, and the x elements they multiply the same way (two float4 for
// bf16). Stored values load with __ldcs (evict first: they stream once; the
// read-only __ldg path was 2-16 % slower on the H100), x with __ldg.
// - A row slice of a block of at most 64 bytes (8 x 8 in float or double,
//   up to 8 x 32 in bf16) belongs to one thread, which owns a scalar row: a
//   group of S lanes (the power of two covering br, at most 32) takes S rows
//   of one block row, and no reduction is left. The block loop is unrolled
//   by U = 4 blocks (2 where a thread owns three or four vectors of a
//   block, to bound its registers), so each thread has U data loads and U x
//   loads in flight.
// - A wider slice goes to a group of L lanes (L the power of two covering
//   the slice's 16-byte vectors, at most 32), 16 bytes a lane, which owns a
//   tile of R rows of one block row: each x vector a lane loads serves the
//   R rows, and a round has U blocks in flight, R + 1 loads a block (R = 4,
//   U = 4; R = 8, U = 2 for bf16, whose x vectors are twice as wide). A
//   fixed __shfl_down_sync tree per row ends it.
// In both, the group reads its block row's indptr pair once (lane 0) and
// its block indices S (or L) at a time, one a lane, and hands them round
// with __shfl_sync. Each thread sums its values in a fixed order: blocks in
// storage order, each block's elements in order (for the wider slices, the
// U blocks of a round for each of the lane's vectors in turn).
//
// stream (blocks of at most 32 values that vector does not take: rows of
// 1, 3 or 5 values, (8, 4) in bf16, or an operand off 16 bytes). Bound by
// the same bytes. Under BSR storage a block row's stored values are one
// contiguous run, so a warp owns a block row and reads the run A = (32 /
// (br * bc)) * (br * bc) values a step, coalesced (ex56's 3 x 3 blocks: 27
// lanes, 216 bytes a step in double). As A is a multiple of the block
// size, a lane keeps one position of every block it reads, and one
// accumulator. The block ids come 32 at a time, one a lane, handed round
// with __shfl_sync, so a step's loads of values (__ldcs) and of x (__ldg)
// wait on no load of their own; U = 3 steps are in flight. The launch
// bounds hold it to 32 registers, so that 64 warps sit on an SM: the bytes
// in flight come from warps more than from steps a warp. On the ex56
// pattern (3 x 3 double, 161^3 nodes; the bound 2.59 ms) it took 2.98 ms
// with U = 3 in 128-thread CTAs (4 bytes spilled), 3.02 in 256-thread
// CTAs, 3.18-3.23 with U = 2 (no spill), 3.60-5.56 with 36-68 registers
// (U = 2 to 4, fewer warps), 4.27-4.54 with U = 4 spilled into 32; the
// scalar variant 5.26. A fixed __shfl_down_sync tree over a block's
// columns, then over the step's blocks, ends it. A short block row leaves
// a warp's lanes idle, so the wrapper sends this variant block rows of at
// least three steps on average.
//
// scalar (everything else: blocks of more than 32 values off 16 bytes, and
// short block rows). The first design: a group of L lanes (the power of two
// covering bc, at most 32) owns a scalar row and walks the row's slice of
// each block one element a lane, then a fixed shuffle tree.
//
// All three: no atomics, so a result is bitwise the same from run to
// run. Every row is written, rows of empty block rows with 0, so no mask
// pass follows. Blocks at or past min(indptr[nbr], nblocks) are never read.
// Offsets into data, x and y are 64-bit. Registers (ptxas -v, nvcc 12.9,
// sm_90a), no spills in 101 of the 102 instances: the one-thread-a-row
// kernel 94 (float, 8 x 8), 98 (double, 8 x 8), 78 (bf16, 8 x 8); the wide
// kernel 128 (float and double, L = 32; bf16, L = 16); the scalar variant
// 40 (float, L = 32); the stream kernel 32 (float, double and bf16), with
// the one spill named above in its double instance.
//
// C interface: one entry point per storage type, with the variant as an
// int (0 scalar, 1 vector, 2 stream). Each launches on the given stream,
// allocates nothing, does not synchronise, and returns cudaGetLastError(),
// or cudaErrorInvalidValue for arguments the variant does not take.
// nbr == 0 launches nothing; the caller handles a matrix with no blocks.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kScalar = 0;
constexpr int kVector = 1;
constexpr int kStream = 2;

__device__ __forceinline__ float load_acc(const float* p) { return __ldg(p); }

__device__ __forceinline__ double load_acc(const double* p) { return __ldg(p); }

__device__ __forceinline__ float load_acc(const __nv_bfloat16* p) {
  const unsigned short bits = __ldg(reinterpret_cast<const unsigned short*>(p));
  return __bfloat162float(__ushort_as_bfloat16(bits));
}

// The lanes of a group of G (a power of two up to 32, groups aligned
// within the warp).
template <int G>
__device__ __forceinline__ unsigned group_mask() {
  if constexpr (G == 32) {
    return 0xffffffffu;
  } else {
    return ((1u << G) - 1u) << ((threadIdx.x & 31) & ~(G - 1));
  }
}

// The two bf16 values packed in a 32-bit word, widened exactly (a bf16 is
// the high half of a float).
__device__ __forceinline__ float bf16_lo(unsigned w) {
  return __uint_as_float(w << 16);
}

__device__ __forceinline__ float bf16_hi(unsigned w) {
  return __uint_as_float(w & 0xffff0000u);
}

// 16 bytes of stored values (D) and the x elements they multiply (X), in
// one load each, and their products added to acc in order. Stored values
// stream once (__ldcs, evict first); x is re-read and kept (__ldg).
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  using D = float4;
  using X = float4;
  static __device__ __forceinline__ D load_d(const float* p) {
    return __ldcs(reinterpret_cast<const float4*>(p));
  }
  static __device__ __forceinline__ X load_x(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  static __device__ __forceinline__ void fma(float& acc, const D& d,
                                             const X& x) {
    acc += d.x * x.x;
    acc += d.y * x.y;
    acc += d.z * x.z;
    acc += d.w * x.w;
  }
};

template <>
struct Vec<double> {
  using D = double2;
  using X = double2;
  static __device__ __forceinline__ D load_d(const double* p) {
    return __ldcs(reinterpret_cast<const double2*>(p));
  }
  static __device__ __forceinline__ X load_x(const double* p) {
    return __ldg(reinterpret_cast<const double2*>(p));
  }
  static __device__ __forceinline__ void fma(double& acc, const D& d,
                                             const X& x) {
    acc += d.x * x.x;
    acc += d.y * x.y;
  }
};

template <>
struct Vec<__nv_bfloat16> {
  using D = uint4;
  struct X {
    float4 a, b;
  };
  static __device__ __forceinline__ D load_d(const __nv_bfloat16* p) {
    return __ldcs(reinterpret_cast<const uint4*>(p));
  }
  static __device__ __forceinline__ X load_x(const float* p) {
    return {__ldg(reinterpret_cast<const float4*>(p)),
            __ldg(reinterpret_cast<const float4*>(p) + 1)};
  }
  static __device__ __forceinline__ void fma(float& acc, const D& d,
                                             const X& x) {
    acc += bf16_lo(d.x) * x.a.x;
    acc += bf16_hi(d.x) * x.a.y;
    acc += bf16_lo(d.y) * x.a.z;
    acc += bf16_hi(d.y) * x.a.w;
    acc += bf16_lo(d.z) * x.b.x;
    acc += bf16_hi(d.z) * x.b.y;
    acc += bf16_lo(d.w) * x.b.z;
    acc += bf16_hi(d.w) * x.b.w;
  }
};

// The wide vector kernel's tile: the rows R a group owns and the blocks U a
// round has in flight. bf16 blocks take twice the rows and half the blocks:
// their x vectors are 32 bytes, and at R = 4, U = 4 the kernel needs 156
// registers, one CTA an SM (tri128 bf16 0.180 ms, against 0.132 ms at
// R = 8, U = 2 on the H100, spalinalg_tpu_torch/tools/bench_bsr.py).
template <typename T>
struct Lanes {
  static constexpr int R = 4, U = 4;
};

template <>
struct Lanes<__nv_bfloat16> {
  static constexpr int R = 8, U = 2;
};

// The stream kernel's steps in flight a lane and its CTA size; its launch
// bounds hold it to 32 registers, so that 64 warps fit an SM (measured on
// the H100: the note at the top).
constexpr int kStreamSteps = 3;
constexpr int kStreamCta = 128;

// The group's block range [kb, ke), read by lane 0 and handed round.
template <int G>
__device__ __forceinline__ void block_range(const int* __restrict__ indptr,
                                            long long bi, long long nblocks,
                                            unsigned mask, int lane,
                                            long long& kb, long long& ke) {
  kb = ke = 0;
  if (lane == 0) {
    ke = indptr[bi + 1];
    ke = ke < nblocks ? ke : nblocks;
    kb = indptr[bi];
    kb = kb < ke ? kb : ke;
  }
  kb = __shfl_sync(mask, kb, 0, G);
  ke = __shfl_sync(mask, ke, 0, G);
}

// vector variant, a thread a row: NV 16-byte vectors per row slice (1-4).
template <typename T, typename A, int S, int NV>
__global__ void __launch_bounds__(kThreads)
bsr_spmv_rows(const int* __restrict__ indptr, const int* __restrict__ indices,
              const T* __restrict__ data, const A* __restrict__ x,
              A* __restrict__ y, long long nbr, int br, int bc,
              long long nblocks) {
  using V = Vec<T>;
  constexpr int U = NV <= 2 ? 4 : 2;
  constexpr int kVec = 16 / sizeof(T);
  const int groups_per_brow = (br + S - 1) / S;
  const long long group =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) / S;
  const long long bi = group / groups_per_brow;
  if (bi >= nbr) {
    return;  // the whole group leaves together: groups are S-aligned
  }
  const int lane = threadIdx.x & (S - 1);
  const int ii = static_cast<int>(group - bi * groups_per_brow) * S + lane;
  const bool live = ii < br;  // lanes past br only hand indices round
  const unsigned mask = group_mask<S>();
  long long kb, ke;
  block_range<S>(indptr, bi, nblocks, mask, lane, kb, ke);
  A acc = A(0);
  for (long long k0 = kb; k0 < ke; k0 += S) {
    const int nb = static_cast<int>(ke - k0 < S ? ke - k0 : S);
    const int mine = lane < nb ? __ldg(indices + k0 + lane) : 0;
    for (int j = 0; j < nb; j += U) {
      typename V::D dv[U][NV];
      typename V::X xv[U][NV];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        // j + u past S (S < U) wraps modulo S; such a block is not read.
        const int col = __shfl_sync(mask, mine, j + u, S);
        if (live && j + u < nb) {
          const T* d = data + ((k0 + j + u) * br + ii) *
                                  static_cast<long long>(bc);
          const A* xb = x + static_cast<long long>(col) * bc;
#pragma unroll
          for (int v = 0; v < NV; ++v) {
            dv[u][v] = V::load_d(d + v * kVec);
            xv[u][v] = V::load_x(xb + v * kVec);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (live && j + u < nb) {
#pragma unroll
          for (int v = 0; v < NV; ++v) {
            V::fma(acc, dv[u][v], xv[u][v]);
          }
        }
      }
    }
  }
  if (live) {
    y[bi * br + ii] = acc;
  }
}

// vector variant, L lanes a tile of R rows of one block row, 16 bytes a
// lane: each x vector a lane loads serves the tile's R rows.
template <typename T, typename A, int L>
__global__ void __launch_bounds__(kThreads)
bsr_spmv_lanes(const int* __restrict__ indptr, const int* __restrict__ indices,
               const T* __restrict__ data, const A* __restrict__ x,
               A* __restrict__ y, long long nbr, int br, int bc,
               long long nblocks) {
  using V = Vec<T>;
  constexpr int U = Lanes<T>::U;
  constexpr int R = Lanes<T>::R;
  constexpr int kVec = 16 / sizeof(T);
  const int tiles_per_brow = (br + R - 1) / R;
  const long long group =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) / L;
  const long long bi = group / tiles_per_brow;
  if (bi >= nbr) {
    return;  // the whole group leaves together: groups are L-aligned
  }
  const int lane = threadIdx.x & (L - 1);
  const unsigned mask = group_mask<L>();
  const int ii0 = static_cast<int>(group - bi * tiles_per_brow) * R;
  const int rows = br - ii0 < R ? br - ii0 : R;
  const int nvec = bc / kVec;
  long long kb, ke;
  block_range<L>(indptr, bi, nblocks, mask, lane, kb, ke);
  A acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    acc[r] = A(0);
  }
  for (long long k0 = kb; k0 < ke; k0 += L) {
    const int nb = static_cast<int>(ke - k0 < L ? ke - k0 : L);
    const int mine = lane < nb ? __ldg(indices + k0 + lane) : 0;
    for (int j = 0; j < nb; j += U) {
      const T* d[U];
      const A* xb[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int col = __shfl_sync(mask, mine, j + u, L);
        d[u] = data + ((k0 + j + u) * br + ii0) * static_cast<long long>(bc);
        xb[u] = x + static_cast<long long>(col) * bc;
      }
      for (int v = lane; v < nvec; v += L) {
        typename V::D dv[U][R];
        typename V::X xv[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (j + u < nb) {
            xv[u] = V::load_x(xb[u] + v * kVec);
#pragma unroll
            for (int r = 0; r < R; ++r) {
              if (r < rows) {
                dv[u][r] = V::load_d(d[u] + r * bc + v * kVec);
              }
            }
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (j + u < nb) {
#pragma unroll
            for (int r = 0; r < R; ++r) {
              if (r < rows) {
                V::fma(acc[r], dv[u][r], xv[u]);
              }
            }
          }
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int off = L / 2; off > 0; off >>= 1) {
      acc[r] += __shfl_down_sync(mask, acc[r], off, L);
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r < rows) {
        y[bi * br + ii0 + r] = acc[r];
      }
    }
  }
}

// scalar variant: L lanes a row, one element a lane.
template <typename T, typename A, int L>
__global__ void __launch_bounds__(kThreads)
bsr_spmv_scalar(const int* __restrict__ indptr,
                const int* __restrict__ indices, const T* __restrict__ data,
                const A* __restrict__ x, A* __restrict__ y, long long nrows,
                int br, int bc, long long nblocks) {
  const long long row =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) / L;
  if (row >= nrows) {
    return;  // the whole group leaves together: groups are L-aligned
  }
  const int lane = threadIdx.x & (L - 1);
  const long long bi = row / br;
  const long long ii = row - bi * br;
  long long ke = indptr[bi + 1];
  ke = ke < nblocks ? ke : nblocks;
  long long kb = indptr[bi];
  kb = kb < ke ? kb : ke;
  A acc = A(0);
  for (long long k = kb; k < ke; ++k) {
    const T* d = data + (k * br + ii) * bc;
    const A* xb = x + static_cast<long long>(__ldg(indices + k)) * bc;
#pragma unroll 4
    for (int j = lane; j < bc; j += L) {
      acc += load_acc(d + j) * __ldg(xb + j);
    }
  }
  const unsigned mask = group_mask<L>();
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1) {
    acc += __shfl_down_sync(mask, acc, off, L);
  }
  if (lane == 0) {
    y[row] = acc;
  }
}

// The stored value at p widened to the accumulation type, streamed once
// (__ldcs, evict first).
__device__ __forceinline__ float load_stream(const float* p) {
  return __ldcs(p);
}

__device__ __forceinline__ double load_stream(const double* p) {
  return __ldcs(p);
}

__device__ __forceinline__ float load_stream(const __nv_bfloat16* p) {
  return bf16_lo(__ldcs(reinterpret_cast<const unsigned short*>(p)));
}

// stream variant: a warp a block row. Its stored values are one contiguous
// run, data[kb * bs .. ke * bs) with bs = br * bc; the warp reads it
// A = (32 / bs) * bs values a step, lane l at flat positions l, l + A, ...
// Since A is a multiple of bs, lane l keeps one position q = l % bs of every
// block it reads (row q / bc, column q % bc) and one accumulator: its
// blocks are kb + l / bs + i * (32 / bs). The block ids come 32 at a time,
// one a lane, handed round with __shfl_sync, so that a step's loads of
// values and of x wait on no load of its own; U steps are in flight.
template <typename T, typename A>
__global__ void __launch_bounds__(kStreamCta, 2048 / kStreamCta)
bsr_spmv_stream(const int* __restrict__ indptr,
                const int* __restrict__ indices, const T* __restrict__ data,
                const A* __restrict__ x, A* __restrict__ y, long long nbr,
                int br, int bc, long long nblocks) {
  constexpr int U = kStreamSteps;
  const long long bi =
      (static_cast<long long>(blockIdx.x) * kStreamCta + threadIdx.x) / 32;
  if (bi >= nbr) {
    return;  // the whole warp leaves together
  }
  const int lane = threadIdx.x & 31;
  const int bs = br * bc;
  const int slots = 32 / bs;   // blocks a step
  const int slot = lane / bs;  // lanes past slots * bs only reduce
  const int q = lane - slot * bs;
  const int r = q / bc;
  const int c = q - r * bc;
  const bool live = slot < slots;
  long long ke = indptr[bi + 1];
  ke = ke < nblocks ? ke : nblocks;
  long long kb = indptr[bi];
  kb = kb < ke ? kb : ke;
  const int n = static_cast<int>(ke - kb);  // indptr is int32
  const int* ind = indices + kb;
  const T* dq = data + kb * bs + q;
  const A* xc = x + c;
  A acc = A(0);
  for (int k0 = 0; k0 < n; k0 += 32) {
    const int nb = n - k0 < 32 ? n - k0 : 32;
    const int mine = lane < nb ? __ldg(ind + k0 + lane) : 0;
    const T* d = dq + static_cast<long long>(k0) * bs;
    for (int j0 = slot; j0 - slot < nb; j0 += U * slots) {
      A dv[U], xv[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int j = j0 + u * slots;  // past 31 only where not read
        const int col = __shfl_sync(0xffffffffu, mine, j & 31);
        if (live && j < nb) {
          dv[u] = load_stream(d + j * bs);
          xv[u] = __ldg(xc + static_cast<long long>(col) * bc);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (live && j0 + u * slots < nb) {
          acc += dv[u] * xv[u];
        }
      }
    }
  }
  // A fixed tree over the bc lanes of a block's row, then over the slots:
  // lane r * bc (slot 0, column 0) ends with row r's sum.
  for (int off = 1; off < bc; off <<= 1) {
    const A v = __shfl_down_sync(0xffffffffu, acc, off);
    if ((c & (2 * off - 1)) == 0 && c + off < bc) {
      acc += v;
    }
  }
  for (int off = 1; off < slots; off <<= 1) {
    const A v = __shfl_down_sync(0xffffffffu, acc, off * bs);
    if ((slot & (2 * off - 1)) == 0 && slot + off < slots) {
      acc += v;
    }
  }
  if (slot == 0 && c == 0) {
    y[bi * br + r] = acc;
  }
}

template <typename T, typename A>
struct Args {
  const void* indptr;
  const void* indices;
  const void* data;
  const void* x;
  void* y;
  long long nbr;
  int br;
  int bc;
  long long nblocks;
  cudaStream_t stream;
};

template <typename T, typename A>
int run(void (*kernel)(const int*, const int*, const T*, const A*, A*,
                       long long, int, int, long long),
        long long threads, long long extent, const Args<T, A>& a,
        int cta = kThreads) {
  const long long blocks = (threads + cta - 1) / cta;
  if (blocks > 2147483647LL) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  kernel<<<static_cast<unsigned>(blocks), cta, 0, a.stream>>>(
      static_cast<const int*>(a.indptr), static_cast<const int*>(a.indices),
      static_cast<const T*>(a.data), static_cast<const A*>(a.x),
      static_cast<A*>(a.y), extent, a.br, a.bc, a.nblocks);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename A, int L>
int scalar_l(const Args<T, A>& a) {
  const long long nrows = a.nbr * a.br;
  return run<T, A>(bsr_spmv_scalar<T, A, L>, nrows * L, nrows, a);
}

template <typename T, typename A>
int scalar(const Args<T, A>& a) {
  const int bc = a.bc;
  if (bc == 1) return scalar_l<T, A, 1>(a);
  if (bc == 2) return scalar_l<T, A, 2>(a);
  if (bc <= 4) return scalar_l<T, A, 4>(a);
  if (bc <= 8) return scalar_l<T, A, 8>(a);
  if (bc <= 16) return scalar_l<T, A, 16>(a);
  return scalar_l<T, A, 32>(a);
}

template <typename T, typename A, int S>
int rows_s(const Args<T, A>& a, int nvec) {
  const long long threads =
      a.nbr * static_cast<long long>((a.br + S - 1) / S) * S;
  if (nvec == 1) return run<T, A>(bsr_spmv_rows<T, A, S, 1>, threads, a.nbr, a);
  if (nvec == 2) return run<T, A>(bsr_spmv_rows<T, A, S, 2>, threads, a.nbr, a);
  if (nvec == 3) return run<T, A>(bsr_spmv_rows<T, A, S, 3>, threads, a.nbr, a);
  return run<T, A>(bsr_spmv_rows<T, A, S, 4>, threads, a.nbr, a);
}

template <typename T, typename A, int L>
int lanes_l(const Args<T, A>& a) {
  constexpr int R = Lanes<T>::R;
  const long long tiles = a.nbr * static_cast<long long>((a.br + R - 1) / R);
  return run<T, A>(bsr_spmv_lanes<T, A, L>, tiles * L, a.nbr, a);
}

template <typename T, typename A>
int vector(const Args<T, A>& a) {
  const int nvec = a.bc * static_cast<int>(sizeof(T)) / 16;
  if (nvec <= 4) {
    const int br = a.br;
    if (br == 1) return rows_s<T, A, 1>(a, nvec);
    if (br == 2) return rows_s<T, A, 2>(a, nvec);
    if (br <= 4) return rows_s<T, A, 4>(a, nvec);
    if (br <= 8) return rows_s<T, A, 8>(a, nvec);
    if (br <= 16) return rows_s<T, A, 16>(a, nvec);
    return rows_s<T, A, 32>(a, nvec);
  }
  if (nvec <= 8) return lanes_l<T, A, 8>(a);
  if (nvec <= 16) return lanes_l<T, A, 16>(a);
  return lanes_l<T, A, 32>(a);
}

template <typename T, typename A>
int launch(const void* indptr, const void* indices, const void* data,
           const void* x, void* y, long long nbr, int br, int bc,
           long long nblocks, int variant, void* stream) {
  if (nbr < 0 || br < 1 || bc < 1 || nblocks < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool vector_ok =
      (static_cast<long long>(bc) * sizeof(T)) % 16 == 0 &&
      reinterpret_cast<std::uintptr_t>(data) % 16 == 0 &&
      reinterpret_cast<std::uintptr_t>(x) % 16 == 0;
  const bool stream_ok = static_cast<long long>(br) * bc <= 32;
  if (variant != kScalar && !(variant == kVector && vector_ok) &&
      !(variant == kStream && stream_ok)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (nbr == 0) {
    return static_cast<int>(cudaSuccess);
  }
  const Args<T, A> a{indptr, indices, data, x, y, nbr, br, bc, nblocks,
                     static_cast<cudaStream_t>(stream)};
  if (variant == kStream) {
    return run<T, A>(bsr_spmv_stream<T, A>, a.nbr * 32, a.nbr, a,
                     kStreamCta);
  }
  return variant == kVector ? vector<T, A>(a) : scalar<T, A>(a);
}

}  // namespace

extern "C" int spal_bsr_spmv_f32(const void* indptr, const void* indices,
                                 const void* data, const void* x, void* y,
                                 long long nbr, int br, int bc,
                                 long long nblocks, int variant,
                                 void* stream) {
  return launch<float, float>(indptr, indices, data, x, y, nbr, br, bc,
                              nblocks, variant, stream);
}

extern "C" int spal_bsr_spmv_bf16(const void* indptr, const void* indices,
                                  const void* data, const void* x, void* y,
                                  long long nbr, int br, int bc,
                                  long long nblocks, int variant,
                                  void* stream) {
  return launch<__nv_bfloat16, float>(indptr, indices, data, x, y, nbr, br,
                                      bc, nblocks, variant, stream);
}

extern "C" int spal_bsr_spmv_f64(const void* indptr, const void* indices,
                                 const void* data, const void* x, void* y,
                                 long long nbr, int br, int bc,
                                 long long nblocks, int variant,
                                 void* stream) {
  return launch<double, double>(indptr, indices, data, x, y, nbr, br, bc,
                                nblocks, variant, stream);
}
