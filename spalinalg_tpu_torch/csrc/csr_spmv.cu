// CSR sparse matrix-vector product for Hopper (sm_90a): y = A x.
//
//   y[i] = sum over p in [rowptr[i], rowptr[i+1]) of values[q(p)] * x[colind[p]]
//
// with q(p) = p, or q(p) = perm[p] when a perm array is given: the
// backward's Aᵀ·g runs on the cached transpose and reads the forward's
// values through its permutation, or (the bucket route, csr_transpose.cu)
// the values bucketed by column block through bperm, instead of a
// gathered copy of them.
//
// Replaces the four Pallas kernels of the JAX package's CSR SpMV:
//   spalinalg_tpu/ops/kernels/csr_route.py     _route_kernel       (f32)
//   spalinalg_tpu/ops/kernels/csr_route.py     _route_kernel_pk    (f32, packed pages)
//   spalinalg_tpu/ops/kernels/csr_route_df.py  _route_kernel_df    (f64 as (hi, lo) f32)
//   spalinalg_tpu/ops/kernels/csr_route_df.py  _route_kernel_df_pk (the same, packed)
// Their host-built routing plan, lane-gather network, spill recursion and
// double-float arithmetic exist because the TPU serialises dynamic gathers
// and has no native f64. Hopper gathers natively and has fp64, so this
// source reads rowptr/colind/values directly and is instantiated for float
// and double. It accumulates in its own type, as the JAX f32 route does.
//
// What bounds it on this card. Compulsory bytes: every stored entry
// streams its value and column index once (sizeof(T) + 4 bytes), and x and
// y once: 0.168 / 0.253 ms at n = 2^21 with 32 entries a row. But every
// entry also gathers one x element at a random column, and a 4- or 8-byte
// gather moves a whole 32-byte L2 sector to the SM: 2.15 GB of L2 traffic
// a product there, with x (8 / 16 MB) resident in the 50 MB L2. So the
// kernel is bound by keeping enough gathers in flight, behind loads that
// move as many bytes per instruction as they can.
//
// Two variants; the caller names one (the wrapper's csr_spmv_variant) and
// the entry point refuses arguments that do not suit it:
//
// vector (colind, values and perm start on a 16-byte boundary; a plan built
// once per structure, see below). Two kinds of warp, in one launch:
// - A window warp owns the rows whose first entry lies in its window of
//   kBudget = 256 entries, [w * 256, (w + 1) * 256), less a last row longer
//   than kBudget. Those rows' entries span fewer than 2 * kBudget slots.
//   Each lane streams 16-byte vectors of colind and values (int4 with
//   float4 or two double2, or int4 of perm and four gathered values) with
//   __ldcs (evict first: they are read once), two vectors at a time; a
//   scalar head and tail take the entries before the first and after the
//   last 16-byte boundary. Each lane issues all of its x gathers (__ldg,
//   eight in flight) before it multiplies, and parks the products in the
//   warp's slice of shared memory. Then the rows are closed by a fixed
//   segmented reduction: with R <= 32 rows, a group of G lanes a row (G the
//   largest power of two with G * R <= 32) sums the row's products strided
//   by G and ends in a __shfl_xor_sync tree; with more rows, a lane a row
//   sums them in order. At 32 entries a row a warp owns 8 rows, 256
//   entries, and each lane moves 2 x 16 bytes of indices and of values.
// - A piece warp owns one piece of kBudget entries of a long row (longer
//   than kBudget), sums its products in a fixed order (a lane's own
//   entries, then a __shfl_xor_sync tree), and writes the partial to
//   scratch. A second kernel then adds each long row's partials in piece
//   order, one thread a row.
// The plan (the wrapper's csr_spmv_plan, cached with the structure) holds,
// as one int32 array: four numbers a window (its first row, the row past
// its last short row, and their entry range, read as one int4), each
// piece's row and first entry, the long rows and the first piece of each.
//
// scalar (everything else: colind, values or perm off a 16-byte boundary).
// The first design, kept for those views: a group of L lanes of one warp
// owns a row, L a power of two from 1 to 32 chosen by the caller from the
// mean row length; each lane strides over the row by L, one entry (three
// dependent loads) at a time, and a fixed __shfl_down_sync tree ends it.
//
// products (x == nullptr; the vector variant, on a structure that splits no
// row). The values are the products already: the SpMV backward's
// "products" route (csr_transpose.cu) hands the kernel values[p]·g[row p]
// bucketed by column block, read through bperm. The window warps stage
// them as they are, where the other instance stages values·x, and sum them
// in the same order: the same bits, with no column id read and no gather
// of x. The piece path would fuse the products into its sum (an FMA), so
// this instance has none and the entry point refuses a plan with pieces.
//
// Both: no atomics, and the summation order depends only on the structure
// (and L), so a result is bitwise the same from run to run. Every row is
// written, an empty row with 0. Slots past rowptr[nrows] are never read.
// Registers (ptxas -v, nvcc 12.9, sm_90a), no spills in any instance: the
// window/piece kernel 40 (float) and 48 (double), with 18.7 / 37.4 KB of
// shared memory a block, its products instance 40 / 44; the scalar kernel
// 32; the finishing kernel 31 / 28.
//
// C interface: one entry point per type. Each launches on the given stream,
// allocates nothing, does not synchronise, and returns cudaGetLastError(),
// or cudaErrorInvalidValue for arguments the variant does not take (x ==
// nullptr: the products instance).
// nrows == 0 launches nothing (a grid of 0 blocks is a launch error); the
// caller handles a matrix with no stored slots.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBudget = 256;          // entries a window or a piece
constexpr int kSpan = 2 * kBudget;    // a window's rows span fewer slots
// Staged products a warp: kSpan + 3 offsets from the aligned base, with 4
// slots of skew after every 32 (stage_index).
constexpr int kStage = kSpan + 4 + 4 * (kSpan / 32 + 1);
constexpr int kScalar = 0;
constexpr int kVector = 1;
constexpr unsigned kFull = 0xffffffffu;

template <typename T, int L>
__global__ void __launch_bounds__(kThreads)
csr_spmv_scalar(const int* __restrict__ rowptr, const int* __restrict__ colind,
                const T* __restrict__ values, const int* __restrict__ perm,
                const T* __restrict__ x, T* __restrict__ y, long long nrows) {
  const long long row =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) / L;
  const int lane = threadIdx.x & (L - 1);
  T sum = T(0);
  if (row < nrows) {
    const long long end = rowptr[row + 1];
    for (long long p = rowptr[row] + lane; p < end; p += L) {
      const T v = perm == nullptr ? values[p] : __ldg(values + perm[p]);
      sum += v * __ldg(x + colind[p]);
    }
  }
  // No lane returns early, so every lane of the warp reaches each shuffle
  // and the full mask is valid; width L keeps the rows' groups apart.
#pragma unroll
  for (int offset = L / 2; offset > 0; offset >>= 1) {
    sum += __shfl_down_sync(kFull, sum, offset, L);
  }
  if (row < nrows && lane == 0) {
    y[row] = sum;
  }
}

// Four consecutive stored values from 16-byte aligned storage, or through
// four perm entries (one int4 of perm, four gathers).
template <typename T>
struct Quad {
  T v[4];
};

__device__ __forceinline__ Quad<float> load_quad(const float* values, int p) {
  const float4 a = __ldcs(reinterpret_cast<const float4*>(values + p));
  return {{a.x, a.y, a.z, a.w}};
}

__device__ __forceinline__ Quad<double> load_quad(const double* values,
                                                  int p) {
  const double2 a = __ldcs(reinterpret_cast<const double2*>(values + p));
  const double2 b = __ldcs(reinterpret_cast<const double2*>(values + p) + 1);
  return {{a.x, a.y, b.x, b.y}};
}

template <typename T>
__device__ __forceinline__ Quad<T> load_quad_perm(const T* values,
                                                  const int* perm, int p) {
  const int4 q = __ldcs(reinterpret_cast<const int4*>(perm + p));
  return {{__ldg(values + q.x), __ldg(values + q.y), __ldg(values + q.z),
           __ldg(values + q.w)}};
}

template <typename T>
__device__ __forceinline__ T load_one(const T* values, const int* perm,
                                      int p) {
  return perm == nullptr ? __ldcs(values + p) : __ldg(values + __ldcs(perm + p));
}

// Where the product of entry offset o (from the window's 16-byte aligned
// base) is staged: 4 slots of skew after every 32, so that the rows of a
// window (32 entries apart at 32 entries a row) fall on different banks
// when a lane group reads them, and a quad still starts on 16 bytes.
__device__ __forceinline__ int stage_index(int o) { return o + 4 * (o >> 5); }

__device__ __forceinline__ void stage_quad(float* sm, int o, float a, float b,
                                           float c, float d) {
  *reinterpret_cast<float4*>(sm + stage_index(o)) = make_float4(a, b, c, d);
}

__device__ __forceinline__ void stage_quad(double* sm, int o, double a,
                                           double b, double c, double d) {
  double2* q = reinterpret_cast<double2*>(sm + stage_index(o));
  q[0] = make_double2(a, b);
  q[1] = make_double2(c, d);
}

// The products of the entries [e0, e1) that lane `lane` owns, in a fixed
// order: first its head or tail entry (lanes 0-2 the entries before the
// first 16-byte boundary, lanes 3-5 those after the last), then its
// 16-byte vectors, two a round, lane + 32 * i. All of a round's x gathers
// are issued before any product is formed. With STAGE the products go to
// shared memory (sm, at offsets from base = e0 rounded down to 16 bytes)
// and 0 is returned; else the lane's sum of them is. With PROD the values
// are the products already (colind and x are not read): staged as they
// are, they are the bits the products of values and x would have.
template <typename T, bool STAGE, bool PROD>
__device__ __forceinline__ T products(const int* __restrict__ colind,
                                      const T* __restrict__ values,
                                      const int* __restrict__ perm,
                                      const T* __restrict__ x, int e0, int e1,
                                      int lane, T* sm) {
  static_assert(STAGE || !PROD, "given products are only staged");
  const int base = e0 & ~3;
  const int h = min((e0 + 3) & ~3, e1);
  const int t = max(e1 & ~3, h);
  T sum = T(0);
  {
    const int p = lane < 3 ? e0 + lane : t + lane - 3;
    if (lane < 6 && p < (lane < 3 ? h : e1)) {
      const T prod = PROD ? load_one(values, perm, p)
                          : load_one(values, perm, p) *
                                __ldg(x + __ldcs(colind + p));
      if (STAGE) {
        sm[stage_index(p - base)] = prod;
      } else {
        sum += prod;
      }
    }
  }
  const int nq = (t - h) >> 2;
  for (int q0 = lane; q0 < nq; q0 += 64) {
    const int q1 = q0 + 32;
    const bool two = q1 < nq;
    const int p0 = h + 4 * q0;
    const int p1 = h + 4 * (two ? q1 : q0);
    // The column ids load first, ahead of the values: issuing them after
    // the values made the float64 product 23 % slower on the H100.
    int4 c0 = make_int4(0, 0, 0, 0);
    int4 c1 = c0;
    if (!PROD) {
      c0 = __ldcs(reinterpret_cast<const int4*>(colind + p0));
      c1 = __ldcs(reinterpret_cast<const int4*>(colind + p1));
    }
    const Quad<T> v0 = perm == nullptr ? load_quad(values, p0)
                                       : load_quad_perm(values, perm, p0);
    const Quad<T> v1 = perm == nullptr ? load_quad(values, p1)
                                       : load_quad_perm(values, perm, p1);
    if (PROD) {
      stage_quad(sm, p0 - base, v0.v[0], v0.v[1], v0.v[2], v0.v[3]);
      if (two) {
        stage_quad(sm, p1 - base, v1.v[0], v1.v[1], v1.v[2], v1.v[3]);
      }
      continue;
    }
    const T x0 = __ldg(x + c0.x), x1 = __ldg(x + c0.y);
    const T x2 = __ldg(x + c0.z), x3 = __ldg(x + c0.w);
    const T x4 = __ldg(x + c1.x), x5 = __ldg(x + c1.y);
    const T x6 = __ldg(x + c1.z), x7 = __ldg(x + c1.w);
    if (STAGE) {
      stage_quad(sm, p0 - base, v0.v[0] * x0, v0.v[1] * x1, v0.v[2] * x2,
                 v0.v[3] * x3);
      if (two) {
        stage_quad(sm, p1 - base, v1.v[0] * x4, v1.v[1] * x5, v1.v[2] * x6,
                   v1.v[3] * x7);
      }
    } else {
      sum += v0.v[0] * x0;
      sum += v0.v[1] * x1;
      sum += v0.v[2] * x2;
      sum += v0.v[3] * x3;
      if (two) {
        sum += v1.v[0] * x4;
        sum += v1.v[1] * x5;
        sum += v1.v[2] * x6;
        sum += v1.v[3] * x7;
      }
    }
  }
  return sum;
}

template <typename T, bool PROD>
__global__ void __launch_bounds__(kThreads)
csr_spmv_vector(const int* __restrict__ rowptr, const int* __restrict__ colind,
                const T* __restrict__ values, const int* __restrict__ perm,
                const T* __restrict__ x, T* __restrict__ y,
                const int* __restrict__ plan, int nwin, int npieces,
                T* __restrict__ partial) {
  __shared__ __align__(16) T staged[kWarps][kStage];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long w = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (w >= nwin) {
    // A piece of a long row (never with PROD: the entry point refuses a
    // plan with pieces there). The warp leaves together: w is uniform.
    if constexpr (!PROD) {
      const long long piece = w - nwin;
      if (piece >= npieces) {
        return;
      }
      const int* piece_row = plan + 4 * nwin;
      const int row = piece_row[piece];
      const int e0 = piece_row[npieces + piece];  // piece_start
      const int e1 = min(e0 + kBudget, __ldg(rowptr + row + 1));
      T sum = products<T, false, false>(colind, values, perm, x, e0, e1, lane,
                                        nullptr);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        sum += __shfl_xor_sync(kFull, sum, off);
      }
      if (lane == 0) {
        partial[piece] = sum;
      }
    }
    return;
  }
  // The window: its rows [r0, r1) (a long last row already left out) and
  // their entries [e0, e1), in one 16-byte load.
  const int4 win = __ldg(reinterpret_cast<const int4*>(plan) + w);
  const int r0 = win.x, r1 = win.y, e0 = win.z, e1 = win.w;
  if (r1 == r0) {
    return;
  }
  const int base = e0 & ~3;
  const int nr = r1 - r0;
  int g_log = 5;
  while ((nr << g_log) > 32) {
    --g_log;
  }
  // With nr <= 32 rows, each lane's row bounds load before the products.
  const int row = r0 + (lane >> g_log);
  int lo = 0, hi = 0;
  if (nr <= 32 && row < r1) {
    lo = __ldg(rowptr + row) - base;
    hi = __ldg(rowptr + row + 1) - base;
  }
  T* sm = staged[warp];
  products<T, true, PROD>(colind, values, perm, x, e0, e1, lane, sm);
  __syncwarp();
  if (nr <= 32) {
    const int G = 1 << g_log;
    const int j = lane & (G - 1);
    const bool active = row < r1;
    T sum = T(0);
    for (int p = lo + j; p < hi; p += G) {
      sum += sm[stage_index(p)];
    }
    for (int off = G >> 1; off > 0; off >>= 1) {
      sum += __shfl_xor_sync(kFull, sum, off);
    }
    if (active && j == 0) {
      y[row] = sum;
    }
  } else {
    for (int row = r0 + lane; row < r1; row += 32) {
      const int b = __ldg(rowptr + row + 1) - base;
      T sum = T(0);
      for (int p = __ldg(rowptr + row) - base; p < b; ++p) {
        sum += sm[stage_index(p)];
      }
      y[row] = sum;
    }
  }
}

// y of each long row: its pieces' partials added in piece order.
template <typename T>
__global__ void __launch_bounds__(kThreads)
csr_spmv_finish(const int* __restrict__ long_rows,
                const int* __restrict__ first_piece,
                const T* __restrict__ partial, T* __restrict__ y, int nlong) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= nlong) {
    return;
  }
  T sum = T(0);
  for (int p = first_piece[i]; p < first_piece[i + 1]; ++p) {
    sum += partial[p];
  }
  y[long_rows[i]] = sum;
}

template <typename T, int L>
int launch_scalar(const int* rowptr, const int* colind, const T* values,
                  const int* perm, const T* x, T* y, long long nrows,
                  cudaStream_t stream) {
  const long long blocks = (nrows * L + kThreads - 1) / kThreads;
  if (blocks > 2147483647LL) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  csr_spmv_scalar<T, L><<<static_cast<unsigned>(blocks), kThreads, 0,
                          stream>>>(rowptr, colind, values, perm, x, y, nrows);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) {
  return reinterpret_cast<std::uintptr_t>(p) % 16 == 0;
}

template <typename T>
int launch(const void* rowptr_, const void* colind_, const void* values_,
           const void* perm_, const void* x_, void* y_, long long nrows,
           int lanes, int variant, const void* plan_, long long nwin,
           long long npieces, long long nlong, void* partial_, void* stream) {
  const int* rowptr = static_cast<const int*>(rowptr_);
  const int* colind = static_cast<const int*>(colind_);
  const T* values = static_cast<const T*>(values_);
  const int* perm = static_cast<const int*>(perm_);
  const T* x = static_cast<const T*>(x_);
  T* y = static_cast<T*>(y_);
  if (nrows < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (nrows == 0) {
    return static_cast<int>(cudaSuccess);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant == kScalar) {
    if (x == nullptr) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    switch (lanes) {
      case 1: return launch_scalar<T, 1>(rowptr, colind, values, perm, x, y, nrows, s);
      case 2: return launch_scalar<T, 2>(rowptr, colind, values, perm, x, y, nrows, s);
      case 4: return launch_scalar<T, 4>(rowptr, colind, values, perm, x, y, nrows, s);
      case 8: return launch_scalar<T, 8>(rowptr, colind, values, perm, x, y, nrows, s);
      case 16: return launch_scalar<T, 16>(rowptr, colind, values, perm, x, y, nrows, s);
      case 32: return launch_scalar<T, 32>(rowptr, colind, values, perm, x, y, nrows, s);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  const int* plan = static_cast<const int*>(plan_);
  T* partial = static_cast<T*>(partial_);
  // x == nullptr: the values are the products (the window path only).
  const bool prod = x == nullptr;
  if (variant != kVector || plan == nullptr || nwin < 1 || npieces < 0 ||
      (prod && npieces > 0) ||
      nlong < 0 || (npieces > 0 && (partial == nullptr || nlong == 0)) ||
      !aligned16(colind) || (perm == nullptr ? !aligned16(values)
                                             : !aligned16(perm)) ||
      nwin + npieces > 2147483647LL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long blocks = (nwin + npieces + kWarps - 1) / kWarps;
  auto kernel = prod ? csr_spmv_vector<T, true> : csr_spmv_vector<T, false>;
  kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      rowptr, colind, values, perm, x, y, plan, static_cast<int>(nwin),
      static_cast<int>(npieces), partial);
  if (nlong > 0) {
    const int* long_rows = plan + 4 * nwin + 2 * npieces;
    csr_spmv_finish<T><<<static_cast<unsigned>((nlong + kThreads - 1) /
                                               kThreads),
                         kThreads, 0, s>>>(long_rows, long_rows + nlong,
                                           partial, y,
                                           static_cast<int>(nlong));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int spal_csr_spmv_f32(const void* rowptr, const void* colind,
                                 const void* values, const void* perm,
                                 const void* x, void* y, long long nrows,
                                 int lanes, int variant, const void* plan,
                                 long long nwin, long long npieces,
                                 long long nlong, void* partial, void* stream) {
  return launch<float>(rowptr, colind, values, perm, x, y, nrows, lanes,
                       variant, plan, nwin, npieces, nlong, partial, stream);
}

extern "C" int spal_csr_spmv_f64(const void* rowptr, const void* colind,
                                 const void* values, const void* perm,
                                 const void* x, void* y, long long nrows,
                                 int lanes, int variant, const void* plan,
                                 long long nwin, long long npieces,
                                 long long nlong, void* partial, void* stream) {
  return launch<double>(rowptr, colind, values, perm, x, y, nrows, lanes,
                        variant, plan, nwin, npieces, nlong, partial, stream);
}

extern "C" const char* spal_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
