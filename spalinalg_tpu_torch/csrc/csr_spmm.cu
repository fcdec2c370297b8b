// CSR sparse matrix times dense matrix for Hopper (sm_90a): Y = A X.
//
//   Y[i, c] = sum over p in [rowptr[i], rowptr[i+1]) of values[p] * X[colind[p], c]
//
// X is (ncols, k) and Y is (nrows, k), both row-major and contiguous.
//
// Replaces the two Pallas kernels of the JAX package's CSR SpMM:
//   spalinalg_tpu/ops/kernels/csr_route.py  _route_spmm_kernel     (B2a)
//   spalinalg_tpu/ops/kernels/csr_route.py  _route_spmm_kernel_pk  (B2b, packed pages)
// Their routing plan, lane-gather tables, spill recursion and the 1 <= k <= 64
// limit (a VMEM budget for the per-page X tile) work around TPU limits.
// Hopper gathers rows of X natively, so this kernel reads
// rowptr/colind/values directly, takes any k, and is instantiated for float
// and double. It accumulates in its own type.
//
// What bounds it on this card: bytes. Every stored entry streams its value
// and column index once (sizeof(T) + 4 bytes) and gathers one row of X,
// k * sizeof(T) bytes (256 B at k = 64 in float), from L2 or device memory.
// Two flops per gathered element are far below the card's arithmetic rate.
//
// What the design does about it: one warp owns one row. The lanes cover the
// k columns in groups of G lanes, G the power of two from 1 to 32 that covers
// k, so a gathered row of X is read by neighbouring lanes at neighbouring
// addresses (coalesced). For k > 32 a lane holds NT = 2 column tiles and
// passes over column blocks of 64; for k < 32 the warp splits into 32 / G
// sub-groups that take different entries of the row at once. The warp loads
// 32 entries (index and value) cooperatively and broadcasts each with
// __shfl_sync. Sub-group sums meet in a fixed __shfl_down_sync tree. There are
// no atomics and the summation order depends only on the structure and k, so
// a result is bitwise the same from run to run. Slots past rowptr[nrows] are
// never read; an empty row gives 0. Offsets into X and Y are 64-bit, since
// ncols * k passes 2^31 well inside the card's memory.
//
// C interface: one entry point per type. Each launches on the given stream,
// allocates nothing, does not synchronise, and returns cudaGetLastError().
// nrows == 0 or k == 0 launches nothing.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarp = 32;
constexpr int kRowsPerBlock = kThreads / kWarp;

template <typename T, int G, int NT>
__global__ void __launch_bounds__(kThreads)
csr_spmm_kernel(const int* __restrict__ rowptr, const int* __restrict__ colind,
                const T* __restrict__ values, const T* __restrict__ X,
                T* __restrict__ Y, long long nrows, long long k) {
  constexpr int S = kWarp / G;  // sub-groups: entries in flight per warp
  const long long row =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) / kWarp;
  if (row >= nrows) {
    return;  // the whole warp leaves together: row is uniform in a warp
  }
  const int lane = threadIdx.x & (kWarp - 1);
  const int sub = lane / G;
  const int c0 = lane % G;
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
        v = values[p0 + lane];
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
      T* yr = Y + row * k + cb + c0;
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        if (cb + c0 + t * G < k) {
          yr[t * G] = acc[t];
        }
      }
    }
  }
}

template <typename T, int G, int NT>
int launch_g(const void* rowptr, const void* colind, const void* values,
             const void* X, void* Y, long long nrows, long long k,
             cudaStream_t stream) {
  const long long blocks = (nrows + kRowsPerBlock - 1) / kRowsPerBlock;
  if (blocks > 2147483647LL) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  csr_spmm_kernel<T, G, NT><<<static_cast<unsigned>(blocks), kThreads, 0,
                              stream>>>(
      static_cast<const int*>(rowptr), static_cast<const int*>(colind),
      static_cast<const T*>(values), static_cast<const T*>(X),
      static_cast<T*>(Y), nrows, k);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* rowptr, const void* colind, const void* values,
           const void* X, void* Y, long long nrows, long long k,
           void* stream) {
  if (nrows < 0 || k < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (nrows == 0 || k == 0) {
    return static_cast<int>(cudaSuccess);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k == 1) return launch_g<T, 1, 1>(rowptr, colind, values, X, Y, nrows, k, s);
  if (k == 2) return launch_g<T, 2, 1>(rowptr, colind, values, X, Y, nrows, k, s);
  if (k <= 4) return launch_g<T, 4, 1>(rowptr, colind, values, X, Y, nrows, k, s);
  if (k <= 8) return launch_g<T, 8, 1>(rowptr, colind, values, X, Y, nrows, k, s);
  if (k <= 16) return launch_g<T, 16, 1>(rowptr, colind, values, X, Y, nrows, k, s);
  if (k <= 32) return launch_g<T, 32, 1>(rowptr, colind, values, X, Y, nrows, k, s);
  return launch_g<T, 32, 2>(rowptr, colind, values, X, Y, nrows, k, s);
}

}  // namespace

extern "C" int spal_csr_spmm_f32(const void* rowptr, const void* colind,
                                 const void* values, const void* X, void* Y,
                                 long long nrows, long long k, void* stream) {
  return launch<float>(rowptr, colind, values, X, Y, nrows, k, stream);
}

extern "C" int spal_csr_spmm_f64(const void* rowptr, const void* colind,
                                 const void* values, const void* X, void* Y,
                                 long long nrows, long long k, void* stream) {
  return launch<double>(rowptr, colind, values, X, Y, nrows, k, stream);
}
