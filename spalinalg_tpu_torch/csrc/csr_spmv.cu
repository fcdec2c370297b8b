// CSR sparse matrix-vector product for Hopper (sm_90a): y = A x.
//
//   y[i] = sum over p in [rowptr[i], rowptr[i+1]) of values[p] * x[colind[p]]
//
// Replaces the four Pallas kernels of the JAX package's CSR SpMV:
//   spalinalg_tpu/ops/kernels/csr_route.py     _route_kernel       (f32)
//   spalinalg_tpu/ops/kernels/csr_route.py     _route_kernel_pk    (f32, packed pages)
//   spalinalg_tpu/ops/kernels/csr_route_df.py  _route_kernel_df    (f64 as (hi, lo) f32)
//   spalinalg_tpu/ops/kernels/csr_route_df.py  _route_kernel_df_pk (the same, packed)
// Their host-built routing plan, lane-gather network, spill recursion and
// double-float arithmetic exist because the TPU serialises dynamic gathers
// and has no native f64. Hopper gathers natively and has fp64, so this one
// kernel reads rowptr/colind/values directly and is instantiated for float
// and double. It accumulates in its own type, as the JAX f32 route does.
//
// What bounds it on this card: bytes. Every stored entry streams its value
// and its column index once (sizeof(T) + 4 bytes), and gathers one x entry
// (sizeof(T), served from the 50 MB L2 while x fits there); every row reads
// two rowptr entries and writes one y. One FMA per entry is far below the
// card's arithmetic rate.
//
// What the design does about it (vector CSR): a group of L lanes of one
// warp owns a row, L a power of two from 1 to 32 chosen by the caller from
// the mean row length. Neighbouring lanes read neighbouring values and
// indices, so the stream is coalesced, and short rows do not leave most of
// a warp idle. Each lane strides over its row by L; a fixed __shfl_down_sync
// tree sums the lanes. There are no atomics, and the summation order depends
// only on the structure and L, so a result is bitwise the same from run to
// run. Slots past rowptr[nrows] are never read; an empty row gives 0.
// Splitting very long rows across warps and staging through shared memory
// are later work.
//
// C interface: one entry point per type. Each launches on the given stream,
// allocates nothing, does not synchronise, and returns cudaGetLastError().
// nrows == 0 launches nothing (a grid of 0 blocks is a launch error); the
// caller handles a matrix with no stored slots.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <typename T, int L>
__global__ void __launch_bounds__(kThreads)
csr_spmv_kernel(const int* __restrict__ rowptr, const int* __restrict__ colind,
                const T* __restrict__ values, const T* __restrict__ x,
                T* __restrict__ y, long long nrows) {
  const long long row =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) / L;
  const int lane = threadIdx.x & (L - 1);
  T sum = T(0);
  if (row < nrows) {
    const long long end = rowptr[row + 1];
    for (long long p = rowptr[row] + lane; p < end; p += L) {
      sum += values[p] * __ldg(x + colind[p]);
    }
  }
  // No lane returns early, so every lane of the warp reaches each shuffle
  // and the full mask is valid; width L keeps the rows' groups apart.
#pragma unroll
  for (int offset = L / 2; offset > 0; offset >>= 1) {
    sum += __shfl_down_sync(0xffffffffu, sum, offset, L);
  }
  if (row < nrows && lane == 0) {
    y[row] = sum;
  }
}

template <typename T, int L>
int launch_lanes(const void* rowptr, const void* colind, const void* values,
                 const void* x, void* y, long long nrows,
                 cudaStream_t stream) {
  const long long blocks = (nrows * L + kThreads - 1) / kThreads;
  if (blocks > 2147483647LL) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  csr_spmv_kernel<T, L><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const int*>(rowptr), static_cast<const int*>(colind),
      static_cast<const T*>(values), static_cast<const T*>(x),
      static_cast<T*>(y), nrows);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* rowptr, const void* colind, const void* values,
           const void* x, void* y, long long nrows, int lanes, void* stream) {
  if (nrows < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (nrows == 0) {
    return static_cast<int>(cudaSuccess);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (lanes) {
    case 1: return launch_lanes<T, 1>(rowptr, colind, values, x, y, nrows, s);
    case 2: return launch_lanes<T, 2>(rowptr, colind, values, x, y, nrows, s);
    case 4: return launch_lanes<T, 4>(rowptr, colind, values, x, y, nrows, s);
    case 8: return launch_lanes<T, 8>(rowptr, colind, values, x, y, nrows, s);
    case 16: return launch_lanes<T, 16>(rowptr, colind, values, x, y, nrows, s);
    case 32: return launch_lanes<T, 32>(rowptr, colind, values, x, y, nrows, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int spal_csr_spmv_f32(const void* rowptr, const void* colind,
                                 const void* values, const void* x, void* y,
                                 long long nrows, int lanes, void* stream) {
  return launch<float>(rowptr, colind, values, x, y, nrows, lanes, stream);
}

extern "C" int spal_csr_spmv_f64(const void* rowptr, const void* colind,
                                 const void* values, const void* x, void* y,
                                 long long nrows, int lanes, void* stream) {
  return launch<double>(rowptr, colind, values, x, y, nrows, lanes, stream);
}

extern "C" const char* spal_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
