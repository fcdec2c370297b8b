// DIA (diagonal storage) sparse matrix-vector product for Hopper (sm_90a).
//
// Row-aligned storage: data[k * nrows + i] = A[i, i + offsets[k]]. Forward:
//
//   y[i]  = sum over k = 0..D-1 of data[k, i] * x[i + offsets[k]]     (nrows)
//
// and, with the transposed flag, the gradient to x of that product:
//
//   dx[j] = sum over k = 0..D-1 of data[k, j - offsets[k]] * g[j - offsets[k]]
//           for the k with 0 <= j - offsets[k] < nrows                (ncols)
//
// Replaces the two Pallas kernels of the JAX package's DIA SpMV:
//   spalinalg_tpu/ops/kernels/dia_stream.py  _dia_kernel     (f32)
//   spalinalg_tpu/ops/kernels/dia_df.py      _dia_df_kernel  (f64 as (hi, lo) f32)
// Their VMEM-resident padded x, lane rolls with sublane carry, 128 x 128
// row tiles, diagonal caps (64 and 48) and double-float planes with
// TwoProd/TwoSum exist because the TPU has no unaligned gathers and no
// native f64. Hopper reads x at any offset and has fp64, so one kernel,
// instantiated for float and double, reads the storage directly.
//
// What bounds it on this card: bytes. Each call must read the D diagonals
// (sizeof(T) * D * nrows), read x and write y (sizeof(T) * (ncols + nrows)
// in all; about (sizeof(T) * D + 2 * sizeof(T)) * nrows for a square
// matrix) and the D offsets. Two flops per stored slot are far below the
// card's arithmetic rate.
//
// What the design does about it: one thread per output entry, grid-stride.
// For each k, neighbouring threads read neighbouring data[k, i] and
// neighbouring x[i + offsets[k]], so every stream is coalesced; the shifted
// x windows of the D diagonals overlap and are served from L1/L2, so x is
// read from device memory about once. The offsets live in a small device
// array (D is not bounded); every thread of a warp reads the same offset,
// a broadcast. A column outside [0, ncols) reads x as 0 and is still
// multiplied, as both JAX paths do. The diagonals are summed in the fixed
// order k = 0..D-1 (the order of the JAX package's _matvec_xla), with no
// atomics, so a result is bitwise the same from run to run. The transposed
// pass reads data in place: no transposed copy is built. Staging an x tile
// and its halo in shared memory does not suit offsets of +-65,536 (a 3-D
// stencil) and is later work.
//
// C interface: one entry point per type. Each launches on the given stream,
// allocates nothing, does not synchronise, and returns cudaGetLastError().
// An empty output launches nothing; D == 0 is handled by the caller.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132LL * 64;  // grid-stride beyond this

template <typename T>
__global__ void __launch_bounds__(kThreads)
dia_spmv_kernel(const long long* __restrict__ offsets, int ndiag,
                const T* __restrict__ data, const T* __restrict__ x,
                T* __restrict__ y, long long nrows, long long ncols) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < nrows; i += stride) {
    T sum = T(0);
#pragma unroll 4
    for (int k = 0; k < ndiag; ++k) {
      const long long j = i + __ldg(offsets + k);
      const T xv = (j >= 0 && j < ncols) ? __ldg(x + j) : T(0);
      sum += __ldg(data + static_cast<long long>(k) * nrows + i) * xv;
    }
    y[i] = sum;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
dia_spmv_t_kernel(const long long* __restrict__ offsets, int ndiag,
                  const T* __restrict__ data, const T* __restrict__ g,
                  T* __restrict__ dx, long long nrows, long long ncols) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long j = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       j < ncols; j += stride) {
    T sum = T(0);
#pragma unroll 4
    for (int k = 0; k < ndiag; ++k) {
      const long long i = j - __ldg(offsets + k);
      if (i >= 0 && i < nrows) {
        sum += __ldg(data + static_cast<long long>(k) * nrows + i) *
               __ldg(g + i);
      }
    }
    dx[j] = sum;
  }
}

template <typename T>
int launch(const void* offsets, int ndiag, const void* data, const void* x,
           void* y, long long nrows, long long ncols, int transposed,
           void* stream) {
  if (nrows < 0 || ncols < 0 || ndiag < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long n_out = transposed ? ncols : nrows;
  if (n_out == 0) {
    return static_cast<int>(cudaSuccess);
  }
  long long blocks = (n_out + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) {
    blocks = kMaxBlocks;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long* off = static_cast<const long long*>(offsets);
  if (transposed) {
    dia_spmv_t_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        off, ndiag, static_cast<const T*>(data), static_cast<const T*>(x),
        static_cast<T*>(y), nrows, ncols);
  } else {
    dia_spmv_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        off, ndiag, static_cast<const T*>(data), static_cast<const T*>(x),
        static_cast<T*>(y), nrows, ncols);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// (offsets, ndiag, data, x, y, nrows, ncols, transposed, stream): x has
// ncols entries and y nrows, or with transposed != 0 x is g (nrows) and y
// is dx (ncols).
extern "C" int spal_dia_spmv_f32(const void* offsets, int ndiag,
                                 const void* data, const void* x, void* y,
                                 long long nrows, long long ncols,
                                 int transposed, void* stream) {
  return launch<float>(offsets, ndiag, data, x, y, nrows, ncols, transposed,
                       stream);
}

extern "C" int spal_dia_spmv_f64(const void* offsets, int ndiag,
                                 const void* data, const void* x, void* y,
                                 long long nrows, long long ncols,
                                 int transposed, void* stream) {
  return launch<double>(offsets, ndiag, data, x, y, nrows, ncols, transposed,
                        stream);
}
