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
// kernel reads indptr/indices/data directly and is instantiated for three
// storage types: float, __nv_bfloat16 (converted with the intrinsics,
// accumulated in float) and double. x and y are in the accumulation type.
//
// What bounds it on this card: bytes. Every stored block streams once
// (br * bc * sizeof(T) bytes, 64 KB for a 128 x 128 float block) and its
// block-column index once; x (re-read by the br rows of a block row) is
// served from the 50 MB L2 while it fits there. One FMA per stored value
// is far below the card's arithmetic rate.
//
// What the design does about it: a group of L lanes of one warp owns a
// scalar row, L the power of two from 1 to 32 that covers bc. The lanes
// walk the bc contiguous values of the row's slice of each block, so a
// group reads neighbouring addresses (coalesced) and, for small blocks,
// the 32 / L groups of a warp read neighbouring rows of the same blocks.
// A fixed __shfl_down_sync tree within the group sums the lanes: there are
// no atomics and the summation order depends only on the structure, so a
// result is bitwise the same from run to run. Every row is written, rows
// of empty block rows with 0, so no mask pass follows. Blocks at or past
// min(indptr[nbr], nblocks) are never read. Offsets into data are 64-bit:
// nblocks * br * bc passes 2^31 at sizes users run. Staging blocks through
// shared memory with TMA, and tensor cores for bf16, are later work.
//
// C interface: one entry point per storage type. Each launches on the
// given stream, allocates nothing, does not synchronise, and returns
// cudaGetLastError(). nbr == 0 launches nothing; the caller handles a
// matrix with no blocks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float load_acc(const float* p) { return __ldg(p); }

__device__ __forceinline__ double load_acc(const double* p) { return __ldg(p); }

__device__ __forceinline__ float load_acc(const __nv_bfloat16* p) {
  const unsigned short bits = __ldg(reinterpret_cast<const unsigned short*>(p));
  return __bfloat162float(__ushort_as_bfloat16(bits));
}

template <typename T, typename A, int L>
__global__ void __launch_bounds__(kThreads)
bsr_spmv_kernel(const int* __restrict__ indptr, const int* __restrict__ indices,
                const T* __restrict__ data, const A* __restrict__ x,
                A* __restrict__ y, long long nrows, int br, int bc,
                long long nblocks) {
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
  // Only this row's L lanes take part; width L keeps the groups apart.
  const int base = (threadIdx.x & 31) & ~(L - 1);
  const unsigned mask =
      L == 32 ? 0xffffffffu : (((1u << (L & 31)) - 1u) << base);
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1) {
    acc += __shfl_down_sync(mask, acc, off, L);
  }
  if (lane == 0) {
    y[row] = acc;
  }
}

template <typename T, typename A, int L>
int launch_l(const void* indptr, const void* indices, const void* data,
             const void* x, void* y, long long nrows, int br, int bc,
             long long nblocks, cudaStream_t stream) {
  const long long blocks = (nrows * L + kThreads - 1) / kThreads;
  if (blocks > 2147483647LL) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  bsr_spmv_kernel<T, A, L><<<static_cast<unsigned>(blocks), kThreads, 0,
                             stream>>>(
      static_cast<const int*>(indptr), static_cast<const int*>(indices),
      static_cast<const T*>(data), static_cast<const A*>(x),
      static_cast<A*>(y), nrows, br, bc, nblocks);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename A>
int launch(const void* indptr, const void* indices, const void* data,
           const void* x, void* y, long long nbr, int br, int bc,
           long long nblocks, void* stream) {
  if (nbr < 0 || br < 1 || bc < 1 || nblocks < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (nbr == 0) {
    return static_cast<int>(cudaSuccess);
  }
  const long long nrows = nbr * br;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bc == 1) return launch_l<T, A, 1>(indptr, indices, data, x, y, nrows, br, bc, nblocks, s);
  if (bc == 2) return launch_l<T, A, 2>(indptr, indices, data, x, y, nrows, br, bc, nblocks, s);
  if (bc <= 4) return launch_l<T, A, 4>(indptr, indices, data, x, y, nrows, br, bc, nblocks, s);
  if (bc <= 8) return launch_l<T, A, 8>(indptr, indices, data, x, y, nrows, br, bc, nblocks, s);
  if (bc <= 16) return launch_l<T, A, 16>(indptr, indices, data, x, y, nrows, br, bc, nblocks, s);
  return launch_l<T, A, 32>(indptr, indices, data, x, y, nrows, br, bc, nblocks, s);
}

}  // namespace

extern "C" int spal_bsr_spmv_f32(const void* indptr, const void* indices,
                                 const void* data, const void* x, void* y,
                                 long long nbr, int br, int bc,
                                 long long nblocks, void* stream) {
  return launch<float, float>(indptr, indices, data, x, y, nbr, br, bc,
                              nblocks, stream);
}

extern "C" int spal_bsr_spmv_bf16(const void* indptr, const void* indices,
                                  const void* data, const void* x, void* y,
                                  long long nbr, int br, int bc,
                                  long long nblocks, void* stream) {
  return launch<__nv_bfloat16, float>(indptr, indices, data, x, y, nbr, br,
                                      bc, nblocks, stream);
}

extern "C" int spal_bsr_spmv_f64(const void* indptr, const void* indices,
                                 const void* data, const void* x, void* y,
                                 long long nbr, int br, int bc,
                                 long long nblocks, void* stream) {
  return launch<double, double>(indptr, indices, data, x, y, nbr, br, bc,
                                nblocks, stream);
}
