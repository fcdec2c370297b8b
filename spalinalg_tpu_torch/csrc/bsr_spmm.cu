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
// sequential TPU grid. This kernel reads the block arrays directly, takes
// any k >= 1 and is instantiated for float, __nv_bfloat16 (converted with
// the intrinsics, accumulated in float) and double. X and Y are in the
// accumulation type.
//
// What bounds it on this card: the loads. Every stored value multiplies a
// row of X (k * sizeof(A) bytes, 256 B at k = 64 in float), so a kernel
// that gives each scalar row its own pass over the X rows of its blocks
// moves br times the X traffic through L1/L2 that the block row needs, and
// 2 flops per value are cheap beside it.
//
// What the design does about it: rows of one block row share their blocks'
// X rows, so a group of G lanes owns a tile of RT rows of one block row
// (RT = 1, 4 or 8 by br) and a range of the k columns: G the power of two
// from 1 to 32 that covers k, and NT = 2 column tiles a lane for k > 32
// (then passes over column blocks of 64). For each stored value position
// (block, j) the group loads one row of X once, neighbouring lanes at
// neighbouring addresses (coalesced), and applies it to its RT rows, whose
// values every lane of the group reads at one address (a broadcast); the
// RT x NT sums stay in registers. No shuffles and no atomics; each output
// sums its blocks in storage order and each block's values in order, so a
// result is bitwise the same from run to run. Unbounded, double's 8 x 2
// tile takes 198 registers, so one CTA of 256 threads fits an SM; the
// launch bound of two CTAs an SM caps it at 128 (no spills), which takes
// the 128 x 128, k = 64 product from 4.89 to 3.57 ms on the H100. The
// same cap slows float there (2.26 -> 2.68 ms), so float has none. Lanes
// past k read a valid column and write nothing; rows past br in the last
// tile read row q0 and write nothing. Every row is written, rows of empty
// block rows with 0.
// Blocks at or past min(indptr[nbr], nblocks) are never read. Offsets into
// data, X and Y are 64-bit. At 128 x 128 blocks this is slower than a
// batched dense product (the blocks' values are reused k times, so the
// work is compute-heavy): staging tiles in shared memory, and tensor cores
// (mma / wgmma) for bf16, are later work.
//
// C interface: one entry point per storage type. Each launches on the
// given stream, allocates nothing, does not synchronise, and returns
// cudaGetLastError(). nbr == 0 or k == 0 launches nothing.

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
bsr_spmm_kernel(const int* __restrict__ indptr,
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
bsr_spmm_kernel_f64(const int* __restrict__ indptr,
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
    kernel = bsr_spmm_kernel_f64<T, A, G, NT, RT>;
  } else {
    kernel = bsr_spmm_kernel<T, A, G, NT, RT>;
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
int launch(const void* indptr, const void* indices, const void* data,
           const void* X, void* Y, long long nbr, int br, int bc,
           long long nblocks, long long k, void* stream) {
  if (nbr < 0 || br < 1 || bc < 1 || nblocks < 0 || k < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (nbr == 0 || k == 0) {
    return static_cast<int>(cudaSuccess);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k == 1) return launch_g<T, A, 1, 1>(indptr, indices, data, X, Y, nbr, br, bc, nblocks, k, s);
  if (k == 2) return launch_g<T, A, 2, 1>(indptr, indices, data, X, Y, nbr, br, bc, nblocks, k, s);
  if (k <= 4) return launch_g<T, A, 4, 1>(indptr, indices, data, X, Y, nbr, br, bc, nblocks, k, s);
  if (k <= 8) return launch_g<T, A, 8, 1>(indptr, indices, data, X, Y, nbr, br, bc, nblocks, k, s);
  if (k <= 16) return launch_g<T, A, 16, 1>(indptr, indices, data, X, Y, nbr, br, bc, nblocks, k, s);
  if (k <= 32) return launch_g<T, A, 32, 1>(indptr, indices, data, X, Y, nbr, br, bc, nblocks, k, s);
  return launch_g<T, A, 32, 2>(indptr, indices, data, X, Y, nbr, br, bc, nblocks, k, s);
}

}  // namespace

extern "C" int spal_bsr_spmm_f32(const void* indptr, const void* indices,
                                 const void* data, const void* X, void* Y,
                                 long long nbr, int br, int bc,
                                 long long nblocks, long long k,
                                 void* stream) {
  return launch<float, float>(indptr, indices, data, X, Y, nbr, br, bc,
                              nblocks, k, stream);
}

extern "C" int spal_bsr_spmm_bf16(const void* indptr, const void* indices,
                                  const void* data, const void* X, void* Y,
                                  long long nbr, int br, int bc,
                                  long long nblocks, long long k,
                                  void* stream) {
  return launch<__nv_bfloat16, float>(indptr, indices, data, X, Y, nbr, br,
                                      bc, nblocks, k, stream);
}

extern "C" int spal_bsr_spmm_f64(const void* indptr, const void* indices,
                                 const void* data, const void* X, void* Y,
                                 long long nbr, int br, int bc,
                                 long long nblocks, long long k,
                                 void* stream) {
  return launch<double, double>(indptr, indices, data, X, Y, nbr, br, bc,
                                nblocks, k, stream);
}
