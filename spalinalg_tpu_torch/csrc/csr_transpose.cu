// The CSR backward's values in column buckets, for Hopper (sm_90a).
//
// The backward passes of the CSR SpMV and SpMM compute dx = Aᵀ·g and
// dX = Aᵀ·G with the forward's kernels on the cached transposed structure,
// whose slot q holds A's value values[perm[q]]. Read through perm, that is
// one random 4- or 8-byte read a slot across the whole value array (268 /
// 537 MB at n = 2^21 with 32 entries a row, 5-10x the H100's 50 MB L2):
// every read brings in a 32-byte sector that is evicted before its
// neighbours are read, so the transposed SpMV took 4.6 / 5.4x its forward.
//
// Here the values are first put where the transposed walk will look for
// them (the wrapper's csr_transpose.bucket_plan, built once per structure):
// the columns are cut into blocks of W columns, W a power of two chosen so
// that a block's values fill about BUCKET_BYTES (2 MiB), and the values are
// laid out block by block, each block's slots in slot order, in a buffer vb
// (ordered by block, then by slab, then by slot). The transposed walk reads
// vb[bperm[q]] (bperm[q] is where values[perm[q]] landed): it walks the
// columns in order, so at any moment the CTAs read inside a few blocks'
// regions of vb, which stay in L2, and each sector comes from device memory
// about once. That second pass is the forward kernels' perm path run on
// (vb, bperm) in place of (values, perm): the same code, the same terms in
// the same order, so the same bits.
//
// The SpMV's Aᵀ·g goes further (the "products" route): pass 1 moves
// values[p]·g[row p] (g read in row order, the row from the transpose's
// major), and the vector SpMV kernel's products instance sums them through
// bperm in its own order, with no gather of g: the same bits where no row
// of Aᵀ is split (csr_spmv.cu). Its pass 2 then does one random L2 read a
// slot instead of two.
//
// No TPU kernel is replaced: the JAX package computes this dx with an XLA
// scatter-add (spalinalg_tpu/ops/kernels/csr_route.py:1096, :1367). The
// kernels here are the port's own.
//
// bucket_scatter (pass 1). A CTA owns a slab of kSlab = 8192 consecutive
// slots. It reads their values in order (16-byte loads where values start
// on a 16-byte boundary: 0.064 against 0.091 ms for the float32 SpMM's
// 2^24 slots on the H100, the same at the SpMV's 2^26), puts each at its
// place in the slab's block order in shared memory (lpos, an int16 a slot
// from the plan), and then copies each block's run of the slab to vb, a
// warp a run, contiguous stores (runs: the plan's per-slab list of first
// places in the slab and in vb; about 64 slots each at csr_random n =
// 2^21). With PROD it stages values[p]·g[major[p]] instead. What bounds
// it: bytes, (itemsize + 2)·nse read and itemsize·nse written (0.20 /
// 0.36 ms at n = 2^21, f32 / f64, at 3.35 TB/s); with PROD the function
// needs only g and rowptr more, but the kernel reads each slot's row from
// the transpose's major, 4·nse bytes (268 MB at n = 2^21) that finding
// the rows of a slab from its stretch of rowptr would save (PERF.md
// gives the shares). An unrolled load loop or a warp's runs' bounds
// loaded at once gained nothing on the H100. The plan gives lpos (2
// bytes a slot) rather than have the kernel read colind (4 bytes) and
// rank the slots itself: a
// slot's rank among its slab's slots of its block needs a stable sort
// inside the CTA, which the plan does once per structure. Shared memory:
// kSlab values, 32 / 64 KB a CTA (dynamic past 48 KB). Registers (ptxas
// -v, nvcc 12.9, sm_90a): 32-40, no spills.
//
// No atomics; the output is a permutation of the input (with PROD, of each
// value times its g), bitwise the same from run to run. Slots past the
// structure's last entry (padding) move like any other, in a last block of
// their own, and keep their value.
//
// C interface: one entry point per type. Each launches on the
// given stream, allocates nothing, does not synchronise, and returns
// cudaGetLastError(), or cudaErrorInvalidValue for arguments it does not
// take. nse == 0 launches nothing.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kSlab = 8192;  // SLAB in ops/kernels/csr_transpose.py

// The value pass 1 moves for slot p: values[p], or with PROD its product
// with g at the slot's row, major[p] (a slot at or past nrows, padding,
// keeps its value).
template <typename T, bool PROD>
__device__ __forceinline__ T moved(T v, const T* g, const int* major,
                                   long long nrows, long long p) {
  if (!PROD) {
    return v;
  }
  const int m = __ldcs(major + p);
  return m < nrows ? v * __ldg(g + m) : v;
}

// Four consecutive values from 16-byte aligned storage (streamed: read
// once).
__device__ __forceinline__ void load4(const float* v, float (&out)[4]) {
  const float4 a = __ldcs(reinterpret_cast<const float4*>(v));
  out[0] = a.x;
  out[1] = a.y;
  out[2] = a.z;
  out[3] = a.w;
}

__device__ __forceinline__ void load4(const double* v, double (&out)[4]) {
  const double2 a = __ldcs(reinterpret_cast<const double2*>(v));
  const double2 b = __ldcs(reinterpret_cast<const double2*>(v) + 1);
  out[0] = a.x;
  out[1] = a.y;
  out[2] = b.x;
  out[3] = b.y;
}

// VEC: values start on a 16-byte boundary (lpos, a plan tensor, always
// does, and a slab starts 8192 slots on): a thread stages four slots a
// step from one 16-byte (float) or two (double) loads of values and one
// 8-byte load of lpos; else one slot a step.
template <typename T, bool VEC, bool PROD>
__global__ void __launch_bounds__(kThreads)
bucket_scatter(const T* __restrict__ values, const short* __restrict__ lpos,
               const int* __restrict__ run_ptr,
               const int* __restrict__ run_start,
               const int* __restrict__ run_goff, T* __restrict__ vb,
               long long nse, const T* __restrict__ g,
               const int* __restrict__ major, long long nrows) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* staged = reinterpret_cast<T*>(smem);
  const long long p0 = static_cast<long long>(blockIdx.x) * kSlab;
  const int n = static_cast<int>(
      nse - p0 < kSlab ? nse - p0 : static_cast<long long>(kSlab));
  const T* v = values + p0;
  const short* l = lpos + p0;
  int head = 0;
  if (VEC) {
    head = n & ~3;
    for (int i = 4 * threadIdx.x; i < head; i += 4 * kThreads) {
      T q[4];
      load4(v + i, q);
      const short4 at = __ldcs(reinterpret_cast<const short4*>(l + i));
      const long long p = p0 + i;
      staged[static_cast<unsigned short>(at.x)] =
          moved<T, PROD>(q[0], g, major, nrows, p);
      staged[static_cast<unsigned short>(at.y)] =
          moved<T, PROD>(q[1], g, major, nrows, p + 1);
      staged[static_cast<unsigned short>(at.z)] =
          moved<T, PROD>(q[2], g, major, nrows, p + 2);
      staged[static_cast<unsigned short>(at.w)] =
          moved<T, PROD>(q[3], g, major, nrows, p + 3);
    }
  }
  for (int i = head + threadIdx.x; i < n; i += kThreads) {
    staged[static_cast<unsigned short>(l[i])] =
        moved<T, PROD>(__ldcs(v + i), g, major, nrows, p0 + i);
  }
  __syncthreads();
  const int r0 = run_ptr[blockIdx.x];
  const int r1 = run_ptr[blockIdx.x + 1];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int r = r0 + warp; r < r1; r += kWarps) {
    const int a = run_start[r];
    const int b = r + 1 < r1 ? run_start[r + 1] : n;
    T* out = vb + run_goff[r];
    for (int j = lane; j < b - a; j += 32) {
      out[j] = staged[a + j];
    }
  }
}

template <typename T, bool PROD>
int launch_scatter(const void* values, const void* lpos, const void* run_ptr,
                   const void* run_start, const void* run_goff, void* vb,
                   long long nse, long long nslab, const void* g,
                   const void* major, long long nrows, void* stream) {
  if (nse < 0 || nslab != (nse + kSlab - 1) / kSlab ||
      (PROD && (g == nullptr || major == nullptr || nrows < 0)) ||
      (nse > 0 && (values == nullptr || lpos == nullptr || run_ptr == nullptr ||
                   run_start == nullptr || run_goff == nullptr ||
                   vb == nullptr)) ||
      nslab > 2147483647LL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (nse == 0) {
    return static_cast<int>(cudaSuccess);
  }
  constexpr int shared = kSlab * static_cast<int>(sizeof(T));
  const bool vec = reinterpret_cast<std::uintptr_t>(values) % 16 == 0 &&
                   reinterpret_cast<std::uintptr_t>(lpos) % 16 == 0;
  auto kernel = vec ? bucket_scatter<T, true, PROD>
                    : bucket_scatter<T, false, PROD>;
  const cudaError_t raised = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shared);
  if (raised != cudaSuccess) {
    return static_cast<int>(raised);
  }
  kernel<<<static_cast<unsigned>(nslab), kThreads, shared,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(values), static_cast<const short*>(lpos),
      static_cast<const int*>(run_ptr), static_cast<const int*>(run_start),
      static_cast<const int*>(run_goff), static_cast<T*>(vb), nse,
      static_cast<const T*>(g), static_cast<const int*>(major), nrows);
  return static_cast<int>(cudaGetLastError());
}

// g == nullptr: the values as they are; else each times g at its slot's
// row (major, nrows): the products of the SpMV's Aᵀ·g.
template <typename T>
int launch_scatter_any(const void* values, const void* lpos,
                       const void* run_ptr, const void* run_start,
                       const void* run_goff, void* vb, long long nse,
                       long long nslab, const void* g, const void* major,
                       long long nrows, void* stream) {
  if (g == nullptr) {
    return launch_scatter<T, false>(values, lpos, run_ptr, run_start,
                                    run_goff, vb, nse, nslab, g, major, nrows,
                                    stream);
  }
  return launch_scatter<T, true>(values, lpos, run_ptr, run_start, run_goff,
                                 vb, nse, nslab, g, major, nrows, stream);
}

}  // namespace

extern "C" int spal_bucket_scatter_f32(const void* values, const void* lpos,
                                       const void* run_ptr,
                                       const void* run_start,
                                       const void* run_goff, void* vb,
                                       long long nse, long long nslab,
                                       const void* g, const void* major,
                                       long long nrows, void* stream) {
  return launch_scatter_any<float>(values, lpos, run_ptr, run_start, run_goff,
                                   vb, nse, nslab, g, major, nrows, stream);
}

extern "C" int spal_bucket_scatter_f64(const void* values, const void* lpos,
                                       const void* run_ptr,
                                       const void* run_start,
                                       const void* run_goff, void* vb,
                                       long long nse, long long nslab,
                                       const void* g, const void* major,
                                       long long nrows, void* stream) {
  return launch_scatter_any<double>(values, lpos, run_ptr, run_start,
                                    run_goff, vb, nse, nslab, g, major, nrows,
                                    stream);
}
