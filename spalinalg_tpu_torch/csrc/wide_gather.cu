// Wide gather multiply-accumulate probe for Hopper (sm_90a):
//
//   out[s, l] = sum over k = 0..K-1 of xt[s, idx[k, l]] * val[k, l]
//
// with xt (S, N), idx and val (K, L), out (S, L), all row-major; an index
// outside [0, N) reads 0 (FILL_OR_DROP). Replaces the Pallas kernel of the
// JAX package's probe tool:
//   tools/probe_widegather.py  _kernel  (S = 64, N = 16384, K = 256, L = 128)
// which asked whether the TPU's lane gather lowers from an operand wider
// than its 128 output lanes. On Hopper a gather from any address is native;
// the probe measures the rate of such gathers, which bound the gather-heavy
// kernels (CSR SpMV/SpMM, the SpGEMM numeric phase).
//
// What bounds it on this card: at the tool's shapes, neither device memory
// nor arithmetic. The compulsory bytes (xt once, idx, val, out: 4.5 MB)
// take about 1.3 us at 3.35 TB/s, and the 4.2 MFLOP far less. What a
// design pays instead is the traffic from L2 to the SMs (every output needs
// a whole row of xt and a whole column of idx and val) and the latency of
// the gathers. The first design, one thread an output looping over its 256
// gathers from L2 in order, ran 8192 threads in 64 CTAs on a 132-SM card:
// latency bound at 28.2 us a call.
//
// Design: a CTA owns one row s and a slice of kSlice outputs l. It copies
// xt[s, :] (64 KB at the tool's N) into dynamic shared memory with 16-byte
// cp.async copies (the limit raised on each launch), so every gather reads
// shared memory, not an L2 sector. Its kSplit groups of kSlice threads
// split K into kSplit runs of consecutive takes; each thread sums its run
// in order, and thread group 0 adds the kSplit partial sums in a fixed
// order through shared memory. So a result is bitwise the same from run to
// run; it may differ in the last bits from the serial order of the TPU
// kernel (the tolerance 1e-5 * sum |xt||val| covers that). At the tool's
// shapes the grid is S * L / kSlice = 256 CTAs of 256 threads, two an SM
// (64 KB of row each); the slice and split were chosen on the H100 among
// slices of 16 to 128 outputs and splits of 2 to 16. A row longer than
// fits in shared memory is gathered from device memory by the same code.
// Neighbouring threads take neighbouring l, so idx and val are read
// coalesced.
//
// Measured on "NVIDIA H100 80GB HBM3, 700.00 W" (python -m
// spalinalg_tpu_torch.tools.probe_widegather, launches behind a spin):
// 6.04 us a call, from 28.6 us for the first design in the same session;
// the launch floor, the same kernel at S = 1 and K = 1, is 3.10 us, so
// about half of a call is the cost of any launch of a grid like this one
// (the bound, 1.3 us, is below it). Registers (ptxas -v, nvcc 12.9,
// sm_90a): 32, no spills.
//
// C interface: launches on the given stream, allocates nothing, does not
// synchronise, and returns cudaGetLastError() (or the error of raising the
// shared memory limit). An empty output launches nothing.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kSlice = 32;   // outputs l of a CTA
constexpr int kSplit = 8;    // runs of K a CTA's outputs are split into
constexpr int kThreads = kSlice * kSplit;
// Shared memory a CTA may hold on an H100, less the partial sums.
constexpr long long kMaxRow =
    (232448 - static_cast<long long>(sizeof(float)) * kSlice * kSplit) /
    static_cast<long long>(sizeof(float));

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem));
}

template <bool kShared>
__global__ void __launch_bounds__(kThreads)
wide_gather_kernel(const float* __restrict__ xt, const int* __restrict__ idx,
                   const float* __restrict__ val, float* __restrict__ out,
                   long long N, long long K, long long L) {
  extern __shared__ __align__(16) float row_s[];
  __shared__ float partial[kSplit][kSlice];
  const long long slices = (L + kSlice - 1) / kSlice;
  const long long s = blockIdx.x / slices;
  const long long l0 = (blockIdx.x - s * slices) * kSlice;
  const int li = threadIdx.x % kSlice;
  const int part = threadIdx.x / kSlice;
  const float* row = xt + s * N;
  if constexpr (kShared) {
    if (N % 4 == 0 && reinterpret_cast<std::uintptr_t>(row) % 16 == 0) {
      for (long long i = 4LL * threadIdx.x; i < N; i += 4LL * kThreads) {
        cp_async16(row_s + i, row + i);
      }
      asm volatile("cp.async.commit_group;\n" ::);
      asm volatile("cp.async.wait_group 0;\n" ::);
    } else {
      for (long long i = threadIdx.x; i < N; i += kThreads) {
        row_s[i] = __ldg(row + i);
      }
    }
    __syncthreads();
  }
  const long long l = l0 + li;
  float acc = 0.0f;
  if (l < L) {
    const long long run = (K + kSplit - 1) / kSplit;
    const long long kb = part * run;
    const long long ke = kb + run < K ? kb + run : K;
#pragma unroll 8
    for (long long k = kb; k < ke; ++k) {
      const int c = __ldg(idx + k * L + l);
      const float h =
          static_cast<unsigned long long>(static_cast<long long>(c)) <
                  static_cast<unsigned long long>(N)
              ? (kShared ? row_s[c] : __ldg(row + c))
              : 0.0f;
      acc = __fmaf_rn(h, __ldg(val + k * L + l), acc);
    }
  }
  partial[part][li] = acc;
  __syncthreads();
  if (part == 0 && l < L) {
    float sum = partial[0][li];
#pragma unroll
    for (int p = 1; p < kSplit; ++p) {
      sum += partial[p][li];
    }
    out[s * L + l] = sum;
  }
}

}  // namespace

extern "C" int spal_wide_gather_f32(const void* xt, const void* idx,
                                    const void* val, void* out, long long S,
                                    long long N, long long K, long long L,
                                    void* stream) {
  if (S < 0 || N < 0 || K < 0 || L < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (S * L == 0) {
    return static_cast<int>(cudaSuccess);
  }
  const long long blocks = S * ((L + kSlice - 1) / kSlice);
  if (blocks > 2147483647LL) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const bool shared = N <= kMaxRow;
  void (*kernel)(const float*, const int*, const float*, float*, long long,
                 long long, long long) =
      shared ? &wide_gather_kernel<true> : &wide_gather_kernel<false>;
  const int smem = shared ? static_cast<int>(N * sizeof(float)) : 0;
  if (shared) {
    const cudaError_t raised = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (raised != cudaSuccess) {
      return static_cast<int>(raised);
    }
  }
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xt), static_cast<const int*>(idx),
      static_cast<const float*>(val), static_cast<float*>(out), N, K, L);
  return static_cast<int>(cudaGetLastError());
}
