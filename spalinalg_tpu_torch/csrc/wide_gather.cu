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
// take about 1.3 us at 3.35 TB/s, and the 4.2 MFLOP far less; the S*K*L
// gathers (2.1M, 8.4 MB) are served from L2 and L1, and with 8192 threads
// the card is far from full, so latency of the dependent k loop bounds it.
//
// Design: one thread per (s, l), looping k = 0..K-1 in order (the order of
// the TPU kernel's accumulation), so a result is bitwise the same from run
// to run. Neighbouring threads take neighbouring l, so idx and val are read
// coalesced; the gathers of a warp share one row s of xt.
//
// C interface: launches on the given stream, allocates nothing, does not
// synchronise, and returns cudaGetLastError(). An empty output launches
// nothing.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
wide_gather_kernel(const float* __restrict__ xt, const int* __restrict__ idx,
                   const float* __restrict__ val, float* __restrict__ out,
                   long long S, long long N, long long K, long long L) {
  const long long t = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (t >= S * L) {
    return;
  }
  const long long s = t / L;
  const long long l = t - s * L;
  const float* row = xt + s * N;
  float acc = 0.0f;
  for (long long k = 0; k < K; ++k) {
    const int c = __ldg(idx + k * L + l);
    const float h = (c >= 0 && c < N) ? __ldg(row + c) : 0.0f;
    acc += h * __ldg(val + k * L + l);
  }
  out[t] = acc;
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
  const long long blocks = (S * L + kThreads - 1) / kThreads;
  if (blocks > 2147483647LL) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  wide_gather_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xt), static_cast<const int*>(idx),
      static_cast<const float*>(val), static_cast<float*>(out), S, N, K, L);
  return static_cast<int>(cudaGetLastError());
}
