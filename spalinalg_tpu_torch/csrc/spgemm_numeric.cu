// SpGEMM numeric phase for Hopper (sm_90a): the values of C = A B on a fixed
// symbolic plan.
//
//   out[g] = sum over the terms t with gid[t] = g of a[a_idx[t]] * b[b_idx[t]]
//
// where the plan's term list (a_idx, b_idx: 8 index bytes a term) is sorted
// by output slot and tptr points at each slot's first term (tptr[n_out] is
// the term count). A slot whose terms cancel keeps its sum, 0 included.
//
// Replaces the Pallas kernel of the JAX package's SpGEMM numeric phase:
//   spalinalg_tpu/ops/kernels/pair_route.py  _pair_kernel  (B3)
// with its tail fold and spill, which add into the same sum. Its paired
// route tables, lane-gather network and f32-only arithmetic exist because
// the TPU serialises dynamic gathers; Hopper gathers natively, in float or
// double.
//
// A warp owns 32 consecutive slots and walks their terms 32 at a time (lane
// l takes term base + l: coalesced index loads, every lane busy however the
// terms fall into slots); a lane finds its slot by a binary search over the
// warp's 33 slot pointers in shared memory, a segmented scan
// (__shfl_up_sync, fixed offsets) sums each slot's terms within the batch,
// and the last lane of a segment adds the sum to the slot's accumulator.
// Bound by the index stream and the value gathers (L2 hits where the
// operands fit there).
//
// The summation order depends only on the term list, so a result is bitwise
// the same from run to run; it differs from the plain version's, so they
// agree within tol·Σ|a||b|.
//
// What the H100 showed (PERF.md, the B3 findings): a row-by-row walk of the
// CSR arrays of A, B and C, binned by row work, took about 3x this kernel's
// time on the power-law A·A of 45.7M terms, and was taken out.
//
// C interface: one entry point per type. It launches on the given stream,
// allocates nothing, does not synchronise, and returns cudaGetLastError();
// n_out == 0 launches nothing.

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;

// A warp owns 32 consecutive slots and walks their terms from the plan's
// slot-sorted term list (see the header).
constexpr int kTermThreads = 256;
constexpr int kTermWarps = kTermThreads / kWarp;

template <typename T>
__global__ void __launch_bounds__(kTermThreads)
terms_kernel(const int* __restrict__ tptr, const int* __restrict__ a_idx,
             const int* __restrict__ b_idx, const T* __restrict__ a,
             const T* __restrict__ b, T* __restrict__ out, long long n_out) {
  __shared__ int s_ptr[kTermWarps][kWarp + 1];
  __shared__ T s_acc[kTermWarps][kWarp];
  const int w = threadIdx.x / kWarp;
  const int lane = threadIdx.x & (kWarp - 1);
  const long long s0 =
      (static_cast<long long>(blockIdx.x) * kTermWarps + w) * kWarp;
  if (s0 >= n_out) {
    return;  // the whole warp leaves together
  }
  const int nslots = static_cast<int>(min(static_cast<long long>(kWarp),
                                          n_out - s0));
  // Pointers past the warp's last slot repeat its end, so the search below
  // never lands there.
  s_ptr[w][lane] = tptr[s0 + min(lane, nslots)];
  if (lane == 0) {
    s_ptr[w][kWarp] = tptr[s0 + nslots];
  }
  s_acc[w][lane] = T(0);
  __syncwarp();
  const long long t1 = s_ptr[w][kWarp];
  for (long long base = s_ptr[w][0]; base < t1; base += kWarp) {
    const long long t = base + lane;
    T v = T(0);
    int slot = kWarp;  // past every slot: idle lanes form their own segment
    if (t < t1) {
      v = a[a_idx[t]] * b[b_idx[t]];
      // The largest slot i with s_ptr[i] <= t (an empty slot's pointer
      // equals the next one's, so the search passes over it).
      slot = 0;
#pragma unroll
      for (int step = kWarp / 2; step > 0; step >>= 1) {
        if (s_ptr[w][slot + step] <= t) {
          slot += step;
        }
      }
    }
    // Slots are sorted along the lanes, so equal slots at lane - off mean
    // the whole stretch between belongs to one slot.
#pragma unroll
    for (int off = 1; off < kWarp; off <<= 1) {
      const T u = __shfl_up_sync(kFull, v, off);
      const int su = __shfl_up_sync(kFull, slot, off);
      if (lane >= off && su == slot) {
        v += u;
      }
    }
    const int next = __shfl_down_sync(kFull, slot, 1);
    if (slot < kWarp && (lane == kWarp - 1 || next != slot)) {
      s_acc[w][slot] += v;
    }
    __syncwarp();
  }
  if (lane < nslots) {
    out[s0 + lane] = s_acc[w][lane];
  }
}

template <typename T>
int launch_terms(const void* tptr, const void* a_idx, const void* b_idx,
                 const void* a, const void* b, void* out, long long n_out,
                 void* stream) {
  if (n_out < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_out == 0) {
    return static_cast<int>(cudaSuccess);
  }
  const long long blocks = (n_out + kTermThreads - 1) / kTermThreads;
  if (blocks > 2147483647LL) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  terms_kernel<T><<<static_cast<unsigned>(blocks), kTermThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(tptr), static_cast<const int*>(a_idx),
      static_cast<const int*>(b_idx), static_cast<const T*>(a),
      static_cast<const T*>(b), static_cast<T*>(out), n_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int spal_spgemm_terms_f32(const void* tptr, const void* a_idx,
                                     const void* b_idx, const void* a,
                                     const void* b, void* out, long long n_out,
                                     void* stream) {
  return launch_terms<float>(tptr, a_idx, b_idx, a, b, out, n_out, stream);
}

extern "C" int spal_spgemm_terms_f64(const void* tptr, const void* a_idx,
                                     const void* b_idx, const void* a,
                                     const void* b, void* out, long long n_out,
                                     void* stream) {
  return launch_terms<double>(tptr, a_idx, b_idx, a, b, out, n_out, stream);
}
