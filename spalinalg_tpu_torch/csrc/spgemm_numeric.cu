// SpGEMM numeric phase for Hopper (sm_90a): the values of C = A B on a fixed
// symbolic plan.
//
//   out[g] = sum over t in [tptr[g], tptr[g+1]) of a[a_idx[t]] * b[b_idx[t]]
//
// The plan's term list (a_idx, b_idx) is sorted by output slot g, and tptr
// (n_out + 1) points at each slot's first term.
//
// Replaces the Pallas kernel of the JAX package's SpGEMM numeric phase:
//   spalinalg_tpu/ops/kernels/pair_route.py  _pair_kernel  (B3)
// with its tail fold and spill, which add into the same sum. Its paired
// route tables, lane-gather network and f32-only arithmetic exist because the
// TPU serialises dynamic gathers. Hopper gathers natively, so both gathers
// happen here, from the value arrays themselves, in float or double.
//
// What bounds it on this card: bytes and memory latency. Every term streams
// its two indices (8 bytes) and gathers one value of a and one of b, which
// hit L2 when the operands fit there; one multiply-add per term is far
// below the arithmetic rate. Terms per slot are very uneven on power-law
// inputs (hub rows have hundreds of entries in A and B).
//
// What the design does about it: a warp owns 32 consecutive slots and walks
// their terms, which are contiguous, 32 at a time: lane l takes term
// base + l, so the index loads are coalesced and every lane is busy however
// the terms fall into slots. A slot with thousands of terms is shared by all
// 32 lanes instead of serialising one, and short slots do not leave lanes
// idle. Each lane finds its term's slot by a binary search over the warp's 33
// slot pointers in shared memory, a segmented inclusive scan
// (__shfl_up_sync, fixed offsets) sums the terms of each slot within the
// batch, and the last lane of each segment adds that sum to the slot's
// accumulator in shared memory. There are no atomics: each accumulator is
// written by one lane per batch, batches run in order, and the summation
// order depends only on the plan, so a result is bitwise the same from run
// to run. An empty slot gives 0.
//
// C interface: one entry point per type. Each launches on the given stream,
// allocates nothing, does not synchronise, and returns cudaGetLastError().
// n_out == 0 launches nothing.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = kThreads / kWarp;

template <typename T>
__global__ void __launch_bounds__(kThreads)
spgemm_numeric_kernel(const int* __restrict__ tptr,
                      const int* __restrict__ a_idx,
                      const int* __restrict__ b_idx,
                      const T* __restrict__ a, const T* __restrict__ b,
                      T* __restrict__ out, long long n_out) {
  __shared__ int s_ptr[kWarpsPerBlock][kWarp + 1];
  __shared__ T s_acc[kWarpsPerBlock][kWarp];
  const int w = threadIdx.x / kWarp;
  const int lane = threadIdx.x & (kWarp - 1);
  const long long s0 =
      (static_cast<long long>(blockIdx.x) * kWarpsPerBlock + w) * kWarp;
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
      const T u = __shfl_up_sync(0xffffffffu, v, off);
      const int su = __shfl_up_sync(0xffffffffu, slot, off);
      if (lane >= off && su == slot) {
        v += u;
      }
    }
    const int next = __shfl_down_sync(0xffffffffu, slot, 1);
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
int launch(const void* tptr, const void* a_idx, const void* b_idx,
           const void* a, const void* b, void* out, long long n_out,
           void* stream) {
  if (n_out < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_out == 0) {
    return static_cast<int>(cudaSuccess);
  }
  const long long slots_per_block = static_cast<long long>(kThreads);
  const long long blocks = (n_out + slots_per_block - 1) / slots_per_block;
  if (blocks > 2147483647LL) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  spgemm_numeric_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(tptr), static_cast<const int*>(a_idx),
      static_cast<const int*>(b_idx), static_cast<const T*>(a),
      static_cast<const T*>(b), static_cast<T*>(out), n_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int spal_spgemm_numeric_f32(const void* tptr, const void* a_idx,
                                       const void* b_idx, const void* a,
                                       const void* b, void* out,
                                       long long n_out, void* stream) {
  return launch<float>(tptr, a_idx, b_idx, a, b, out, n_out, stream);
}

extern "C" int spal_spgemm_numeric_f64(const void* tptr, const void* a_idx,
                                       const void* b_idx, const void* a,
                                       const void* b, void* out,
                                       long long n_out, void* stream) {
  return launch<double>(tptr, a_idx, b_idx, a, b, out, n_out, stream);
}
