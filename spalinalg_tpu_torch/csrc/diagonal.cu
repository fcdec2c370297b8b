// The stored diagonal of a CSR structure, or of a square-block BSR one, for
// Hopper (sm_90a).
//
// For output row i (0 <= i < nrows_out) and its row r = i + row0 of the
// structure, p is the LAST position in [ptr[r], ptr[r+1]) with
// idx[p] == r + col_shift (of a slot stored twice, the last entry counts).
// With blocks of b x b values (b = 1 for CSR):
//
//   out[i * b + j] = values[p * b * b + j * b + j]       (j < b)
//
// and 0 where the row has no such position. With invert, the same store
// writes d != 0 ? 1 / d : 1 in place of d (one IEEE division in the value
// type; bf16 divides in float and rounds to nearest), the Jacobi
// preconditioner's inverse diagonal.
//
// Replaces no Pallas kernel: the JAX package's diagonal
// (spalinalg_tpu/ops/reduce_api.py::diagonal) is XLA code. It replaces the
// port's plain torch chain (a searchsorted over every slot for its row,
// int64 row ids, a hit mask, a scatter_reduce("amax") of the positions,
// a gather, then the inverse's elementwise passes: about 44 kernels and
// several passes of 8-byte ids over every slot).
//
// What bounds it on this card: bytes. Each call must read the index run of
// every walked row (4 bytes a slot), the row pointers (4 bytes a row), the
// b diagonal values of each row and write b values a row: for HPCG's 256^3
// 27-point operator in float64 2.13 GB, 0.64 ms at 3.35 TB/s. No row ids
// are needed: a row's group of lanes walks the row's own run.
//
// What the design does about it: a group of kLanes = 4 lanes owns a row,
// grid-stride over the rows. Where idx starts on a 16-byte boundary (V = 4)
// each lane loads 16 bytes, an int4 of four indices, from the aligned chunk
// at or before the row's start; else (V = 1) one index a lane. For HPCG's
// 27 entries a row (and ex56's 27 blocks a block row) two steps of 16 slots
// cover a row, and a warp walks eight neighbouring rows, one contiguous
// stretch of indices: more rows a warp keep more independent loads in
// flight. On an H100 SXM at 700 W (HPCG's 256^3 operator, float64): 4 lanes
// 1.27 ms, 8 lanes (one step a row) 1.53, 16 2.57, 32 4.58; two steps an
// iteration (both loads issued first) gave 1.26 at 4 lanes, so the loop
// stays one step an iteration. 1.27 ms is 50 % of the bound: a row's loads
// depend on each other (its pointers, then its indices, then its diagonal
// value). A long row takes its 4 lanes more steps. Each step,
// every lane keeps the last of its slots that hits, and the group takes
// the highest lane that hit (__ballot_sync, 31 - __clz) and shuffles its
// offset out: the last hit of the row wins, as in the plain version. Slots
// of a chunk outside the row are masked, and no slot at or past
// ptr[nrows] is read for its index (a 16-byte chunk that holds one of the
// row's slots lies inside the allocation). Offsets within a row are 32-bit
// (int32 positions), value offsets 64-bit: ex56's p * 9 reaches 1.0e9.
// The values are copied, so the diagonal is the plain version's bit for
// bit, and the inverse divides as torch's 1 / d does.
//
// C interface: one entry point per value type. Each launches on the given
// stream, allocates nothing, does not synchronise, and returns
// cudaGetLastError(). An empty output launches nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 4;  // lanes a row
constexpr long long kMaxBlocks = 132LL * 64;  // grid-stride beyond this

// A stored value in its arithmetic type (bf16 widened exactly to float),
// and back.
template <typename T>
struct Val {
  static __device__ __forceinline__ T load(const T* p) { return *p; }
  static __device__ __forceinline__ T store(T v) { return v; }
};

template <>
struct Val<__nv_bfloat16> {
  static __device__ __forceinline__ float load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  static __device__ __forceinline__ __nv_bfloat16 store(float v) {
    return __float2bfloat16(v);
  }
};

// The value written for stored position `at` (-1: none): a copy, or with
// invert the Jacobi inverse d != 0 ? 1 / d : 1.
template <typename T>
__device__ __forceinline__ T diagonal_entry(const T* __restrict__ values,
                                            long long at, int invert) {
  using V = Val<T>;
  if (!invert) {
    return at < 0 ? V::store(0) : values[at];
  }
  if (at < 0) {
    return V::store(1);
  }
  const auto d = V::load(values + at);
  return d != 0 ? V::store(1 / d) : V::store(1);
}

// The last of lane's slots o .. o + V - 1 of a row's run (offsets from its
// first aligned chunk) that lies in [lead, len) and holds col; -1 if none.
template <int V>
__device__ __forceinline__ int lane_hit(const int* __restrict__ run, int o,
                                        int lead, int len, int col) {
  int mine = -1;
  if (o < len) {
    if (V == 4) {
      const int4 c = __ldg(reinterpret_cast<const int4*>(run + o));
      if (c.x == col && o >= lead) mine = o;
      if (c.y == col && o + 1 >= lead && o + 1 < len) mine = o + 1;
      if (c.z == col && o + 2 >= lead && o + 2 < len) mine = o + 2;
      if (c.w == col && o + 3 < len) mine = o + 3;
    } else if (__ldg(run + o) == col) {
      mine = o;
    }
  }
  return mine;
}

// The group's last hit so far: the highest lane that hit this step, else
// the hit of an earlier step.
__device__ __forceinline__ int group_hit(unsigned group, int mine, int hit) {
  const unsigned found = __ballot_sync(group, mine >= 0) & group;
  return found ? __shfl_sync(group, mine, 31 - __clz(found)) : hit;
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
diagonal_kernel(const int* __restrict__ ptr, const int* __restrict__ idx,
                const T* __restrict__ values, T* __restrict__ out,
                long long nrows_out, long long row0, long long col_shift,
                int b, int invert) {
  const int lane = threadIdx.x & 31;
  const int sub = lane & (kLanes - 1);
  const unsigned group = ((1u << kLanes) - 1) << (lane & ~(kLanes - 1));
  const long long groups =
      static_cast<long long>(gridDim.x) * (kThreads / kLanes);
  const long long bb = static_cast<long long>(b) * b;
  for (long long i =
           (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) / kLanes;
       i < nrows_out; i += groups) {
    const long long r = i + row0;
    const long long start = __ldg(ptr + r);
    const long long a0 = V == 4 ? start & ~3LL : start;
    const int lead = static_cast<int>(start - a0);
    const int len = static_cast<int>(__ldg(ptr + r + 1) - a0);
    const int* __restrict__ run = idx + a0;
    const int col = static_cast<int>(r + col_shift);
    int hit = -1;
    for (int s = 0; s < len; s += V * kLanes) {
      hit = group_hit(group, lane_hit<V>(run, s + V * sub, lead, len, col),
                      hit);
    }
    const long long p = hit < 0 ? -1 : a0 + hit;
    for (int j = sub; j < b; j += kLanes) {
      out[i * b + j] = diagonal_entry(
          values, p < 0 ? -1 : p * bb + static_cast<long long>(j) * (b + 1),
          invert);
    }
  }
}

template <typename T>
int launch(const void* ptr_, const void* idx_, const void* values_,
           void* out_, long long nrows_out, long long row0,
           long long col_shift, long long b, long long invert, long long vec,
           void* stream) {
  if (nrows_out < 0 || row0 < 0 || b < 1 || (vec != 1 && vec != 4)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (nrows_out == 0) {
    return static_cast<int>(cudaSuccess);
  }
  long long blocks = (nrows_out * kLanes + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) {
    blocks = kMaxBlocks;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ptr = static_cast<const int*>(ptr_);
  const int* idx = static_cast<const int*>(idx_);
  const T* values = static_cast<const T*>(values_);
  T* out = static_cast<T*>(out_);
  const unsigned g = static_cast<unsigned>(blocks);
  const int bi = static_cast<int>(b), inv = invert != 0;
  if (vec == 4) {
    diagonal_kernel<T, 4><<<g, kThreads, 0, s>>>(
        ptr, idx, values, out, nrows_out, row0, col_shift, bi, inv);
  } else {
    diagonal_kernel<T, 1><<<g, kThreads, 0, s>>>(
        ptr, idx, values, out, nrows_out, row0, col_shift, bi, inv);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// (ptr, idx, values, out, nrows_out, row0, col_shift, b, invert, vec,
//  stream): ptr and idx int32; values (nblocks, b, b) or, for b = 1,
// (nse,); out nrows_out * b values; vec 4 where idx starts on a 16-byte
// boundary, else 1.
#define SPAL_DIAGONAL_ENTRY(NAME, T)                                          \
  extern "C" int NAME(const void* ptr, const void* idx, const void* values,   \
                      void* out, long long nrows_out, long long row0,         \
                      long long col_shift, long long b, long long invert,     \
                      long long vec, void* stream) {                          \
    return launch<T>(ptr, idx, values, out, nrows_out, row0, col_shift, b,    \
                     invert, vec, stream);                                    \
  }

SPAL_DIAGONAL_ENTRY(spal_diagonal_f32, float)
SPAL_DIAGONAL_ENTRY(spal_diagonal_bf16, __nv_bfloat16)
SPAL_DIAGONAL_ENTRY(spal_diagonal_f64, double)
