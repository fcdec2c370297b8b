// CSR sampled dense-dense matrix product (SDDMM) for Hopper (sm_90a):
//
//   out[p] = sum over c < k of G[major[p], c] * X[colind[p], c]
//
// for every stored slot p, and out[p] = 0 where major[p] == nrows, which
// marks a padding slot. G is (nrows, k) and X (ncols, k), row-major and
// contiguous. It is the gradient of a CSR product with respect to its
// values: for Y = A X with output gradient G, dvals[p] = G[row_p] . X[col_p]
// (k = 1 is SpMV's dvals[p] = g[row_p] * x[col_p]). major is the per-slot
// row id the cached transpose plan already holds.
//
// No Pallas kernel computes this. It replaces XLA code of the JAX package:
//   spalinalg_tpu/ops/kernels/csr_route.py:1093  (_route_spmv_ad_bwd, dvals)
//   spalinalg_tpu/ops/kernels/csr_route.py:1364  (_route_spmm_ad_bwd, dvals)
// and, in this port, the plain torch dvals of both CSR backward passes
// (2^26-element gathered temporaries, 13-21x the SpMM forward kernel).
//
// What bounds it on this card: bytes and gathers, as the forward SpMM.
// Every slot streams its row and column ids (8 bytes) and writes one value;
// its G row is shared with the slots of the same row (read about once, from
// L1/L2), and its X row is gathered at a random column, k * sizeof(T) bytes
// that hit L2 only as far as X fits there. Two flops per gathered element
// are far below the card's arithmetic rate. The function itself needs only
// rowptr, not a row id a slot: those 4 bytes a slot (268 MB a launch at
// 2^26 slots) are this design's cost, which a walk of rowptr windows, as
// the vector CSR SpMV does, would avoid.
//
// What the design does about it: a warp owns 512 consecutive slots and
// walks them in batches of 32 M slots, whose row and column ids it loads
// with one coalesced __ldcs a lane (M of them), the next batch's while the
// current one's rows are in flight. A group of S lanes owns a slot (S the
// power of two covering the row's vectors, at most 32; S = 1 for k = 1, a
// lane a slot, M = 8 / S slots a lane a batch below S = 8), and takes U
// slots at once (4, or 2 where a lane holds two vectors a row; 8 held more
// registers and ran slower in trials on the H100): the ids come
// by __shfl_sync, then each lane issues the X loads of all U slots before it
// multiplies. Slots of one row share its G vectors, kept in registers from
// step to step; the row a step moves to loads with its X rows. Rows are read in
// 16-byte vectors (float4, double2) where k * sizeof(T) is a multiple of 16
// and G and X start on a 16-byte boundary (variant vector), one element a
// lane otherwise (variant scalar). A lane sums its vectors in order; a fixed
// __shfl_xor_sync tree over the group ends a slot; the warp stores 32
// consecutive results a store instruction, with __stcs. There are no
// atomics, so a result is bitwise the same from run to run.
// Registers (ptxas -v, nvcc 12.9, sm_90a): at k = 1 (scalar, S = 1) 80
// (float) and 92 (double), no spills; at k = 64 (vector) 80 (float, S = 16,
// no spills) and 80 (double, S = 32, 8 bytes of spill stores); the other
// instances 58-115, spilling 0-8 bytes.
//
// C interface: one entry point per type, with the variant as an int (0
// scalar, 1 vector). Each launches on the given stream, allocates nothing,
// does not synchronise, and returns cudaGetLastError(), or
// cudaErrorInvalidValue for arguments the variant does not take. nse == 0
// or k == 0 launches nothing.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarpSlots = 512;  // slots a warp
constexpr int kScalar = 0;
constexpr int kVector = 1;

template <typename T, bool VEC>
struct Row;

template <typename T>
struct Row<T, false> {
  using V = T;
  static constexpr int kWidth = 1;
  static __device__ __forceinline__ T dot(const V& a, const V& b) {
    return a * b;
  }
};

template <>
struct Row<float, true> {
  using V = float4;
  static constexpr int kWidth = 4;
  static __device__ __forceinline__ float dot(const V& a, const V& b) {
    float s = a.x * b.x;
    s += a.y * b.y;
    s += a.z * b.z;
    s += a.w * b.w;
    return s;
  }
};

template <>
struct Row<double, true> {
  using V = double2;
  static constexpr int kWidth = 2;
  static __device__ __forceinline__ double dot(const V& a, const V& b) {
    double s = a.x * b.x;
    s += a.y * b.y;
    return s;
  }
};

template <typename T, bool VEC, int S, int NV>
__global__ void __launch_bounds__(kThreads)
csr_sddmm_kernel(const int* __restrict__ major, const int* __restrict__ colind,
                 const T* __restrict__ G, const T* __restrict__ X,
                 T* __restrict__ out, long long nse, int nrows,
                 long long nv) {
  using R = Row<T, VEC>;
  using V = typename R::V;
  constexpr int SG = 32 / S;               // groups a warp
  constexpr int M = S >= 8 ? 1 : 8 / S;    // slot ids a lane a batch
  constexpr int PER = S * M;               // slots a group a batch
  constexpr int U0 = 4 / NV;
  constexpr int U = PER < U0 ? PER : U0;   // slots a group has in flight
  const int lane = threadIdx.x & 31;
  const int sub = lane / S;
  const int c0 = lane % S;
  const long long warp =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const long long first = warp * kWarpSlots;
  if (first >= nse) {
    return;  // the whole warp leaves together
  }
  const long long last = min(first + kWarpSlots, nse);
  const bool single_pass = nv <= S * NV;
  const V* g = reinterpret_cast<const V*>(G);
  const V* x = reinterpret_cast<const V*>(X);
  // Slot ids of a batch of 32 * M slots: lane l holds slot b + 32 m + l;
  // -1 past the warp's slots.
  int rid[M], cid[M];
  auto load_ids = [&](long long b, int (&r)[M], int (&c)[M]) {
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const long long q = b + 32 * m + lane;
      r[m] = q < last ? __ldcs(major + q) : -1;
      c[m] = q < last ? __ldcs(colind + q) : 0;
    }
  };
  load_ids(first, rid, cid);
  int g_row = -1;   // the row whose G vectors g_keep holds
  V g_keep[NV];
  for (long long b = first; b < last; b += 32 * M) {
    int rnext[M], cnext[M];
    load_ids(b + 32 * M, rnext, cnext);  // the next batch's ids, in flight
    T res[M];
#pragma unroll
    for (int m = 0; m < M; ++m) {
      res[m] = T(0);
    }
#pragma unroll
    for (int i0 = 0; i0 < PER; i0 += U) {
      int rr[U], cc[U];
      bool live[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        // slot (i0 + u) * SG + sub of the batch, held by a lane of
        // register (i0 + u) * SG / 32
        const int i = i0 + u;
        rr[u] = __shfl_sync(0xffffffffu, rid[(i * SG) / 32],
                            (i * SG) % 32 + sub);
        cc[u] = __shfl_sync(0xffffffffu, cid[(i * SG) / 32],
                            (i * SG) % 32 + sub);
        live[u] = rr[u] >= 0 && rr[u] < nrows;
      }
      T sum[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        sum[u] = T(0);
      }
      // Slots of one row share its G vectors, kept in registers (g_keep,
      // of row g_row) from one step to the next. A step's last slot names
      // the row it most likely moves to: its G vectors load with the X
      // rows; any other new row loads when it comes.
      const bool fresh = single_pass && live[U - 1] && rr[U - 1] != g_row;
      for (long long cb = 0; cb < nv; cb += S * NV) {
        V xv[U][NV], g_new[NV];
#pragma unroll
        for (int t = 0; t < NV; ++t) {
          const long long j = cb + c0 + t * S;
          if (fresh && j < nv) {
            g_new[t] = __ldg(g + static_cast<long long>(rr[U - 1]) * nv + j);
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
#pragma unroll
          for (int t = 0; t < NV; ++t) {
            const long long j = cb + c0 + t * S;
            if (live[u] && j < nv) {
              xv[u][t] = __ldg(x + static_cast<long long>(cc[u]) * nv + j);
            }
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (!live[u]) {
            continue;
          }
          V gv[NV];
#pragma unroll
          for (int t = 0; t < NV; ++t) {
            const long long j = cb + c0 + t * S;
            if (j < nv) {
              if (single_pass && rr[u] == g_row) {
                gv[t] = g_keep[t];
              } else if (fresh && rr[u] == rr[U - 1]) {
                gv[t] = g_new[t];
              } else {
                gv[t] = __ldg(g + static_cast<long long>(rr[u]) * nv + j);
              }
              sum[u] += R::dot(gv[t], xv[u][t]);
            }
          }
        }
        if (fresh) {
#pragma unroll
          for (int t = 0; t < NV; ++t) {
            g_keep[t] = g_new[t];
          }
          g_row = rr[U - 1];
        }
      }
      // A fixed tree over the group's lanes; every lane of the warp takes
      // part. Lane c0 keeps the sums of the slots i with i % S == c0.
#pragma unroll
      for (int u = 0; u < U; ++u) {
#pragma unroll
        for (int off = S / 2; off > 0; off >>= 1) {
          sum[u] += __shfl_xor_sync(0xffffffffu, sum[u], off);
        }
        const int i = i0 + u;
        if (c0 == i % S) {
          res[i / S] = live[u] ? sum[u] : T(0);
        }
      }
    }
    // Lane (sub, c0) writes slot (m S + c0) SG + sub of each m: the
    // warp's 32 stores of an m cover 32 consecutive slots.
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const long long q = b + static_cast<long long>(m * S + c0) * SG + sub;
      if (q < last) {
        __stcs(out + q, res[m]);
      }
    }
#pragma unroll
    for (int m = 0; m < M; ++m) {
      rid[m] = rnext[m];
      cid[m] = cnext[m];
    }
  }
}

template <typename T, bool VEC, int S, int NV>
int launch_s(const void* major, const void* colind, const void* G,
             const void* X, void* out, long long nse, long long nrows,
             long long nv, cudaStream_t stream) {
  const long long warps = (nse + kWarpSlots - 1) / kWarpSlots;
  const long long blocks = (warps + kThreads / 32 - 1) / (kThreads / 32);
  if (blocks > 2147483647LL || nrows > 2147483647LL) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  csr_sddmm_kernel<T, VEC, S, NV><<<static_cast<unsigned>(blocks), kThreads,
                                    0, stream>>>(
      static_cast<const int*>(major), static_cast<const int*>(colind),
      static_cast<const T*>(G), static_cast<const T*>(X),
      static_cast<T*>(out), nse, static_cast<int>(nrows), nv);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool VEC>
int launch_v(const void* major, const void* colind, const void* G,
             const void* X, void* out, long long nse, long long nrows,
             long long k, cudaStream_t s) {
  const long long nv = k / Row<T, VEC>::kWidth;
  if (nv <= 1) return launch_s<T, VEC, 1, 1>(major, colind, G, X, out, nse, nrows, nv, s);
  if (nv <= 2) return launch_s<T, VEC, 2, 1>(major, colind, G, X, out, nse, nrows, nv, s);
  if (nv <= 4) return launch_s<T, VEC, 4, 1>(major, colind, G, X, out, nse, nrows, nv, s);
  if (nv <= 8) return launch_s<T, VEC, 8, 1>(major, colind, G, X, out, nse, nrows, nv, s);
  if (nv <= 16) return launch_s<T, VEC, 16, 1>(major, colind, G, X, out, nse, nrows, nv, s);
  if (nv <= 32) return launch_s<T, VEC, 32, 1>(major, colind, G, X, out, nse, nrows, nv, s);
  return launch_s<T, VEC, 32, 2>(major, colind, G, X, out, nse, nrows, nv, s);
}

bool aligned16(const void* p) {
  return reinterpret_cast<std::uintptr_t>(p) % 16 == 0;
}

template <typename T>
int launch(const void* major, const void* colind, const void* G,
           const void* X, void* out, long long nse, long long nrows,
           long long k, int variant, void* stream) {
  if (nse < 0 || nrows < 0 || k < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (nse == 0 || k == 0) {
    return static_cast<int>(cudaSuccess);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant == kScalar) {
    return launch_v<T, false>(major, colind, G, X, out, nse, nrows, k, s);
  }
  if (variant != kVector || (k * static_cast<long long>(sizeof(T))) % 16 ||
      !aligned16(G) || !aligned16(X)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_v<T, true>(major, colind, G, X, out, nse, nrows, k, s);
}

}  // namespace

extern "C" int spal_csr_sddmm_f32(const void* major, const void* colind,
                                  const void* G, const void* X, void* out,
                                  long long nse, long long nrows, long long k,
                                  int variant, void* stream) {
  return launch<float>(major, colind, G, X, out, nse, nrows, k, variant,
                       stream);
}

extern "C" int spal_csr_sddmm_f64(const void* major, const void* colind,
                                  const void* G, const void* X, void* out,
                                  long long nse, long long nrows, long long k,
                                  int variant, void* stream) {
  return launch<double>(major, colind, G, X, out, nse, nrows, k, variant,
                        stream);
}
