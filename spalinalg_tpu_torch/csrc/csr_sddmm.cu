// CSR sampled dense-dense matrix product (SDDMM) for Hopper (sm_90a):
//
//   out[p] = sum over c < k of G[row_p, c] * X[colind[p], c]
//
// for every stored slot p below rowptr[nrows], and out[p] = 0 for the
// padding slots past it. G is (nrows, k) and X (ncols, k), row-major and
// contiguous. It is the gradient of a CSR product with respect to its
// values: for Y = A X with output gradient G, dvals[p] = G[row_p] . X[col_p]
// (k = 1 is SpMV's dvals[p] = g[row_p] * x[col_p]). The scalar and vector
// variants read row_p from major, the per-slot row id the cached transpose
// plan already holds (nrows for a padding slot); staged and rowwalk find it
// from rowptr.
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
// 2^26 slots) are the scalar and vector variants' cost; the staged and
// rowwalk variants below read rowptr instead.
//
// What the vector and scalar design does about it: a warp owns 512
// consecutive slots and walks them in batches of 32 M slots, whose row and
// column ids it loads with one coalesced __ldcs a lane (M of them), the
// next batch's while the current one's rows are in flight. A group of S lanes owns a slot (S the
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
// instances 58-115, spilling 0-8 bytes. The staged kernel at k = 64 (32
// rows a tile) 48 (float, NV = 2) and 59 (double, NV = 4), no spills; its
// other instances 30-72, spilling 0-8 bytes; the rowwalk kernel 30.
//
// Two more variants read no row id a slot: they take rowptr and a plan
// built once per structure instead of major, and write 0 to the padding
// slots [rowptr[nrows], nse) themselves (every CTA a strided share).
//
// staged (X, G and colind start on a 16-byte boundary; the tile plan of
// csr_tile_plan at 32 or 64 rows a tile, which the wrapper builds at 32;
// the wrapper takes it where what a CTA stages fits STAGE_BUDGET). On a
// banded matrix the vector variant gathers a whole row of X from L2 for
// every slot: 33 slots a row x 512 B (double, k = 64) x 2^19 rows, 8.9 GB
// a launch, for rows of X that only 33 neighbouring rows need; it also
// spends ten shuffles a slot (five xor levels of a double over a whole
// warp) at one shuffle a clock an SM. Here a CTA of 256 threads owns a
// tile of TR consecutive rows and copies, with 16-byte cp.async pieces
// (one wait), three contiguous runs into shared memory: the rows [c0, c0
// + w) of X its slots read, its own TR rows of G and its slots' column
// ids. At TR = 32 on the banded matrix that is 32 + 16 + 4 KB (double, k
// = 64), which leaves room for four CTAs an SM; at TR = 64 (89 KB) two
// CTAs an SM could not hide one CTA's copies behind the other's work. The
// warps then take the tile's rows in turn (their slot ranges read from
// rowptr while the copies run) and work from shared memory alone. A lane
// holds its row's G vectors in registers and the row's slots go to groups
// of S lanes, a slot a group: S = 8 where a row of X has at least eight
// 16-byte vectors, so that each quarter warp (one shared-memory wavefront
// of 16-byte loads) reads 128 contiguous bytes of one row of X and no bank
// is hit twice; a lane sums NV = nv / 8 vectors in order (up to 8; wider
// rows in passes, each pass's sum added to the stored one). A group ends a
// slot with a three-level __shfl_xor_sync tree (six shuffles a double
// slot, for four slots a warp at once) and its first lane stores it with
// __stcs. The lane split is not the vector variant's (S = 32 / 16 there at
// k = 64), so the sums are taken in another fixed order: the variant is
// held at TOL·|G||X| against the plain version, and is bitwise the same
// from run to run. 16-byte vectors where k * sizeof(T) is a multiple of
// 16, one element a lane otherwise.
//
// rowwalk (k = 1 only: the SpMV's dvals; the vector SpMV's plan,
// csr_spmv_plan). The scalar variant reads major, 4 B a slot (268 MB a
// launch at 2^26 slots, 0.08 ms at 3.35 TB/s). Here a warp takes one of
// the plan's windows (its short rows and their entries, fewer than 2 *
// kBudget) or one piece of kBudget entries of a long row. A window warp
// walks its entries 32 at a time, a slot a lane, and finds each slot's row
// from rowptr: the lanes hold the ends of 32 consecutive rows (read through
// L1), and a five-step binary search by __shfl_sync counts the ends at or
// before the lane's slot; the warp starts the next step at the row of its
// last slot. A piece warp's slots all lie in its row. Each slot then
// gathers g[row] and x[col] and stores their product with __stcs.
//
// C interface: one entry point per type, with the variant as an int (0
// scalar, 1 vector, 2 staged, 3 rowwalk) and the plan as a pointer and three
// counts (staged: the rows a tile, the widest window and the most slots a
// tile; rowwalk: the windows and the pieces). Each launches on the given
// stream, allocates nothing, does not synchronise, and returns
// cudaGetLastError(), or cudaErrorInvalidValue for arguments the variant
// does not take (staged: X, G or colind off 16 bytes, a tile height other
// than 32 or 64, runs past the shared memory a CTA may hold; rowwalk: k !=
// 1; scalar and vector: no major). nse == 0 or k == 0 launches nothing; so
// does nrows == 0, which the caller handles (every slot is padding).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kWarpSlots = 512;  // slots a warp
constexpr int kScalar = 0;
constexpr int kVector = 1;
constexpr int kStaged = 2;
constexpr int kRowWalk = 3;
// Rows a tile: TILE_ROWS in ops/kernels/csr_spmv.py; staged takes it or
// half of it.
constexpr int kTileRows = 64;
constexpr int kBudget = 256;             // BUDGET in ops/kernels/csr_spmv.py
constexpr long long kMaxShared = 232448; // what a CTA may hold on an H100
constexpr unsigned kFull = 0xffffffffu;

template <typename T, bool VEC>
struct Row;

template <typename T>
struct Row<T, false> {
  using V = T;
  static constexpr int kWidth = 1;
  static __device__ __forceinline__ T dot(const V& a, const V& b) {
    return a * b;
  }
  static __device__ __forceinline__ T mac(const V& a, const V& b, T s) {
    return s + a * b;
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
  static __device__ __forceinline__ float mac(const V& a, const V& b,
                                              float s) {
    s += a.x * b.x;
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
  static __device__ __forceinline__ double mac(const V& a, const V& b,
                                               double s) {
    s += a.x * b.x;
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

// 16 bytes from global to shared memory.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem));
}

// Start the copy of the elements [first, first + count) of src (16-byte
// aligned) into smem with 16-byte cp.async pieces from the 16-byte
// boundary at or below them; return where element `first` will land. The
// caller waits with stage_wait.
template <typename T>
__device__ const T* stage_copy(unsigned char* smem, const T* src,
                               long long first, long long count) {
  const long long b0 = first * static_cast<long long>(sizeof(T));
  const long long a0 = b0 & ~15LL;
  const long long pieces =
      count > 0 ? (b0 + count * static_cast<long long>(sizeof(T)) - a0 + 15) >> 4
                : 0;
  const unsigned char* from = reinterpret_cast<const unsigned char*>(src) + a0;
  for (long long i = threadIdx.x; i < pieces; i += blockDim.x) {
    cp_async16(smem + 16 * i, from + 16 * i);
  }
  return reinterpret_cast<const T*>(smem + (b0 - a0));
}

// Wait for every thread's copies. Takes every thread of the CTA.
__device__ __forceinline__ void stage_wait() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();
}

// 0 to the padding slots [rowptr[nrows], nse), a strided share a thread.
template <typename T>
__device__ __forceinline__ void zero_padding(const int* rowptr, T* out,
                                             long long nse, long long nrows) {
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long q = rowptr[nrows] + static_cast<long long>(blockIdx.x) *
                                         blockDim.x + threadIdx.x;
       q < nse; q += step) {
    out[q] = T(0);
  }
}

// staged: plan holds (first slot, end slot, c0, w) a tile of kTileRows
// rows. Shared memory: the window of X (x_bytes), the tile's rows of G
// (g_bytes), then its column ids.
template <typename T, bool VEC, int S, int NV, int TR>
__global__ void __launch_bounds__(kThreads)
csr_sddmm_staged(const int* __restrict__ rowptr, const int* __restrict__ colind,
                 const T* __restrict__ G, const T* __restrict__ X,
                 T* __restrict__ out, const int4* __restrict__ plan,
                 long long nse, long long nrows, long long nv,
                 long long x_bytes, long long g_bytes) {
  using R = Row<T, VEC>;
  using V = typename R::V;
  constexpr int SG = 32 / S;  // slots a warp at once
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int4 tile = plan[blockIdx.x];
  const long long e0 = tile.x;
  const long long c0 = tile.z;
  const long long r0 = static_cast<long long>(blockIdx.x) * TR;
  const long long r1 = r0 + TR < nrows ? r0 + TR : nrows;
  const long long k = nv * R::kWidth;
  // The warp's rows are r0 + warp + kWarps * i; lane i holds the i-th
  // one's slot range, read while the copies run.
  const long long my_row = r0 + warp + static_cast<long long>(kWarps) * lane;
  int row_start = 0, row_end = 0;
  if (lane < TR / kWarps && my_row < r1) {
    row_start = rowptr[my_row];
    row_end = rowptr[my_row + 1];
  }
  // With 16-byte vectors a row of X or G is a whole number of them, so
  // both runs start on a 16-byte boundary of shared memory.
  const V* xs = reinterpret_cast<const V*>(
      stage_copy(smem, X, c0 * k, static_cast<long long>(tile.w) * k));
  const V* gs =
      reinterpret_cast<const V*>(stage_copy(smem + x_bytes, G, r0 * k,
                                            (r1 - r0) * k));
  const int* cs = stage_copy(smem + x_bytes + g_bytes, colind, e0,
                             static_cast<long long>(tile.y) - e0);
  stage_wait();
  zero_padding(rowptr, out, nse, nrows);
  const int sub = lane / S;
  const int cl = lane % S;
  for (int i = 0; i < TR / kWarps; ++i) {
    const long long row = r0 + warp + static_cast<long long>(kWarps) * i;
    if (row >= r1) {
      break;  // uniform: the same row in every lane
    }
    const long long start = __shfl_sync(kFull, row_start, i);
    const long long end = __shfl_sync(kFull, row_end, i);
    const V* gr = gs + (row - r0) * nv;
    // p0 = p - sub is the same in every lane: the loop is uniform.
    for (long long cb = 0; cb < nv; cb += S * NV) {
      V gk[NV];
#pragma unroll
      for (int t = 0; t < NV; ++t) {
        const long long j = cb + cl + t * S;
        if (j < nv) {
          gk[t] = gr[j];
        }
      }
      for (long long p = start + sub; p - sub < end; p += SG) {
        const bool live = p < end;
        const V* xr = xs + (live ? cs[p - e0] - c0 : 0) * nv;
        T sum = T(0);
#pragma unroll
        for (int t = 0; t < NV; ++t) {
          const long long j = cb + cl + t * S;
          if (live && j < nv) {
            sum = R::mac(gk[t], xr[j], sum);
          }
        }
#pragma unroll
        for (int off = S / 2; off > 0; off >>= 1) {
          sum += __shfl_xor_sync(kFull, sum, off);
        }
        if (live && cl == 0) {
          if (cb == 0) {
            __stcs(out + p, sum);
          } else {
            out[p] += sum;  // a later pass of a row wider than S * NV
          }
        }
      }
    }
  }
}

// rowwalk (k = 1): plan is csr_spmv_plan's (windows as int4 (r0, r1, e0,
// e1), then each piece's row and first slot).
template <typename T>
__global__ void __launch_bounds__(kThreads)
csr_sddmm_rowwalk(const int* __restrict__ rowptr,
                  const int* __restrict__ colind, const T* __restrict__ g,
                  const T* __restrict__ x, T* __restrict__ out,
                  const int* __restrict__ plan, long long nwin,
                  long long npieces, long long nse, long long nrows) {
  zero_padding(rowptr, out, nse, nrows);
  const int lane = threadIdx.x & 31;
  const long long w =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  if (w >= nwin + npieces) {
    return;  // the whole warp leaves together
  }
  if (w >= nwin) {
    const long long piece = w - nwin;
    const long long row = plan[4 * nwin + piece];
    const long long first = plan[4 * nwin + npieces + piece];
    const long long row_end = rowptr[row + 1];
    const long long end = first + kBudget < row_end ? first + kBudget : row_end;
    const T gr = __ldg(g + row);
    for (long long p = first + lane; p < end; p += 32) {
      __stcs(out + p, gr * __ldg(x + __ldcs(colind + p)));
    }
    return;
  }
  const int4 win = reinterpret_cast<const int4*>(plan)[w];
  const long long r1 = win.y;
  const long long e1 = win.w;
  long long rb = win.x;  // rows before rb end at or before the step's slots
  for (long long base = win.z; base < e1; base += 32) {
    const long long p = base + lane;
    const bool live = p < e1;
    const int col = live ? __ldcs(colind + p) : 0;
    long long row = rb;
    bool need = live;
    for (long long cb = rb; __any_sync(kFull, need); cb += 32) {
      // the ends of rows cb .. cb + 31 (sorted), past the window's rows
      // none
      const int end_j = cb + lane < r1 ? __ldg(rowptr + cb + lane + 1)
                                       : 0x7fffffff;
      const int last = __shfl_sync(kFull, end_j, 31);
      int pos = 0;  // the count of those ends at or before p
#pragma unroll
      for (int s = 16; s > 0; s >>= 1) {
        if (__shfl_sync(kFull, end_j, pos + s - 1) <= p) {
          pos += s;
        }
      }
      if (pos == 31 && last <= p) {
        pos = 32;
      }
      if (need && pos < 32) {
        row = cb + pos;
        need = false;
      }
    }
    rb = __shfl_sync(kFull, row, 31);
    if (live) {
      __stcs(out + p, __ldg(g + row) * __ldg(x + col));
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

template <typename T, bool VEC, int S, int NV, int TR>
int launch_st(const void* rowptr, const void* colind, const void* G,
              const void* X, void* out, const void* plan, long long ntiles,
              long long x_bytes, long long g_bytes, long long shared,
              long long nse, long long nrows, long long nv,
              cudaStream_t stream) {
  const cudaError_t raised = cudaFuncSetAttribute(
      csr_sddmm_staged<T, VEC, S, NV, TR>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(shared));
  if (raised != cudaSuccess) {
    return static_cast<int>(raised);
  }
  csr_sddmm_staged<T, VEC, S, NV, TR><<<static_cast<unsigned>(ntiles),
                                        kThreads, static_cast<size_t>(shared),
                                        stream>>>(
      static_cast<const int*>(rowptr), static_cast<const int*>(colind),
      static_cast<const T*>(G), static_cast<const T*>(X),
      static_cast<T*>(out), static_cast<const int4*>(plan), nse, nrows, nv,
      x_bytes, g_bytes);
  return static_cast<int>(cudaGetLastError());
}

// Lanes a slot and vectors a lane: eight lanes (128 contiguous bytes of a
// row of X a quarter warp) from eight vectors a row up.
template <typename T, bool VEC, int TR>
int launch_staged_v(const void* rowptr, const void* colind, const void* G,
                    const void* X, void* out, const void* plan,
                    long long ntiles, long long x_bytes, long long g_bytes,
                    long long shared, long long nse, long long nrows,
                    long long k, cudaStream_t s) {
  const long long nv = k / Row<T, VEC>::kWidth;
  if (nv <= 1) return launch_st<T, VEC, 1, 1, TR>(rowptr, colind, G, X, out, plan, ntiles, x_bytes, g_bytes, shared, nse, nrows, nv, s);
  if (nv <= 2) return launch_st<T, VEC, 2, 1, TR>(rowptr, colind, G, X, out, plan, ntiles, x_bytes, g_bytes, shared, nse, nrows, nv, s);
  if (nv <= 4) return launch_st<T, VEC, 4, 1, TR>(rowptr, colind, G, X, out, plan, ntiles, x_bytes, g_bytes, shared, nse, nrows, nv, s);
  if (nv <= 8) return launch_st<T, VEC, 8, 1, TR>(rowptr, colind, G, X, out, plan, ntiles, x_bytes, g_bytes, shared, nse, nrows, nv, s);
  if (nv <= 16) return launch_st<T, VEC, 8, 2, TR>(rowptr, colind, G, X, out, plan, ntiles, x_bytes, g_bytes, shared, nse, nrows, nv, s);
  if (nv <= 32) return launch_st<T, VEC, 8, 4, TR>(rowptr, colind, G, X, out, plan, ntiles, x_bytes, g_bytes, shared, nse, nrows, nv, s);
  return launch_st<T, VEC, 8, 8, TR>(rowptr, colind, G, X, out, plan, ntiles, x_bytes, g_bytes, shared, nse, nrows, nv, s);
}

bool aligned16(const void* p) {
  return reinterpret_cast<std::uintptr_t>(p) % 16 == 0;
}

// Bytes of a staged run of `bytes`, copied from the 16-byte boundary below
// it, rounded to whole 16-byte pieces.
long long run_bytes(long long bytes) { return (bytes + 31) / 16 * 16; }

// rows: the plan's rows a tile, kTileRows or kTileRows / 2.
template <typename T>
int launch_staged(const void* rowptr, const void* colind, const void* G,
                  const void* X, void* out, const void* plan, long long rows,
                  long long max_window, long long max_slots, long long nse,
                  long long nrows, long long k, cudaStream_t s) {
  const long long row_bytes = k * static_cast<long long>(sizeof(T));
  const long long x_bytes = run_bytes(max_window * row_bytes);
  const long long g_bytes = run_bytes(rows * row_bytes);
  const long long shared = x_bytes + g_bytes + run_bytes(4 * max_slots);
  if (!aligned16(X) || !aligned16(G) || !aligned16(colind) ||
      rowptr == nullptr || plan == nullptr || max_window < 0 ||
      max_slots < 0 || (rows != kTileRows && rows != kTileRows / 2) ||
      shared > kMaxShared) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long ntiles = (nrows + rows - 1) / rows;
  const bool vec = row_bytes % 16 == 0;
  if (rows == kTileRows) {
    return vec ? launch_staged_v<T, true, kTileRows>(rowptr, colind, G, X, out, plan, ntiles, x_bytes, g_bytes, shared, nse, nrows, k, s)
               : launch_staged_v<T, false, kTileRows>(rowptr, colind, G, X, out, plan, ntiles, x_bytes, g_bytes, shared, nse, nrows, k, s);
  }
  return vec ? launch_staged_v<T, true, kTileRows / 2>(rowptr, colind, G, X, out, plan, ntiles, x_bytes, g_bytes, shared, nse, nrows, k, s)
             : launch_staged_v<T, false, kTileRows / 2>(rowptr, colind, G, X, out, plan, ntiles, x_bytes, g_bytes, shared, nse, nrows, k, s);
}

template <typename T>
int launch_rowwalk(const void* rowptr, const void* colind, const void* G,
                   const void* X, void* out, const void* plan, long long nwin,
                   long long npieces, long long nse, long long nrows,
                   long long k, cudaStream_t stream) {
  if (k != 1 || rowptr == nullptr || plan == nullptr || nwin < 1 ||
      npieces < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long blocks = (nwin + npieces + kWarps - 1) / kWarps;
  if (blocks > 2147483647LL) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  csr_sddmm_rowwalk<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                         stream>>>(
      static_cast<const int*>(rowptr), static_cast<const int*>(colind),
      static_cast<const T*>(G), static_cast<const T*>(X),
      static_cast<T*>(out), static_cast<const int*>(plan), nwin, npieces,
      nse, nrows);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* major, const void* rowptr, const void* colind,
           const void* G, const void* X, void* out, long long nse,
           long long nrows, long long k, int variant, const void* plan,
           long long n_a, long long n_b, long long n_c, void* stream) {
  if (nse < 0 || nrows < 0 || k < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (nse == 0 || k == 0 || nrows == 0) {
    return static_cast<int>(cudaSuccess);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant == kStaged) {
    return launch_staged<T>(rowptr, colind, G, X, out, plan, n_a, n_b, n_c,
                            nse, nrows, k, s);
  }
  if (variant == kRowWalk) {
    return launch_rowwalk<T>(rowptr, colind, G, X, out, plan, n_a, n_b, nse,
                             nrows, k, s);
  }
  if (major == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
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

extern "C" int spal_csr_sddmm_f32(const void* major, const void* rowptr,
                                  const void* colind, const void* G,
                                  const void* X, void* out, long long nse,
                                  long long nrows, long long k, int variant,
                                  const void* plan, long long n_a,
                                  long long n_b, long long n_c,
                                  void* stream) {
  return launch<float>(major, rowptr, colind, G, X, out, nse, nrows, k,
                       variant, plan, n_a, n_b, n_c, stream);
}

extern "C" int spal_csr_sddmm_f64(const void* major, const void* rowptr,
                                  const void* colind, const void* G,
                                  const void* X, void* out, long long nse,
                                  long long nrows, long long k, int variant,
                                  const void* plan, long long n_a,
                                  long long n_b, long long n_c,
                                  void* stream) {
  return launch<double>(major, rowptr, colind, G, X, out, nse, nrows, k,
                        variant, plan, n_a, n_b, n_c, stream);
}
