// SpGEMM numeric phase for Hopper (sm_90a): the values of C = A B on a fixed
// symbolic plan.
//
//   out[g] = sum over the terms (i, k, j) of row i with slot g of
//            a[e] * b[p],   e in [a_ptr[i], a_ptr[i+1]), k = a_col[e],
//                           p in [b_ptr[k], b_ptr[k+1]), j = b_col[p]
//
// where slot g = c_ptr[i] + s and s is the position of j in C's row i,
// c_col[c_ptr[i] .. c_ptr[i+1]) (sorted and unique: the symbolic phase's
// output). A slot whose terms cancel keeps its exact sum, 0 included.
//
// Replaces the Pallas kernel of the JAX package's SpGEMM numeric phase:
//   spalinalg_tpu/ops/kernels/pair_route.py  _pair_kernel  (B3)
// with its tail fold and spill, which add into the same sum. Its paired
// route tables, lane-gather network and f32-only arithmetic exist because
// the TPU serialises dynamic gathers; Hopper gathers natively, in float or
// double. Two variants, named by the caller (the wrapper passes terms
// unless told rowwise):
//
// terms. The plan's term list sorted by slot (a_idx, b_idx: 8 index bytes
// a term) and tptr, each slot's first term. A warp owns 32 consecutive
// slots and walks their terms 32 at a time (lane l takes term base + l:
// coalesced index loads, every lane busy however the terms fall into
// slots); a lane finds its slot by a binary search over the warp's 33 slot
// pointers in shared memory, a segmented scan (__shfl_up_sync, fixed
// offsets) sums each slot's terms within the batch, and the last lane of a
// segment adds the sum to the slot's accumulator. Bound by the index
// stream and the value gathers (L2 hits where the operands fit there).
//
// rowwise. Row by row over the CSR arrays of A, B and C, and a row plan
// (the wrapper's spgemm_rows, built once per structure): none of the term
// list. The compulsory bytes are then A's arrays once, C's column ids once
// and C's values written once; every term still gathers a column id and a
// value of B (L2 hits where B fits), finds its slot in C's row and adds
// into an accumulator. The plan puts each row of C in one bin by its work,
// and one grid runs each bin and length class, the heaviest first:
// - thread: at most kThreadSlots slots (and a bounded walk). A thread
//   walks the row's terms in order, finds each one's slot by comparing its
//   column with the row's column ids held in registers, and adds into its
//   own column of shared memory. The sums are in term order.
// - warp, cta: a warp (warp bin; kBlockWarps rows a block) or kCtaWarps
//   warps (cta bin) a row. They copy C's row into shared memory with a
//   zeroed accumulator of the same length and a bucket index over the
//   row's column range (start[q] is the first slot whose column falls in
//   bucket q, so a lookup is two reads and a short binary search). They
//   walk A's row in chunks of one entry a thread: each thread reads its
//   entry's B row bounds, a scan lays the chunk's terms out flat, and each
//   warp takes kUnroll batches of 32 consecutive terms at a time (a lane
//   finds its A entry by a binary search of the chunk's prefix sums), with
//   every batch's loads of B in flight before the first lookup.
// - wide: a row whose column ids and accumulator do not fit the budget
//   the wrapper passes: as cta, but the accumulator is the output itself
//   and the column ids are searched where they lie, in device memory.
// Determinism, with no atomics: lanes that hit one slot in one round
// (repeated columns in A's or B's rows, or two B rows sharing a column)
// are combined in a fixed order. Each warp, in warp order, matches its
// lanes on the slot (__match_any_sync); the lowest lane of each set sums
// the set's products in lane order and adds the sum to the slot, one
// batch after another. A cta row first tries the quick way: every term
// writes its id into a tag array over the row's slots, and if every term
// reads its own id back (no two terms of the round share a slot), each
// adds its own product at once. Products are rounded before they are added
// (no fused multiply-add), as in the plain version, so an exact
// cancellation gives 0.
//
// Both variants' summation order depends only on the structure, so a
// result is bitwise the same from run to run; it differs from the plain
// version's, so they agree within tol·Σ|a||b|.
//
// What the H100 showed (PERF.md, the B3 findings): on the power-law A·A of 45.7M
// terms rowwise takes about 3x the time of terms. In the warp and cta
// bins the rounds (their barriers, tag checks and ordered commits) and
// each row's set-up take the time, not the lookups or the loads of B.
// So every caller runs terms, and rowwise runs only where it is named.
//
// C interface: one entry point per variant and type. Each launches on the
// given stream, allocates nothing, does not synchronise, and returns
// cudaGetLastError(); rowwise refuses (cudaErrorInvalidValue) a grid whose
// longest row does not fit its shared memory. n_out == 0 (terms) or an
// empty grid list (rowwise) launches nothing.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreadSlots = 16;    // slots (and terms) of a thread-bin row
constexpr int kThreadBlock = 256;
constexpr int kCtaWarps = 8;        // warps of a cta (and wide) row
constexpr int kBlockWarps = 8;      // warps of a block (warp bin: a row each)
constexpr int kUnroll = 2;          // batches of 32 terms a warp takes a round
constexpr int kWideBuckets = 4096;  // bucket index of a wide row
constexpr int kStage = 8;           // loads in flight a thread, staging
constexpr long long kMaxShared = 232448;  // what a block may hold on an H100
constexpr long long kDefaultShared = 48 * 1024;

enum Bin { kThreadBin = 0, kWarpBin = 1, kCtaBin = 2, kWideBin = 3 };

__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}

__host__ __device__ constexpr long long round4(long long n) {
  return (n + 3) & ~3LL;
}

__host__ __device__ constexpr long long round16(long long n) {
  return (n + 15) & ~15LL;
}

// Shared-memory bytes of the G warps of one row for a row of `len` slots
// with `buckets` buckets (wide rows keep no slots in shared memory).
// Mirrored by the wrapper's row_bytes.
template <typename T, int G, bool WIDE>
__host__ __device__ constexpr long long row_bytes(long long len,
                                                  long long buckets) {
  constexpr long long threads = G * kWarp;
  constexpr bool tags = G > 1 && !WIDE;
  return static_cast<long long>(sizeof(T)) * (threads * (1 + kUnroll))
         + 4 * (2 * threads + G)
         + (WIDE ? 0 : len * static_cast<long long>(sizeof(T) + 4))
         + (tags ? round4(2 * len) : 0) + 4 * (buckets + 1);
}

__host__ __device__ inline long long ceil_pow2(long long n) {
  long long p = 1;
  while (p < n) {
    p <<= 1;
  }
  return p;
}

// First position in sorted col[lo, hi) whose value is >= j.
__device__ __forceinline__ int lower_bound(const int* col, int lo, int hi,
                                           int j) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (col[mid] < j) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

template <typename T>
__global__ void __launch_bounds__(kThreadBlock)
thread_rows(const int* __restrict__ a_ptr, const int* __restrict__ a_col,
            const T* __restrict__ a_val, const int* __restrict__ b_ptr,
            const int* __restrict__ b_col, const T* __restrict__ b_val,
            const int* __restrict__ c_ptr, const int* __restrict__ c_col,
            T* __restrict__ out, const int* __restrict__ rows, int nrows) {
  const int r = blockIdx.x * kThreadBlock + threadIdx.x;
  if (r >= nrows) {
    return;
  }
  const int i = rows[r];
  const int c0 = c_ptr[i];
  const int len = c_ptr[i + 1] - c0;
  // The row's column ids in registers; its accumulator in the thread's own
  // column of shared memory (a slot a row of kThreadBlock values).
  __shared__ T s_acc[kThreadSlots * kThreadBlock];
  T* acc = s_acc + threadIdx.x;
  int col[kThreadSlots];
#pragma unroll
  for (int s = 0; s < kThreadSlots; ++s) {
    col[s] = s < len ? c_col[c0 + s] : -1;
    acc[s * kThreadBlock] = T(0);
  }
  const int a1 = a_ptr[i + 1];
  for (int e = a_ptr[i]; e < a1; ++e) {
    const int k = a_col[e];
    const T av = a_val[e];
    const int p1 = b_ptr[k + 1];
#pragma unroll 4
    for (int p = b_ptr[k]; p < p1; ++p) {
      const int j = b_col[p];
      const T prod = mul_rn(av, b_val[p]);
      int slot = -1;
#pragma unroll
      for (int s = 0; s < kThreadSlots; ++s) {
        slot = col[s] == j ? s : slot;
      }
      if (slot >= 0) {
        acc[slot * kThreadBlock] += prod;
      }
    }
  }
#pragma unroll
  for (int s = 0; s < kThreadSlots; ++s) {
    if (s < len) {
      out[c0 + s] = acc[s * kThreadBlock];
    }
  }
}

// Barrier of the G warps of one row.
template <int G>
__device__ __forceinline__ void group_sync() {
  if (G == 1) {
    __syncwarp();
  } else {
    __syncthreads();
  }
}

template <int G>
__device__ __forceinline__ int group_sync_or(int flag) {
  if (G == 1) {
    return __any_sync(kFull, flag);
  }
  return __syncthreads_or(flag);
}

// G warps a row, NW / G rows a block (G is 1 or NW); `gbytes` is the
// shared memory of one row's warps.
template <typename T, int G, int NW, bool WIDE>
__global__ void __launch_bounds__(NW * kWarp)
block_rows(const int* __restrict__ a_ptr, const int* __restrict__ a_col,
           const T* __restrict__ a_val, const int* __restrict__ b_ptr,
           const int* __restrict__ b_col, const T* __restrict__ b_val,
           const int* __restrict__ c_ptr, const int* __restrict__ c_col,
           T* __restrict__ out, const int* __restrict__ rows, int nrows,
           int gbytes) {
  constexpr int kThreads = G * kWarp;  // of one row
  constexpr bool kTags = G > 1 && !WIDE;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x % kThreads;
  const int w = tid / kWarp;
  const int lane = tid % kWarp;
  const int r = blockIdx.x * (NW / G) + threadIdx.x / kThreads;
  if (r >= nrows) {
    return;  // the row's warps leave together
  }
  const int i = rows[r];
  const int a0 = a_ptr[i];
  const int a1 = a_ptr[i + 1];
  const int c0 = c_ptr[i];
  const int len = c_ptr[i + 1] - c0;
  if (len == 0) {
    return;
  }
  const int* gcol = c_col + c0;
  // The first chunk's A entries and B row bounds, loaded before the row is
  // staged so that the two wait together.
  int bs = 0;
  int bl = 0;
  T av = T(0);
  if (a0 + tid < a1) {
    const int k = a_col[a0 + tid];
    av = a_val[a0 + tid];
    bs = b_ptr[k];
    bl = b_ptr[k + 1] - bs;
  }

  // Layout of the row's shared memory: the T arrays first, then the ints.
  unsigned char* base = smem + static_cast<long long>(threadIdx.x / kThreads)
                        * gbytes;
  T* ch_av = reinterpret_cast<T*>(base);       // a value per chunk entry
  T* stage = ch_av + kThreads;                 // products, ordered path
  T* s_acc = stage + kThreads * kUnroll;       // [len], not WIDE
  int* ch_excl = reinterpret_cast<int*>(s_acc + (WIDE ? 0 : len));
  int* ch_bs = ch_excl + kThreads;             // B row start per entry
  int* wsum = ch_bs + kThreads;                // [G] scan totals
  int* s_col = wsum + G;                       // [len], not WIDE
  uint16_t* tag = reinterpret_cast<uint16_t*>(s_col + (WIDE ? 0 : len));
  int* start = reinterpret_cast<int*>(
      reinterpret_cast<unsigned char*>(tag) + (kTags ? round4(2LL * len) : 0));
  const int* col = WIDE ? gcol : s_col;
  T* acc = WIDE ? out + c0 : s_acc;

  // The bucket index: at most one bucket a slot (a power of two), as many
  // as fit, so that (column - lo) >> shift < buckets.
  const long long room = (gbytes - row_bytes<T, G, WIDE>(len, 0)) / 4;
  long long nb = WIDE ? kWideBuckets : ceil_pow2(len);
  while (nb > 1 && nb > room) {
    nb >>= 1;
  }
  const int lo = gcol[0];
  const int span = gcol[len - 1] - lo;
  int shift = 0;
  while ((span >> shift) >= nb) {
    ++shift;
  }
  const int used = (span >> shift) + 1;  // buckets in use, <= nb
  // Stage the row (kStage loads in flight a thread), zero the accumulator,
  // then fill the index from the staged copy.
  for (int s0 = tid; s0 < len; s0 += kThreads * kStage) {
    int cs[kStage];
#pragma unroll
    for (int k = 0; k < kStage; ++k) {
      const int s = s0 + k * kThreads;
      cs[k] = s < len ? gcol[s] : 0;
    }
#pragma unroll
    for (int k = 0; k < kStage; ++k) {
      const int s = s0 + k * kThreads;
      if (s < len) {
        if (!WIDE) {
          s_col[s] = cs[k];
        }
        acc[s] = T(0);
      }
    }
  }
  group_sync<G>();
  for (int s0 = tid; s0 < len; s0 += kThreads * kStage) {
    int q[kStage];
    int qp[kStage];
#pragma unroll
    for (int k = 0; k < kStage; ++k) {
      const int s = s0 + k * kThreads;
      q[k] = s < len ? (col[s] - lo) >> shift : 0;
      qp[k] = s > 0 && s < len ? (col[s - 1] - lo) >> shift : -1;
    }
#pragma unroll
    for (int k = 0; k < kStage; ++k) {
      const int s = s0 + k * kThreads;
      if (s < len) {
        for (int qq = qp[k] + 1; qq <= q[k]; ++qq) {
          start[qq] = s;
        }
        if (s == len - 1) {
          for (int qq = q[k] + 1; qq <= used; ++qq) {
            start[qq] = len;
          }
        }
      }
    }
  }

  for (long long chunk = a0; chunk < a1; chunk += kThreads) {
    if (chunk != a0) {
      bs = 0;
      bl = 0;
      av = T(0);
      if (chunk + tid < a1) {
        const int k = a_col[chunk + tid];
        av = a_val[chunk + tid];
        bs = b_ptr[k];
        bl = b_ptr[k + 1] - bs;
      }
    }
    // The chunk's terms laid out flat by a scan of its B row lengths.
    int incl = bl;
#pragma unroll
    for (int off = 1; off < kWarp; off <<= 1) {
      const int u = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) {
        incl += u;
      }
    }
    int before = 0;
    int total = 0;
    if (G == 1) {
      total = __shfl_sync(kFull, incl, kWarp - 1);
    } else {
      if (lane == kWarp - 1) {
        wsum[w] = incl;
      }
      group_sync<G>();
#pragma unroll
      for (int v = 0; v < G; ++v) {
        const int sv = wsum[v];
        before += v < w ? sv : 0;
        total += sv;
      }
    }
    ch_excl[tid] = before + incl - bl;
    ch_bs[tid] = bs;
    ch_av[tid] = av;
    group_sync<G>();

    for (int t0 = 0; t0 < total; t0 += kThreads * kUnroll) {
      int p[kUnroll];
      T a[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int t = t0 + (w * kUnroll + u) * kWarp + lane;
        p[u] = -1;
        a[u] = T(0);
        if (t < total) {
          // the last chunk entry whose first term is <= t (it has terms)
          int pos = 0;
#pragma unroll
          for (int step = kThreads / 2; step > 0; step >>= 1) {
            if (ch_excl[pos + step] <= t) {
              pos += step;
            }
          }
          p[u] = ch_bs[pos] + (t - ch_excl[pos]);
          a[u] = ch_av[pos];
        }
      }
      // every batch's loads in flight before the first is used
      int j[kUnroll];
      T bv[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        j[u] = -1;
        bv[u] = T(0);
        if (p[u] >= 0) {
          j[u] = __ldg(b_col + p[u]);
          bv[u] = __ldg(b_val + p[u]);
        }
      }
      int slot[kUnroll];
      T prod[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        slot[u] = -1;
        prod[u] = mul_rn(a[u], bv[u]);
        const int d = j[u] - lo;
        if (p[u] >= 0 && d >= 0 && d <= span) {
          const int q = d >> shift;
          const int hi = start[q + 1];
          const int s = lower_bound(col, start[q], hi, j[u]);
          if (s < hi && col[s] == j[u]) {
            slot[u] = s;
          }
        }
      }

      if (kTags) {
        // Quick way: no two terms of the round share a slot.
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (slot[u] >= 0) {
            tag[slot[u]] = static_cast<uint16_t>(tid * kUnroll + u);
          }
        }
        group_sync<G>();
        int clash = 0;
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (slot[u] >= 0 && tag[slot[u]] != tid * kUnroll + u) {
            clash = 1;
          }
        }
        if (!group_sync_or<G>(clash)) {
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            if (slot[u] >= 0) {
              acc[slot[u]] += prod[u];
            }
          }
          continue;
        }
      }

      // Ordered way: warp after warp, batch after batch, lanes that share
      // a slot summed in lane order by the lowest of them.
      T* wstage = stage + w * kWarp * kUnroll;
      for (int v = 0; v < G; ++v) {
        if (v == w) {
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            const int key = slot[u] >= 0 ? slot[u] : -1 - lane;
            const unsigned mask = __match_any_sync(kFull, key);
            wstage[u * kWarp + lane] = prod[u];
            __syncwarp();
            if (slot[u] >= 0 && lane == __ffs(mask) - 1) {
              T sum = prod[u];
              for (unsigned m = mask & (mask - 1); m != 0; m &= m - 1) {
                sum += wstage[u * kWarp + __ffs(m) - 1];
              }
              acc[slot[u]] += sum;
            }
            __syncwarp();
          }
        }
        group_sync<G>();
      }
    }
    group_sync<G>();  // the chunk arrays are rewritten next
  }

  if (!WIDE) {
    for (int s = tid; s < len; s += kThreads) {
      out[c0 + s] = s_acc[s];
    }
  }
}

struct Args {
  const int* a_ptr;
  const int* a_col;
  const void* a_val;
  const int* b_ptr;
  const int* b_col;
  const void* b_val;
  const int* c_ptr;
  const int* c_col;
  void* out;
  cudaStream_t stream;
};

template <typename T, int G, int NW, bool WIDE>
cudaError_t launch_rows(const Args& x, const int* rows, long long nrows,
                        long long gbytes) {
  constexpr int kRowsPerBlock = NW / G;
  const long long blocks = (nrows + kRowsPerBlock - 1) / kRowsPerBlock;
  const long long shared = gbytes * kRowsPerBlock;
  if (blocks > 2147483647LL) {
    return cudaErrorInvalidConfiguration;
  }
  if (shared > kMaxShared) {
    return cudaErrorInvalidValue;
  }
  if (shared > kDefaultShared) {
    const cudaError_t raised = cudaFuncSetAttribute(
        block_rows<T, G, NW, WIDE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(shared));
    if (raised != cudaSuccess) {
      return raised;
    }
  }
  block_rows<T, G, NW, WIDE><<<static_cast<unsigned>(blocks), NW * kWarp,
                               static_cast<size_t>(shared), x.stream>>>(
      x.a_ptr, x.a_col, static_cast<const T*>(x.a_val), x.b_ptr, x.b_col,
      static_cast<const T*>(x.b_val), x.c_ptr, x.c_col, static_cast<T*>(x.out),
      rows, static_cast<int>(nrows), static_cast<int>(gbytes));
  return cudaGetLastError();
}

// One grid: `nrows` rows of bin `bin` from rows[first], whose longest C row
// has `max_len` slots; `budget` caps a cta row's shared memory.
template <typename T>
cudaError_t launch_bin(const Args& x, const int* rows, long long bin,
                       long long first, long long nrows, long long max_len,
                       long long budget) {
  if (nrows <= 0 || first < 0 || max_len < 0) {
    return nrows == 0 ? cudaSuccess : cudaErrorInvalidValue;
  }
  rows += first;
  if (bin == kThreadBin) {
    if (max_len > kThreadSlots) {
      return cudaErrorInvalidValue;
    }
    const long long blocks = (nrows + kThreadBlock - 1) / kThreadBlock;
    if (blocks > 2147483647LL) {
      return cudaErrorInvalidConfiguration;
    }
    thread_rows<T><<<static_cast<unsigned>(blocks), kThreadBlock, 0,
                     x.stream>>>(
        x.a_ptr, x.a_col, static_cast<const T*>(x.a_val), x.b_ptr, x.b_col,
        static_cast<const T*>(x.b_val), x.c_ptr, x.c_col,
        static_cast<T*>(x.out), rows, static_cast<int>(nrows));
    return cudaGetLastError();
  }
  if (bin == kWarpBin) {
    // half a bucket a slot of the longest row
    const long long gbytes = round16(
        row_bytes<T, 1, false>(max_len, ceil_pow2(max_len) / 2));
    return launch_rows<T, 1, kBlockWarps, false>(x, rows, nrows, gbytes);
  }
  if (bin == kCtaBin) {
    const long long need = row_bytes<T, kCtaWarps, false>(max_len, 1);
    long long gbytes = round16(
        row_bytes<T, kCtaWarps, false>(max_len, ceil_pow2(max_len)));
    gbytes = gbytes < budget ? gbytes : budget;
    if (need > gbytes) {
      return cudaErrorInvalidValue;  // a row past the budget: a wide row
    }
    return launch_rows<T, kCtaWarps, kCtaWarps, false>(x, rows, nrows,
                                                        gbytes);
  }
  if (bin == kWideBin) {
    const long long gbytes = round16(
        row_bytes<T, kCtaWarps, true>(0, kWideBuckets));
    return launch_rows<T, kCtaWarps, kCtaWarps, true>(x, rows, nrows,
                                                       gbytes);
  }
  return cudaErrorInvalidValue;
}

// grids: `ngrids` quadruples (bin, first row, rows, longest C row) in host
// memory, launched in order; rows: the row ids they index.
template <typename T>
int launch(const void* a_ptr, const void* a_col, const void* a_val,
           const void* b_ptr, const void* b_col, const void* b_val,
           const void* c_ptr, const void* c_col, void* out, const void* rows,
           const void* grids, long long ngrids, long long budget,
           void* stream) {
  if (ngrids < 0 || budget > kMaxShared) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args x{static_cast<const int*>(a_ptr), static_cast<const int*>(a_col),
               a_val, static_cast<const int*>(b_ptr),
               static_cast<const int*>(b_col), b_val,
               static_cast<const int*>(c_ptr), static_cast<const int*>(c_col),
               out, static_cast<cudaStream_t>(stream)};
  const auto* g = static_cast<const long long*>(grids);
  for (long long n = 0; n < ngrids; ++n) {
    const cudaError_t err = launch_bin<T>(
        x, static_cast<const int*>(rows), g[4 * n], g[4 * n + 1],
        g[4 * n + 2], g[4 * n + 3], budget);
    if (err != cudaSuccess) {
      return static_cast<int>(err);
    }
  }
  return static_cast<int>(cudaSuccess);
}

// The terms variant: a warp owns 32 consecutive slots and walks their terms
// from the plan's slot-sorted term list (see the header).
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

extern "C" int spal_spgemm_rowwise_f32(
    const void* a_ptr, const void* a_col, const void* a_val,
    const void* b_ptr, const void* b_col, const void* b_val,
    const void* c_ptr, const void* c_col, void* out, const void* rows,
    const void* grids, long long ngrids, long long budget, void* stream) {
  return launch<float>(a_ptr, a_col, a_val, b_ptr, b_col, b_val, c_ptr,
                       c_col, out, rows, grids, ngrids, budget, stream);
}

extern "C" int spal_spgemm_rowwise_f64(
    const void* a_ptr, const void* a_col, const void* a_val,
    const void* b_ptr, const void* b_col, const void* b_val,
    const void* c_ptr, const void* c_col, void* out, const void* rows,
    const void* grids, long long ngrids, long long budget, void* stream) {
  return launch<double>(a_ptr, a_col, a_val, b_ptr, b_col, b_val, c_ptr,
                        c_col, out, rows, grids, ngrids, budget, stream);
}

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
