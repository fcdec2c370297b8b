// One conjugate-gradient step's vector work after the product ap = A·p, for
// Hopper (sm_90a): three passes over the n-vectors, and the first
// residual's dot products.
//
//   pap        out[0] = p·ap
//   update     alpha = rz / pap;  r = r - alpha·ap (in place);  z = inv·r
//              (z = r where inv is null; never stored);  out = [r·z, r·r]
//   direction  alpha = rz / pap, beta = rz' / rz;  x' = x + alpha·p (out of
//              place, from the old p);  p = z + beta·p (in place)
//   dots       out = [r·z, r·r] of the first residual, z as in update
//
// rz, pap and rz' are read from device memory by every thread: the host
// never sees them, and on a DistCsr each dot is summed over the ranks
// (an all_reduce in place) between the passes. x is updated in direction,
// which reads the old p anyway, so update need not read p.
//
// Replaces no Pallas kernel: the JAX package's CG
// (spalinalg_tpu/linalg/cg.py) runs its step as XLA code inside a
// lax.while_loop. It replaces the port's torch step (two divisions of 0-d
// tensors, four products and three sums of n-vectors, three cuBLAS dots),
// which makes 24 passes over n-vectors a step.
//
// What bounds it on this card: bytes. The passes read and write 12
// n-vectors a step with the Jacobi inverse (pap 2, update 4, direction 6;
// 10 without): at HPCG's 256^3 in float64 1.611 GB, 0.48 ms at 3.35 TB/s,
// against the torch step's 3.22 GB. The arithmetic (a few flops a value)
// is far below the card's rate.
//
// What the design does about it: every value is loaded and stored 16 bytes
// at a time (a double2 or float4; one value a lane where a vector is off a
// 16-byte boundary) with the streaming hints __ldcs / __stcs, since the
// vectors (100-134 MB in the benchmark's cells) never fit the 50 MB L2.
// Each thread walks packs grid-stride, on a grid of at most 4 blocks of 256
// threads on each of the 132 SMs. z is formed in registers where it is
// needed, in update and again in direction, and never stored.
//
// Elementwise results are exactly the torch step's: every product and sum
// is one round-to-nearest operation (__dmul_rn / __dadd_rn, __fmul_rn /
// __fadd_rn: never contracted into an FMA), in the torch step's order, and
// alpha and beta are IEEE divisions as torch's 0-d divisions are. So given
// the same dot values, x', r and p are bitwise the torch step's.
//
// Sums are deterministic: each thread sums its own values (FMAs) in walk
// order, a warp folds by a fixed __shfl_down_sync tree, thread 0 sums the
// warps in order and stores the block's partial. The last block to finish,
// elected by a ticket counter (one atomicAdd a block, after a
// __threadfence), sums the partials in a fixed order and resets the
// ticket to 0 for the next launch. No atomic touches a sum, so the bits
// depend only on n and on the vectors' alignment (the pack width), never on
// the order the blocks ran in.
//
// C interface: one entry point per pass and value type. Each launches on
// the given stream, allocates nothing (the caller gives the partials, of
// at least K·blocks values for K sums, and the ticket, an unsigned int
// that is 0), does not synchronise, and returns cudaGetLastError(). vec is
// 16 / sizeof(T) where every vector starts on a 16-byte boundary, else 1.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr long long kMaxBlocks = 132LL * 4;  // grid-stride beyond this

// Values of a 16-byte pack.
template <typename T>
constexpr int kPack = static_cast<int>(16 / sizeof(T));

// One round-to-nearest operation each, never contracted.
template <typename T>
struct Op;

template <>
struct Op<double> {
  static __device__ __forceinline__ double mul(double a, double b) {
    return __dmul_rn(a, b);
  }
  static __device__ __forceinline__ double add(double a, double b) {
    return __dadd_rn(a, b);
  }
  static __device__ __forceinline__ double div(double a, double b) {
    return __ddiv_rn(a, b);
  }
  static __device__ __forceinline__ double fma(double a, double b, double c) {
    return __fma_rn(a, b, c);
  }
};

template <>
struct Op<float> {
  static __device__ __forceinline__ float mul(float a, float b) {
    return __fmul_rn(a, b);
  }
  static __device__ __forceinline__ float add(float a, float b) {
    return __fadd_rn(a, b);
  }
  static __device__ __forceinline__ float div(float a, float b) {
    return __fdiv_rn(a, b);
  }
  static __device__ __forceinline__ float fma(float a, float b, float c) {
    return __fmaf_rn(a, b, c);
  }
};

// Pack c of W values (W = 1: value c), streamed.
__device__ __forceinline__ void load16(const double* a, long long c,
                                       double (&v)[2]) {
  const double2 d = __ldcs(reinterpret_cast<const double2*>(a) + c);
  v[0] = d.x;
  v[1] = d.y;
}

__device__ __forceinline__ void load16(const float* a, long long c,
                                       float (&v)[4]) {
  const float4 f = __ldcs(reinterpret_cast<const float4*>(a) + c);
  v[0] = f.x;
  v[1] = f.y;
  v[2] = f.z;
  v[3] = f.w;
}

__device__ __forceinline__ void store16(double* a, long long c,
                                        const double (&v)[2]) {
  __stcs(reinterpret_cast<double2*>(a) + c, make_double2(v[0], v[1]));
}

__device__ __forceinline__ void store16(float* a, long long c,
                                        const float (&v)[4]) {
  __stcs(reinterpret_cast<float4*>(a) + c, make_float4(v[0], v[1], v[2], v[3]));
}

template <int W, typename T>
__device__ __forceinline__ void load(const T* a, long long c, T (&v)[W]) {
  if constexpr (W == 1) {
    v[0] = __ldcs(a + c);
  } else {
    load16(a, c, v);
  }
}

template <int W, typename T>
__device__ __forceinline__ void store(T* a, long long c, const T (&v)[W]) {
  if constexpr (W == 1) {
    __stcs(a + c, v[0]);
  } else {
    store16(a, c, v);
  }
}

// body.at<W>(c) for each of this thread's packs of W values, grid-stride,
// then body.at<1>(i) for its values of the tail past the last whole pack.
template <int W, typename Body>
__device__ __forceinline__ void sweep(long long n, Body& body) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long first =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long packs = n / W;
  for (long long c = first; c < packs; c += stride) {
    body.template at<W>(c);
  }
  if constexpr (W > 1) {
    for (long long i = packs * W + first; i < n; i += stride) {
      body.template at<1>(i);
    }
  }
}

template <typename T>
__device__ __forceinline__ T warp_total(T v) {
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

// The K sums of acc over the whole grid into out[0 .. K): each block's
// total into partial[k * gridDim.x + block], then the last block to arrive
// sums the partials, in a fixed order, and resets the ticket.
template <typename T, int K>
__device__ __forceinline__ void finish(const T (&acc)[K], T* partial,
                                       unsigned* ticket, T* out) {
  __shared__ T warp_sum[K][kWarps];
  __shared__ bool last;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int k = 0; k < K; ++k) {
    const T v = warp_total(acc[k]);
    if (lane == 0) warp_sum[k][warp] = v;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int k = 0; k < K; ++k) {
      T s = 0;
      for (int w = 0; w < kWarps; ++w) s += warp_sum[k][w];
      partial[k * gridDim.x + blockIdx.x] = s;
    }
    __threadfence();
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  T mine[K];
  for (int k = 0; k < K; ++k) {
    T s = 0;
    for (unsigned b = threadIdx.x; b < gridDim.x; b += kThreads) {
      s += __ldcg(partial + k * gridDim.x + b);
    }
    mine[k] = warp_total(s);
  }
  for (int k = 0; k < K; ++k) {
    if (lane == 0) warp_sum[k][warp] = mine[k];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int k = 0; k < K; ++k) {
      T s = 0;
      for (int w = 0; w < kWarps; ++w) s += warp_sum[k][w];
      out[k] = s;
    }
    *ticket = 0;
  }
}

// r·z and r·r, z = inv·r (or r), one value at a time.
template <typename T, bool kJacobi>
__device__ __forceinline__ void residual_sums(T rv, T iv, T (&acc)[2]) {
  const T z = kJacobi ? Op<T>::mul(iv, rv) : rv;
  acc[0] = Op<T>::fma(rv, z, acc[0]);
  acc[1] = Op<T>::fma(rv, rv, acc[1]);
}

template <typename T>
struct Pap {
  const T* p;
  const T* ap;
  T acc[1] = {0};

  template <int W>
  __device__ __forceinline__ void at(long long c) {
    T pv[W], av[W];
    load<W>(p, c, pv);
    load<W>(ap, c, av);
#pragma unroll
    for (int j = 0; j < W; ++j) acc[0] = Op<T>::fma(pv[j], av[j], acc[0]);
  }
};

template <typename T, bool kJacobi>
struct Dots {
  const T* r;
  const T* inv;
  T acc[2] = {0, 0};

  template <int W>
  __device__ __forceinline__ void at(long long c) {
    T rv[W], iv[W];
    load<W>(r, c, rv);
    if constexpr (kJacobi) load<W>(inv, c, iv);
#pragma unroll
    for (int j = 0; j < W; ++j) {
      residual_sums<T, kJacobi>(rv[j], kJacobi ? iv[j] : rv[j], acc);
    }
  }
};

template <typename T, bool kJacobi>
struct Update {
  T* r;
  const T* ap;
  const T* inv;
  T alpha;
  T acc[2] = {0, 0};

  template <int W>
  __device__ __forceinline__ void at(long long c) {
    T rv[W], av[W], iv[W];
    load<W>(r, c, rv);
    load<W>(ap, c, av);
    if constexpr (kJacobi) load<W>(inv, c, iv);
#pragma unroll
    for (int j = 0; j < W; ++j) {
      rv[j] = Op<T>::add(rv[j], -Op<T>::mul(alpha, av[j]));
      residual_sums<T, kJacobi>(rv[j], kJacobi ? iv[j] : rv[j], acc);
    }
    store<W>(r, c, rv);
  }
};

template <typename T, bool kJacobi>
struct Direction {
  const T* x;
  T* x_out;
  const T* r;
  T* p;
  const T* inv;
  T alpha;
  T beta;

  template <int W>
  __device__ __forceinline__ void at(long long c) {
    T xv[W], rv[W], pv[W], iv[W];
    load<W>(x, c, xv);
    load<W>(p, c, pv);
    load<W>(r, c, rv);
    if constexpr (kJacobi) load<W>(inv, c, iv);
#pragma unroll
    for (int j = 0; j < W; ++j) {
      xv[j] = Op<T>::add(xv[j], Op<T>::mul(alpha, pv[j]));
      const T z = kJacobi ? Op<T>::mul(iv[j], rv[j]) : rv[j];
      pv[j] = Op<T>::add(z, Op<T>::mul(beta, pv[j]));
    }
    store<W>(x_out, c, xv);
    store<W>(p, c, pv);
  }
};

template <typename T, int W>
__global__ void __launch_bounds__(kThreads)
pap_kernel(const T* __restrict__ p, const T* __restrict__ ap, T* partial,
           unsigned* ticket, T* out, long long n) {
  Pap<T> body{p, ap};
  sweep<W>(n, body);
  finish<T, 1>(body.acc, partial, ticket, out);
}

template <typename T, int W, bool kJacobi>
__global__ void __launch_bounds__(kThreads)
dots_kernel(const T* __restrict__ r, const T* __restrict__ inv, T* partial,
            unsigned* ticket, T* out, long long n) {
  Dots<T, kJacobi> body{r, inv};
  sweep<W>(n, body);
  finish<T, 2>(body.acc, partial, ticket, out);
}

template <typename T, int W, bool kJacobi>
__global__ void __launch_bounds__(kThreads)
update_kernel(T* __restrict__ r, const T* __restrict__ ap,
              const T* __restrict__ inv, const T* __restrict__ rz,
              const T* __restrict__ pap, T* partial, unsigned* ticket, T* out,
              long long n) {
  Update<T, kJacobi> body{r, ap, inv, Op<T>::div(*rz, *pap)};
  sweep<W>(n, body);
  finish<T, 2>(body.acc, partial, ticket, out);
}

template <typename T, int W, bool kJacobi>
__global__ void __launch_bounds__(kThreads)
direction_kernel(const T* __restrict__ x, T* __restrict__ x_out,
                 const T* __restrict__ r, T* __restrict__ p,
                 const T* __restrict__ inv, const T* __restrict__ rz,
                 const T* __restrict__ pap, const T* __restrict__ rz_next,
                 long long n) {
  Direction<T, kJacobi> body{x, x_out, r, p, inv, Op<T>::div(*rz, *pap),
                             Op<T>::div(*rz_next, *rz)};
  sweep<W>(n, body);
}

// Blocks of a launch over n values in packs of vec (at least one block, so
// that a sum over no values still writes its 0).
long long blocks_for(long long n, long long vec) {
  long long blocks = (n / vec + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  return blocks < kMaxBlocks ? blocks : kMaxBlocks;
}

template <typename T>
bool bad_shape(long long n, long long vec) {
  return n < 0 || (vec != 1 && vec != kPack<T>);
}

template <typename T>
int launch_pap(const void* p, const void* ap, void* partial,
               long long partial_len, void* ticket, void* out, long long n,
               long long vec, void* stream) {
  const long long blocks = blocks_for(n, vec);
  if (bad_shape<T>(n, vec) || partial_len < blocks) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto g = static_cast<unsigned>(blocks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* u = static_cast<unsigned*>(ticket);
  const T* pp = static_cast<const T*>(p);
  const T* aa = static_cast<const T*>(ap);
  T* part = static_cast<T*>(partial);
  T* o = static_cast<T*>(out);
  if (vec == 1) {
    pap_kernel<T, 1><<<g, kThreads, 0, s>>>(pp, aa, part, u, o, n);
  } else {
    pap_kernel<T, kPack<T>><<<g, kThreads, 0, s>>>(pp, aa, part, u, o,
                                                          n);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int W>
void dots_launch(unsigned g, cudaStream_t s, const T* r, const T* inv,
                 T* part, unsigned* u, T* o, long long n) {
  if (inv != nullptr) {
    dots_kernel<T, W, true><<<g, kThreads, 0, s>>>(r, inv, part, u, o, n);
  } else {
    dots_kernel<T, W, false><<<g, kThreads, 0, s>>>(r, inv, part, u, o, n);
  }
}

template <typename T>
int launch_dots(const void* r, const void* inv, void* partial,
                long long partial_len, void* ticket, void* out, long long n,
                long long vec, void* stream) {
  const long long blocks = blocks_for(n, vec);
  if (bad_shape<T>(n, vec) || partial_len < 2 * blocks) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto g = static_cast<unsigned>(blocks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* rr = static_cast<const T*>(r);
  const T* ii = static_cast<const T*>(inv);
  T* part = static_cast<T*>(partial);
  auto* u = static_cast<unsigned*>(ticket);
  T* o = static_cast<T*>(out);
  if (vec == 1) {
    dots_launch<T, 1>(g, s, rr, ii, part, u, o, n);
  } else {
    dots_launch<T, kPack<T>>(g, s, rr, ii, part, u, o, n);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int W>
void update_launch(unsigned g, cudaStream_t s, T* r, const T* ap,
                   const T* inv, const T* rz, const T* pap, T* part,
                   unsigned* u, T* o, long long n) {
  if (inv != nullptr) {
    update_kernel<T, W, true><<<g, kThreads, 0, s>>>(r, ap, inv, rz, pap,
                                                    part, u, o, n);
  } else {
    update_kernel<T, W, false><<<g, kThreads, 0, s>>>(r, ap, inv, rz, pap,
                                                     part, u, o, n);
  }
}

template <typename T>
int launch_update(void* r, const void* ap, const void* inv, const void* rz,
                  const void* pap, void* partial, long long partial_len,
                  void* ticket, void* out, long long n, long long vec,
                  void* stream) {
  const long long blocks = blocks_for(n, vec);
  if (bad_shape<T>(n, vec) || partial_len < 2 * blocks) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto g = static_cast<unsigned>(blocks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  T* rr = static_cast<T*>(r);
  const T* aa = static_cast<const T*>(ap);
  const T* ii = static_cast<const T*>(inv);
  const T* z = static_cast<const T*>(rz);
  const T* d = static_cast<const T*>(pap);
  T* part = static_cast<T*>(partial);
  auto* u = static_cast<unsigned*>(ticket);
  T* o = static_cast<T*>(out);
  if (vec == 1) {
    update_launch<T, 1>(g, s, rr, aa, ii, z, d, part, u, o, n);
  } else {
    update_launch<T, kPack<T>>(g, s, rr, aa, ii, z, d, part, u, o, n);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int W>
void direction_launch(unsigned g, cudaStream_t s, const T* x, T* x_out,
                      const T* r, T* p, const T* inv, const T* rz,
                      const T* pap, const T* rz_next, long long n) {
  if (inv != nullptr) {
    direction_kernel<T, W, true><<<g, kThreads, 0, s>>>(
        x, x_out, r, p, inv, rz, pap, rz_next, n);
  } else {
    direction_kernel<T, W, false><<<g, kThreads, 0, s>>>(
        x, x_out, r, p, inv, rz, pap, rz_next, n);
  }
}

template <typename T>
int launch_direction(const void* x, void* x_out, const void* r, void* p,
                     const void* inv, const void* rz, const void* pap,
                     const void* rz_next, long long n, long long vec,
                     void* stream) {
  if (bad_shape<T>(n, vec)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) {
    return static_cast<int>(cudaSuccess);
  }
  const auto g = static_cast<unsigned>(blocks_for(n, vec));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* xx = static_cast<const T*>(x);
  T* xo = static_cast<T*>(x_out);
  const T* rr = static_cast<const T*>(r);
  T* pp = static_cast<T*>(p);
  const T* ii = static_cast<const T*>(inv);
  const T* z = static_cast<const T*>(rz);
  const T* d = static_cast<const T*>(pap);
  const T* zn = static_cast<const T*>(rz_next);
  if (vec == 1) {
    direction_launch<T, 1>(g, s, xx, xo, rr, pp, ii, z, d, zn, n);
  } else {
    direction_launch<T, kPack<T>>(g, s, xx, xo, rr, pp, ii, z, d, zn, n);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// (p, ap, partial, partial_len, ticket, out, n, vec, stream)
// (r, inv, partial, partial_len, ticket, out, n, vec, stream)
// (r, ap, inv, rz, pap, partial, partial_len, ticket, out, n, vec, stream)
// (x, x_out, r, p, inv, rz, pap, rz_next, n, vec, stream)
// inv may be null (no preconditioner); rz, pap and rz_next point at one
// value each; out at 1 (pap) or 2 values.
#define SPAL_CG_STEP_ENTRIES(SUFFIX, T)                                        \
  extern "C" int spal_cg_pap_##SUFFIX(                                         \
      const void* p, const void* ap, void* partial, long long partial_len,     \
      void* ticket, void* out, long long n, long long vec, void* stream) {     \
    return launch_pap<T>(p, ap, partial, partial_len, ticket, out, n, vec,     \
                         stream);                                              \
  }                                                                            \
  extern "C" int spal_cg_dots_##SUFFIX(                                        \
      const void* r, const void* inv, void* partial, long long partial_len,    \
      void* ticket, void* out, long long n, long long vec, void* stream) {     \
    return launch_dots<T>(r, inv, partial, partial_len, ticket, out, n, vec,   \
                          stream);                                             \
  }                                                                            \
  extern "C" int spal_cg_update_##SUFFIX(                                      \
      void* r, const void* ap, const void* inv, const void* rz,                \
      const void* pap, void* partial, long long partial_len, void* ticket,     \
      void* out, long long n, long long vec, void* stream) {                   \
    return launch_update<T>(r, ap, inv, rz, pap, partial, partial_len, ticket, \
                            out, n, vec, stream);                              \
  }                                                                            \
  extern "C" int spal_cg_direction_##SUFFIX(                                   \
      const void* x, void* x_out, const void* r, void* p, const void* inv,     \
      const void* rz, const void* pap, const void* rz_next, long long n,       \
      long long vec, void* stream) {                                           \
    return launch_direction<T>(x, x_out, r, p, inv, rz, pap, rz_next, n, vec,  \
                               stream);                                        \
  }

SPAL_CG_STEP_ENTRIES(f32, float)
SPAL_CG_STEP_ENTRIES(f64, double)
