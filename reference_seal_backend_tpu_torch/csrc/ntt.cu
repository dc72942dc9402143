// Fused negacyclic NTT / inverse NTT over RNS limbs for Hopper (sm_90a).
//
// Replaces the one TPU kernel of the JAX package,
// reference_seal_backend_tpu/ops/pallas/ntt_kernel.py (_ntt_kernel: forward
// branch = ntt_fwd here, inverse branch = ntt_inv here).  Like that kernel it
// runs all log2(N) butterfly stages of one polynomial without a trip to device
// memory between stages.  It is not a translation of its [n1, TILE_B, 128]
// sublane layout or of its lane-expanded twiddle planes: those serve the TPU's
// vector unit.
//
// What bounds it on an H100 (3.35 TB/s, 132 SMs x 64 int32 lanes x 1.98 GHz =
// 16.7e12 int32 op/s): a row moves 8*N bytes (one read, one write) and needs
// N/2*log2(N) butterflies of 7 integer instructions each at the least (the
// Shoup multiply's high product, low product and multiply-add; subtract and
// minimum for the conditional subtraction; an add; a three-input add) and 4
// or 5 more per output element.  At N = 8192 that is 65,536 B -> 19.6 ns of
// memory time against about 400,000 op -> 24 ns of instruction time per row:
// integer throughput binds, so every instruction that is not butterfly
// arithmetic (shared-memory traffic, barriers, address arithmetic, waiting
// for a twiddle) is what the design has to take away.
//
// Design.  One thread block owns one (row, limb) polynomial.  The stages are
// grouped into passes of up to kMaxRadixLog = 4 stages (13 stages ->
// 4 + 3 + 3 + 3; ops/ntt.py:pass_split).  In a pass a thread holds the 2^k
// elements of a *task* in registers -- the indices that differ only in the
// bit field those k stages pair up (ops/ntt.py:task_base) -- and runs the k
// stages on them with no barrier and no shared-memory access in between.
// The block meets in shared memory once between two passes: every task is
// written back in place, so one __syncthreads() per pass boundary (3 for
// N = 8192, where the stage-by-stage kernel had 13) and a third of its
// shared-memory traffic.
//   * The first forward pass reads its elements straight from device memory
//     (a warp reads 32 consecutive words per element slot) and the last
//     writes 2^k consecutive words per task straight from registers with
//     16-byte stores; the inverse mirrors this (16-byte loads in its first
//     pass, the N^-1 Shoup multiply folded into the last pass's stores).
//     The polynomial never sits in shared memory before or after a transform.
//   * Element i lives at shared word i + (i >> 5) (ops/ntt.py:smem_index).
//     With that padding and task_base's dealing of tasks to lanes, the 32
//     lanes of a warp hit 32 different banks in every pass, on the write of
//     one pass and on the read of the next (tests/test_torch_ntt_blocked.py
//     checks the maps for every size compiled here).
//   * A task's 2^k - 1 twiddle pairs are loaded together, before the barrier
//     that precedes the pass's reads, with 8- and 16-byte loads from the
//     compact [L, N] bit-reversed tables (stage s0 + r of a task reads the
//     2^r consecutive entries from ((2^s0 + hi) << r), hi = the index bits
//     above the field), so their latency overlaps the barrier and each other.
//   * log2(N) is a template parameter, instantiated for N = 2048 .. 32768,
//     so every loop over stages and elements unrolls and the data stays in
//     registers.  Any other power of two takes the generic kernels below
//     them: one stage per barrier in shared memory, the flat loop of
//     ops/ntt.py:fwd_plain.
//   * A block has N/16 threads up to 512, capped at 64 registers, so that two
//     blocks (32 warps) share an SM and one computes while the other waits at
//     a barrier or for its polynomial; at N = 32768 the shared memory of an SM
//     holds one block, which then has 1024 threads.  With few polynomials
//     (one wave or less) the time is one block's critical path: a load, four
//     passes, a store.
//   * x may be a limb slice of a larger tensor: rows are x_row_stride words
//     apart, limbs N words, so no copy precedes the launch.  out is dense.
//
// Range contract (the reference's default, lazy path): with every prime below
// 2^30 (lazy = 1) values ride in [0, 4p) across the forward stages, inputs may
// lie in [0, 2p), the very first stage uses u unreduced, and epilogue = 0
// returns the [0, 4p) representatives; the inverse keeps [0, 2p) and ends in a
// fully reducing N^-1 Shoup multiply, so its output is canonical.  With
// lazy = 0 (a prime >= 2^30) every butterfly is fully reduced.  Grouping
// stages into passes changes no butterfly's inputs: the integers equal the
// plain PyTorch version's bit for bit.
//
// Plain C interface for ctypes; each entry point returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxRadixLog = 4;  // most stages a pass runs on registers

__device__ __forceinline__ uint32_t shoup_lazy(uint32_t x, uint32_t w,
                                               uint32_t ws, uint32_t p) {
  // x*w - floor(x*ws / 2^32)*p  in [0, 2p) for any uint32 x
  return x * w - __umulhi(x, ws) * p;
}

__device__ __forceinline__ uint32_t csub(uint32_t x, uint32_t m) {
  // x >= m ? x - m : x  (x - m wraps above x when x < m)
  return min(x, x - m);
}

int log2_exact(int n) {
  int b = 0;
  while (b < 30 && (1 << b) < n) ++b;
  return (1 << b) == n ? b : -1;
}

// Above 48 KB a block's dynamic shared memory is an opt-in per function and
// device; `done` remembers the devices it was made on.
template <typename K>
cudaError_t allow_shared_once(K kernel, size_t bytes, unsigned long long* done) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (*done & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err == cudaSuccess) *done |= bit;
  return err;
}

// ---------------------------------------------------------------------------
// The kernels specialised for N = 1 << LOG_N.
// ---------------------------------------------------------------------------

template <int LOG_N>
struct Shape {
  static constexpr int kN = 1 << LOG_N;
  static constexpr size_t kSharedBytes = sizeof(uint32_t) * (kN + kN / 32);
  // One 16-element task a thread up to 512 threads, so that two blocks share
  // an SM and one computes while the other waits at a barrier; where the
  // shared memory of an SM holds one block only (N = 32768), 1024 threads.
  static constexpr int kThreads = kN / 16 < 512                     ? kN / 16
                                  : 2 * kSharedBytes <= 227 * 1024 ? 512
                                                                    : kMaxThreads;
  // 64 registers a thread: 1024 threads an SM, in blocks of kThreads
  static constexpr int kMinBlocks = kThreads <= 512 ? 1024 / kThreads : 1;
  // tasks of one pass a thread works on side by side (the faster of 1 and 2,
  // measured per direction and size)
  static constexpr int kFwdTaskUnroll = LOG_N == 15 ? 2 : 1;
  static constexpr int kInvTaskUnroll = 2;
  static constexpr int kPasses = (LOG_N + kMaxRadixLog - 1) / kMaxRadixLog;

  // ops/ntt.py:pass_split
  __host__ __device__ static constexpr int width(int p) {
    return LOG_N / kPasses + (p < LOG_N % kPasses ? 1 : 0);
  }
  __host__ __device__ static constexpr int start(int p) {
    int s = 0;
    for (int i = 0; i < p; ++i) s += width(i);
    return s;
  }

  static_assert(LOG_N >= 10 && LOG_N <= 15, "specialised sizes: 2^10 .. 2^15");
  static_assert(kPasses >= 2, "pass split");
  static_assert(kThreads % 32 == 0 && kThreads <= kMaxThreads, "whole warps");
  static_assert((kN >> kMaxRadixLog) % kThreads == 0, "tasks per thread");
};

// ops/ntt.py:smem_index.  A task's element e sits at base | e << B with the
// bits of base and of e << B disjoint, so pad(base | e << B) = pad(base) +
// pad(e << B): one padded base a task, a compile-time offset per element.
__host__ __device__ constexpr int pad(int i) { return i + (i >> 5); }

// ops/ntt.py:task_base
template <int LOG_N, int S0, int K>
__device__ __forceinline__ int task_base(int q) {
  constexpr int B = LOG_N - S0 - K;
  if constexpr (B > 0 && B < 5) {
    const int lane = q & 31, rest = q >> 5;
    return (lane & ((1 << B) - 1)) | ((lane >> B) << (5 + B)) |
           ((rest & ((1 << (5 - K)) - 1)) << (B + K)) |
           ((rest >> (5 - K)) << 10);
  } else {
    return ((q >> B) << (B + K)) | (q & ((1 << B) - 1));
  }
}

// A task's twiddles in heap order: stage s0 + r uses w[2^r .. 2^(r+1) - 1],
// the 2^r consecutive table entries from (first << r), first = 2^s0 + hi.
template <int K>
__device__ __forceinline__ void load_twiddles(const uint32_t* __restrict__ t,
                                              int first, uint32_t (&w)[1 << K]) {
  w[0] = 0;
#pragma unroll
  for (int r = 0; r < K; ++r) {
    const uint32_t* src = t + (static_cast<size_t>(first) << r);
    if (r == 0) {
      w[1] = __ldg(src);
    } else if (r == 1) {
      const uint2 v = __ldg(reinterpret_cast<const uint2*>(src));
      w[2] = v.x;
      w[3] = v.y;
    } else {
#pragma unroll
      for (int c = 0; c < (1 << r) / 4; ++c) {
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(src) + c);
        w[(1 << r) + 4 * c + 0] = v.x;
        w[(1 << r) + 4 * c + 1] = v.y;
        w[(1 << r) + 4 * c + 2] = v.z;
        w[(1 << r) + 4 * c + 3] = v.w;
      }
    }
  }
}

// k Cooley-Tukey stages on a task's 2^k elements.  RAW_FIRST: this pass holds
// stage 0 of the transform, whose u is used as it comes.
template <int K, bool LAZY, bool RAW_FIRST>
__device__ __forceinline__ void fwd_stages(uint32_t (&a)[1 << K],
                                           const uint32_t (&w)[1 << K],
                                           const uint32_t (&ws)[1 << K],
                                           uint32_t p, uint32_t p2) {
#pragma unroll
  for (int r = 0; r < K; ++r) {
    const int d = 1 << (K - 1 - r);
#pragma unroll
    for (int f = 0; f < (1 << (K - 1)); ++f) {
      const int j = f >> (K - 1 - r);
      const int e0 = (j << (K - r)) | (f & (d - 1));
      const int e1 = e0 + d;
      const uint32_t u = a[e0];
      const uint32_t v = a[e1];
      const uint32_t wt = w[(1 << r) + j];
      const uint32_t wst = ws[(1 << r) + j];
      if (LAZY) {
        const uint32_t ur = (RAW_FIRST && r == 0) ? u : csub(u, p2);
        const uint32_t tt = shoup_lazy(v, wt, wst, p);
        a[e0] = ur + tt;
        a[e1] = ur - tt + p2;
      } else {
        const uint32_t tt = csub(shoup_lazy(v, wt, wst, p), p);
        a[e0] = csub(u + tt, p);
        a[e1] = u - tt + (u < tt ? p : 0u);
      }
    }
  }
}

// The same k stages of the Gentleman-Sande inverse, last stage first.
template <int K, bool LAZY>
__device__ __forceinline__ void inv_stages(uint32_t (&a)[1 << K],
                                           const uint32_t (&w)[1 << K],
                                           const uint32_t (&ws)[1 << K],
                                           uint32_t p, uint32_t p2) {
#pragma unroll
  for (int r = K - 1; r >= 0; --r) {
    const int d = 1 << (K - 1 - r);
#pragma unroll
    for (int f = 0; f < (1 << (K - 1)); ++f) {
      const int j = f >> (K - 1 - r);
      const int e0 = (j << (K - r)) | (f & (d - 1));
      const int e1 = e0 + d;
      const uint32_t u = a[e0];
      const uint32_t v = a[e1];
      const uint32_t wt = w[(1 << r) + j];
      const uint32_t wst = ws[(1 << r) + j];
      if (LAZY) {
        a[e0] = csub(u + v, p2);
        a[e1] = shoup_lazy(u - v + p2, wt, wst, p);
      } else {
        const uint32_t diff = u - v + (u < v ? p : 0u);
        a[e0] = csub(u + v, p);
        a[e1] = csub(shoup_lazy(diff, wt, wst, p), p);
      }
    }
  }
}

// Forward pass P and those after it.  xin: the polynomial's row in x; out: its
// row in the result; sm: the padded polynomial between passes.
template <int LOG_N, bool LAZY, int P>
__device__ __forceinline__ void fwd_passes(uint32_t* sm,
                                           const uint32_t* __restrict__ xin,
                                           uint32_t* __restrict__ out,
                                           const uint32_t* __restrict__ tw,
                                           const uint32_t* __restrict__ tws,
                                           uint32_t p, int epilogue) {
  using S = Shape<LOG_N>;
  constexpr int K = S::width(P), S0 = S::start(P), B = LOG_N - S0 - K;
  constexpr int E = 1 << K;
  constexpr int kTasks = (S::kN >> K) / S::kThreads;  // per thread
  constexpr int kUnroll = S::kFwdTaskUnroll;
  constexpr bool kFirst = P == 0, kLast = P == S::kPasses - 1;
  static_assert(!kLast || K >= 2, "16-byte stores in the last pass");
  const uint32_t p2 = p + p;

  int base = task_base<LOG_N, S0, K>(threadIdx.x);
  uint32_t w[E], ws[E], a[E];
  load_twiddles<K>(tw, (1 << S0) + (base >> (B + K)), w);
  load_twiddles<K>(tws, (1 << S0) + (base >> (B + K)), ws);
  if (!kFirst) __syncthreads();
#pragma unroll kUnroll
  for (int t = 0; t < kTasks; ++t) {
#pragma unroll
    for (int e = 0; e < E; ++e)
      a[e] = kFirst ? xin[base + (e << B)] : sm[pad(base) + pad(e << B)];
    fwd_stages<K, LAZY, kFirst>(a, w, ws, p, p2);
    if (kLast) {
      // B == 0: the task's elements are out[base .. base + E)
      if (LAZY && epilogue) {
#pragma unroll
        for (int e = 0; e < E; ++e) a[e] = csub(csub(a[e], p2), p);
      }
#pragma unroll
      for (int c = 0; c < E / 4; ++c)
        reinterpret_cast<uint4*>(out + base)[c] =
            make_uint4(a[4 * c], a[4 * c + 1], a[4 * c + 2], a[4 * c + 3]);
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) sm[pad(base) + pad(e << B)] = a[e];
    }
    if (t + 1 < kTasks) {
      base = task_base<LOG_N, S0, K>(threadIdx.x + (t + 1) * S::kThreads);
      load_twiddles<K>(tw, (1 << S0) + (base >> (B + K)), w);
      load_twiddles<K>(tws, (1 << S0) + (base >> (B + K)), ws);
    }
  }
  if constexpr (!kLast)
    fwd_passes<LOG_N, LAZY, P + 1>(sm, xin, out, tw, tws, p, epilogue);
}

// Inverse pass P and those before it (the inverse starts at kPasses - 1).
template <int LOG_N, bool LAZY, int P>
__device__ __forceinline__ void inv_passes(uint32_t* sm,
                                           const uint32_t* __restrict__ xin,
                                           uint32_t* __restrict__ out,
                                           const uint32_t* __restrict__ tw,
                                           const uint32_t* __restrict__ tws,
                                           uint32_t p, uint32_t nw, uint32_t nws) {
  using S = Shape<LOG_N>;
  constexpr int K = S::width(P), S0 = S::start(P), B = LOG_N - S0 - K;
  constexpr int E = 1 << K;
  constexpr int kTasks = (S::kN >> K) / S::kThreads;
  constexpr int kUnroll = S::kInvTaskUnroll;
  constexpr bool kFirst = P == S::kPasses - 1, kLast = P == 0;
  static_assert(!kFirst || K >= 2, "16-byte loads in the first pass");
  const uint32_t p2 = p + p;

  int base = task_base<LOG_N, S0, K>(threadIdx.x);
  uint32_t w[E], ws[E], a[E];
  load_twiddles<K>(tw, (1 << S0) + (base >> (B + K)), w);
  load_twiddles<K>(tws, (1 << S0) + (base >> (B + K)), ws);
  if (!kFirst) __syncthreads();
#pragma unroll kUnroll
  for (int t = 0; t < kTasks; ++t) {
    if (kFirst) {
      // B == 0: the task's elements are xin[base .. base + E)
#pragma unroll
      for (int c = 0; c < E / 4; ++c) {
        const uint4 v = reinterpret_cast<const uint4*>(xin + base)[c];
        a[4 * c] = v.x;
        a[4 * c + 1] = v.y;
        a[4 * c + 2] = v.z;
        a[4 * c + 3] = v.w;
      }
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) a[e] = sm[pad(base) + pad(e << B)];
    }
    inv_stages<K, LAZY>(a, w, ws, p, p2);
#pragma unroll
    for (int e = 0; e < E; ++e) {
      if (kLast)
        out[base + (e << B)] = csub(shoup_lazy(a[e], nw, nws, p), p);
      else
        sm[pad(base) + pad(e << B)] = a[e];
    }
    if (t + 1 < kTasks) {
      base = task_base<LOG_N, S0, K>(threadIdx.x + (t + 1) * S::kThreads);
      load_twiddles<K>(tw, (1 << S0) + (base >> (B + K)), w);
      load_twiddles<K>(tws, (1 << S0) + (base >> (B + K)), ws);
    }
  }
  if constexpr (!kLast)
    inv_passes<LOG_N, LAZY, P - 1>(sm, xin, out, tw, tws, p, nw, nws);
}

template <int LOG_N, bool LAZY>
__global__ void __launch_bounds__(Shape<LOG_N>::kThreads, Shape<LOG_N>::kMinBlocks)
ntt_fwd_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
               const uint32_t* __restrict__ roots,
               const uint32_t* __restrict__ roots_shoup,
               const uint32_t* __restrict__ primes, int nl,
               long long x_row_stride, int lo, int epilogue) {
  extern __shared__ __align__(16) uint32_t sm[];
  const int row = static_cast<int>(blockIdx.x) / nl;
  const int j = static_cast<int>(blockIdx.x) - row * nl;
  const int limb = lo + j;
  constexpr size_t kN = Shape<LOG_N>::kN;
  fwd_passes<LOG_N, LAZY, 0>(sm, x + row * x_row_stride + j * kN,
                             out + blockIdx.x * kN, roots + limb * kN,
                             roots_shoup + limb * kN, primes[limb], epilogue);
}

template <int LOG_N, bool LAZY>
__global__ void __launch_bounds__(Shape<LOG_N>::kThreads, Shape<LOG_N>::kMinBlocks)
ntt_inv_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
               const uint32_t* __restrict__ iroots,
               const uint32_t* __restrict__ iroots_shoup,
               const uint32_t* __restrict__ primes,
               const uint32_t* __restrict__ n_inv,
               const uint32_t* __restrict__ n_inv_shoup, int nl,
               long long x_row_stride, int lo) {
  extern __shared__ __align__(16) uint32_t sm[];
  const int row = static_cast<int>(blockIdx.x) / nl;
  const int j = static_cast<int>(blockIdx.x) - row * nl;
  const int limb = lo + j;
  constexpr size_t kN = Shape<LOG_N>::kN;
  inv_passes<LOG_N, LAZY, Shape<LOG_N>::kPasses - 1>(
      sm, x + row * x_row_stride + j * kN, out + blockIdx.x * kN,
      iroots + limb * kN, iroots_shoup + limb * kN, primes[limb], n_inv[limb],
      n_inv_shoup[limb]);
}

// ---------------------------------------------------------------------------
// The generic kernels: any power of two N >= 2.  The polynomial sits in
// shared memory (4*N bytes) and the block walks the flat stage loop, one
// __syncthreads() per stage.
// ---------------------------------------------------------------------------

template <bool LAZY>
__global__ void __launch_bounds__(kMaxThreads)
ntt_fwd_generic_kernel(const uint32_t* __restrict__ x,
                       uint32_t* __restrict__ out,
                       const uint32_t* __restrict__ roots,
                       const uint32_t* __restrict__ roots_shoup,
                       const uint32_t* __restrict__ primes, int n, int log_n,
                       int nl, long long x_row_stride, int lo, int epilogue) {
  extern __shared__ uint32_t sm[];
  const int row = static_cast<int>(blockIdx.x) / nl;
  const int j = static_cast<int>(blockIdx.x) - row * nl;
  const int limb = lo + j;
  const uint32_t* xin = x + row * x_row_stride + static_cast<size_t>(j) * n;
  const size_t base = static_cast<size_t>(blockIdx.x) * n;
  const uint32_t* tw = roots + static_cast<size_t>(limb) * n;
  const uint32_t* tws = roots_shoup + static_cast<size_t>(limb) * n;
  const uint32_t p = primes[limb];
  const uint32_t p2 = p + p;
  const int half = n >> 1;

  for (int i = threadIdx.x; i < n; i += blockDim.x) sm[i] = xin[i];
  __syncthreads();

  for (int s = 0; s < log_n; ++s) {
    const int m = 1 << s;
    const int log_t = log_n - s - 1;
    const int t = 1 << log_t;
    for (int k = threadIdx.x; k < half; k += blockDim.x) {
      const int g = k >> log_t;
      const int i0 = (g << (log_t + 1)) | (k & (t - 1));
      const int i1 = i0 + t;
      const uint32_t w = __ldg(tw + m + g);
      const uint32_t ws = __ldg(tws + m + g);
      const uint32_t u = sm[i0];
      const uint32_t v = sm[i1];
      if (LAZY) {
        // first-stage u is used as it comes: inputs below 2p keep [0, 4p)
        const uint32_t ur = (s == 0) ? u : csub(u, p2);
        const uint32_t tt = shoup_lazy(v, w, ws, p);
        sm[i0] = ur + tt;
        sm[i1] = ur - tt + p2;
      } else {
        const uint32_t tt = csub(shoup_lazy(v, w, ws, p), p);
        sm[i0] = csub(u + tt, p);
        sm[i1] = u - tt + (u < tt ? p : 0u);
      }
    }
    __syncthreads();
  }

  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    uint32_t y = sm[i];
    if (LAZY && epilogue) y = csub(csub(y, p2), p);
    out[base + i] = y;
  }
}

template <bool LAZY>
__global__ void __launch_bounds__(kMaxThreads)
ntt_inv_generic_kernel(const uint32_t* __restrict__ x,
                       uint32_t* __restrict__ out,
                       const uint32_t* __restrict__ iroots,
                       const uint32_t* __restrict__ iroots_shoup,
                       const uint32_t* __restrict__ primes,
                       const uint32_t* __restrict__ n_inv,
                       const uint32_t* __restrict__ n_inv_shoup, int n,
                       int log_n, int nl, long long x_row_stride, int lo) {
  extern __shared__ uint32_t sm[];
  const int row = static_cast<int>(blockIdx.x) / nl;
  const int j = static_cast<int>(blockIdx.x) - row * nl;
  const int limb = lo + j;
  const uint32_t* xin = x + row * x_row_stride + static_cast<size_t>(j) * n;
  const size_t base = static_cast<size_t>(blockIdx.x) * n;
  const uint32_t* tw = iroots + static_cast<size_t>(limb) * n;
  const uint32_t* tws = iroots_shoup + static_cast<size_t>(limb) * n;
  const uint32_t p = primes[limb];
  const uint32_t p2 = p + p;
  const int half = n >> 1;

  for (int i = threadIdx.x; i < n; i += blockDim.x) sm[i] = xin[i];
  __syncthreads();

  for (int s = log_n - 1; s >= 0; --s) {
    const int m = 1 << s;
    const int log_t = log_n - s - 1;
    const int t = 1 << log_t;
    for (int k = threadIdx.x; k < half; k += blockDim.x) {
      const int g = k >> log_t;
      const int i0 = (g << (log_t + 1)) | (k & (t - 1));
      const int i1 = i0 + t;
      const uint32_t w = __ldg(tw + m + g);
      const uint32_t ws = __ldg(tws + m + g);
      const uint32_t u = sm[i0];
      const uint32_t v = sm[i1];
      if (LAZY) {
        sm[i0] = csub(u + v, p2);
        sm[i1] = shoup_lazy(u - v + p2, w, ws, p);
      } else {
        const uint32_t diff = u - v + (u < v ? p : 0u);
        sm[i0] = csub(u + v, p);
        sm[i1] = csub(shoup_lazy(diff, w, ws, p), p);
      }
    }
    __syncthreads();
  }

  const uint32_t nw = n_inv[limb];
  const uint32_t nws = n_inv_shoup[limb];
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    out[base + i] = csub(shoup_lazy(sm[i], nw, nws, p), p);
}

// ---------------------------------------------------------------------------
// Launching.  One transform's arguments, as the entry points take them.
// ---------------------------------------------------------------------------

struct Call {
  const uint32_t* x;
  uint32_t* out;
  const uint32_t* tw;   // roots (forward) or iroots (inverse), [L, n]
  const uint32_t* tws;  // their Shoup companions
  const uint32_t* primes;
  const uint32_t* n_inv;        // inverse only
  const uint32_t* n_inv_shoup;  // inverse only
  long long rows;
  int nl;
  int n;
  long long x_row_stride;
  int lo;
  int lazy;
  int epilogue;  // forward only
  cudaStream_t stream;
};

bool aligned16(const void* ptr, long long row_stride) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && row_stride % 4 == 0;
}

template <int LOG_N, bool INVERSE>
cudaError_t launch(const Call& c) {
  using S = Shape<LOG_N>;
  if (!aligned16(c.x, c.x_row_stride) || !aligned16(c.out, 0) ||
      !aligned16(c.tw, 0) || !aligned16(c.tws, 0))
    return cudaErrorMisalignedAddress;
  static unsigned long long shared_ok[2] = {0, 0};
  const unsigned blocks = static_cast<unsigned>(c.rows * c.nl);
  if constexpr (INVERSE) {
    auto kernel = c.lazy ? ntt_inv_kernel<LOG_N, true> : ntt_inv_kernel<LOG_N, false>;
    cudaError_t err =
        allow_shared_once(kernel, S::kSharedBytes, &shared_ok[c.lazy != 0]);
    if (err != cudaSuccess) return err;
    kernel<<<blocks, S::kThreads, S::kSharedBytes, c.stream>>>(
        c.x, c.out, c.tw, c.tws, c.primes, c.n_inv, c.n_inv_shoup, c.nl,
        c.x_row_stride, c.lo);
  } else {
    auto kernel = c.lazy ? ntt_fwd_kernel<LOG_N, true> : ntt_fwd_kernel<LOG_N, false>;
    cudaError_t err =
        allow_shared_once(kernel, S::kSharedBytes, &shared_ok[c.lazy != 0]);
    if (err != cudaSuccess) return err;
    kernel<<<blocks, S::kThreads, S::kSharedBytes, c.stream>>>(
        c.x, c.out, c.tw, c.tws, c.primes, c.nl, c.x_row_stride, c.lo,
        c.epilogue);
  }
  return cudaGetLastError();
}

template <bool INVERSE>
cudaError_t launch_generic(const Call& c, int log_n) {
  static unsigned long long shared_ok[2][32] = {};
  const unsigned blocks = static_cast<unsigned>(c.rows * c.nl);
  const size_t smem = sizeof(uint32_t) * static_cast<size_t>(c.n);
  const int threads = (c.n / 2 < kMaxThreads) ? c.n / 2 : kMaxThreads;
  if constexpr (INVERSE) {
    auto kernel = c.lazy ? ntt_inv_generic_kernel<true> : ntt_inv_generic_kernel<false>;
    cudaError_t err =
        allow_shared_once(kernel, smem, &shared_ok[c.lazy != 0][log_n]);
    if (err != cudaSuccess) return err;
    kernel<<<blocks, threads, smem, c.stream>>>(
        c.x, c.out, c.tw, c.tws, c.primes, c.n_inv, c.n_inv_shoup, c.n, log_n,
        c.nl, c.x_row_stride, c.lo);
  } else {
    auto kernel = c.lazy ? ntt_fwd_generic_kernel<true> : ntt_fwd_generic_kernel<false>;
    cudaError_t err =
        allow_shared_once(kernel, smem, &shared_ok[c.lazy != 0][log_n]);
    if (err != cudaSuccess) return err;
    kernel<<<blocks, threads, smem, c.stream>>>(
        c.x, c.out, c.tw, c.tws, c.primes, c.n, log_n, c.nl, c.x_row_stride,
        c.lo, c.epilogue);
  }
  return cudaGetLastError();
}

// The specialised kernels for N = 2048 .. 32768 (ops/cuda/ntt.py:
// KERNEL_LOG_NS), the generic ones for any other power of two.
template <bool INVERSE>
int transform(const Call& c) {
  const int log_n = log2_exact(c.n);
  if (log_n < 1 || c.rows < 1 || c.nl < 1 || c.rows * c.nl > 0x7FFFFFFFLL ||
      c.x_row_stride < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (log_n) {
    case 11: return static_cast<int>(launch<11, INVERSE>(c));
    case 12: return static_cast<int>(launch<12, INVERSE>(c));
    case 13: return static_cast<int>(launch<13, INVERSE>(c));
    case 14: return static_cast<int>(launch<14, INVERSE>(c));
    case 15: return static_cast<int>(launch<15, INVERSE>(c));
    default: return static_cast<int>(launch_generic<INVERSE>(c, log_n));
  }
}

}  // namespace

extern "C" {

// x: [rows, nl, n] uint32, rows x_row_stride words apart, limbs n words, words
// dense; out: [rows, nl, n] dense; tables: [L, n] / [L] uint32 of the plan's
// full limb stack; the polynomial at (row, j) uses limb lo + j.
int rsb_ntt_fwd(const void* x, void* out, const void* roots,
                const void* roots_shoup, const void* primes, long long rows,
                int nl, int n, long long x_row_stride, int lo, int lazy,
                int epilogue, void* stream) {
  return transform<false>(Call{
      static_cast<const uint32_t*>(x), static_cast<uint32_t*>(out),
      static_cast<const uint32_t*>(roots),
      static_cast<const uint32_t*>(roots_shoup),
      static_cast<const uint32_t*>(primes), nullptr, nullptr, rows, nl, n,
      x_row_stride, lo, lazy, epilogue, static_cast<cudaStream_t>(stream)});
}

int rsb_ntt_inv(const void* x, void* out, const void* iroots,
                const void* iroots_shoup, const void* primes,
                const void* n_inv, const void* n_inv_shoup, long long rows,
                int nl, int n, long long x_row_stride, int lo, int lazy,
                void* stream) {
  return transform<true>(Call{
      static_cast<const uint32_t*>(x), static_cast<uint32_t*>(out),
      static_cast<const uint32_t*>(iroots),
      static_cast<const uint32_t*>(iroots_shoup),
      static_cast<const uint32_t*>(primes),
      static_cast<const uint32_t*>(n_inv),
      static_cast<const uint32_t*>(n_inv_shoup), rows, nl, n, x_row_stride, lo,
      lazy, 0, static_cast<cudaStream_t>(stream)});
}

const char* rsb_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
