// Fused negacyclic NTT / inverse NTT over RNS limbs for Hopper (sm_90a).
//
// Replaces the one TPU kernel of the JAX package,
// reference_seal_backend_tpu/ops/pallas/ntt_kernel.py (_ntt_kernel: forward
// branch = ntt_fwd here, inverse branch = ntt_inv here).  Like that kernel it
// runs all log2(N) butterfly stages of one polynomial without a trip to device
// memory between stages.  It is not a translation of its [n1, TILE_B, 128]
// sublane layout or of its lane-expanded twiddle planes: those serve the TPU's
// vector unit.  Here one thread block owns one (row, limb) polynomial, keeps it
// in dynamic shared memory (4*N bytes) and walks the flat stage loop of
// ops/ntt.py (fwd_plain / inv_plain), one __syncthreads() per stage, reading
// twiddles from the compact [L, N] bit-reversed root tables.
//
// Range contract (the reference's default, lazy path): with every prime below
// 2^30 (lazy = 1) values ride in [0, 4p) across the forward stages, inputs may
// lie in [0, 2p), and epilogue = 0 returns the [0, 4p) representatives; the
// inverse keeps [0, 2p) and ends in a fully reducing N^-1 Shoup multiply, so
// its output is canonical.  With lazy = 0 (a prime >= 2^30) every butterfly is
// fully reduced.  The integers equal the plain PyTorch version's bit for bit.
//
// Bound on an H100 (3.35 TB/s, 132 SMs x 64 int32 lanes x 1.98 GHz = 16.7e12
// int32 op/s): a row moves 8*N bytes (one read, one write) and needs
// N/2*log2(N) butterflies of about 10 integer operations.  At N = 8192 that
// is 65,536 B -> 19.6 ns of memory time against 532,480 op -> 31.8 ns of
// issue time per row: the kernel is bound by operations, not bytes, and the
// shared-memory design already keeps the traffic at its minimum.
//
// Plain C interface for ctypes; each entry point returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 1024;

__device__ __forceinline__ uint32_t shoup_lazy(uint32_t x, uint32_t w,
                                               uint32_t ws, uint32_t p) {
  // x*w - floor(x*ws / 2^32)*p  in [0, 2p) for any uint32 x
  return x * w - __umulhi(x, ws) * p;
}

__device__ __forceinline__ uint32_t csub(uint32_t x, uint32_t m) {
  return x >= m ? x - m : x;
}

template <bool LAZY>
__global__ void __launch_bounds__(kMaxThreads)
ntt_fwd_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
               const uint32_t* __restrict__ roots,
               const uint32_t* __restrict__ roots_shoup,
               const uint32_t* __restrict__ primes, int n, int log_n, int nl,
               int lo, int epilogue) {
  extern __shared__ uint32_t sm[];
  const int limb = lo + static_cast<int>(blockIdx.x % nl);
  const size_t base = static_cast<size_t>(blockIdx.x) * n;
  const uint32_t* tw = roots + static_cast<size_t>(limb) * n;
  const uint32_t* tws = roots_shoup + static_cast<size_t>(limb) * n;
  const uint32_t p = primes[limb];
  const uint32_t p2 = p + p;
  const int half = n >> 1;

  for (int i = threadIdx.x; i < n; i += blockDim.x) sm[i] = x[base + i];
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
ntt_inv_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
               const uint32_t* __restrict__ iroots,
               const uint32_t* __restrict__ iroots_shoup,
               const uint32_t* __restrict__ primes,
               const uint32_t* __restrict__ n_inv,
               const uint32_t* __restrict__ n_inv_shoup, int n, int log_n,
               int nl, int lo) {
  extern __shared__ uint32_t sm[];
  const int limb = lo + static_cast<int>(blockIdx.x % nl);
  const size_t base = static_cast<size_t>(blockIdx.x) * n;
  const uint32_t* tw = iroots + static_cast<size_t>(limb) * n;
  const uint32_t* tws = iroots_shoup + static_cast<size_t>(limb) * n;
  const uint32_t p = primes[limb];
  const uint32_t p2 = p + p;
  const int half = n >> 1;

  for (int i = threadIdx.x; i < n; i += blockDim.x) sm[i] = x[base + i];
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

int log2_exact(int n) {
  int b = 0;
  while ((1 << b) < n) ++b;
  return (1 << b) == n ? b : -1;
}

template <typename K>
cudaError_t allow_shared(K kernel, size_t bytes) {
  // above 48 KB a block's dynamic shared memory is an opt-in per function
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace

extern "C" {

// x, out: [rows, nl, n] uint32 contiguous; tables: [L, n] / [L] uint32 of the
// plan's full limb stack; the polynomial at (row, j) uses limb lo + j.
int rsb_ntt_fwd(const void* x, void* out, const void* roots,
                const void* roots_shoup, const void* primes, long long rows,
                int nl, int n, int lo, int lazy, int epilogue, void* stream) {
  const int log_n = log2_exact(n);
  if (log_n < 1 || rows < 1 || nl < 1 || rows * nl > 0x7FFFFFFFLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(uint32_t) * static_cast<size_t>(n);
  const int threads = (n / 2 < kMaxThreads) ? n / 2 : kMaxThreads;
  const unsigned blocks = static_cast<unsigned>(rows * nl);
  auto kernel = lazy ? ntt_fwd_kernel<true> : ntt_fwd_kernel<false>;
  cudaError_t err = allow_shared(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<uint32_t*>(out),
      static_cast<const uint32_t*>(roots),
      static_cast<const uint32_t*>(roots_shoup),
      static_cast<const uint32_t*>(primes), n, log_n, nl, lo, epilogue);
  return static_cast<int>(cudaGetLastError());
}

int rsb_ntt_inv(const void* x, void* out, const void* iroots,
                const void* iroots_shoup, const void* primes,
                const void* n_inv, const void* n_inv_shoup, long long rows,
                int nl, int n, int lo, int lazy, void* stream) {
  const int log_n = log2_exact(n);
  if (log_n < 1 || rows < 1 || nl < 1 || rows * nl > 0x7FFFFFFFLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(uint32_t) * static_cast<size_t>(n);
  const int threads = (n / 2 < kMaxThreads) ? n / 2 : kMaxThreads;
  const unsigned blocks = static_cast<unsigned>(rows * nl);
  auto kernel = lazy ? ntt_inv_kernel<true> : ntt_inv_kernel<false>;
  cudaError_t err = allow_shared(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<uint32_t*>(out),
      static_cast<const uint32_t*>(iroots),
      static_cast<const uint32_t*>(iroots_shoup),
      static_cast<const uint32_t*>(primes),
      static_cast<const uint32_t*>(n_inv),
      static_cast<const uint32_t*>(n_inv_shoup), n, log_n, nl, lo);
  return static_cast<int>(cudaGetLastError());
}

const char* rsb_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
