// The BEHZ multiply's chain from the tensor product's inverse transform to the
// output's forward transform, fused, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package runs these steps as XLA elementwise
// code (reference_seal_backend_tpu/evaluator/behz.py), and the port's plain
// version is evaluator/behz.py, whose functions this kernel chains:
//   _fbc_q_to_bsk(prod_q, t_qhinv)   fast base conversion q -> Bsk, times t
//   floor_bsk                         x t in Bsk, minus the above, x q^-1
//   _sk_to_q                          exact Shenoy-Kumaresan Bsk -> q, with
//                                     its centred alpha
//   to_ntt's Montgomery entry         x R mod q_j (q_r1)
// Plain, those are about 180 elementwise int64 kernels a multiply whose
// largest intermediates ([products, k, kb, N] and [products, kb, k, N]) go
// to device memory and back several times.
//
// What bounds it on an H100: a coefficient column reads k + kb words and
// writes k (56 bytes at k = 4), and issues 705 instructions at k = 4 (its
// SASS: 261 IMAD on the FMA pipe, 261 on the integer ALU pipe, 148 uniform
// loads of the constants).  At one warp instruction per scheduler a clock
// the issue takes longer than the bytes take at 3.35 TB/s, by about a
// quarter (chip_smoke.py's behz_times reckons both).  So the design keeps
// everything else away: one thread owns one coefficient column of one
// product polynomial, its k + kb input residues and every intermediate in
// registers, and no value goes back to device memory before the k outputs.  A warp reads and writes 32 consecutive words of each row.
// The Shoup constants of the context (BehzTables) travel by value in the
// kernel's parameters, so every thread reads them from the constant bank
// with compile-time offsets (K is fixed per build and every loop over the
// bases unrolls).  One library a number of q limbs, built when a context
// of that many first asks for it, so that a process compiles only the K it
// runs.
//
// Every value leaving a step is canonical, as in the plain version: its lazy
// sums ([0, 2p) terms added pairwise there, one after another here) differ
// only in representatives that a full reduction then removes, so the output
// equals the plain steps' integers bit for bit.  Every prime is below 2^30.
//
// Plain C interface for ctypes; the entry point returns cudaGetLastError().

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

#ifndef RSB_BEHZ_K
#error "build with -DRSB_BEHZ_K=<q limbs> (ops/cuda/behz.py:build)"
#endif
static_assert(RSB_BEHZ_K >= 1 && RSB_BEHZ_K <= 28, "q limbs 1 .. 28");

namespace {

constexpr int kThreads = 256;

// The constants of one context, word for word as ops/cuda/behz.py:pack lays
// them out; (w, ws) Shoup pairs, ws = floor(w * 2^32 / p).
template <int K>
struct Consts {
  static constexpr int KB = K + 2;  // Bsk = B u {m_sk}
  static constexpr int KA = K + 1;  // B
  // 3797 words at K = 28: above 4 KB of parameters, which CUDA 12.1 and
  // later take up to 32764 bytes on Volta and newer
  uint32_t q[K];
  uint32_t bsk[KB];  // m_sk last
  uint32_t t_qhinv[2][K];
  uint32_t qh_bsk[2][K][KB];
  uint32_t t_bsk[2][KB];
  uint32_t qinv_bsk[2][KB];
  uint32_t bh_inv[2][KA];
  uint32_t bh_msk[2][KA];
  uint32_t binv_msk[2];
  uint32_t bh_q[2][KA][K];
  uint32_t b_q[2][K];
  uint32_t msk_b_q[K];
  uint32_t q_r1[2][K];
  uint32_t half_msk;
};

__device__ __forceinline__ uint32_t csub(uint32_t x, uint32_t m) {
  // x >= m ? x - m : x  (x - m wraps above x when x < m)
  return min(x, x - m);
}

__device__ __forceinline__ uint32_t shoup_lazy(uint32_t x, uint32_t w,
                                               uint32_t ws, uint32_t p) {
  // x*w - floor(x*ws / 2^32)*p  in [0, 2p) for any uint32 x
  return x * w - __umulhi(x, ws) * p;
}

__device__ __forceinline__ uint32_t shoup(uint32_t x, uint32_t w, uint32_t ws,
                                          uint32_t p) {
  return csub(shoup_lazy(x, w, ws, p), p);
}

__device__ __forceinline__ uint32_t mod_sub(uint32_t a, uint32_t b, uint32_t p) {
  return a - b + (a < b ? p : 0u);
}

// x: [rows, K + KB, n] (the q rows, then Bsk), out: [rows, K, n], both dense.
template <int K>
__global__ void __launch_bounds__(kThreads)
behz_floor_sk_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
                     int n, int chunks, const Consts<K> c) {
  constexpr int KB = Consts<K>::KB, KA = Consts<K>::KA;
  const long long row = blockIdx.x / chunks;
  const int col = (blockIdx.x % chunks) * blockDim.x + threadIdx.x;
  const uint32_t* xr = x + row * (K + KB) * n + col;

  uint32_t xq[K], xb[KB];
#pragma unroll
  for (int i = 0; i < K; ++i) xq[i] = __ldg(xr + i * n);
#pragma unroll
  for (int j = 0; j < KB; ++j) xb[j] = __ldg(xr + (K + j) * n);

  // fast base conversion q -> Bsk of prod_q * t (t rides the qhat^-1 factor)
  uint32_t y[K];
#pragma unroll
  for (int i = 0; i < K; ++i)
    y[i] = shoup(xq[i], c.t_qhinv[0][i], c.t_qhinv[1][i], c.q[i]);

  // the floor by q in Bsk: (prod_bsk * t - fbc) * q^-1
  uint32_t yb[KB];
#pragma unroll
  for (int j = 0; j < KB; ++j) {
    const uint32_t p = c.bsk[j];
    uint32_t acc = 0;  // [0, 2p): lazy terms, one conditional subtract each
#pragma unroll
    for (int i = 0; i < K; ++i)
      acc = csub(acc + shoup_lazy(y[i], c.qh_bsk[0][i][j], c.qh_bsk[1][i][j], p),
                 2 * p);
    const uint32_t fbc = csub(acc, p);
    const uint32_t tc = shoup(xb[j], c.t_bsk[0][j], c.t_bsk[1][j], p);
    yb[j] = shoup(mod_sub(tc, fbc, p), c.qinv_bsk[0][j], c.qinv_bsk[1][j], p);
  }

  // Shenoy-Kumaresan: B -> q, the overflow alpha recovered mod m_sk
  const uint32_t msk = c.bsk[KA];
  uint32_t yp[KA];
  uint32_t conv = 0;
#pragma unroll
  for (int i = 0; i < KA; ++i) {
    yp[i] = shoup(yb[i], c.bh_inv[0][i], c.bh_inv[1][i], c.bsk[i]);
    conv = csub(conv + shoup(yp[i], c.bh_msk[0][i], c.bh_msk[1][i], msk), msk);
  }
  const uint32_t alpha =
      shoup(mod_sub(conv, yb[KA], msk), c.binv_msk[0], c.binv_msk[1], msk);
  const bool negative = alpha > c.half_msk;

  uint32_t* o = out + row * K * n + col;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const uint32_t p = c.q[j];
    uint32_t acc = 0;
#pragma unroll
    for (int i = 0; i < KA; ++i)
      acc = csub(acc + shoup_lazy(yp[i], c.bh_q[0][i][j], c.bh_q[1][i][j], p),
                 2 * p);
    // alpha < m_sk < 2^32: one Shoup product gives alpha * B mod q_j
    uint32_t v = mod_sub(csub(acc, p), shoup(alpha, c.b_q[0][j], c.b_q[1][j], p), p);
    if (negative) v = csub(v + c.msk_b_q[j], p);
    // into Montgomery form for the forward transform
    o[j * n] = shoup(v, c.q_r1[0][j], c.q_r1[1][j], p);
  }
}

}  // namespace

extern "C" {

// The number of q limbs this build takes (RSB_BEHZ_K).
int rsb_behz_k() { return RSB_BEHZ_K; }

// Words of Consts<RSB_BEHZ_K>: the wrapper checks its packing against this.
int rsb_behz_consts_words() {
  return static_cast<int>(sizeof(Consts<RSB_BEHZ_K>) / sizeof(uint32_t));
}

// x: [rows, 2k + 2, n] uint32 dense, out: [rows, k, n] dense; k this build's
// RSB_BEHZ_K; n a power of two from 32; consts: rsb_behz_consts_words()
// host words (ops/cuda/behz.py:pack), copied into the launch's parameters.
int rsb_behz_floor_sk(const void* x, void* out, long long rows, int k, int n,
                      const void* consts, void* stream) {
  constexpr int K = RSB_BEHZ_K;
  if (k != K || rows < 1 || n < 32 || (n & (n - 1)) != 0 ||
      rows * (n < kThreads ? 1 : n / kThreads) > 0x7FFFFFFFLL)
    return static_cast<int>(cudaErrorInvalidValue);
  Consts<K> c;
  std::memcpy(&c, consts, sizeof(c));
  const int threads = n < kThreads ? n : kThreads;
  const int chunks = n / threads;
  behz_floor_sk_kernel<K><<<static_cast<unsigned>(rows * chunks), threads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<uint32_t*>(out), n, chunks, c);
  return static_cast<int>(cudaGetLastError());
}

const char* rsb_behz_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
