// Shared by every kernel library of the port: the error-string export the
// Python loader (kernels/build.py) looks up in each library, the mbarrier
// helpers of the kernels that load through TMA (flash_attention.cu,
// kitnet_ae.cuh), and the exact FC arithmetic that the dense (fc_full.cu),
// single-key (feature_update.cu) and sketch (sketch_update.cu) kernels have
// in common.
//
// The FC arithmetic is the plain versions' operation for operation: exp2f
// (not __expf), IEEE division and square root; every library that uses it
// is built with --fmad=false, so no multiply-add is contracted.
#pragma once
#include <cuda_runtime.h>
#include <cstdint>

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// ---- shared addresses and mbarriers ----
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// Wait until the phase of parity `parity` has completed.  A wait longer
// than 2^34 clocks (about 9 s; a tile takes microseconds) traps, so a
// broken pipeline ends the launch with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  const long long start = clock64();
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    if (!done && clock64() - start > (1LL << 34)) __trap();
  }
}

namespace fc {

constexpr int ND = 4;           // decay instances
constexpr int NF = 80;          // features per packet
constexpr int UNI_F = 12;       // features per uni key type
constexpr int BI_F = 28;        // features per bi key type
constexpr int BI_COL0 = 24;     // first bi feature column
constexpr int CHAIN_B = 32;     // positions a uni chain loads at once
constexpr int CHAIN_PAD = 2 * CHAIN_B;  // positions past the last a chain may load

// lambda of decay instance q (core/state.py LAMBDAS)
__device__ __forceinline__ float lam(int q) {
  return q == 0 ? 10.0f : q == 1 ? 1.0f : q == 2 ? 0.1f : static_cast<float>(1.0 / 60.0);
}

__device__ __forceinline__ float safe_div(float a, float b) {
  return b > 0.0f ? a / fmaxf(b, 1e-12f) : 0.0f;
}

// decay factor 2^(-lambda dt) since last_t; 0 for a fresh row (last_t < 0)
__device__ __forceinline__ float decay(float last_t, float t, int q) {
  const float dt = fmaxf(t - last_t, 0.0f);
  return last_t < 0.0f ? 0.0f : exp2f(-lam(q) * dt);
}

// (mu, var, sigma) of one decay instance
__device__ __forceinline__ void stats(float w, float ls, float ss, float& mu,
                                      float& var, float& sig) {
  mu = safe_div(ls, w);
  const float ex2 = safe_div(ss, w);
  var = fabsf(ex2 - mu * mu);
  sig = sqrtf(fmaxf(var, 0.0f));
}

// B consecutive values of a (positions, STRIDE) array at column q from
// sorted position b; the arrays hold CHAIN_PAD positions past the last, so
// a batch may run past the chain's end.  Read-only loads: they may run
// ahead of the chain's stores.
template <int B, int STRIDE, class T>
__device__ __forceinline__ void load_batch(const T* __restrict__ a, int64_t b, int q,
                                           T (&out)[B]) {
  const T* base = a + b * STRIDE + q;
#pragma unroll
  for (int k = 0; k < B; ++k) out[k] = __ldg(base + k * STRIDE);
}

// the positions of a batch from b that lie before end (B at most)
template <int B>
__device__ __forceinline__ int batch_count(int64_t b, int64_t end) {
  return end - b < B ? static_cast<int>(end - b) : B;
}

// `cnt` steps of one uni chain from the batch's values, each position's
// atoms parked at pw/pls/pss[k * ND] (the pointers at the batch's first
// position and the chain's decay)
template <int B>
__device__ __forceinline__ void uni_steps(const float (&d)[B], const float (&xs)[B], int cnt,
                                          float& w, float& ls, float& ss,
                                          float* __restrict__ pw, float* __restrict__ pls,
                                          float* __restrict__ pss) {
#pragma unroll
  for (int k = 0; k < B; ++k) {
    if (k < cnt) {
      w = w * d[k] + 1.0f;
      ls = ls * d[k] + xs[k];
      ss = ss * d[k] + xs[k] * xs[k];
      pw[k * ND] = w; pls[k * ND] = ls; pss[k * ND] = ss;
    }
  }
}

// One uni chain: the atoms (w, ls, ss) of decay q of one table row, walked
// over the sorted positions [p, end) in order.  Only the affine updates are
// serial: the decay factors (delta, (positions, ND)) and lengths x were
// gathered beforehand, and each batch of CHAIN_B positions loads while the
// one before it is applied (two buffers in turn).  Each position's
// post-update atoms are parked at pw/pls/pss[pos * ND + q].
__device__ __forceinline__ void uni_chain(const float* __restrict__ delta,
                                          const float* __restrict__ x, int64_t p,
                                          int64_t end, int q, float& w, float& ls,
                                          float& ss, float* __restrict__ pw,
                                          float* __restrict__ pls, float* __restrict__ pss) {
  constexpr int B = CHAIN_B;
  float d0[B], x0[B], d1[B], x1[B];
  load_batch<B, ND>(delta, p, q, d0);
  load_batch<B, 1>(x, p, 0, x0);
  for (;;) {
    load_batch<B, ND>(delta, p + B, q, d1);
    load_batch<B, 1>(x, p + B, 0, x1);
    uni_steps<B>(d0, x0, batch_count<B>(p, end), w, ls, ss, pw + p * ND + q,
                 pls + p * ND + q, pss + p * ND + q);
    p += B;
    if (p >= end) return;
    load_batch<B, ND>(delta, p + B, q, d0);
    load_batch<B, 1>(x, p + B, 0, x0);
    uni_steps<B>(d1, x1, batch_count<B>(p, end), w, ls, ss, pw + p * ND + q,
                 pls + p * ND + q, pss + p * ND + q);
    p += B;
    if (p >= end) return;
  }
}

}  // namespace fc
