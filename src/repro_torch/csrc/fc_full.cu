// Exact 80-feature Peregrine feature computation (FC) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/feature_update.py ::
// feature_update_full (_fc_full_kernel).  Semantics are the serial oracle's,
// process_serial(mode="exact"): packets are applied in array order.
//
// Design.  The TPU kernel walks every packet in one sequential grid with the
// tables resident in VMEM.  On the GPU blocks run in parallel with nothing
// carried between them, but the serial order only matters within one key
// type's slot: a uni key type's segment is the packets that share its row;
// a bi key type's segment is the packets that share its channel/socket slot,
// both directions together (one direction's last residual feeds the other's
// SR, and SR is kept per slot).  The wrapper stable-sorts the 4n
// (key type, packet) pairs by combined key kt*n_slots + slot, so each
// segment is a run of equal keys in array order.  One thread is launched
// per sorted position; the thread at the head of a run walks the run, keeps
// the run's table rows in registers (4 floats per table row, 48 floats for
// a bi slot), writes that key type's 12 or 28 features straight into each
// packet's row in the oracle's column order, and stores the rows back once.
//
// Bound.  Bytes: each touched row is read and written once (uni 4 tables,
// bi 5 tables x 2 directions + 2 SR tables, 16 B a row), plus 320 B of
// features and 24 B of packet data, index and key per packet.  The tables
// (about 4 MiB at 8192 slots) live in HBM/L2; a thread's rows live in
// registers for the whole segment, so each row crosses memory once per
// launch.  What keeps the kernel far from that bound is a heavy-hitter
// segment, which serialises in one thread, and the launch and sort around
// it.
//
// Arithmetic is the oracle's, operation for operation: exp2f (not __expf),
// IEEE division and square root, and the build passes --fmad=false so no
// multiply-add is contracted.  The variance E[x^2] - mu^2 cancels, and a
// contracted multiply-add would move std/radius/cov/pcc by O(0.1).
#include <cuda_runtime.h>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int ND = 4;           // decay instances
constexpr int NF = 80;          // features per packet
constexpr int UNI_F = 12;       // features per uni key type
constexpr int BI_F = 28;        // features per bi key type
constexpr int BI_COL0 = 24;     // first bi feature column

__constant__ float kLam[ND] = {10.0f, 1.0f, 0.1f, static_cast<float>(1.0 / 60.0)};

struct Tables {
  float *ult, *uw, *uls, *uss;              // (2*n_slots, 4)
  float *blt, *bw, *bls, *bss, *brl;        // (4*n_slots, 4): row 2*base+dir
  float *bsr, *bslt;                        // (2*n_slots, 4): row base
};

// One direction of a bi slot, held in registers while its segment runs.
struct Dir {
  float lt[ND], w[ND], ls[ND], ss[ND], rl[ND];
};

__device__ __forceinline__ void load4(float (&dst)[ND], const float* row) {
  const float4 v = *reinterpret_cast<const float4*>(row);
  dst[0] = v.x; dst[1] = v.y; dst[2] = v.z; dst[3] = v.w;
}

__device__ __forceinline__ void store4(float* row, const float (&src)[ND]) {
  *reinterpret_cast<float4*>(row) = make_float4(src[0], src[1], src[2], src[3]);
}

__device__ __forceinline__ float safe_div(float a, float b) {
  return b > 0.0f ? a / fmaxf(b, 1e-12f) : 0.0f;
}

__device__ __forceinline__ float decay(float last_t, float t, int q) {
  const float dt = fmaxf(t - last_t, 0.0f);
  return last_t < 0.0f ? 0.0f : exp2f(-kLam[q] * dt);
}

// (mu, var, sigma) of one decay instance.
__device__ __forceinline__ void stats(float w, float ls, float ss, float& mu,
                                      float& var, float& sig) {
  mu = safe_div(ls, w);
  const float ex2 = safe_div(ss, w);
  var = fabsf(ex2 - mu * mu);
  sig = sqrtf(fmaxf(var, 0.0f));
}

// One packet of a bi segment: update `own`, read `opp` as stored (stale),
// update the slot's SR, and emit the 28 features at `f`.
__device__ __forceinline__ void bi_step(Dir& own, const Dir& opp, float (&sr)[ND],
                                        float (&slt)[ND], float t, float x, float* f) {
#pragma unroll
  for (int q = 0; q < ND; ++q) {
    const float delta = decay(own.lt[q], t, q);
    const float w_o = own.w[q] * delta + 1.0f;
    const float ls_o = own.ls[q] * delta + x;
    const float ss_o = own.ss[q] * delta + x * x;
    float mu_o, var_o, sig_o, mu_p, var_p, sig_p;
    stats(w_o, ls_o, ss_o, mu_o, var_o, sig_o);
    const float w_p = opp.w[q];
    stats(w_p, opp.ls[q], opp.ss[q], mu_p, var_p, sig_p);

    const float dsr = decay(slt[q], t, q);
    const float r = x - mu_o;
    const float sr2 = sr[q] * dsr + r * opp.rl[q];

    const float mag = sqrtf(fmaxf(mu_o * mu_o + mu_p * mu_p, 0.0f));
    const float rad = sqrtf(fmaxf(var_o * var_o + var_p * var_p, 0.0f));
    const float cov = safe_div(sr2, w_o + w_p);
    const float pcc = safe_div(cov, sig_o * sig_p);

    own.lt[q] = t; own.w[q] = w_o; own.ls[q] = ls_o; own.ss[q] = ss_o;
    own.rl[q] = r;
    sr[q] = sr2; slt[q] = t;

    float* g = f + q * 7;
    g[0] = w_o; g[1] = mu_o; g[2] = sig_o; g[3] = mag;
    g[4] = rad; g[5] = cov; g[6] = pcc;
  }
}

__global__ void fc_full_kernel(const int64_t* __restrict__ perm,
                               const int32_t* __restrict__ skey,
                               const int32_t* __restrict__ dirb,
                               const float* __restrict__ ts,
                               const float* __restrict__ lens, Tables tab,
                               float* __restrict__ feats, int n, int n_slots) {
  const int64_t total = 4LL * n;
  const int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j >= total) return;
  const int key = skey[j];
  if (j > 0 && skey[j - 1] == key) return;          // not a segment head
  const int kt = key / n_slots;                     // key type 0..3

  if (kt < 2) {
    // ---- unidirectional key type: row = kt*n_slots + slot = key ----
    const size_t row = static_cast<size_t>(key) * ND;
    float lt[ND], w[ND], ls[ND], ss[ND];
    load4(lt, tab.ult + row); load4(w, tab.uw + row);
    load4(ls, tab.uls + row); load4(ss, tab.uss + row);
    for (int64_t p = j; p < total && skey[p] == key; ++p) {
      const int i = static_cast<int>(perm[p] - static_cast<int64_t>(kt) * n);
      const float t = ts[i], x = lens[i];
      float* f = feats + static_cast<size_t>(i) * NF + kt * UNI_F;
#pragma unroll
      for (int q = 0; q < ND; ++q) {
        const float delta = decay(lt[q], t, q);
        w[q] = w[q] * delta + 1.0f;
        ls[q] = ls[q] * delta + x;
        ss[q] = ss[q] * delta + x * x;
        lt[q] = t;
        float mu, var, sig;
        stats(w[q], ls[q], ss[q], mu, var, sig);
        f[q * 3 + 0] = w[q]; f[q * 3 + 1] = mu; f[q * 3 + 2] = sig;
      }
    }
    store4(tab.ult + row, lt); store4(tab.uw + row, w);
    store4(tab.uls + row, ls); store4(tab.uss + row, ss);
  } else {
    // ---- bidirectional key type: base = kb*n_slots + slot ----
    const int kb = kt - 2;
    const size_t base = static_cast<size_t>(key) - 2 * static_cast<size_t>(n_slots);
    const size_t r0 = base * 2 * ND, r1 = (base * 2 + 1) * ND, rs = base * ND;
    Dir d0, d1;
    load4(d0.lt, tab.blt + r0); load4(d0.w, tab.bw + r0); load4(d0.ls, tab.bls + r0);
    load4(d0.ss, tab.bss + r0); load4(d0.rl, tab.brl + r0);
    load4(d1.lt, tab.blt + r1); load4(d1.w, tab.bw + r1); load4(d1.ls, tab.bls + r1);
    load4(d1.ss, tab.bss + r1); load4(d1.rl, tab.brl + r1);
    float sr[ND], slt[ND];
    load4(sr, tab.bsr + rs); load4(slt, tab.bslt + rs);
    for (int64_t p = j; p < total && skey[p] == key; ++p) {
      const int i = static_cast<int>(perm[p] - static_cast<int64_t>(kt) * n);
      const float t = ts[i], x = lens[i];
      float* f = feats + static_cast<size_t>(i) * NF + BI_COL0 + kb * BI_F;
      if (dirb[i] == 0) {
        bi_step(d0, d1, sr, slt, t, x, f);
      } else {
        bi_step(d1, d0, sr, slt, t, x, f);
      }
    }
    store4(tab.blt + r0, d0.lt); store4(tab.bw + r0, d0.w); store4(tab.bls + r0, d0.ls);
    store4(tab.bss + r0, d0.ss); store4(tab.brl + r0, d0.rl);
    store4(tab.blt + r1, d1.lt); store4(tab.bw + r1, d1.w); store4(tab.bls + r1, d1.ls);
    store4(tab.bss + r1, d1.ss); store4(tab.brl + r1, d1.rl);
    store4(tab.bsr + rs, sr); store4(tab.bslt + rs, slt);
  }
}

}  // namespace

// perm: (4n,) int64 stable sort permutation of the kt-major (4, n) key
// matrix; skey: (4n,) int32 sorted keys kt*n_slots + slot; dirb: (n,) int32.
extern "C" int fc_full_launch(const void* perm, const void* skey, const void* dirb,
                              const void* ts, const void* lens,
                              void* ult, void* uw, void* uls, void* uss,
                              void* blt, void* bw, void* bls, void* bss, void* brl,
                              void* bsr, void* bslt, void* feats, int n, int n_slots,
                              int block, void* stream) {
  Tables tab{static_cast<float*>(ult), static_cast<float*>(uw),
             static_cast<float*>(uls), static_cast<float*>(uss),
             static_cast<float*>(blt), static_cast<float*>(bw),
             static_cast<float*>(bls), static_cast<float*>(bss),
             static_cast<float*>(brl), static_cast<float*>(bsr),
             static_cast<float*>(bslt)};
  const int64_t total = 4LL * n;
  const unsigned grid = static_cast<unsigned>((total + block - 1) / block);
  fc_full_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(perm), static_cast<const int32_t*>(skey),
      static_cast<const int32_t*>(dirb), static_cast<const float*>(ts),
      static_cast<const float*>(lens), tab, static_cast<float*>(feats), n, n_slots);
  return static_cast<int>(cudaGetLastError());
}
