// Count-Min sketch feature computation (all 80 features) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/sketch_update.py ::
// sketch_update_full (_sketch_kernel).  Semantics are the plain version's,
// core/sketch.py::process_sketch: packets are applied in array order; per
// key type the R hashed cells are gathered, aged out past evict_age,
// decayed, combined by the per-atom minimum across rows (the Count-Min
// read) and written back by conservative update, max(cand - inc, est); the
// opposite direction is read as stored (stale) through the same minimum;
// SR is kept per row and the row of least sw (the first, on a tie) is
// emitted.
//
// Design.  The TPU kernel walks every packet in one sequential grid with
// all tables in VMEM.  The dense FC kernel's per-slot segmentation does not
// carry over: two flows that collide in one row may not collide in the
// others, so any two packets of a key type may share a cell.  What is left
// to run in parallel: the four key types touch disjoint tables, and every
// operation of the update is elementwise across the four decays.  So the
// kernel runs one warp per key type (4 blocks of 32 threads), and lane
// r*4 + j owns row r and decay j.  Each cell (key type, row, column[, dir],
// decay) is only ever touched by one lane of one warp, in packet order, so
// no lane ever waits on another's store.  The minimum across rows and the
// first argmin of sw are __shfl_xor reductions over the row bits of the
// lane; lanes of rows >= R take part with +inf.  Lanes of row 0 write the
// features, in FEATURE_NAMES order.  The wrapper hashes the row indices
// before the launch; the kernel never hashes.
//
// Bound.  Bytes: each touched cell read and written once, 320 B of features
// and the packet's indices, time and length.  What the kernel meets
// instead is latency: each warp walks all n packets in turn, and a packet's
// loads may hit the cell the previous packet stored, so every packet costs
// at least one L2 round trip per warp.  Four warps on a 132-SM card leave
// it far from either bound; the packet's read-only inputs are loaded one
// packet ahead to keep them off that chain.
//
// Arithmetic is the plain version's, operation for operation: exp2f, IEEE
// division and square root, and the build passes --fmad=false so no
// multiply-add is contracted.  At R = 1 the stored state is then the dense
// FC kernel's (csrc/fc_full.cu) bit for bit.
#include <cuda_runtime.h>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int ND = 4;           // decay instances
constexpr int NF = 80;          // features per packet
constexpr int UNI_F = 12;       // features per uni key type
constexpr int BI_F = 28;        // features per bi key type
constexpr int BI_COL0 = 24;     // first bi feature column
constexpr int MAX_ROWS = 8;     // rows that fit one warp, 4 lanes a row
constexpr unsigned FULL = 0xffffffffu;

__constant__ float kLam[ND] = {10.0f, 1.0f, 0.1f, static_cast<float>(1.0 / 60.0)};

struct Tables {
  float *ult, *uw, *uls, *uss;              // (N_UNI*R*W, 4)
  float *blt, *bw, *bls, *bss, *brl;        // (N_BI*R*W*2, 4): row 2*base+dir
  float *bsr, *bslt, *bsw;                  // (N_BI*R*W, 4): row base
};

__device__ __forceinline__ float safe_div(float a, float b) {
  return b > 0.0f ? a / fmaxf(b, 1e-12f) : 0.0f;
}

// minimum over the lanes of one decay (lane bits 2..4 are the row)
__device__ __forceinline__ float row_min(float v) {
  v = fminf(v, __shfl_xor_sync(FULL, v, 4));
  v = fminf(v, __shfl_xor_sync(FULL, v, 8));
  v = fminf(v, __shfl_xor_sync(FULL, v, 16));
  return v;
}

// the first row holding the minimum of v, over the lanes of one decay
__device__ __forceinline__ int row_argmin(float v, int r) {
#pragma unroll
  for (int off = 4; off < 32; off <<= 1) {
    const float ov = __shfl_xor_sync(FULL, v, off);
    const int orow = __shfl_xor_sync(FULL, r, off);
    if (ov < v || (ov == v && orow < r)) {
      v = ov;
      r = orow;
    }
  }
  return r;
}

// decay factor of one cell: 0 when fresh or aged out
__device__ __forceinline__ float cu_decay(float lt, float t, float lam, float age) {
  const float dt = fmaxf(t - lt, 0.0f);
  const bool dead = lt < 0.0f || (age > 0.0f && dt > age);
  return dead ? 0.0f : exp2f(-lam * dt);
}

// (mu, var, sigma) of one decay instance
__device__ __forceinline__ void stats(float w, float ls, float ss, float& mu,
                                      float& var, float& sig) {
  mu = safe_div(ls, w);
  const float ex2 = safe_div(ss, w);
  var = fabsf(ex2 - mu * mu);
  sig = sqrtf(fmaxf(var, 0.0f));
}

struct Packet {
  float t, x;
  int row, dir;
};

__device__ __forceinline__ Packet load_packet(const int32_t* __restrict__ krows,
                                              const int32_t* __restrict__ dirb,
                                              const float* __restrict__ ts,
                                              const float* __restrict__ lens,
                                              int i, int R, int r, bool active) {
  Packet p;
  p.t = ts[i];
  p.x = lens[i];
  p.row = active ? krows[static_cast<size_t>(i) * R + r] : 0;
  p.dir = dirb[i];
  return p;
}

__global__ void __launch_bounds__(32)
sketch_update_kernel(const int32_t* __restrict__ rows,
                     const int32_t* __restrict__ dirb,
                     const float* __restrict__ ts,
                     const float* __restrict__ lens,
                     const float* __restrict__ age_p, Tables tab,
                     float* __restrict__ feats, int n, int R) {
  const int kt = blockIdx.x;                        // key type 0..3
  const int lane = threadIdx.x;
  const int j = lane & 3, r = lane >> 2;            // decay, row
  const bool active = r < R;
  const float lam = kLam[j];
  const float age = *age_p;
  const float inf = __int_as_float(0x7f800000);
  const int32_t* krows = rows + static_cast<size_t>(kt) * n * R;

  Packet nxt = n > 0 ? load_packet(krows, dirb, ts, lens, 0, R, r, active) : Packet{};
  for (int i = 0; i < n; ++i) {
    const Packet p = nxt;
    if (i + 1 < n) nxt = load_packet(krows, dirb, ts, lens, i + 1, R, r, active);
    const float t = p.t, x = p.x;
    float* f = feats + static_cast<size_t>(i) * NF;

    if (kt < 2) {
      // ---- unidirectional key type ----
      const size_t e = static_cast<size_t>(p.row) * ND + j;
      float cw = inf, cls = inf, css = inf;
      if (active) {
        const float delta = cu_decay(tab.ult[e], t, lam, age);
        cw = tab.uw[e] * delta + 1.0f;
        cls = tab.uls[e] * delta + x;
        css = tab.uss[e] * delta + x * x;
      }
      const float ew = row_min(cw), els = row_min(cls), ess = row_min(css);
      if (active) {
        tab.ult[e] = t;
        tab.uw[e] = fmaxf(cw - 1.0f, ew);
        tab.uls[e] = fmaxf(cls - x, els);
        tab.uss[e] = fmaxf(css - x * x, ess);
      }
      if (r == 0) {
        float mu, var, sig;
        stats(ew, els, ess, mu, var, sig);
        float* g = f + kt * UNI_F + j * 3;
        g[0] = ew; g[1] = mu; g[2] = sig;
      }
    } else {
      // ---- bidirectional key type: own row 2*base+dir, SR row base ----
      const size_t eo = (static_cast<size_t>(p.row) * 2 + p.dir) * ND + j;
      const size_t ep = (static_cast<size_t>(p.row) * 2 + 1 - p.dir) * ND + j;
      const size_t es = static_cast<size_t>(p.row) * ND + j;
      float cw = inf, cls = inf, css = inf;
      float wp = inf, lsp = inf, ssp = inf;
      float sr = 0.0f, sr_lt = 0.0f, sw = 0.0f, rl_p = 0.0f;
      if (active) {
        const float delta = cu_decay(tab.blt[eo], t, lam, age);
        cw = tab.bw[eo] * delta + 1.0f;
        cls = tab.bls[eo] * delta + x;
        css = tab.bss[eo] * delta + x * x;
        // opposite direction as stored (stale); aged-out cells read as 0
        const bool zap = age > 0.0f && (t - tab.blt[ep]) > age;
        wp = zap ? 0.0f : tab.bw[ep];
        lsp = zap ? 0.0f : tab.bls[ep];
        ssp = zap ? 0.0f : tab.bss[ep];
        rl_p = tab.brl[ep];
        sr = tab.bsr[es];
        sr_lt = tab.bslt[es];
        sw = tab.bsw[es];
      }
      const float ew = row_min(cw), els = row_min(cls), ess = row_min(css);
      const float w_p = row_min(wp), ls_p = row_min(lsp), ss_p = row_min(ssp);
      float mu_o, var_o, sig_o, mu_p, var_p, sig_p;
      stats(ew, els, ess, mu_o, var_o, sig_o);
      stats(w_p, ls_p, ss_p, mu_p, var_p, sig_p);

      // SR per row; the emitted value is the row of least sw
      const float r_feat = x - mu_o;
      float sr2 = 0.0f, sw_now = inf;
      if (active) {
        const float dt_sr = fmaxf(t - sr_lt, 0.0f);
        const bool evict = age > 0.0f && dt_sr > age;
        const float dsr = (sr_lt < 0.0f || evict) ? 0.0f : exp2f(-lam * dt_sr);
        const float r_opp = evict ? 0.0f : rl_p;
        sr2 = sr * dsr + r_feat * r_opp;
        sw_now = sw * dsr;
      }
      const float m_sw = row_min(sw_now);
      const float sw2 = active ? fmaxf(sw_now, m_sw + 1.0f) : inf;
      const int best = row_argmin(sw2, r);
      const float sr_est = __shfl_sync(FULL, sr2, best * 4 + j);

      if (active) {
        tab.blt[eo] = t;
        tab.bw[eo] = fmaxf(cw - 1.0f, ew);
        tab.bls[eo] = fmaxf(cls - x, els);
        tab.bss[eo] = fmaxf(css - x * x, ess);
        tab.brl[eo] = r_feat;
        tab.bsr[es] = sr2;
        tab.bslt[es] = t;
        tab.bsw[es] = sw2;
      }
      if (r == 0) {
        const float mag = sqrtf(fmaxf(mu_o * mu_o + mu_p * mu_p, 0.0f));
        const float rad = sqrtf(fmaxf(var_o * var_o + var_p * var_p, 0.0f));
        const float cov = safe_div(sr_est, ew + w_p);
        const float pcc = safe_div(cov, sig_o * sig_p);
        float* g = f + BI_COL0 + (kt - 2) * BI_F + j * 7;
        g[0] = ew; g[1] = mu_o; g[2] = sig_o; g[3] = mag;
        g[4] = rad; g[5] = cov; g[6] = pcc;
      }
    }
  }
}

}  // namespace

// rows: (4, n, R) int32 flat table rows per key type (uni: (k*R+r)*W+col,
// bi: the SR row (k*R+r)*W+col); dirb: (n,) int32; age: 0-dim float32.
extern "C" int sketch_update_launch(const void* rows, const void* dirb,
                                    const void* ts, const void* lens, const void* age,
                                    void* ult, void* uw, void* uls, void* uss,
                                    void* blt, void* bw, void* bls, void* bss,
                                    void* brl, void* bsr, void* bslt, void* bsw,
                                    void* feats, int n, int R, void* stream) {
  if (R < 1 || R > MAX_ROWS) return static_cast<int>(cudaErrorInvalidValue);
  Tables tab{static_cast<float*>(ult), static_cast<float*>(uw),
             static_cast<float*>(uls), static_cast<float*>(uss),
             static_cast<float*>(blt), static_cast<float*>(bw),
             static_cast<float*>(bls), static_cast<float*>(bss),
             static_cast<float*>(brl), static_cast<float*>(bsr),
             static_cast<float*>(bslt), static_cast<float*>(bsw)};
  sketch_update_kernel<<<4, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(rows), static_cast<const int32_t*>(dirb),
      static_cast<const float*>(ts), static_cast<const float*>(lens),
      static_cast<const float*>(age), tab, static_cast<float*>(feats), n, R);
  return static_cast<int>(cudaGetLastError());
}
