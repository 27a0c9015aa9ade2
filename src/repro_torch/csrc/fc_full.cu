// Exact 80-feature Peregrine feature computation (FC) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/feature_update.py ::
// feature_update_full (_fc_full_kernel).  Semantics are the serial oracle's,
// process_serial(mode="exact"): packets are applied in array order.
//
// What is serial.  The TPU kernel walks every packet in one sequential
// grid with the tables resident in VMEM.  On the GPU, serial order only
// matters within one key type's slot: a uni key type's segment is the
// packets that share its row; a bi key type's segment is the packets that
// share its channel/socket slot, both directions together.  The wrapper
// stable-sorts the 4n (key type, packet) pairs by combined key
// (t*4 + kt)*n_slots + slot, so each segment is a run of equal keys in
// array order.
//
// Tenants.  The tables may be a pool of T tenants' tables stacked on a
// leading axis (init_state_stacked), and one launch may take L tenants'
// chunks, lane-major: t is the packet's tenant in the pool (0 for a single
// state).  Tenants share no key, so each lane's segments, and its bits, are
// those of a launch of that lane alone.  A key's uni row is
// (t*N_UNI + kt)*n_slots + slot and its bi base row
// (t*N_BI + kt - 2)*n_slots + slot (key_row).  Inside a segment only three things are recurrences: the affine
// atom updates w*delta + 1, ls*delta + x, ss*delta + x^2 per (direction,
// decay); for bi key types the SR update sr*dsr + r*rl_opp; and the stored
// last residual.  Everything else is arithmetic per packet on values the
// chains produce.  So one launch runs six kernels:
//
//   fc_scan_kernel, a block per tile of TILE sorted positions: gathers each
//   position's time, length and (packet, direction) into sorted order, and
//   takes inclusive max-scans inside the tile of "last position of
//   direction 0", "of direction 1" and "last segment head", with each
//   tile's last value of the three.
//   fc_prelude_kernel, a thread per position: its segment head, and the
//   latest earlier position of its own and of the opposite direction in
//   the segment (the in-tile scans, else a look-back over the tiles'
//   values); then the decay factors of the position's own atoms (since the
//   previous packet of the same direction, or the stored last_t at the
//   head) and, for bi key types, of the SR (since the previous packet of
//   either direction, or the stored sr_last_t).
//   fc_chain_kernel, a thread per (segment, decay): the affine chains only,
//   both directions of a bi slot in registers, each batch of positions'
//   inputs loading while the batch before it is applied; each position's
//   post-update (w, ls, ss) is parked by sorted position.  Uni rows are
//   stored back here.
//   fc_residual_kernel, a thread per (bi position, decay): r = x - mu_own
//   from the parked atoms; the opposite direction as stored, i.e. parked
//   at its latest earlier packet or the table's row; and the product
//   r * rl_opp, rl_opp being the residual of that latest opposite packet or
//   the stored one.
//   fc_sr_kernel, a thread per (bi segment, decay): sr = sr*dsr + r*rl_opp,
//   parked; then every bi row of the slot stored back as the oracle leaves
//   it.
//   fc_features_kernel, a thread per (position, decay): the IEEE divisions
//   and square roots the features need, from the parked values, into the
//   packet's row in the oracle's columns.
//
// Each value is computed by the oracle's operations in the oracle's order;
// the work is only moved between threads and kernels, so features and
// state equal the oracle's bit for bit.
//
// Bound.  Bytes: each touched row read and written once (uni 4 tables, bi
// 5 tables x 2 directions + 2 SR tables, 16 B a row), 320 B of features and
// 24 B of packet data, index and key a packet.  What the kernels meet
// instead is the longest segment: its chain costs one dependent multiply
// and add a packet (the chain floor) and, in practice, the time one thread
// takes to dispatch a step's instructions, plus the launches of six kernels.
//
// Arithmetic is the oracle's, operation for operation: exp2f (not __expf),
// IEEE division and square root, and the build passes --fmad=false so no
// multiply-add is contracted.  The variance E[x^2] - mu^2 cancels, and a
// contracted multiply-add would move std/radius/cov/pcc by O(0.1).
#include <cuda_runtime.h>
#include <cstdint>

#include "common.cuh"

namespace {

using fc::BI_COL0;
using fc::BI_F;
using fc::CHAIN_PAD;
using fc::ND;
using fc::NF;
using fc::UNI_F;

constexpr int TILE = 1024;      // sorted positions a scan block takes
constexpr int BI_B = 16;        // positions a bi or SR chain loads at once
constexpr int THREADS = 256;    // threads of the other kernels' blocks
constexpr unsigned FULL = 0xffffffffu;

struct Tables {
  float *ult, *uw, *uls, *uss;              // (2*n_slots, 4)
  float *blt, *bw, *bls, *bss, *brl;        // (4*n_slots, 4): row 2*base+dir
  float *bsr, *bslt;                        // (2*n_slots, 4): row base
};

// The scratch buffer, per sorted position p of the N = 4n positions, each
// array CHAIN_PAD positions longer than N (the chains load batches past
// their end): NF_ARR float arrays of (NP, ND) first (each 16-byte aligned),
// then eight (NP) arrays, then three values a tile (the wrapper sizes it:
// kernels/feature_update.py fc_scratch_words).
constexpr int NF_ARR = 11;
struct Scratch {
  float *delta, *dsr;               // (N, ND): own decay, SR decay
  float *pw, *pls, *pss;            // (N, ND): parked atoms after the update
  float *opw, *opls, *opss;         // (N, ND): the opposite direction as stored
  float *r, *rprod, *psr;           // (N, ND): residual, r * rl_opp, parked sr
  float *t, *x;                     // (N): the packet's time and length
  int32_t* meta;                    // (N): packet index * 2 + direction
  int32_t *last0, *last1, *lhead;   // (N): in-tile inclusive max-scans
  int32_t* popp;                    // (N): latest earlier opposite position, -1
  int32_t* send;                    // (N): at a segment head, its last position
  int32_t *agg0, *agg1, *aggh;      // (tiles): each tile's last scan values
};

// A combined key (t*4 + kt)*n_slots + slot: its key type and its table row,
// the uni row (t*N_UNI + kt)*n_slots + slot or the bi base row
// (t*N_BI + kt - 2)*n_slots + slot (N_UNI = N_BI = 2).  At t = 0 these are
// key and key - 2*n_slots.
__device__ __forceinline__ int key_type(int key, int n_slots) { return (key / n_slots) & 3; }

__device__ __forceinline__ size_t key_row(int key, int n_slots) {
  const int ks = key / n_slots;
  return static_cast<size_t>((ks >> 2) * 2 + (ks & 1)) * n_slots + (key - ks * n_slots);
}

__host__ __device__ inline int64_t n_tiles(int64_t N) { return (N + TILE - 1) / TILE; }

__host__ __device__ inline Scratch scratch_of(float* base, int64_t N) {
  Scratch s;
  const int64_t NP = N + CHAIN_PAD;
  float** arr[NF_ARR] = {&s.delta, &s.dsr, &s.pw, &s.pls, &s.pss, &s.opw,
                         &s.opls, &s.opss, &s.r, &s.rprod, &s.psr};
  for (int a = 0; a < NF_ARR; ++a) *arr[a] = base + a * ND * NP;
  s.t = base + NF_ARR * ND * NP;
  s.x = s.t + NP;
  int32_t* ib = reinterpret_cast<int32_t*>(s.x + NP);
  s.meta = ib;
  s.last0 = ib + NP;
  s.last1 = ib + 2 * NP;
  s.lhead = ib + 3 * NP;
  s.popp = ib + 4 * NP;
  s.send = ib + 5 * NP;
  const int64_t T = n_tiles(N);
  s.agg0 = ib + 6 * NP;
  s.agg1 = s.agg0 + T;
  s.aggh = s.agg1 + T;
  return s;
}

// Inclusive max-scan of three values over the block (blockDim.x = TILE).
__device__ void block_max_scan3(int& a, int& b, int& c) {
  __shared__ int sums[3][TILE / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int ya = __shfl_up_sync(FULL, a, off), yb = __shfl_up_sync(FULL, b, off),
              yc = __shfl_up_sync(FULL, c, off);
    if (lane >= off) { a = max(a, ya); b = max(b, yb); c = max(c, yc); }
  }
  if (lane == 31) { sums[0][warp] = a; sums[1][warp] = b; sums[2][warp] = c; }
  __syncthreads();
  if (warp == 0) {
    int sa = sums[0][lane], sb = sums[1][lane], sc = sums[2][lane];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int ya = __shfl_up_sync(FULL, sa, off), yb = __shfl_up_sync(FULL, sb, off),
                yc = __shfl_up_sync(FULL, sc, off);
      if (lane >= off) { sa = max(sa, ya); sb = max(sb, yb); sc = max(sc, yc); }
    }
    sums[0][lane] = sa; sums[1][lane] = sb; sums[2][lane] = sc;
  }
  __syncthreads();
  if (warp > 0) {
    a = max(a, sums[0][warp - 1]);
    b = max(b, sums[1][warp - 1]);
    c = max(c, sums[2][warp - 1]);
  }
}

__global__ void __launch_bounds__(TILE)
fc_scan_kernel(const int64_t* __restrict__ perm, const int32_t* __restrict__ skey,
               const int32_t* __restrict__ dirb, const float* __restrict__ ts,
               const float* __restrict__ lens, Scratch s, int n, int n_slots) {
  const int64_t N = 4LL * n;
  const int64_t p = static_cast<int64_t>(blockIdx.x) * TILE + threadIdx.x;
  const bool valid = p < N;
  int v0 = -1, v1 = -1, vh = -1;
  if (valid) {
    const int key = skey[p];
    const int kt = key_type(key, n_slots);
    const int i = static_cast<int>(perm[p] - static_cast<int64_t>(kt) * n);
    const int dir = kt >= 2 ? dirb[i] : 0;
    s.t[p] = ts[i];
    s.x[p] = lens[i];
    s.meta[p] = i * 2 + dir;
    (dir ? v1 : v0) = static_cast<int>(p);
    if (p == 0 || skey[p - 1] != key) vh = static_cast<int>(p);
  }
  block_max_scan3(v0, v1, vh);
  if (valid) {
    s.last0[p] = v0;
    s.last1[p] = v1;
    s.lhead[p] = vh;
  }
  if (threadIdx.x == TILE - 1) {
    s.agg0[blockIdx.x] = v0;
    s.agg1[blockIdx.x] = v1;
    s.aggh[blockIdx.x] = vh;
  }
}

// The latest position before p of direction `dir` in the segment that
// starts at h, or -1: the tile's scan at p - 1, else the tiles before it.
__device__ __forceinline__ int last_before(const Scratch& s, int p, int h, int dir) {
  const int tile0 = (p / TILE) * TILE;
  const int32_t* scan = dir ? s.last1 : s.last0;
  const int32_t* agg = dir ? s.agg1 : s.agg0;
  int cand = p - 1 >= tile0 ? scan[p - 1] : -1;
  if (cand < 0 && h < tile0) {
    for (int u = p / TILE - 1; u >= 0 && (u + 1) * TILE > h; --u) {
      cand = agg[u];
      if (cand >= 0) break;
    }
  }
  return cand >= h ? cand : -1;
}

__global__ void __launch_bounds__(THREADS)
fc_prelude_kernel(const int32_t* __restrict__ skey, Tables tab, Scratch s, int n,
                  int n_slots) {
  const int64_t N = 4LL * n;
  const int64_t pp = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  if (pp >= N) return;
  const int p = static_cast<int>(pp);
  const int key = skey[p];
  const int kt = key_type(key, n_slots);
  const size_t row = key_row(key, n_slots);
  const float t = s.t[p];
  int h = s.lhead[p];
  for (int u = p / TILE - 1; h < 0; --u) h = s.aggh[u];
  if (p + 1 == N || skey[p + 1] != key) s.send[h] = p;
  float d[ND];
  if (kt < 2) {
    const float* lt = tab.ult + row * ND;
#pragma unroll
    for (int q = 0; q < ND; ++q) d[q] = fc::decay(p > h ? s.t[p - 1] : lt[q], t, q);
  } else {
    const size_t base = row;
    const int dir = s.meta[p] & 1;
    const int ps = last_before(s, p, h, dir);
    s.popp[p] = last_before(s, p, h, 1 - dir);
    const float* lt = tab.blt + (base * 2 + dir) * ND;
    const float* slt = tab.bslt + base * ND;
    float e[ND];
#pragma unroll
    for (int q = 0; q < ND; ++q) {
      d[q] = fc::decay(ps >= 0 ? s.t[ps] : lt[q], t, q);
      e[q] = fc::decay(p > h ? s.t[p - 1] : slt[q], t, q);
    }
    reinterpret_cast<float4*>(s.dsr)[p] = make_float4(e[0], e[1], e[2], e[3]);
  }
  reinterpret_cast<float4*>(s.delta)[p] = make_float4(d[0], d[1], d[2], d[3]);
}

__device__ __forceinline__ bool is_head(const int32_t* skey, int64_t p, int key) {
  return p == 0 || skey[p - 1] != key;
}

// `cnt` steps of one bi slot's chains of decay q from the batch's values,
// the direction of each position picking its atoms; parked at
// pw/pls/pss[k * ND] (the pointers at the batch's first position and q)
__device__ __forceinline__ void bi_steps(const float (&d)[BI_B], const float (&xs)[BI_B],
                                         const int32_t (&m)[BI_B], int cnt, float (&w)[2],
                                         float (&ls)[2], float (&ss)[2],
                                         float* __restrict__ pw, float* __restrict__ pls,
                                         float* __restrict__ pss) {
#pragma unroll
  for (int k = 0; k < BI_B; ++k) {
    if (k < cnt) {
      const bool dir = m[k] & 1;
      const float w2 = (dir ? w[1] : w[0]) * d[k] + 1.0f;
      const float ls2 = (dir ? ls[1] : ls[0]) * d[k] + xs[k];
      const float ss2 = (dir ? ss[1] : ss[0]) * d[k] + xs[k] * xs[k];
      if (dir) { w[1] = w2; ls[1] = ls2; ss[1] = ss2; } else { w[0] = w2; ls[0] = ls2; ss[0] = ss2; }
      pw[k * ND] = w2; pls[k * ND] = ls2; pss[k * ND] = ss2;
    }
  }
}

// `cnt` steps of one SR chain of decay q from the batch's values, parked
// at psr[k * ND]; the latest position of each direction follows
__device__ __forceinline__ void sr_steps(const float (&ds)[BI_B], const float (&rp)[BI_B],
                                         const int32_t (&m)[BI_B], int cnt, int64_t p0,
                                         float& sr, int64_t& last0, int64_t& last1,
                                         float* __restrict__ psr) {
#pragma unroll
  for (int k = 0; k < BI_B; ++k) {
    if (k < cnt) {
      sr = sr * ds[k] + rp[k];
      psr[k * ND] = sr;
      if (m[k] & 1) last1 = p0 + k; else last0 = p0 + k;
    }
  }
}

__global__ void __launch_bounds__(THREADS)
fc_chain_kernel(const int32_t* __restrict__ skey, Tables tab, Scratch s, int n,
                int n_slots) {
  const int64_t N = 4LL * n;
  const int64_t g = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  const int64_t p = g >> 2;
  const int q = static_cast<int>(g & 3);
  if (p >= N) return;
  const int key = skey[p];
  if (!is_head(skey, p, key)) return;
  const int kt = key_type(key, n_slots);
  const size_t row = key_row(key, n_slots);
  const int64_t end = static_cast<int64_t>(s.send[p]) + 1;

  if (kt < 2) {
    const size_t e = row * ND + q;
    float w = tab.uw[e], ls = tab.uls[e], ss = tab.uss[e];
    fc::uni_chain(s.delta, s.x, p, end, q, w, ls, ss, s.pw, s.pls, s.pss);
    tab.ult[e] = s.t[end - 1];
    tab.uw[e] = w; tab.uls[e] = ls; tab.uss[e] = ss;
    return;
  }

  // bi: both directions' atoms in registers; the rows are stored back by
  // fc_sr_kernel, after fc_residual_kernel has read them as stored
  const size_t base = row;
  const size_t e0 = base * 2 * ND + q, e1 = (base * 2 + 1) * ND + q;
  float w[2] = {tab.bw[e0], tab.bw[e1]}, ls[2] = {tab.bls[e0], tab.bls[e1]},
        ss[2] = {tab.bss[e0], tab.bss[e1]};
  float d0[BI_B], x0[BI_B], d1[BI_B], x1[BI_B];
  int32_t m0[BI_B], m1[BI_B];
  fc::load_batch<BI_B, ND>(s.delta, p, q, d0);
  fc::load_batch<BI_B, 1>(s.x, p, 0, x0);
  fc::load_batch<BI_B, 1>(s.meta, p, 0, m0);
  for (int64_t p0 = p;;) {
    fc::load_batch<BI_B, ND>(s.delta, p0 + BI_B, q, d1);
    fc::load_batch<BI_B, 1>(s.x, p0 + BI_B, 0, x1);
    fc::load_batch<BI_B, 1>(s.meta, p0 + BI_B, 0, m1);
    const int64_t e = p0 * ND + q;
    bi_steps(d0, x0, m0, fc::batch_count<BI_B>(p0, end), w, ls, ss, s.pw + e, s.pls + e,
             s.pss + e);
    p0 += BI_B;
    if (p0 >= end) return;
    fc::load_batch<BI_B, ND>(s.delta, p0 + BI_B, q, d0);
    fc::load_batch<BI_B, 1>(s.x, p0 + BI_B, 0, x0);
    fc::load_batch<BI_B, 1>(s.meta, p0 + BI_B, 0, m0);
    const int64_t e1b = p0 * ND + q;
    bi_steps(d1, x1, m1, fc::batch_count<BI_B>(p0, end), w, ls, ss, s.pw + e1b,
             s.pls + e1b, s.pss + e1b);
    p0 += BI_B;
    if (p0 >= end) return;
  }
}

__global__ void __launch_bounds__(THREADS)
fc_residual_kernel(const int32_t* __restrict__ skey, Tables tab, Scratch s, int n,
                   int n_slots) {
  const int64_t N = 4LL * n;
  const int64_t g = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  const int64_t p = g >> 2;
  const int q = static_cast<int>(g & 3);
  if (p >= N) return;
  const int key = skey[p];
  if (key_type(key, n_slots) < 2) return;
  const int64_t e = p * ND + q;
  const float r = s.x[p] - fc::safe_div(s.pls[e], s.pw[e]);
  const int po = s.popp[p];
  float wp, lsp, ssp, rl;
  if (po >= 0) {
    const int64_t eo = static_cast<int64_t>(po) * ND + q;
    wp = s.pw[eo]; lsp = s.pls[eo]; ssp = s.pss[eo];
    rl = s.x[po] - fc::safe_div(lsp, wp);
  } else {
    const size_t base = key_row(key, n_slots);
    const size_t et = (base * 2 + 1 - (s.meta[p] & 1)) * ND + q;
    wp = tab.bw[et]; lsp = tab.bls[et]; ssp = tab.bss[et]; rl = tab.brl[et];
  }
  s.opw[e] = wp; s.opls[e] = lsp; s.opss[e] = ssp;
  s.r[e] = r;
  s.rprod[e] = r * rl;
}

__global__ void __launch_bounds__(THREADS)
fc_sr_kernel(const int32_t* __restrict__ skey, Tables tab, Scratch s, int n,
             int n_slots) {
  const int64_t N = 4LL * n;
  const int64_t g = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  const int64_t p = g >> 2;
  const int q = static_cast<int>(g & 3);
  if (p >= N) return;
  const int key = skey[p];
  if (key_type(key, n_slots) < 2 || !is_head(skey, p, key)) return;
  const int64_t end = static_cast<int64_t>(s.send[p]) + 1;
  const size_t base = key_row(key, n_slots);
  const size_t es = base * ND + q;
  float sr = tab.bsr[es];
  int64_t last0 = -1, last1 = -1;
  float ds0[BI_B], rp0[BI_B], ds1[BI_B], rp1[BI_B];
  int32_t m0[BI_B], m1[BI_B];
  fc::load_batch<BI_B, ND>(s.dsr, p, q, ds0);
  fc::load_batch<BI_B, ND>(s.rprod, p, q, rp0);
  fc::load_batch<BI_B, 1>(s.meta, p, 0, m0);
  for (int64_t p0 = p;;) {
    fc::load_batch<BI_B, ND>(s.dsr, p0 + BI_B, q, ds1);
    fc::load_batch<BI_B, ND>(s.rprod, p0 + BI_B, q, rp1);
    fc::load_batch<BI_B, 1>(s.meta, p0 + BI_B, 0, m1);
    sr_steps(ds0, rp0, m0, fc::batch_count<BI_B>(p0, end), p0, sr, last0, last1,
             s.psr + p0 * ND + q);
    p0 += BI_B;
    if (p0 >= end) break;
    fc::load_batch<BI_B, ND>(s.dsr, p0 + BI_B, q, ds0);
    fc::load_batch<BI_B, ND>(s.rprod, p0 + BI_B, q, rp0);
    fc::load_batch<BI_B, 1>(s.meta, p0 + BI_B, 0, m0);
    sr_steps(ds1, rp1, m1, fc::batch_count<BI_B>(p0, end), p0, sr, last0, last1,
             s.psr + p0 * ND + q);
    p0 += BI_B;
    if (p0 >= end) break;
  }
  tab.bsr[es] = sr;
  tab.bslt[es] = s.t[end - 1];
#pragma unroll
  for (int d = 0; d < 2; ++d) {
    const int64_t ld = d ? last1 : last0;
    if (ld < 0) continue;
    const size_t et = (base * 2 + d) * ND + q;
    const int64_t e = ld * ND + q;
    tab.blt[et] = s.t[ld];
    tab.bw[et] = s.pw[e]; tab.bls[et] = s.pls[e]; tab.bss[et] = s.pss[e];
    tab.brl[et] = s.r[e];
  }
}

// The features of one (sorted position, decay) from the parked values,
// into the packet's row in the oracle's columns: uni (w, mu, sigma); bi
// (w, mu, sigma, magnitude, radius, cov, pcc) with the opposite direction
// as stored.
__global__ void __launch_bounds__(THREADS)
fc_features_kernel(const int32_t* __restrict__ skey, Scratch s,
                   float* __restrict__ feats, int n, int n_slots) {
  const int64_t N = 4LL * n;
  const int64_t g = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  const int64_t p = g >> 2;
  const int q = static_cast<int>(g & 3);
  if (p >= N) return;
  const int kt = key_type(skey[p], n_slots);
  const int64_t e = p * ND + q;
  float* f = feats + static_cast<size_t>(s.meta[p] >> 1) * NF;
  const float w_o = s.pw[e];
  float mu_o, var_o, sig_o;
  fc::stats(w_o, s.pls[e], s.pss[e], mu_o, var_o, sig_o);
  if (kt < 2) {
    float* u = f + kt * UNI_F + q * 3;
    u[0] = w_o; u[1] = mu_o; u[2] = sig_o;
    return;
  }
  const float w_p = s.opw[e];
  float mu_p, var_p, sig_p;
  fc::stats(w_p, s.opls[e], s.opss[e], mu_p, var_p, sig_p);
  float* b = f + BI_COL0 + (kt - 2) * BI_F + q * 7;
  const float cov = fc::safe_div(s.psr[e], w_o + w_p);
  b[0] = w_o; b[1] = mu_o; b[2] = sig_o;
  b[3] = sqrtf(fmaxf(mu_o * mu_o + mu_p * mu_p, 0.0f));
  b[4] = sqrtf(fmaxf(var_o * var_o + var_p * var_p, 0.0f));
  b[5] = cov;
  b[6] = fc::safe_div(cov, sig_o * sig_p);
}

// one thread, `steps` dependent multiply-adds of the chains' form
__global__ void fc_chain_probe_kernel(float d, int steps, float* __restrict__ out) {
  float w = 0.0f;
  for (int k = 0; k < steps; ++k) w = w * d + 1.0f;
  *out = w;
}

unsigned blocks(int64_t items, int per) { return static_cast<unsigned>((items + per - 1) / per); }

}  // namespace

// perm: (4n,) int64 stable sort permutation of the kt-major (4, n) key
// matrix; skey: (4n,) int32 sorted keys (t*4 + kt)*n_slots + slot, t the
// packet's tenant (0 for a single state); dirb: (n,) int32; the tables
// (T*rows, 4), T >= 1 tenants stacked with 4*T*n_slots < 2^31;
// scratch: (NF_ARR * ND + 8) * (4n + CHAIN_PAD) + 3 * tiles float32 words
// (kernels/feature_update.py fc_scratch_words), 16-byte aligned.
extern "C" int fc_full_launch(const void* perm, const void* skey, const void* dirb,
                              const void* ts, const void* lens,
                              void* ult, void* uw, void* uls, void* uss,
                              void* blt, void* bw, void* bls, void* bss, void* brl,
                              void* bsr, void* bslt, void* feats, void* scratch,
                              int n, int n_slots, void* stream) {
  if (n < 1 || n_slots < 1) return static_cast<int>(cudaErrorInvalidValue);
  Tables tab{static_cast<float*>(ult), static_cast<float*>(uw),
             static_cast<float*>(uls), static_cast<float*>(uss),
             static_cast<float*>(blt), static_cast<float*>(bw),
             static_cast<float*>(bls), static_cast<float*>(bss),
             static_cast<float*>(brl), static_cast<float*>(bsr),
             static_cast<float*>(bslt)};
  const int64_t N = 4LL * n;
  const Scratch s = scratch_of(static_cast<float*>(scratch), N);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* sk = static_cast<const int32_t*>(skey);
  float* f = static_cast<float*>(feats);
  fc_scan_kernel<<<blocks(N, TILE), TILE, 0, st>>>(
      static_cast<const int64_t*>(perm), sk, static_cast<const int32_t*>(dirb),
      static_cast<const float*>(ts), static_cast<const float*>(lens), s, n, n_slots);
  fc_prelude_kernel<<<blocks(N, THREADS), THREADS, 0, st>>>(sk, tab, s, n, n_slots);
  fc_chain_kernel<<<blocks(N * ND, THREADS), THREADS, 0, st>>>(sk, tab, s, n, n_slots);
  fc_residual_kernel<<<blocks(N * ND, THREADS), THREADS, 0, st>>>(sk, tab, s, n, n_slots);
  fc_sr_kernel<<<blocks(N * ND, THREADS), THREADS, 0, st>>>(sk, tab, s, n, n_slots);
  fc_features_kernel<<<blocks(N * ND, THREADS), THREADS, 0, st>>>(sk, s, f, n, n_slots);
  return static_cast<int>(cudaGetLastError());
}

// Measurement probe, not on any path: `steps` dependent multiply-adds
// (w = w*d + 1, unfused) in one thread, for the chain floor.
extern "C" int fc_chain_probe_launch(float d, int steps, void* out, void* stream) {
  fc_chain_probe_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      d, steps, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
