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
// Design: a dependency-level schedule, then a level-by-level update.  The
// four key types touch disjoint tables and the four decays never interact.
// Within a key type, packet i touches, in row r, only the cells of column
// col_r(i) (a bi key type's own, opposite and SR cells all hang off the
// channel's base column).  So each cell sees its packets in array order as
// long as every packet runs after the earlier packets it shares a column
// with, and the result is the serial walk's bit for bit.
//
//   sketch_schedule_kernel, one block per key type: one warp walks the
//   packets 32 at a time (a lane a packet) with level(i) = 1 + max_r
//   last[r, col_r(i)], then last[r, col_r(i)] = level(i).  `last` lives in
//   shared memory, LAST_TABLE entries (128 KiB): row r owns a power-of-two
//   stripe of last_row_width(R) entries and a column is taken modulo it, so
//   columns may alias (an extra dependency: levels only rise) but rows never
//   do.  Lanes of one step that share a cell are found with
//   __match_any_sync per row and resolved in lane order.  Up to MAX_ROWS
//   rows a lane holds its packet's rows in registers; past it each row is
//   read in turn.  The block then
//   sorts the packets stably by level (counting sort: the walk numbers each
//   packet within its level, a block scan gives level starts) and cuts each
//   level into rounds of at most P packets.  Level counts stay in shared
//   memory up to SMEM_LEVELS packets, else in the scratch buffer.
//
//   sketch_update_kernel<RP>, one block per (key type, decay): a group of
//   RP lanes (R rounded up to a power of two, at most 32; a lane a row) runs
//   one packet, UPDATE_THREADS / RP packets a round, rounds in order with
//   __syncthreads() between them.  No two packets of a round share a cell.
//   The minimum across rows and the first argmin of sw are __shfl_xor
//   reductions inside the group; lanes of rows >= R take part with +inf.
//   Past 32 rows a packet takes the whole warp and lane r the rows r,
//   r + 32, ..., reducing over its own rows first.
//   A warp with no packet in the round only waits.  The chain between
//   rounds holds only what the tables need: row-0 lanes park the packet's
//   estimates in its feature slots, and the round starts are read three
//   rounds ahead, the order array two, the packet's inputs one.
//
//   sketch_features_kernel, a thread per (packet, key type, decay): the
//   features from the parked estimates, in place, at the packet's own row
//   in FEATURE_NAMES order.  The wrapper hashes the row indices before the
//   launch.
//
// Bound.  Bytes: the inputs read once, each touched cell read and written
// once, 320 B of features a packet.  What the kernel meets instead is the
// chain of levels: a round costs a few dependent L2 round trips plus the
// arithmetic, and a chunk needs at least as many rounds as its deepest
// key type has levels (a single flow: one round a packet).
//
// Arithmetic is the plain version's, operation for operation: exp2f, IEEE
// division and square root, and the build passes --fmad=false so no
// multiply-add is contracted.  At R = 1 the stored state is then the dense
// FC kernel's (csrc/fc_full.cu) bit for bit.
#include <cuda_runtime.h>
#include <cstdint>

#include "common.cuh"

namespace {

using fc::BI_COL0;
using fc::BI_F;
using fc::ND;
using fc::NF;
using fc::safe_div;
using fc::UNI_F;

constexpr int MAX_ROWS = 8;     // rows the schedule holds in registers
constexpr int LAST_TABLE = 32768;     // entries of the schedule's `last` table
constexpr int SMEM_LEVELS = 8192;     // level counts in shared memory up to this n
constexpr int SCHED_THREADS = 1024;
constexpr int UPDATE_THREADS = 512;
constexpr unsigned FULL = 0xffffffffu;

struct Tables {
  float *ult, *uw, *uls, *uss;              // (N_UNI*R*W, 4)
  float *blt, *bw, *bls, *bss, *brl;        // (N_BI*R*W*2, 4): row 2*base+dir
  float *bsr, *bslt, *bsw;                  // (N_BI*R*W, 4): row base
};

// One key type's schedule in the scratch buffer, 5n + 5 int32 a key type:
// level (n), rank within the level (n; later rounds per level), order (n),
// level starts (n + 2), round starts (n + 1), and {depth, rounds}.
struct Sched {
  int32_t *level, *rank, *order, *cnt, *rstart, *meta;
};

__host__ __device__ inline Sched sched_of(int32_t* scratch, int n, int kt) {
  int32_t* b = scratch + static_cast<size_t>(kt) * (5 * static_cast<size_t>(n) + 5);
  return {b, b + n, b + 2 * static_cast<size_t>(n), b + 3 * static_cast<size_t>(n),
          b + 4 * static_cast<size_t>(n) + 2, b + 5 * static_cast<size_t>(n) + 3};
}

// entries of `last` that one row owns: the largest power of two with R of
// them in LAST_TABLE
__host__ __device__ inline int last_row_width(int R) {
  int w = LAST_TABLE;
  while (w * R > LAST_TABLE) w >>= 1;
  return w;
}

// Exclusive prefix sum of a[0, m) in place by the whole block; returns the
// total.  Every thread of the block must call it.
__device__ int block_exclusive_scan(int32_t* a, int m, int* warp_sums) {
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31, warp = tid >> 5;
  const int per = (m + nt - 1) / nt;
  const int lo = min(tid * per, m), hi = min(lo + per, m);
  int sum = 0;
  for (int q = lo; q < hi; ++q) sum += a[q];
  int x = sum;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(FULL, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < nt / 32 ? warp_sums[lane] : 0;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(FULL, w, off);
      if (lane >= off) w += y;
    }
    warp_sums[lane] = w;
  }
  __syncthreads();
  int run = x - sum + (warp > 0 ? warp_sums[warp - 1] : 0);
  const int total = warp_sums[nt / 32 - 1];
  for (int q = lo; q < hi; ++q) {
    const int v = a[q];
    a[q] = run;
    run += v;
  }
  __syncthreads();
  return total;
}

// ---------------------------------------------------------------------------
// schedule: levels, the stable order by level, and the rounds
// ---------------------------------------------------------------------------
// MR = MAX_ROWS: up to 8 rows, each packet's rows in registers and the next
// step's prefetched; MR = 0: any R, each row read when its turn comes.
template <int MR>
__global__ void __launch_bounds__(SCHED_THREADS)
sketch_schedule_kernel(const int32_t* __restrict__ rows, int32_t* __restrict__ scratch,
                       int n, int R, int W, int P) {
  extern __shared__ int32_t smem[];
  __shared__ int warp_sums[32];
  __shared__ int depth;
  const int kt = blockIdx.x, tid = threadIdx.x;
  const Sched s = sched_of(scratch, n, kt);
  int32_t* last = smem;
  int32_t* cnt = n <= SMEM_LEVELS ? smem + LAST_TABLE : s.cnt;
  for (int q = tid; q < LAST_TABLE; q += blockDim.x) last[q] = 0;
  for (int q = tid; q < n + 2; q += blockDim.x) cnt[q] = 0;
  __syncthreads();

  if (tid < 32) {
    const int lane = tid;
    const unsigned below = (1u << lane) - 1u;
    const int tw = last_row_width(R);
    const int kk = kt & 1;                       // key type within uni or bi
    const int32_t* krows = rows + static_cast<size_t>(kt) * n * R;
    constexpr int NR = MR > 0 ? MR : 1;
    int nxt[NR];
    if constexpr (MR > 0) {
#pragma unroll
      for (int r = 0; r < MR; ++r)
        nxt[r] = (r < R && lane < n) ? krows[static_cast<size_t>(lane) * R + r] : 0;
    }
    // the cell of row r of this lane's packet in `last`
    auto cell = [&](int r, int i, bool act) {
      int v;
      if constexpr (MR > 0) {
        v = nxt[r];
      } else {
        v = act ? krows[static_cast<size_t>(i) * R + r] : 0;
      }
      const int col = v - (kk * R + r) * W;
      return act ? r * tw + (col & (tw - 1)) : -1 - lane;
    };
    int deepest = 0;
    for (int base = 0; base < n; base += 32) {
      const int i = base + lane;
      const bool act = i < n;
      int slot[NR];
      unsigned same[NR];
      unsigned deps = 0;
      int lvl = 0;
      if constexpr (MR > 0) {
#pragma unroll
        for (int r = 0; r < MR; ++r) {
          if (r < R) {
            slot[r] = cell(r, i, act);
            same[r] = __match_any_sync(FULL, slot[r]);
            deps |= same[r];
            if (act) lvl = max(lvl, last[slot[r]]);
          }
        }
        const int ni = i + 32;
#pragma unroll
        for (int r = 0; r < MR; ++r)
          if (r < R && ni < n) nxt[r] = krows[static_cast<size_t>(ni) * R + r];
      } else {
        for (int r = 0; r < R; ++r) {
          const int c = cell(r, i, act);
          deps |= __match_any_sync(FULL, c);
          if (act) lvl = max(lvl, last[c]);
        }
      }
      lvl += 1;
      // earlier lanes of this step that share a cell, resolved in lane order
      deps &= below;
      unsigned srcs = __reduce_or_sync(FULL, deps);
      while (srcs) {
        const int k = __ffs(srcs) - 1;
        srcs &= srcs - 1;
        const int lk = __shfl_sync(FULL, lvl, k);
        if ((deps >> k) & 1u) lvl = max(lvl, lk + 1);
      }
      __syncwarp();
      // the last lane on a cell holds its highest level
      if constexpr (MR > 0) {
#pragma unroll
        for (int r = 0; r < MR; ++r)
          if (r < R && act && (same[r] >> lane) == 1u) last[slot[r]] = lvl;
      } else {
        for (int r = 0; r < R; ++r) {
          const int c = cell(r, i, act);
          const unsigned sm = __match_any_sync(FULL, c);
          if (act && (sm >> lane) == 1u) last[c] = lvl;
        }
      }
      // number within the level, in packet order
      const unsigned peers = __match_any_sync(FULL, act ? lvl : -1 - lane);
      const int rk = act ? cnt[lvl] + __popc(peers & below) : 0;
      __syncwarp();
      if (act && (peers >> lane) == 1u) cnt[lvl] = rk + 1;
      if (act) {
        s.level[i] = lvl;
        s.rank[i] = rk;
        deepest = max(deepest, lvl);
      }
      __syncwarp();
    }
    deepest = __reduce_max_sync(FULL, deepest);
    if (lane == 0) depth = deepest;
  }
  __syncthreads();

  const int L = depth;
  block_exclusive_scan(cnt, L + 2, warp_sums);   // cnt[l]: first position of level l
  for (int i = tid; i < n; i += blockDim.x) s.order[cnt[s.level[i]] + s.rank[i]] = i;
  __syncthreads();
  int32_t* nr = s.rank;                          // rounds of level q + 1
  for (int q = tid; q < L; q += blockDim.x) nr[q] = (cnt[q + 2] - cnt[q + 1] + P - 1) / P;
  __syncthreads();
  const int rounds = block_exclusive_scan(nr, L, warp_sums);
  for (int q = tid; q < L; q += blockDim.x) {
    const int end = cnt[q + 2];
    int32_t* out = s.rstart + nr[q];
    for (int pos = cnt[q + 1]; pos < end; pos += P) *out++ = pos;
  }
  if (tid == 0) {
    s.rstart[rounds] = n;
    s.meta[0] = L;
    s.meta[1] = rounds;
  }
}

// ---------------------------------------------------------------------------
// update: the rounds in order
// ---------------------------------------------------------------------------

// minimum over the RP lanes of one packet (lane bits below RP are the row)
template <int RP>
__device__ __forceinline__ float row_min(float v) {
#pragma unroll
  for (int off = 1; off < RP; off <<= 1) v = fminf(v, __shfl_xor_sync(FULL, v, off));
  return v;
}

// the first row holding the minimum of v, over the RP lanes of one packet
template <int RP>
__device__ __forceinline__ int row_argmin(float v, int r) {
#pragma unroll
  for (int off = 1; off < RP; off <<= 1) {
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

struct Packet {
  float t, x;
  int i, row, dir;              // i < 0: no packet in this slot
};

__device__ __forceinline__ Packet load_packet(const int32_t* __restrict__ krows,
                                              const int32_t* __restrict__ dirb,
                                              const float* __restrict__ ts,
                                              const float* __restrict__ lens,
                                              int i, int R, int r) {
  Packet p{0.0f, 0.0f, i, 0, 0};
  if (i >= 0) {
    p.t = ts[i];
    p.x = lens[i];
    p.dir = dirb[i];
    if (r < R) p.row = krows[static_cast<size_t>(i) * R + r];
  }
  return p;
}

// One packet (or none: p.i < 0) through one decay of one key type, on
// its group of RP lanes; every lane of the warp takes part.  Only what the
// tables need is computed here; the packet's Count-Min estimates (and a bi
// key type's opposite estimates and SR) go to its feature slots, and
// sketch_features_kernel turns them into features after the last round.
template <int RP>
__device__ __forceinline__ void update_packet(const Packet& p, int kt, int j, int r,
                                              int R, float lam, float age,
                                              const Tables& tab, float* __restrict__ feats) {
  const float inf = __int_as_float(0x7f800000);
  const int lane = threadIdx.x & 31;
  const bool active = p.i >= 0 && r < R;
  const float t = p.t, x = p.x;
  float* f = feats + static_cast<size_t>(p.i < 0 ? 0 : p.i) * NF;

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
    const float ew = row_min<RP>(cw), els = row_min<RP>(cls), ess = row_min<RP>(css);
    if (active) {
      tab.ult[e] = t;
      tab.uw[e] = fmaxf(cw - 1.0f, ew);
      tab.uls[e] = fmaxf(cls - x, els);
      tab.uss[e] = fmaxf(css - x * x, ess);
    }
    if (r == 0 && p.i >= 0) {
      float* g = f + kt * UNI_F + j * 3;
      g[0] = ew; g[1] = els; g[2] = ess;
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
    const float ew = row_min<RP>(cw), els = row_min<RP>(cls), ess = row_min<RP>(css);
    const float w_p = row_min<RP>(wp), ls_p = row_min<RP>(lsp), ss_p = row_min<RP>(ssp);

    // SR per row; the emitted value is the row of least sw
    const float r_feat = x - safe_div(els, ew);
    float sr2 = 0.0f, sw_now = inf;
    if (active) {
      const float dt_sr = fmaxf(t - sr_lt, 0.0f);
      const bool evict = age > 0.0f && dt_sr > age;
      const float dsr = (sr_lt < 0.0f || evict) ? 0.0f : exp2f(-lam * dt_sr);
      const float r_opp = evict ? 0.0f : rl_p;
      sr2 = sr * dsr + r_feat * r_opp;
      sw_now = sw * dsr;
    }
    const float m_sw = row_min<RP>(sw_now);
    const float sw2 = active ? fmaxf(sw_now, m_sw + 1.0f) : inf;
    const int best = row_argmin<RP>(sw2, r);
    const float sr_est = __shfl_sync(FULL, sr2, (lane & ~(RP - 1)) + best);

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
    if (r == 0 && p.i >= 0) {
      float* g = f + BI_COL0 + (kt - 2) * BI_F + j * 7;
      g[0] = ew; g[1] = els; g[2] = ess; g[3] = w_p;
      g[4] = ls_p; g[5] = ss_p; g[6] = sr_est;
    }
  }
}

// One packet (or none: p.i < 0) through one decay of one key type with
// R > 32 rows on a whole warp: lane r takes rows r, r + 32, ...; each lane
// reduces over its rows first (in row order, so the first argmin stays the
// first), then the warp.  A row's candidates are computed again from the
// tables for its write-back, which happens after every read of the round.
__device__ __forceinline__ void update_packet_multi(const Packet& p, int kt, int j,
                                                    int lane, int R, const int32_t* krows,
                                                    float lam, float age, const Tables& tab,
                                                    float* __restrict__ feats) {
  const float inf = __int_as_float(0x7f800000);
  const bool active = p.i >= 0;
  const float t = p.t, x = p.x;
  const int32_t* prow = krows + static_cast<size_t>(active ? p.i : 0) * R;
  float* f = feats + static_cast<size_t>(active ? p.i : 0) * NF;

  if (kt < 2) {
    float cw = inf, cls = inf, css = inf;
    for (int r = lane; active && r < R; r += 32) {
      const size_t e = static_cast<size_t>(prow[r]) * ND + j;
      const float delta = cu_decay(tab.ult[e], t, lam, age);
      cw = fminf(cw, tab.uw[e] * delta + 1.0f);
      cls = fminf(cls, tab.uls[e] * delta + x);
      css = fminf(css, tab.uss[e] * delta + x * x);
    }
    const float ew = row_min<32>(cw), els = row_min<32>(cls), ess = row_min<32>(css);
    for (int r = lane; active && r < R; r += 32) {
      const size_t e = static_cast<size_t>(prow[r]) * ND + j;
      const float delta = cu_decay(tab.ult[e], t, lam, age);
      const float w = tab.uw[e] * delta + 1.0f, ls = tab.uls[e] * delta + x,
                  ss = tab.uss[e] * delta + x * x;
      tab.ult[e] = t;
      tab.uw[e] = fmaxf(w - 1.0f, ew);
      tab.uls[e] = fmaxf(ls - x, els);
      tab.uss[e] = fmaxf(ss - x * x, ess);
    }
    if (lane == 0 && active) {
      float* g = f + kt * UNI_F + j * 3;
      g[0] = ew; g[1] = els; g[2] = ess;
    }
    return;
  }

  // ---- bidirectional key type: own row 2*base+dir, SR row base ----
  auto rows_of = [&](int r, size_t& eo, size_t& ep, size_t& es) {
    const size_t base = static_cast<size_t>(prow[r]);
    eo = (base * 2 + p.dir) * ND + j;
    ep = (base * 2 + 1 - p.dir) * ND + j;
    es = base * ND + j;
  };
  // the SR decay and the opposite residual of one row
  auto sr_terms = [&](size_t ep, size_t es, float& dsr, float& r_opp) {
    const float sr_lt = tab.bslt[es];
    const float dt_sr = fmaxf(t - sr_lt, 0.0f);
    const bool evict = age > 0.0f && dt_sr > age;
    dsr = (sr_lt < 0.0f || evict) ? 0.0f : exp2f(-lam * dt_sr);
    r_opp = evict ? 0.0f : tab.brl[ep];
  };
  float cw = inf, cls = inf, css = inf, wp = inf, lsp = inf, ssp = inf;
  for (int r = lane; active && r < R; r += 32) {
    size_t eo, ep, es;
    rows_of(r, eo, ep, es);
    const float delta = cu_decay(tab.blt[eo], t, lam, age);
    cw = fminf(cw, tab.bw[eo] * delta + 1.0f);
    cls = fminf(cls, tab.bls[eo] * delta + x);
    css = fminf(css, tab.bss[eo] * delta + x * x);
    const bool zap = age > 0.0f && (t - tab.blt[ep]) > age;
    wp = fminf(wp, zap ? 0.0f : tab.bw[ep]);
    lsp = fminf(lsp, zap ? 0.0f : tab.bls[ep]);
    ssp = fminf(ssp, zap ? 0.0f : tab.bss[ep]);
  }
  const float ew = row_min<32>(cw), els = row_min<32>(cls), ess = row_min<32>(css);
  const float w_p = row_min<32>(wp), ls_p = row_min<32>(lsp), ss_p = row_min<32>(ssp);
  const float r_feat = x - safe_div(els, ew);
  float sw_min = inf;
  for (int r = lane; active && r < R; r += 32) {
    size_t eo, ep, es;
    rows_of(r, eo, ep, es);
    float dsr, r_opp;
    sr_terms(ep, es, dsr, r_opp);
    sw_min = fminf(sw_min, tab.bsw[es] * dsr);
  }
  const float m_sw = row_min<32>(sw_min);
  // each lane's first row of least sw2, and its sr2
  float best_sw = inf, best_sr = 0.0f;
  int best_row = R;
  for (int r = lane; active && r < R; r += 32) {
    size_t eo, ep, es;
    rows_of(r, eo, ep, es);
    float dsr, r_opp;
    sr_terms(ep, es, dsr, r_opp);
    const float sw2 = fmaxf(tab.bsw[es] * dsr, m_sw + 1.0f);
    if (sw2 < best_sw) {
      best_sw = sw2;
      best_row = r;
      best_sr = tab.bsr[es] * dsr + r_feat * r_opp;
    }
  }
  const int best = row_argmin<32>(best_sw, best_row);
  const float sr_est = __shfl_sync(FULL, best_sr, best & 31);
  __syncwarp();
  for (int r = lane; active && r < R; r += 32) {
    size_t eo, ep, es;
    rows_of(r, eo, ep, es);
    float dsr, r_opp;
    sr_terms(ep, es, dsr, r_opp);
    const float delta = cu_decay(tab.blt[eo], t, lam, age);
    const float w = tab.bw[eo] * delta + 1.0f, ls = tab.bls[eo] * delta + x,
                ss = tab.bss[eo] * delta + x * x;
    const float sr2 = tab.bsr[es] * dsr + r_feat * r_opp;
    const float sw2 = fmaxf(tab.bsw[es] * dsr, m_sw + 1.0f);
    tab.blt[eo] = t;
    tab.bw[eo] = fmaxf(w - 1.0f, ew);
    tab.bls[eo] = fmaxf(ls - x, els);
    tab.bss[eo] = fmaxf(ss - x * x, ess);
    tab.brl[eo] = r_feat;
    tab.bsr[es] = sr2;
    tab.bslt[es] = t;
    tab.bsw[es] = sw2;
  }
  if (lane == 0 && active) {
    float* g = f + BI_COL0 + (kt - 2) * BI_F + j * 7;
    g[0] = ew; g[1] = els; g[2] = ess; g[3] = w_p;
    g[4] = ls_p; g[5] = ss_p; g[6] = sr_est;
  }
}

// RP lanes a packet; MULTI: R > 32 rows on RP = 32 lanes (update_packet_multi)
template <int RP, bool MULTI>
__global__ void __launch_bounds__(UPDATE_THREADS)
sketch_update_kernel(const int32_t* __restrict__ rows,
                     const int32_t* __restrict__ dirb,
                     const float* __restrict__ ts,
                     const float* __restrict__ lens,
                     const float* __restrict__ age_p, Tables tab,
                     float* __restrict__ feats, const int32_t* __restrict__ scratch,
                     int n, int R) {
  const int kt = blockIdx.x >> 2, j = blockIdx.x & 3;   // key type, decay
  const int r = threadIdx.x & (RP - 1);                  // row
  const int slot = threadIdx.x / RP;                     // packet of the round
  const float lam = fc::lam(j);
  const float age = *age_p;
  const int32_t* krows = rows + static_cast<size_t>(kt) * n * R;
  const Sched s = sched_of(const_cast<int32_t*>(scratch), n, kt);
  const int32_t* __restrict__ rstart = s.rstart;
  const int32_t* __restrict__ order = s.order;
  const int rounds = s.meta[1];

  auto rs_at = [&](int k) { return k <= rounds ? rstart[k] : n; };
  auto pkt_at = [&](int beg, int end) { return beg + slot < end ? order[beg + slot] : -1; };
  int rs2 = rs_at(2), rs3 = rs_at(3);
  int p1 = pkt_at(rs_at(1), rs2);
  Packet cur = load_packet(krows, dirb, ts, lens, pkt_at(rs_at(0), rs_at(1)), R, r);

  for (int k = 0; k < rounds; ++k) {
    const Packet nxt = load_packet(krows, dirb, ts, lens, p1, R, r);
    p1 = pkt_at(rs2, rs3);
    rs2 = rs3;
    rs3 = rs_at(k + 4);

    // a warp whose lanes hold no packet this round only waits
    if constexpr (MULTI) {
      // a packet takes the whole warp, so cur.i is the same on every lane
      if (cur.i >= 0) update_packet_multi(cur, kt, j, r, R, krows, lam, age, tab, feats);
    } else if (__any_sync(FULL, cur.i >= 0)) {
      update_packet<RP>(cur, kt, j, r, R, lam, age, tab, feats);
    }
    __syncthreads();
    cur = nxt;
  }
}

// The features of each (packet, key type, decay) from the estimates the
// update left in its feature slots, in place: uni (w, ls, ss) -> (w, mu,
// sigma); bi (w, ls, ss, w_p, ls_p, ss_p, sr) -> (w, mu, sigma, magnitude,
// radius, cov, pcc).
__global__ void sketch_features_kernel(float* __restrict__ feats, int n) {
  const int64_t q = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (q >= static_cast<int64_t>(n) * 16) return;
  const int kt = static_cast<int>(q & 15) >> 2, j = static_cast<int>(q & 3);
  float* f = feats + (q >> 4) * NF;
  float mu_o, var_o, sig_o;
  if (kt < 2) {
    float* g = f + kt * UNI_F + j * 3;
    fc::stats(g[0], g[1], g[2], mu_o, var_o, sig_o);
    g[1] = mu_o; g[2] = sig_o;
    return;
  }
  float* g = f + BI_COL0 + (kt - 2) * BI_F + j * 7;
  const float ew = g[0], w_p = g[3], sr_est = g[6];
  float mu_p, var_p, sig_p;
  fc::stats(ew, g[1], g[2], mu_o, var_o, sig_o);
  fc::stats(w_p, g[4], g[5], mu_p, var_p, sig_p);
  const float mag = sqrtf(fmaxf(mu_o * mu_o + mu_p * mu_p, 0.0f));
  const float rad = sqrtf(fmaxf(var_o * var_o + var_p * var_p, 0.0f));
  const float cov = safe_div(sr_est, ew + w_p);
  const float pcc = safe_div(cov, sig_o * sig_p);
  g[1] = mu_o; g[2] = sig_o; g[3] = mag;
  g[4] = rad; g[5] = cov; g[6] = pcc;
}

// one thread follows a chain of indices through L2 (loads that skip L1)
__global__ void l2_chase_kernel(const int32_t* __restrict__ next, int steps,
                                int32_t* __restrict__ out) {
  int p = 0;
  for (int k = 0; k < steps; ++k) p = __ldcg(next + p);
  *out = p;
}

// lanes a packet: R rounded up to a power of two, at most a warp
int rows_pow2(int R) {
  int rp = 1;
  while (rp < R && rp < 32) rp <<= 1;
  return rp;
}

// packets a round of the update for R rows
int round_size(int R) { return UPDATE_THREADS / rows_pow2(R); }

template <int RP, bool MULTI = false>
void launch_update(const void* rows, const void* dirb, const void* ts, const void* lens,
                   const void* age, const Tables& tab, void* feats, const void* scratch,
                   int n, int R, cudaStream_t st) {
  sketch_update_kernel<RP, MULTI><<<16, UPDATE_THREADS, 0, st>>>(
      static_cast<const int32_t*>(rows), static_cast<const int32_t*>(dirb),
      static_cast<const float*>(ts), static_cast<const float*>(lens),
      static_cast<const float*>(age), tab, static_cast<float*>(feats),
      static_cast<const int32_t*>(scratch), n, R);
}

}  // namespace

// Dynamic shared memory of the schedule kernel for n packets.
extern "C" int sketch_schedule_smem(int n) {
  return (LAST_TABLE + (n <= SMEM_LEVELS ? n + 2 : 0)) * static_cast<int>(sizeof(int32_t));
}

// rows: (4, n, R) int32 flat table rows per key type (uni: (k*R+r)*W+col,
// bi: the SR row (k*R+r)*W+col); dirb: (n,) int32; age: 0-dim float32;
// scratch: 4 * (5n + 5) int32, left holding each key type's schedule.
extern "C" int sketch_update_launch(const void* rows, const void* dirb,
                                    const void* ts, const void* lens, const void* age,
                                    void* ult, void* uw, void* uls, void* uss,
                                    void* blt, void* bw, void* bls, void* bss,
                                    void* brl, void* bsr, void* bslt, void* bsw,
                                    void* feats, void* scratch, int n, int R, int W,
                                    void* stream) {
  if (R < 1 || R > LAST_TABLE || n < 1 || W < 1) return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const int smem = sketch_schedule_smem(n);
  auto sched = R <= MAX_ROWS ? sketch_schedule_kernel<MAX_ROWS> : sketch_schedule_kernel<0>;
  cudaError_t err = cudaFuncSetAttribute(
      sched, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  sched<<<4, SCHED_THREADS, smem, st>>>(
      static_cast<const int32_t*>(rows), static_cast<int32_t*>(scratch), n, R, W,
      round_size(R));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  Tables tab{static_cast<float*>(ult), static_cast<float*>(uw),
             static_cast<float*>(uls), static_cast<float*>(uss),
             static_cast<float*>(blt), static_cast<float*>(bw),
             static_cast<float*>(bls), static_cast<float*>(bss),
             static_cast<float*>(brl), static_cast<float*>(bsr),
             static_cast<float*>(bslt), static_cast<float*>(bsw)};
  switch (rows_pow2(R)) {
    case 1: launch_update<1>(rows, dirb, ts, lens, age, tab, feats, scratch, n, R, st); break;
    case 2: launch_update<2>(rows, dirb, ts, lens, age, tab, feats, scratch, n, R, st); break;
    case 4: launch_update<4>(rows, dirb, ts, lens, age, tab, feats, scratch, n, R, st); break;
    case 8: launch_update<8>(rows, dirb, ts, lens, age, tab, feats, scratch, n, R, st); break;
    case 16: launch_update<16>(rows, dirb, ts, lens, age, tab, feats, scratch, n, R, st); break;
    default:
      if (R <= 32) {
        launch_update<32>(rows, dirb, ts, lens, age, tab, feats, scratch, n, R, st);
      } else {
        launch_update<32, true>(rows, dirb, ts, lens, age, tab, feats, scratch, n, R, st);
      }
      break;
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t items = static_cast<int64_t>(n) * 16;
  sketch_features_kernel<<<static_cast<unsigned>((items + 255) / 256), 256, 0, st>>>(
      static_cast<float*>(feats), n);
  return static_cast<int>(cudaGetLastError());
}

// Measurement probe, not on any path: `steps` dependent loads through L2
// along the index chain `next` (one thread), for the chain floor.
extern "C" int sketch_l2_chase_launch(const void* next, int steps, void* out, void* stream) {
  l2_chase_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(next), steps, static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
