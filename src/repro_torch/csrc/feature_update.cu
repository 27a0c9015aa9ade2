// Single-key-type streaming atom update for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/feature_update.py ::
// feature_update (_fc_kernel).  Semantics are the plain version's,
// kernels/feature_update.py::feature_update_ref: packets are applied in
// array order; per packet, delta = 2^(-lambda*dt) (0 for a fresh slot), then
// w, LS, SS <- (w, LS, SS)*delta + (1, x, x^2), then [w | mu | sigma] per
// decay, written as the packet's 12 stats.
//
// Design: the uni half of csrc/fc_full.cu, with its device code from
// common.cuh.  Serial order only matters within one slot, so the wrapper
// stable-sorts the packets by slot, and only the affine atom updates stay
// serial.  One launch runs three kernels:
//   feature_update_prelude_kernel, a thread per sorted position: gathers
//   the packet's time, length and index into sorted order, computes its
//   decay factors, since the previous packet of its slot or the stored
//   last_t at the head of the run; a run's head finds the run's end;
//   feature_update_chain_kernel, a thread per (run, decay): the affine
//   chain (common.cuh uni_chain), each position's post-update (w, ls, ss)
//   parked, the row stored back once;
//   feature_update_stats_kernel, a thread per (position, decay): w, mu
//   and sigma from the parked atoms into the packet's stats row.
//
// Bound.  Bytes: each touched row (4 tables x 16 B) read and written once,
// 48 B of stats and 16 B of packet data, index and key a packet.  The
// longest run's chain of dependent multiply-adds sets the time in practice.
//
// Arithmetic is the plain version's, operation for operation: exp2f, IEEE
// division and square root, no contracted multiply-add (--fmad=false).
#include <cuda_runtime.h>
#include <cstdint>

#include "common.cuh"

namespace {

using fc::ND;

constexpr int THREADS = 256;

// per sorted position, each array fc::CHAIN_PAD positions longer than n (a
// chain loads batches past its end): decay factors and the parked atoms
// (np, ND), then time, length, packet index and, at a run head, the run's
// last position (np)
struct Scratch {
  float *delta, *pw, *pls, *pss, *t, *x;
  int32_t *idx, *send;
};

__host__ __device__ inline Scratch scratch_of(float* base, int64_t n) {
  const int64_t np = n + fc::CHAIN_PAD;
  float* f = base + 4 * ND * np;
  int32_t* i = reinterpret_cast<int32_t*>(f + 2 * np);
  return {base, base + ND * np, base + 2 * ND * np, base + 3 * ND * np, f, f + np, i, i + np};
}

__global__ void __launch_bounds__(THREADS)
feature_update_prelude_kernel(const int64_t* __restrict__ perm,
                              const int32_t* __restrict__ skey,
                              const float* __restrict__ ts,
                              const float* __restrict__ lens,
                              const float* __restrict__ last_t, Scratch s, int n) {
  const int64_t p = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  if (p >= n) return;
  const int key = skey[p];
  const int64_t i = perm[p];
  const float t = ts[i];
  const bool head = p == 0 || skey[p - 1] != key;
  const float* lt = last_t + static_cast<size_t>(key) * ND;
  const float prev = head ? 0.0f : ts[perm[p - 1]];
  float d[ND];
#pragma unroll
  for (int q = 0; q < ND; ++q) d[q] = fc::decay(head ? lt[q] : prev, t, q);
  reinterpret_cast<float4*>(s.delta)[p] = make_float4(d[0], d[1], d[2], d[3]);
  s.t[p] = t;
  s.x[p] = lens[i];
  s.idx[p] = static_cast<int32_t>(i);
  if (head) {
    // the run's last position: gallop over the sorted keys, then bisect
    int64_t lo = p, step = 1;
    while (lo + step < n && skey[lo + step] == key) {
      lo += step;
      step *= 2;
    }
    int64_t hi = lo + step < n ? lo + step : n;
    while (hi - lo > 1) {
      const int64_t mid = (lo + hi) / 2;
      if (skey[mid] == key) lo = mid; else hi = mid;
    }
    s.send[p] = static_cast<int32_t>(lo);
  }
}

__global__ void __launch_bounds__(THREADS)
feature_update_chain_kernel(const int32_t* __restrict__ skey, Scratch s,
                            float* __restrict__ last_t, float* __restrict__ w_t,
                            float* __restrict__ ls_t, float* __restrict__ ss_t, int n) {
  const int64_t g = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  const int64_t p = g >> 2;
  const int q = static_cast<int>(g & 3);
  if (p >= n) return;
  const int key = skey[p];
  if (p > 0 && skey[p - 1] == key) return;          // not a run head
  const int64_t end = static_cast<int64_t>(s.send[p]) + 1;
  const size_t e = static_cast<size_t>(key) * ND + q;
  float w = w_t[e], ls = ls_t[e], ss = ss_t[e];
  fc::uni_chain(s.delta, s.x, p, end, q, w, ls, ss, s.pw, s.pls, s.pss);
  last_t[e] = s.t[end - 1];
  w_t[e] = w; ls_t[e] = ls; ss_t[e] = ss;
}

__global__ void __launch_bounds__(THREADS)
feature_update_stats_kernel(Scratch s, float* __restrict__ stats, int n) {
  const int64_t g = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  if (g >= static_cast<int64_t>(n) * ND) return;
  const int64_t p = g >> 2;
  const int q = static_cast<int>(g & 3);
  const float w = s.pw[g];
  const float mu = s.pls[g] / w;
  float* st = stats + static_cast<size_t>(s.idx[p]) * 3 * ND + q;
  st[0] = w;
  st[ND] = mu;
  st[2 * ND] = sqrtf(fabsf(s.pss[g] / w - mu * mu));
}

unsigned blocks(int64_t items) { return static_cast<unsigned>((items + THREADS - 1) / THREADS); }

}  // namespace

// perm: (n,) int64 stable sort permutation of the slots; skey: (n,) int32
// sorted slots; tables (n_slots, 4) float32; stats (n, 12) float32;
// scratch: (4 * ND + 4) * (n + fc::CHAIN_PAD) float32 words, 16-byte
// aligned.
extern "C" int feature_update_launch(const void* perm, const void* skey,
                                     const void* ts, const void* lens,
                                     void* last_t, void* w, void* ls, void* ss,
                                     void* stats, void* scratch, int n, void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const Scratch s = scratch_of(static_cast<float*>(scratch), n);
  const auto* sk = static_cast<const int32_t*>(skey);
  feature_update_prelude_kernel<<<blocks(n), THREADS, 0, st>>>(
      static_cast<const int64_t*>(perm), sk, static_cast<const float*>(ts),
      static_cast<const float*>(lens), static_cast<const float*>(last_t), s, n);
  feature_update_chain_kernel<<<blocks(static_cast<int64_t>(n) * ND), THREADS, 0, st>>>(
      sk, s, static_cast<float*>(last_t), static_cast<float*>(w),
      static_cast<float*>(ls), static_cast<float*>(ss), n);
  feature_update_stats_kernel<<<blocks(static_cast<int64_t>(n) * ND), THREADS, 0, st>>>(
      s, static_cast<float*>(stats), n);
  return static_cast<int>(cudaGetLastError());
}
