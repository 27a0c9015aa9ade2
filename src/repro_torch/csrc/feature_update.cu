// Single-key-type streaming atom update for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/feature_update.py ::
// feature_update (_fc_kernel).  Semantics are the plain version's,
// kernels/feature_update.py::feature_update_ref: packets are applied in
// array order; per packet, delta = 2^(-lambda*dt) (0 for a fresh slot), then
// w, LS, SS <- (w, LS, SS)*delta + (1, x, x^2), then [w | mu | sigma] per
// decay, written as the packet's 12 stats.
//
// Design.  The TPU kernel walks the packets in one sequential grid with the
// table in VMEM.  Serial order only matters within one slot, so the wrapper
// stable-sorts the packets by slot and the kernel runs one thread per
// sorted position: the thread at the head of a run of equal slots walks the
// run in array order with the slot's row in registers and stores it back
// once.  This is the uni half of csrc/fc_full.cu.
//
// Bound.  Bytes: each touched row (4 tables x 16 B) read and written once,
// 48 B of stats and 16 B of packet data, index and key a packet.  The
// longest run, which one thread walks alone, sets the time in practice.
//
// Arithmetic is the plain version's, operation for operation: exp2f, IEEE
// division and square root, no contracted multiply-add (--fmad=false).
#include <cuda_runtime.h>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int ND = 4;           // decay instances

__constant__ float kLam[ND] = {10.0f, 1.0f, 0.1f, static_cast<float>(1.0 / 60.0)};

__device__ __forceinline__ void load4(float (&dst)[ND], const float* row) {
  const float4 v = *reinterpret_cast<const float4*>(row);
  dst[0] = v.x; dst[1] = v.y; dst[2] = v.z; dst[3] = v.w;
}

__device__ __forceinline__ void store4(float* row, const float (&src)[ND]) {
  *reinterpret_cast<float4*>(row) = make_float4(src[0], src[1], src[2], src[3]);
}

__global__ void feature_update_kernel(const int64_t* __restrict__ perm,
                                      const int32_t* __restrict__ skey,
                                      const float* __restrict__ ts,
                                      const float* __restrict__ lens,
                                      float* __restrict__ last_t, float* __restrict__ w_t,
                                      float* __restrict__ ls_t, float* __restrict__ ss_t,
                                      float* __restrict__ stats, int n) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j >= n) return;
  const int key = skey[j];
  if (j > 0 && skey[j - 1] == key) return;          // not a run head
  const size_t row = static_cast<size_t>(key) * ND;
  float lt[ND], w[ND], ls[ND], ss[ND];
  load4(lt, last_t + row); load4(w, w_t + row);
  load4(ls, ls_t + row); load4(ss, ss_t + row);
  for (int64_t p = j; p < n && skey[p] == key; ++p) {
    const int64_t i = perm[p];
    const float t = ts[i], x = lens[i];
    float* s = stats + i * 3 * ND;
#pragma unroll
    for (int q = 0; q < ND; ++q) {
      const float dt = fmaxf(t - lt[q], 0.0f);
      const float delta = lt[q] < 0.0f ? 0.0f : exp2f(-kLam[q] * dt);
      w[q] = w[q] * delta + 1.0f;
      ls[q] = ls[q] * delta + x;
      ss[q] = ss[q] * delta + x * x;
      lt[q] = t;
      const float mu = ls[q] / w[q];
      s[q] = w[q];
      s[ND + q] = mu;
      s[2 * ND + q] = sqrtf(fabsf(ss[q] / w[q] - mu * mu));
    }
  }
  store4(last_t + row, lt); store4(w_t + row, w);
  store4(ls_t + row, ls); store4(ss_t + row, ss);
}

}  // namespace

// perm: (n,) int64 stable sort permutation of the slots; skey: (n,) int32
// sorted slots; tables (n_slots, 4) float32; stats (n, 12) float32.
extern "C" int feature_update_launch(const void* perm, const void* skey,
                                     const void* ts, const void* lens,
                                     void* last_t, void* w, void* ls, void* ss,
                                     void* stats, int n, int block, void* stream) {
  const unsigned grid = static_cast<unsigned>((static_cast<int64_t>(n) + block - 1) / block);
  feature_update_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(perm), static_cast<const int32_t*>(skey),
      static_cast<const float*>(ts), static_cast<const float*>(lens),
      static_cast<float*>(last_t), static_cast<float*>(w), static_cast<float*>(ls),
      static_cast<float*>(ss), static_cast<float*>(stats), n);
  return static_cast<int>(cudaGetLastError());
}
