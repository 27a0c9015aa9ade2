// Flash attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py ::
// flash_attention (_attn_kernel).  For each batch b, query head h (kv head
// h / G) and query row i:
//   s_j = q_i . k_j / sqrt(D);  s_j = cap * tanh(s_j / cap) if cap > 0;
//   s_j = -1e30 where masked (causal: i < j; window: i - j >= window);
//   o_i = sum_j softmax(s)_j v_j
// on absolute positions from 0.  Keys past Sk do not exist (no weight).
// Softmax and both products in float32; inputs float32 or bfloat16, the
// output in the input type.
//
// Design.  Grid (q tile of 64 rows, b*H + h); 256 threads.  The block stages
// its q tile once and then one 64-key K and V tile at a time in shared
// memory as float32 (rows padded to D + 4 floats; 212 KiB at D = 256, so
// one block per SM), and walks the key tiles with the online softmax: each
// query row keeps its running max m, denominator l and its share of the
// float32 accumulator in registers.  Thread (ty, tx) = (tid / 16, tid % 16)
// owns query rows ty + 16i (i < 4); for S = Q K^T it computes keys
// tx + 16j (j < 4), and for O += P V the columns VW*tx + 16*VW*jj + c.  A
// row's 16 threads form one half-warp, so row max and row sum are
// xor-shuffles.  P goes through shared memory between the two products.
// Tiles whose keys the causal or window mask hides from every row of the
// block are skipped: that is exact, since a masked score's weight
// exp(-1e30 - m) is 0 once the row has seen any visible key.  A row with no
// visible key at all (only when Sq > Sk with a window) gets the reference's
// uniform softmax over all Sk keys; blocks holding such a row visit every
// tile.  The masked score stays the finite -1e30 for that reason: with -inf,
// the correction exp(m_prev - m_new) of a row that has seen only masked
// scores would be exp(-inf + inf) = NaN.
//
// Bound.  Operations: 4*D float operations per visible (query, key) pair
// and query head, on CUDA cores (tensor cores would round float32 to TF32),
// against the inputs read once and the output written once.  The products
// are register-tiled scalar FMAs: per 4-wide step of D, 8 shared-memory
// float4 loads feed 64 FMAs.  wgmma/TMA and a bf16 tensor-core path are
// later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cmath>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int BQ = 64;          // query rows per block
constexpr int BK = 64;          // keys per tile
constexpr int THREADS = 256;
constexpr float MASKED = -1e30f;

template <int D>
struct Tile {
  static constexpr int LD = D + 4;                       // q/k/v row stride
  static constexpr int LDP = BK + 4;                     // P row stride
  static constexpr int VW = (D % 64 == 0) ? 4 : (D % 32 == 0 ? 2 : 1);
  static constexpr int NJ = D / (16 * VW);               // vectors a row
  static constexpr size_t SMEM =
      (static_cast<size_t>(BQ + 2 * BK) * LD + static_cast<size_t>(BQ) * LDP) *
      sizeof(float);
};

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Rows [r0, r0 + 64) of a (rows, D) matrix with row stride `rs` into a
// float32 tile; rows at or past `nrows` are zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int64_t rs,
                                          int r0, int nrows) {
  constexpr int C4 = D / 4;
  for (int idx = threadIdx.x; idx < 64 * C4; idx += THREADS) {
    const int r = idx / C4, c = (idx % C4) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < nrows) x = load4(src + (r0 + r) * rs + c);
    *reinterpret_cast<float4*>(dst + r * Tile<D>::LD + c) = x;
  }
}

__device__ __forceinline__ float halfwarp_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float halfwarp_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out,
                       int H, int G, int Sq, int Sk,
                       int64_t qsb, int64_t qsh, int64_t qss,
                       int64_t ksb, int64_t ksh, int64_t kss,
                       int64_t vsb, int64_t vsh, int64_t vss,
                       int64_t osb, int64_t osh, int64_t oss,
                       int causal, int window, float softcap, float scale) {
  using C = Tile<D>;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + BQ * C::LD;
  float* Vs = Ks + BK * C::LD;
  float* Ps = Vs + BK * C::LD;

  const int nq = (Sq + BQ - 1) / BQ;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x)) * BQ;  // longest rows first
  const int q1 = min(q0 + BQ, Sq) - 1;
  const int b = blockIdx.y / H, h = blockIdx.y % H, kh = h / G;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const T* kb = k + b * ksb + kh * ksh;
  const T* vb = v + b * vsb + kh * vsh;

  load_tile<T, D>(Qs, q + b * qsb + h * qsh, qss, q0, Sq - q0);

  // the keys some row of this block sees
  int lo = 0, hi = Sk;
  if (causal) hi = min(Sk, q1 + 1);
  if (window > 0) lo = max(0, q0 - window + 1);
  if (window > 0 && q1 >= Sk + window - 1) {   // a row that sees no key
    lo = 0;
    hi = Sk;
  }

  float m[4], l[4], acc[4][C::NJ * C::VW];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = MASKED;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < C::NJ * C::VW; ++c) acc[i][c] = 0.f;
  }

  for (int t = lo / BK; t < (hi + BK - 1) / BK; ++t) {
    const int k0 = t * BK;
    load_tile<T, D>(Ks, kb, kss, k0, Sk - k0);
    load_tile<T, D>(Vs, vb, vss, k0, Sk - k0);
    __syncthreads();

    // S = Q K^T for rows ty + 16i, keys tx + 16j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 a[4], bk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const float4*>(Qs + (ty + 16 * i) * C::LD + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        bk[j] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * j) * C::LD + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float x = s[i][j];
          x = fmaf(a[i].x, bk[j].x, x);
          x = fmaf(a[i].y, bk[j].y, x);
          x = fmaf(a[i].z, bk[j].z, x);
          x = fmaf(a[i].w, bk[j].w, x);
          s[i][j] = x;
        }
    }

    // scale, softcap, mask; online softmax; P to shared memory
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty + 16 * i;
      float rmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        float x = s[i][j] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        bool ok = true;
        if (causal) ok = ok && qp >= kp;
        if (window > 0) ok = ok && (qp - kp) < window;
        x = ok ? x : MASKED;
        if (kp >= Sk) x = -INFINITY;          // no such key
        s[i][j] = x;
        rmax = fmaxf(rmax, x);
      }
      const float m_new = fmaxf(m[i], halfwarp_max(rmax));
      const float corr = expf(m[i] - m_new);
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        s[i][j] = p;
        rsum += p;
      }
      l[i] = l[i] * corr + halfwarp_sum(rsum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < C::NJ * C::VW; ++c) acc[i][c] *= corr;
#pragma unroll
      for (int j = 0; j < 4; ++j) Ps[(ty + 16 * i) * C::LDP + tx + 16 * j] = s[i][j];
    }
    __syncthreads();

    // O += P V for rows ty + 16i, columns VW*tx + 16*VW*jj + c
#pragma unroll 2
    for (int kk = 0; kk < BK; kk += 4) {
      float4 p4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        p4[i] = *reinterpret_cast<const float4*>(Ps + (ty + 16 * i) * C::LDP + kk);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float* vrow = Vs + (kk + u) * C::LD + C::VW * tx;
        float vv[C::NJ * C::VW];
#pragma unroll
        for (int jj = 0; jj < C::NJ; ++jj) {
          if constexpr (C::VW == 4) {
            const float4 x = *reinterpret_cast<const float4*>(vrow + 64 * jj);
            vv[4 * jj] = x.x; vv[4 * jj + 1] = x.y; vv[4 * jj + 2] = x.z; vv[4 * jj + 3] = x.w;
          } else {
#pragma unroll
            for (int c = 0; c < C::VW; ++c) vv[C::VW * jj + c] = vrow[16 * C::VW * jj + c];
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = u == 0 ? p4[i].x : u == 1 ? p4[i].y : u == 2 ? p4[i].z : p4[i].w;
#pragma unroll
          for (int c = 0; c < C::NJ * C::VW; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
        }
      }
    }
    __syncthreads();
  }

  T* ob = out + b * osb + h * osh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int jj = 0; jj < C::NJ; ++jj)
#pragma unroll
      for (int c = 0; c < C::VW; ++c)
        store1(ob + row * oss + C::VW * tx + 16 * C::VW * jj + c,
               acc[i][C::VW * jj + c] / denom);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int H, int K, int Sq, int Sk, const int64_t* st,
                   int causal, int window, float softcap, cudaStream_t stream) {
  auto kern = flash_attention_kernel<T, D>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(Tile<D>::SMEM));
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const dim3 grid((Sq + BQ - 1) / BQ, B * H);
  kern<<<grid, THREADS, Tile<D>::SMEM, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), H, H / K, Sq, Sk,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      st[9], st[10], st[11], causal, window, softcap,
      1.0f / sqrtf(static_cast<float>(D)));
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int D, const void* q, const void* k, const void* v,
                     void* out, int B, int H, int K, int Sq, int Sk,
                     const int64_t* st, int causal, int window, float softcap,
                     cudaStream_t stream) {
  switch (D) {
    case 32: return launch<T, 32>(q, k, v, out, B, H, K, Sq, Sk, st, causal, window, softcap, stream);
    case 64: return launch<T, 64>(q, k, v, out, B, H, K, Sq, Sk, st, causal, window, softcap, stream);
    case 128: return launch<T, 128>(q, k, v, out, B, H, K, Sq, Sk, st, causal, window, softcap, stream);
    case 256: return launch<T, 256>(q, k, v, out, B, H, K, Sq, Sk, st, causal, window, softcap, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, H, Sq, D), k/v (B, K, Sk, D), out (B, H, Sq, D), each addressed by
// its (batch, head, row) strides in elements with the last dimension
// contiguous.  bf16 != 0: every tensor is bfloat16, else float32.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* out,
    int B, int H, int K, int Sq, int Sk, int D,
    int64_t qsb, int64_t qsh, int64_t qss, int64_t ksb, int64_t ksh, int64_t kss,
    int64_t vsb, int64_t vsh, int64_t vss, int64_t osb, int64_t osh, int64_t oss,
    int causal, int window, float softcap, int bf16, void* stream) {
  const int64_t st[12] = {qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss, osb, osh, oss};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = bf16
      ? dispatch<__nv_bfloat16>(D, q, k, v, out, B, H, K, Sq, Sk, st, causal, window, softcap, s)
      : dispatch<float>(D, q, k, v, out, B, H, K, Sq, Sk, st, causal, window, softcap, s);
  return static_cast<int>(e);
}
