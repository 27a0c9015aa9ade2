// KitNET autoencoder ensemble forward + masked RMSE for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/kitnet_ae.py ::
// kitnet_ensemble (_ae_kernel).  Per AE e and record b:
//   xm = x*mask; h = sigmoid(xm W1 + b1); y = sigmoid(h W2 + b2);
//   rmse = sqrt(sum(mask*(y - xm)^2) / max(sum(mask), 1))
//
// Design.  Grid (AE e, tile of `blockDim.x` records).  The block loads AE e's
// weights, biases and mask (< 9 KB even at the compiled maximum) into shared
// memory; each thread then computes one record's RMSE with scalar FMAs in
// registers.  The hidden layer is never stored: as each hidden unit is
// computed, its contribution to every output is accumulated.  One thread
// per record makes each score independent of the batch it arrives in,
// bit for bit.
//
// Bound.  The AEs are tiny (m <= 10, h = ceil(0.75 m) on the service's
// default feature map), so the kernel moves bytes rather than doing work:
// the (B, k, m) gathered input is read once and (B, k) RMSEs written once;
// about 2*m*h*2 flops per (record, AE).  A thread reads its m inputs with a
// stride of k*m floats, so loads are not coalesced; fusing the gather and
// normalisation in front of it is later work.
#include <cuda_runtime.h>
#include <cstdint>

#include "common.cuh"

namespace {

template <int MAXD>
__global__ void kitnet_ae_kernel(const float* __restrict__ x_sub,
                                 const float* __restrict__ W1,
                                 const float* __restrict__ b1,
                                 const float* __restrict__ W2,
                                 const float* __restrict__ b2,
                                 const float* __restrict__ mask,
                                 float* __restrict__ out, int B, int k, int m, int h) {
  __shared__ float sW1[MAXD * MAXD], sW2[MAXD * MAXD];
  __shared__ float sb1[MAXD], sb2[MAXD], smask[MAXD];
  const int e = blockIdx.x;
  for (int t = threadIdx.x; t < m * h; t += blockDim.x) {
    sW1[t] = W1[static_cast<size_t>(e) * m * h + t];     // (m, h) row-major
    sW2[t] = W2[static_cast<size_t>(e) * h * m + t];     // (h, m) row-major
  }
  for (int t = threadIdx.x; t < h; t += blockDim.x) sb1[t] = b1[e * h + t];
  for (int t = threadIdx.x; t < m; t += blockDim.x) {
    sb2[t] = b2[e * m + t];
    smask[t] = mask[e * m + t];
  }
  __syncthreads();

  const int64_t b = static_cast<int64_t>(blockIdx.y) * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const float* xr = x_sub + (static_cast<size_t>(b) * k + e) * m;

  float xm[MAXD], acc[MAXD];
  float msum = 0.0f;
#pragma unroll
  for (int j = 0; j < MAXD; ++j) {
    xm[j] = 0.0f;
    acc[j] = 0.0f;
    if (j < m) {
      xm[j] = xr[j] * smask[j];
      msum += smask[j];
    }
  }
  for (int i = 0; i < h; ++i) {
    float a = 0.0f;
#pragma unroll
    for (int j = 0; j < MAXD; ++j)
      if (j < m) a += xm[j] * sW1[j * h + i];
    const float hi = 1.0f / (1.0f + expf(-(a + sb1[i])));
#pragma unroll
    for (int j = 0; j < MAXD; ++j)
      if (j < m) acc[j] += hi * sW2[i * m + j];
  }
  float se = 0.0f;
#pragma unroll
  for (int j = 0; j < MAXD; ++j) {
    if (j < m) {
      const float y = 1.0f / (1.0f + expf(-(acc[j] + sb2[j])));
      const float d = y - xm[j];
      se += d * d * smask[j];
    }
  }
  out[static_cast<size_t>(b) * k + e] = sqrtf(se / fmaxf(msum, 1.0f));
}

}  // namespace

// x_sub (B, k, m), W1 (k, m, h), b1 (k, h), W2 (k, h, m), b2 (k, m),
// mask (k, m), out (B, k); all float32, contiguous.  maxd is 16 or 32 and
// bounds m and h.
extern "C" int kitnet_ae_launch(const void* x_sub, const void* W1, const void* b1,
                                const void* W2, const void* b2, const void* mask,
                                void* out, int B, int k, int m, int h, int maxd,
                                int block, void* stream) {
  const dim3 grid(static_cast<unsigned>(k), static_cast<unsigned>((B + block - 1) / block));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* x = static_cast<const float*>(x_sub);
  const float* w1 = static_cast<const float*>(W1);
  const float* bb1 = static_cast<const float*>(b1);
  const float* w2 = static_cast<const float*>(W2);
  const float* bb2 = static_cast<const float*>(b2);
  const float* mk = static_cast<const float*>(mask);
  float* o = static_cast<float*>(out);
  if (maxd == 16) {
    kitnet_ae_kernel<16><<<grid, block, 0, s>>>(x, w1, bb1, w2, bb2, mk, o, B, k, m, h);
  } else if (maxd == 32) {
    kitnet_ae_kernel<32><<<grid, block, 0, s>>>(x, w1, bb1, w2, bb2, mk, o, B, k, m, h);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
