// KitNET autoencoder ensemble forward + masked RMSE for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/kitnet_ae.py ::
// kitnet_ensemble (_ae_kernel).  Per AE e and record b:
//   xm = x*mask; h = sigmoid(xm W1 + b1); y = sigmoid(h W2 + b2);
//   rmse = sqrt(sum(mask*(y - xm)^2) / max(sum(mask), 1))
//
// Design.  Grid (AE e, tile of `blockDim.x` records).  The block takes AE
// e's weights, biases and mask into dynamic shared memory where they fit
// (every width up to well past 100), else reads them from global memory;
// each thread then computes one record's RMSE with scalar FMAs.  Up to
// width 64 (the template's MAXD, 16, 32 or 64) a record's inputs and
// output sums live in registers and the hidden layer is never stored: as
// each hidden unit is computed, its contribution to every output is
// accumulated.  Past 64 (MAXD = 0) the hidden vector goes to a scratch row
// of the record in global memory and the inputs are read again from the
// input.  Both add in the same order.  One thread per record makes each
// score independent of the batch it arrives in, bit for bit.
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

constexpr int SMEM_MAX = 232448;      // dynamic shared memory a block may take

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

// AE e's parameters: in shared memory (copied by the block) or global
struct Params {
  const float *w1, *w2, *b1, *b2, *mask;
};

template <int MAXD>
__global__ void kitnet_ae_kernel(const float* __restrict__ x_sub,
                                 const float* __restrict__ W1,
                                 const float* __restrict__ b1,
                                 const float* __restrict__ W2,
                                 const float* __restrict__ b2,
                                 const float* __restrict__ mask,
                                 float* __restrict__ out, float* __restrict__ hid,
                                 int B, int k, int m, int h, int in_smem) {
  extern __shared__ float smem[];
  const int e = blockIdx.x;
  Params P{W1 + static_cast<size_t>(e) * m * h, W2 + static_cast<size_t>(e) * h * m,
           b1 + static_cast<size_t>(e) * h, b2 + static_cast<size_t>(e) * m,
           mask + static_cast<size_t>(e) * m};
  if (in_smem) {
    float* sW1 = smem;                  // (m, h) row-major
    float* sW2 = sW1 + m * h;           // (h, m) row-major
    float* sb1 = sW2 + m * h;
    float* sb2 = sb1 + h;
    float* smask = sb2 + m;
    for (int t = threadIdx.x; t < m * h; t += blockDim.x) {
      sW1[t] = P.w1[t];
      sW2[t] = P.w2[t];
    }
    for (int t = threadIdx.x; t < h; t += blockDim.x) sb1[t] = P.b1[t];
    for (int t = threadIdx.x; t < m; t += blockDim.x) {
      sb2[t] = P.b2[t];
      smask[t] = P.mask[t];
    }
    __syncthreads();
    P = {sW1, sW2, sb1, sb2, smask};
  }

  const int64_t b = static_cast<int64_t>(blockIdx.y) * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const float* xr = x_sub + (static_cast<size_t>(b) * k + e) * m;
  float msum = 0.0f, se = 0.0f;
  if constexpr (MAXD > 0) {
    float xm[MAXD], acc[MAXD];
#pragma unroll
    for (int j = 0; j < MAXD; ++j) {
      xm[j] = 0.0f;
      acc[j] = 0.0f;
      if (j < m) {
        xm[j] = xr[j] * P.mask[j];
        msum += P.mask[j];
      }
    }
    for (int i = 0; i < h; ++i) {
      float a = 0.0f;
#pragma unroll
      for (int j = 0; j < MAXD; ++j)
        if (j < m) a += xm[j] * P.w1[j * h + i];
      const float hi = sigmoid(a + P.b1[i]);
#pragma unroll
      for (int j = 0; j < MAXD; ++j)
        if (j < m) acc[j] += hi * P.w2[i * m + j];
    }
#pragma unroll
    for (int j = 0; j < MAXD; ++j) {
      if (j < m) {
        const float y = sigmoid(acc[j] + P.b2[j]);
        const float d = y - xm[j];
        se += d * d * P.mask[j];
      }
    }
  } else {
    float* hv = hid + (static_cast<size_t>(b) * k + e) * h;
    for (int j = 0; j < m; ++j) msum += P.mask[j];
    for (int i = 0; i < h; ++i) {
      float a = 0.0f;
      for (int j = 0; j < m; ++j) {
        const float xm = xr[j] * P.mask[j];
        a += xm * P.w1[j * h + i];
      }
      hv[i] = sigmoid(a + P.b1[i]);
    }
    for (int j = 0; j < m; ++j) {
      float acc = 0.0f;
      for (int i = 0; i < h; ++i) acc += hv[i] * P.w2[i * m + j];
      const float y = sigmoid(acc + P.b2[j]);
      const float d = y - xr[j] * P.mask[j];
      se += d * d * P.mask[j];
    }
  }
  out[static_cast<size_t>(b) * k + e] = sqrtf(se / fmaxf(msum, 1.0f));
}

template <int MAXD>
int launch(dim3 grid, int block, cudaStream_t s, const float* x, const float* w1,
           const float* bb1, const float* w2, const float* bb2, const float* mk,
           float* o, float* hid, int B, int k, int m, int h) {
  const int64_t bytes = (2LL * m * h + h + 2LL * m) * static_cast<int64_t>(sizeof(float));
  const int in_smem = bytes <= SMEM_MAX;
  const int smem = in_smem ? static_cast<int>(bytes) : 0;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kitnet_ae_kernel<MAXD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kitnet_ae_kernel<MAXD><<<grid, block, smem, s>>>(x, w1, bb1, w2, bb2, mk, o, hid, B,
                                                   k, m, h, in_smem);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x_sub (B, k, m), W1 (k, m, h), b1 (k, h), W2 (k, h, m), b2 (k, m),
// mask (k, m), out (B, k); all float32, contiguous.  maxd is 16, 32 or 64
// and bounds m and h, or 0 for any width, with hid a (B, k, h) float32
// scratch (unused otherwise).
extern "C" int kitnet_ae_launch(const void* x_sub, const void* W1, const void* b1,
                                const void* W2, const void* b2, const void* mask,
                                void* out, void* hid, int B, int k, int m, int h,
                                int maxd, int block, void* stream) {
  const dim3 grid(static_cast<unsigned>(k), static_cast<unsigned>((B + block - 1) / block));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* x = static_cast<const float*>(x_sub);
  const float* w1 = static_cast<const float*>(W1);
  const float* bb1 = static_cast<const float*>(b1);
  const float* w2 = static_cast<const float*>(W2);
  const float* bb2 = static_cast<const float*>(b2);
  const float* mk = static_cast<const float*>(mask);
  float* o = static_cast<float*>(out);
  float* hv = static_cast<float*>(hid);
  switch (maxd) {
    case 16: return launch<16>(grid, block, s, x, w1, bb1, w2, bb2, mk, o, hv, B, k, m, h);
    case 32: return launch<32>(grid, block, s, x, w1, bb1, w2, bb2, mk, o, hv, B, k, m, h);
    case 64: return launch<64>(grid, block, s, x, w1, bb1, w2, bb2, mk, o, hv, B, k, m, h);
    case 0: return launch<0>(grid, block, s, x, w1, bb1, w2, bb2, mk, o, hv, B, k, m, h);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
