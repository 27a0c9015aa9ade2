// KitNET autoencoder ensemble forward + masked RMSE for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/kitnet_ae.py ::
// kitnet_ensemble (_ae_kernel).  Per AE e and record b:
//   xm = x*mask; h = sigmoid(xm W1 + b1); y = sigmoid(h W2 + b2);
//   rmse = sqrt(sum(mask*(y - xm)^2) / max(sum(mask), 1))
//
// Bound.  The AEs are tiny (m <= 10 inputs, h = ceil(0.75 m) hidden on the
// service's feature map): about 4 m h float operations a (record, AE) and
// the (B, k, m) input read once.  At a few records a launch nothing but
// latency bounds it: the loads, then the chain of dependent operations a
// thread runs.  Tensor cores do not serve: a product 10 deep and 8 wide
// gains nothing from them, TF32's 10-bit mantissa misses the 1e-5
// tolerance, and split TF32 would triple the work of a kernel whose time
// is latency.
//
// Design.  Two kernels; the launcher takes one by the batch and the net's
// size.  Both do each record's operations in the same order, so a record's
// RMSEs are the same bits from either, in any batch.
//  - tile (kitnet_ae_kernel_tile), for few records: a block takes a tile of
//    records and all k AEs (one record a block while the batch is small, up
//    to 256 / k where it is large; records on grid.x).  It stages the
//    tile's rows of x_sub (contiguous) and every AE's parameters into
//    shared memory at once, with TMA bulk copies where address and size
//    are multiples of 16 bytes and cp.async otherwise (kitnet_ae.cuh), and
//    runs each layer with a thread per (record, AE, unit), its values in
//    shared memory (ensemble_tile, shared with kitnet_score.cu): a
//    thread's chain is one sum of m (or h) terms and a sigmoid, not the
//    m h of a whole AE.
//  - pair (kitnet_ae_kernel_pair), for many records or a net too large for
//    one block's shared memory: a block per (tile of 128 records, AE e), AE
//    fastest, so the k blocks that read a tile's rows of x_sub run together
//    and share their cache lines; the block
//    copies AE e's parameters into shared memory where they fit (else reads
//    them in global memory) and each thread runs one record's whole AE.  Up
//    to width 64 (MAXD, 16, 32 or 64) the inputs and output sums live in
//    registers and the hidden layer is never stored; past 64 (MAXD = 0) the
//    hidden vector goes to a (B, k, h) scratch row in global memory.  With
//    B k pairs enough to fill the card and a short chain (m h small), fewer
//    instructions beat the tile's shorter chains.
// Selection: tile where one record fits a block's shared memory and either
// B k < PAIR_MIN_PAIRS (8192) or the whole net is staged and m h >
// PAIR_MAX_CHAIN (256); pair otherwise.  From chip_smoke.py phase
// ensemble's `designs`, which times both, each forced (NVIDIA H100 80GB
// HBM3, 700 W): on the service's net (k=14, m=10, h=8) tile wins at 8 and
// 256 records, pair from 1024 (14,336 pairs) on; on k=7 nets of m = h = 33
// (staged) tile wins from 1024 to 16,384 records; at m = h = 64 (the net
// past a block) tile wins at 256 records, pair at 8192.
#include <cuda_runtime.h>
#include <cstdint>

#include "kitnet_ae.cuh"

namespace {

using namespace kitnet;

constexpr int64_t PAIR_MIN_PAIRS = 8192;  // (record, AE) pairs from which pair can win
constexpr int PAIR_MAX_CHAIN = 256;       // m h past which a staged net stays on tile
constexpr int PAIR_BLOCK = 128;            // records a pair block

enum { B1, B2, MASK, W1, W2 };  // the tile kernel's staged parts, smallest first

__global__ void __launch_bounds__(MAX_THREADS)
kitnet_ae_kernel_tile(const Parts parts, const float* __restrict__ x_sub,
                      float* __restrict__ out, int B, int k, int m, int h, int R) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * R;
  const int n = B - r0 < R ? static_cast<int>(B - r0) : R;
  const int row = k * m;
  stage_start(parts, x_sub + r0 * row, n * row * 4, BAR_BYTES, smem, bar);
  stage_wait(bar);
  const float* xt = reinterpret_cast<const float*>(smem + BAR_BYTES);  // (n, k, m)
  float* hid = reinterpret_cast<float*>(smem + BAR_BYTES) + R * row;    // n k h
  float* sq = hid + R * k * h;                                          // n k m
  ensemble_tile([xt, row, m](int r, int e, int j) { return xt[r * row + e * m + j]; },
                [out, r0, k](int r, int e, float v) { out[(r0 + r) * k + e] = v; },
                part<float>(parts, W1, smem), part<float>(parts, B1, smem),
                part<float>(parts, W2, smem), part<float>(parts, B2, smem),
                part<float>(parts, MASK, smem), n, k, m, h, hid, sq);
}

// One thread a (record, AE): ensemble_tile's operations in its order (each
// sum from 0 over its terms in index order; x*mask rounded before it is
// used, the squared error rounded before it is weighted).
template <int MAXD>
__global__ void kitnet_ae_kernel_pair(const float* __restrict__ x_sub,
                                      const float* __restrict__ W1,
                                      const float* __restrict__ b1,
                                      const float* __restrict__ W2,
                                      const float* __restrict__ b2,
                                      const float* __restrict__ mask,
                                      float* __restrict__ out, float* __restrict__ hid,
                                      int B, int k, int m, int h, int in_smem) {
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  float* smem = reinterpret_cast<float*>(smem_bytes);
  const int e = blockIdx.x % k;
  const float* w1 = W1 + static_cast<int64_t>(e) * m * h;  // (m, h)
  const float* w2 = W2 + static_cast<int64_t>(e) * h * m;  // (h, m)
  const float* c1 = b1 + static_cast<int64_t>(e) * h;
  const float* c2 = b2 + static_cast<int64_t>(e) * m;
  const float* mk = mask + static_cast<int64_t>(e) * m;
  if (in_smem) {
    float* s = smem;
    for (int t = threadIdx.x; t < m * h; t += blockDim.x) {
      s[t] = w1[t];
      s[m * h + t] = w2[t];
    }
    for (int t = threadIdx.x; t < h; t += blockDim.x) s[2 * m * h + t] = c1[t];
    for (int t = threadIdx.x; t < m; t += blockDim.x) {
      s[2 * m * h + h + t] = c2[t];
      s[2 * m * h + h + m + t] = mk[t];
    }
    __syncthreads();
    w1 = s;
    w2 = s + m * h;
    c1 = s + 2 * m * h;
    c2 = c1 + h;
    mk = c2 + m;
  }
  const int64_t b = static_cast<int64_t>(blockIdx.x / k) * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const float* xr = x_sub + (b * k + e) * m;
  float msum = 0.0f, se = 0.0f;
  if constexpr (MAXD > 0) {
    float xm[MAXD], acc[MAXD];
#pragma unroll
    for (int j = 0; j < MAXD; ++j) {
      xm[j] = 0.0f;
      acc[j] = 0.0f;
      if (j < m) {
        xm[j] = __fmul_rn(xr[j], mk[j]);
        msum += mk[j];
      }
    }
    for (int i = 0; i < h; ++i) {
      float a = 0.0f;
#pragma unroll
      for (int j = 0; j < MAXD; ++j)
        if (j < m) a += xm[j] * w1[j * h + i];
      const float z = sigmoid(a + c1[i]);
#pragma unroll
      for (int j = 0; j < MAXD; ++j)
        if (j < m) acc[j] += z * w2[i * m + j];
    }
#pragma unroll
    for (int j = 0; j < MAXD; ++j) {
      if (j < m) {
        const float d = sigmoid(acc[j] + c2[j]) - xm[j];
        se += __fmul_rn(d, d) * mk[j];
      }
    }
  } else {
    float* z = hid + (b * k + e) * h;
    for (int i = 0; i < h; ++i) {
      float a = 0.0f;
      for (int j = 0; j < m; ++j) a += __fmul_rn(xr[j], mk[j]) * w1[j * h + i];
      z[i] = sigmoid(a + c1[i]);
    }
    for (int j = 0; j < m; ++j) {
      float acc = 0.0f;
      for (int i = 0; i < h; ++i) acc += z[i] * w2[i * m + j];
      const float d = sigmoid(acc + c2[j]) - __fmul_rn(xr[j], mk[j]);
      msum += mk[j];
      se += __fmul_rn(d, d) * mk[j];
    }
  }
  out[b * k + e] = sqrtf(se / fmaxf(msum, 1.0f));
}

template <int MAXD>
int launch_pair(cudaStream_t s, const float* x, const float* w1, const float* bb1,
                const float* w2, const float* bb2, const float* mk, float* o, float* hid,
                int B, int k, int m, int h) {
  const int64_t bytes = (2LL * m * h + h + 2LL * m) * 4;
  const int in_smem = bytes <= SMEM_MAX;
  const int smem = in_smem ? static_cast<int>(bytes) : 0;
  const cudaError_t err = allow_smem(kitnet_ae_kernel_pair<MAXD>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t tiles = (B + PAIR_BLOCK - 1) / PAIR_BLOCK;
  const unsigned blocks = static_cast<unsigned>(tiles * k);
  kitnet_ae_kernel_pair<MAXD><<<blocks, PAIR_BLOCK, smem, s>>>(x, w1, bb1, w2, bb2, mk, o, hid,
                                                             B, k, m, h, in_smem);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x_sub (B, k, m), W1 (k, m, h), b1 (k, h), W2 (k, h, m), b2 (k, m),
// mask (k, m), out (B, k); all float32, contiguous.  hid: a (B, k, h)
// float32 scratch where m > 64 (else unused).  design: 0 chooses, 1 takes
// the tile kernel (an error where one record does not fit a block), 2 the
// pair kernel.
extern "C" int kitnet_ae_launch(const void* x_sub, const void* W1_, const void* b1_,
                                const void* W2_, const void* b2_, const void* mask_,
                                void* out, void* hid, int B, int k, int m, int h, int design,
                                void* stream) {
  if (B <= 0 || k <= 0) return 0;
  if (m <= 0 || h <= 0 || design < 0 || design > 2 || (m > 64 && hid == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* x = static_cast<const float*>(x_sub);
  float* o = static_cast<float*>(out);
  // the tile kernel's shared memory: a record's rows of x_sub (k m), hidden
  // units (k h) and squared errors (k m), then the parameters where they fit
  const int64_t R = tile_records(B, k, static_cast<int64_t>(k) * (2 * m + h) * 4,
                                 SMEM_MAX - BAR_BYTES);
  Parts parts{};
  int smem = 0;
  if (R >= 1) {
    const int64_t km = static_cast<int64_t>(k) * m;
    add_part(parts, b1_, static_cast<int64_t>(k) * h * 4);
    add_part(parts, b2_, km * 4);
    add_part(parts, mask_, km * 4);
    add_part(parts, W1_, km * h * 4);
    add_part(parts, W2_, km * h * 4);
    smem = place_parts(parts, BAR_BYTES + static_cast<int>(R * k * (2 * m + h) * 4));
  }
  const bool few = static_cast<int64_t>(B) * k < PAIR_MIN_PAIRS;
  const bool long_chain = all_staged(parts) && m * h > PAIR_MAX_CHAIN;
  const bool tile = design == 1 || (design == 0 && R >= 1 && (few || long_chain));
  if (tile) {
    if (R < 1) return static_cast<int>(cudaErrorInvalidValue);
    const cudaError_t err = allow_smem(kitnet_ae_kernel_tile, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int blocks = static_cast<int>((B + R - 1) / R);
    const int threads = block_threads(R * k * std::max(m, h));
    kitnet_ae_kernel_tile<<<blocks, threads, smem, s>>>(parts, x, o, B, k, m, h,
                                                         static_cast<int>(R));
    return static_cast<int>(cudaGetLastError());
  }
  const float* w1 = static_cast<const float*>(W1_);
  const float* bb1 = static_cast<const float*>(b1_);
  const float* w2 = static_cast<const float*>(W2_);
  const float* bb2 = static_cast<const float*>(b2_);
  const float* mk = static_cast<const float*>(mask_);
  float* hv = static_cast<float*>(hid);
  if (m <= 16) return launch_pair<16>(s, x, w1, bb1, w2, bb2, mk, o, hv, B, k, m, h);
  if (m <= 32) return launch_pair<32>(s, x, w1, bb1, w2, bb2, mk, o, hv, B, k, m, h);
  if (m <= 64) return launch_pair<64>(s, x, w1, bb1, w2, bb2, mk, o, hv, B, k, m, h);
  return launch_pair<0>(s, x, w1, bb1, w2, bb2, mk, o, hv, B, k, m, h);
}
