// KitNET scoring, records to anomaly scores in one launch, for Hopper
// (sm_90a).
//
// Computes what the JAX package runs as one jit around its Pallas ensemble
// kernel (src/repro/detection/md_backends.py :: _score_pallas_jit, the
// kernel src/repro/kernels/kitnet_ae.py :: kitnet_ensemble):
//   xn = clip((X - lo) / max(hi - lo, 1e-9), 0, 4)          (B, F)
//   r_e = the RMSE of AE e on xn[idx[e]] (kitnet_ae.cu)     (B, k)
//   rn = clip((r - r_lo) / max(r_hi - r_lo, 1e-9), 0, 4)
//   z = sigmoid(rn V1 + c1); y = sigmoid(z V2 + c2)        (k -> kh -> k)
//   score = sqrt(mean((y - rn)^2))                          (B,)
// Before it, the port ran this as some thirty eager torch ops around the
// ensemble kernel and wrote the gathered (B, k, m) subsets to device
// memory.
//
// Bound.  Bytes at every batch the service runs (X read once, the net's
// 13 KB, a score written), and at its 8 records a chunk nothing but
// latency: the loads, then the chains of the ensemble's and the output
// AE's layers.  Tensor cores do not serve (see kitnet_ae.cu).
//
// Design.  A block takes a tile of records (one a block while the batch is
// small, so the records spread over the SMs; up to 256 / k where it is
// large; records on grid.x, so any batch).  Thread 0 starts TMA bulk copies
// of the net's tensors into shared memory, and the block's threads copy
// with cp.async those not 16-byte sized and aligned (a tensor past what
// fits is read in place from global memory), while they read the tile's
// rows of X, contiguous, with 16-byte loads where F and the address allow,
// and store them normalised into shared memory at an odd row stride, so a
// warp's records fall in distinct banks.  Where one record's values do not
// fit beside the barrier (some 58,000 floats: k (h + m + 1) past it is
// k = 120 at m = 300), they go to a scratch in global memory instead, and
// a grid of a few hundred blocks takes a record at a time (a build of its
// own, SCRATCH, so that the shared-memory build addresses its values as
// shared).  Then, each phase between barriers:
//   1. the ensemble (kitnet_ae.cuh's ensemble_tile: a thread per (record,
//      AE, unit) and layer), its inputs gathered from shared memory
//      through idx (int64, as the net holds it), each RMSE normalised into
//      shared memory;
//   2. each (record, hidden unit) pair of the output AE sums its k inputs;
//   3. each (record, output) pair sums its kh inputs and stores its
//      squared error;
//   4. each record sums its k squared errors and writes its score.
// Every sum runs over its terms in index order, so a record's score
// depends on its own values only: bit for bit the same in any batch.
#include <cuda_runtime.h>
#include <cstdint>

#include "kitnet_ae.cuh"

namespace {

using namespace kitnet;

// the staged parts, smallest first
enum { RLO, RHI, C1, C2, B1, B2, MASK, IDX, V1, V2, W1, W2, NPARTS };
static_assert(NPARTS <= MAX_PARTS, "too many staged tensors");

// SCRATCH: a record's values in the scratch (global memory); otherwise in
// shared memory, where the compiler then knows their space
template <bool SCRATCH>
__global__ void __launch_bounds__(MAX_THREADS)
kitnet_score_kernel(const Parts parts, const float* __restrict__ X,
                    const float* __restrict__ lo, const float* __restrict__ hi,
                    float* __restrict__ out, float* __restrict__ scratch, int B, int F, int k,
                    int m, int h, int kh, int R) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  stage_start(parts, nullptr, 0, -1, smem, bar);

  const int FS = F | 1;  // odd row stride: a warp's records fall in distinct banks
  // the tile's values: in shared memory, or in this block's rows of the
  // scratch where one record's do not fit there
  const int64_t rec = FS + static_cast<int64_t>(k) * (h + m + 1) + kh;
  float* xn;  // (R, FS) normalised X
  if constexpr (SCRATCH)
    xn = scratch + static_cast<int64_t>(blockIdx.x) * R * rec;
  else
    xn = reinterpret_cast<float*>(smem + BAR_BYTES);
  float* hid = xn + R * FS;                                          // R k h
  float* sq = hid + R * k * h;                                       // R k m
  float* rn = sq + R * k * m;                                        // (R, k) normalised RMSEs
  float* z = rn + R * k;                                             // (R, kh) output AE hidden
  const int64_t* idx = part<int64_t>(parts, IDX, smem);
  const float* r_lo = part<float>(parts, RLO, smem);
  const float* r_hi = part<float>(parts, RHI, smem);
  const float* v1 = part<float>(parts, V1, smem);
  const float* c1 = part<float>(parts, C1, smem);
  const float* v2 = part<float>(parts, V2, smem);
  const float* c2 = part<float>(parts, C2, smem);
  const int64_t tiles = (B + R - 1) / R;
  for (int64_t t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int64_t r0 = t * R;
    const int n = B - r0 < R ? static_cast<int>(B - r0) : R;
    // the tile's rows of X, read (the first time while the net is copied),
    // normalised on their way into the tile's values (16-byte loads where
    // F and the address allow)
    const float* xg = X + r0 * F;
    if ((F & 3) == 0 && (reinterpret_cast<uintptr_t>(xg) & 15) == 0) {
      for (int q = threadIdx.x; q < n * F / 4; q += blockDim.x) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(xg) + q);
        const int r = 4 * q / F, f = 4 * q - r * F;
        float* d = xn + r * FS + f;
        d[0] = normalize(v.x, __ldg(lo + f), __ldg(hi + f));
        d[1] = normalize(v.y, __ldg(lo + f + 1), __ldg(hi + f + 1));
        d[2] = normalize(v.z, __ldg(lo + f + 2), __ldg(hi + f + 2));
        d[3] = normalize(v.w, __ldg(lo + f + 3), __ldg(hi + f + 3));
      }
    } else {
      for (int q = threadIdx.x; q < n * F; q += blockDim.x) {
        const int r = q / F, f = q - r * F;
        xn[r * FS + f] = normalize(__ldg(xg + q), __ldg(lo + f), __ldg(hi + f));
      }
    }
    if (t == blockIdx.x)
      stage_wait(bar);
    else
      __syncthreads();

    // 1. the ensemble, each RMSE normalised by the ensemble's training range
    ensemble_tile([xn, FS, idx, m](int r, int e, int j) { return xn[r * FS + idx[e * m + j]]; },
                  [rn, k, r_lo, r_hi](int r, int e, float v) {
                    rn[r * k + e] = normalize(v, r_lo[e], r_hi[e]);
                  },
                  part<float>(parts, W1, smem), part<float>(parts, B1, smem),
                  part<float>(parts, W2, smem), part<float>(parts, B2, smem),
                  part<float>(parts, MASK, smem), n, k, m, h, hid, sq);
    __syncthreads();
    // 2. the output AE's hidden layer
    for (int p = threadIdx.x; p < n * kh; p += blockDim.x) {
      const int i = p / n, r = p - i * n;
      float a = 0.0f;
#pragma unroll 4
      for (int j = 0; j < k; ++j) a += rn[r * k + j] * v1[j * kh + i];
      z[r * kh + i] = sigmoid(a + c1[i]);
    }
    __syncthreads();
    // 3. its reconstruction: each (record, output) pair's squared error, in
    //    place of the input only that pair reads
    for (int p = threadIdx.x; p < n * k; p += blockDim.x) {
      const int j = p / n, r = p - j * n;
      float acc = 0.0f;
#pragma unroll 4
      for (int i = 0; i < kh; ++i) acc += z[r * kh + i] * v2[i * k + j];
      const float d = sigmoid(acc + c2[j]) - rn[r * k + j];
      rn[r * k + j] = d * d;
    }
    __syncthreads();
    // 4. the score
    for (int r = threadIdx.x; r < n; r += blockDim.x) {
      float s = 0.0f;
#pragma unroll 4
      for (int j = 0; j < k; ++j) s += rn[r * k + j];
      out[r0 + r] = sqrtf(s / static_cast<float>(k));
    }
    __syncthreads();  // the next tile overwrites these values
  }
}

}  // namespace

// X (B, F), idx (k, m) int64, mask (k, m), W1 (k, m, h), b1 (k, h),
// W2 (k, h, m), b2 (k, m), V1 (k, kh), c1 (kh), V2 (kh, k), c2 (k),
// lo/hi (F), r_lo/r_hi (k), out (B); float32 unless said, contiguous; idx
// values in [0, F).  A record's values, (F | 1) + k (h + m + 1) + kh floats,
// go in a block's shared memory where they fit; otherwise scratch holds
// `scratch_rows` records' (float32) and the grid is that many blocks, each
// taking a record at a time.
extern "C" int kitnet_score_launch(const void* X, const void* idx, const void* mask,
                                   const void* W1_, const void* b1_, const void* W2_,
                                   const void* b2_, const void* V1_, const void* c1_,
                                   const void* V2_, const void* c2_, const void* lo,
                                   const void* hi, const void* r_lo, const void* r_hi,
                                   void* out, void* scratch, int scratch_rows, int B, int F,
                                   int k, int m, int h, int kh, void* stream) {
  if (B <= 0) return 0;
  if (F <= 0 || k <= 0 || m <= 0 || h <= 0 || kh <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t rec = ((F | 1) + static_cast<int64_t>(k) * (h + m + 1) + kh) * 4;
  int64_t R = tile_records(B, k, rec, SMEM_MAX - BAR_BYTES);
  int64_t blocks = (B + R - 1) / std::max<int64_t>(R, 1);
  float* scr = nullptr;
  if (R < 1) {
    if (scratch == nullptr || scratch_rows < 1) return static_cast<int>(cudaErrorInvalidValue);
    R = 1;
    blocks = std::min<int64_t>(B, scratch_rows);
    scr = static_cast<float*>(scratch);
  }
  Parts parts{};
  const int64_t km = static_cast<int64_t>(k) * m;
  add_part(parts, r_lo, k * 4LL);
  add_part(parts, r_hi, k * 4LL);
  add_part(parts, c1_, kh * 4LL);
  add_part(parts, c2_, k * 4LL);
  add_part(parts, b1_, static_cast<int64_t>(k) * h * 4);
  add_part(parts, b2_, km * 4);
  add_part(parts, mask, km * 4);
  add_part(parts, idx, km * 8);
  add_part(parts, V1_, static_cast<int64_t>(k) * kh * 4);
  add_part(parts, V2_, static_cast<int64_t>(k) * kh * 4);
  add_part(parts, W1_, km * h * 4);
  add_part(parts, W2_, km * h * 4);
  const int smem = place_parts(parts, BAR_BYTES + (scr ? 0 : static_cast<int>(R * rec)));
  const int threads = block_threads(std::max<int64_t>(R * k * std::max(m, h), R * kh));
  auto kernel = scr ? kitnet_score_kernel<true> : kitnet_score_kernel<false>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(blocks), threads, smem, static_cast<cudaStream_t>(stream)>>>(
      parts, static_cast<const float*>(X), static_cast<const float*>(lo),
      static_cast<const float*>(hi), static_cast<float*>(out), scr, B, F, k, m, h, kh,
      static_cast<int>(R));
  return static_cast<int>(cudaGetLastError());
}
