// KitNET device code shared by the ensemble kernel (kitnet_ae.cu) and the
// scoring kernel (kitnet_score.cu): the ensemble of a tile of records, the
// normalisation, and the loader that stages a block's tensors into shared
// memory.
//
// The arithmetic is the plain version's (kernels/kitnet_ae.py) up to the
// order of float32 sums and their multiply-adds: sigmoid(x) = 1 / (1 +
// expf(-x)) with IEEE division, every sum in a fixed order that depends on
// nothing but the record's own values, so a record's result is the same,
// bit for bit, in whatever batch and wherever in the batch it arrives.
#pragma once
#include <cuda_runtime.h>
#include <algorithm>
#include <cstdint>

#include "common.cuh"

namespace kitnet {

constexpr int SMEM_MAX = 232448;  // dynamic shared memory a block may take
constexpr int BAR_BYTES = 16;     // the loader's mbarrier, at the start of it
constexpr int MAX_PARTS = 12;
constexpr int MAX_THREADS = 1024;

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

// clip((x - lo) / max(hi - lo, 1e-9), 0, 4); a NaN stays NaN, as in torch.clamp
__device__ __forceinline__ float normalize(float x, float lo, float hi) {
  const float v = (x - lo) / fmaxf(hi - lo, 1e-9f);
  return v < 0.0f ? 0.0f : (v > 4.0f ? 4.0f : v);
}

// ---------------------------------------------------------------------------
// Staging.  The tensors a block reads (the parts) are each either copied
// into its shared memory or, where they do not fit, read in place from
// global memory.  The host decides which (place_parts), the kernel only
// follows `off`.
// ---------------------------------------------------------------------------
struct Parts {
  const void* src[MAX_PARTS];
  int bytes[MAX_PARTS];
  int off[MAX_PARTS];  // byte offset in shared memory, or -1: read in global memory
  int n;
};

inline void add_part(Parts& p, const void* src, int64_t bytes) {
  p.src[p.n] = src;
  p.bytes[p.n] = static_cast<int>(std::min<int64_t>(bytes, SMEM_MAX + 1));
  p.off[p.n] = -1;
  ++p.n;
}

// Room in shared memory for each part in turn, from byte `used` on, 16-byte
// aligned, where it still fits; returns the bytes used.
inline int place_parts(Parts& p, int used) {
  for (int i = 0; i < p.n; ++i) {
    const int at = (used + 15) & ~15;
    if (p.bytes[i] > 0 && at + p.bytes[i] <= SMEM_MAX) {
      p.off[i] = at;
      used = at + p.bytes[i];
    }
  }
  return used;
}

inline bool all_staged(const Parts& p) {
  for (int i = 0; i < p.n; ++i)
    if (p.off[i] < 0) return false;
  return true;
}

// part i's address: in shared memory where it was staged, else in place in
// global memory
template <class T>
__device__ __forceinline__ const T* part(const Parts& p, int i, const unsigned char* smem) {
  return static_cast<const T*>(p.off[i] >= 0 ? static_cast<const void*>(smem + p.off[i])
                                             : p.src[i]);
}

// a 1-D bulk copy (TMA) needs 16-byte aligned addresses and a size in 16 bytes
__device__ __forceinline__ bool bulk_ok(const void* src, int bytes) {
  return bytes > 0 && ((reinterpret_cast<uintptr_t>(src) | static_cast<uintptr_t>(bytes)) & 15) == 0;
}

__device__ __forceinline__ void bulk_copy(unsigned char* dst, const void* src, int bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      :: "r"(smem_u32(dst)), "l"(__cvta_generic_to_global(src)), "r"(bytes),
         "r"(smem_u32(bar))
      : "memory");
}

// the block's threads copy `bytes` (a multiple of 4) in 4-byte cp.asyncs,
// neighbouring threads on neighbouring words
__device__ __forceinline__ void copy_words(unsigned char* dst, const void* src, int bytes) {
  const unsigned char* s = static_cast<const unsigned char*>(src);
  for (int w = threadIdx.x; w < bytes / 4; w += blockDim.x)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(smem_u32(dst + 4 * w)), "l"(__cvta_generic_to_global(s + 4 * w))
                 : "memory");
}

// Start copying the staged parts, and `tile` (`tile_bytes` to byte
// `tile_off`, unless that is -1), into shared memory.  Thread 0 arms the
// mbarrier and starts a bulk copy of each that bulk_ok allows; the block's
// threads copy the rest with cp.async.  Nothing waits: stage_wait ends it.
__device__ __forceinline__ void stage_start(const Parts& p, const void* tile, int tile_bytes,
                                            int tile_off, unsigned char* smem, uint64_t* bar) {
  const bool tile_bulk = tile_off >= 0 && bulk_ok(tile, tile_bytes);
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    uint32_t tx = tile_bulk ? tile_bytes : 0;
#pragma unroll
    for (int i = 0; i < MAX_PARTS; ++i)
      if (i < p.n && p.off[i] >= 0 && bulk_ok(p.src[i], p.bytes[i])) tx += p.bytes[i];
    mbar_expect_tx(bar, tx);
#pragma unroll
    for (int i = 0; i < MAX_PARTS; ++i)
      if (i < p.n && p.off[i] >= 0 && bulk_ok(p.src[i], p.bytes[i]))
        bulk_copy(smem + p.off[i], p.src[i], p.bytes[i], bar);
    if (tile_bulk) bulk_copy(smem + tile_off, tile, tile_bytes, bar);
  }
#pragma unroll
  for (int i = 0; i < MAX_PARTS; ++i)
    if (i < p.n && p.off[i] >= 0 && !bulk_ok(p.src[i], p.bytes[i]))
      copy_words(smem + p.off[i], p.src[i], p.bytes[i]);
  if (tile_off >= 0 && !tile_bulk) copy_words(smem + tile_off, tile, tile_bytes);
}

// Wait for stage_start's copies (and order the block's own shared stores
// before it for every thread).
__device__ __forceinline__ void stage_wait(uint64_t* bar) {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  mbar_wait(bar, 0);
}

// ---------------------------------------------------------------------------
// The ensemble of a tile of n records.  For record r and AE e:
//   xm = x*mask; z = sigmoid(xm W1 + b1); y = sigmoid(z W2 + b2);
//   rmse = sqrt(sum(mask*(y - xm)^2) / max(sum(mask), 1)),
// in three phases between barriers, so that a thread's chain is one sum
// deep, not an AE's m h:
//   A. each (e, i, r), hidden unit i: its sum over j = 0..m-1 in order, the
//      sigmoid, into hid[(e h + i) n + r];
//   B. each (e, j, r), output j: its sum over i = 0..h-1 in order, the
//      squared error, into sq[(e m + j) n + r];
//   C. each (e, r): the error and the mask summed over j in order; the RMSE
//      goes to put(r, e, rmse).
// Items run record fastest, so a warp's threads read the same weights and
// neighbouring scratch words.  x(r, e, j) is the j-th input of AE e on
// record r; hid holds n k h floats, sq n k m.
// ---------------------------------------------------------------------------
template <class In, class Put>
__device__ __forceinline__ void ensemble_tile(In x, Put put, const float* W1, const float* b1,
                                              const float* W2, const float* b2,
                                              const float* mask, int n, int k, int m, int h,
                                              float* hid, float* sq) {
  for (int p = threadIdx.x; p < n * k * h; p += blockDim.x) {
    const int q = p / n, r = p - q * n, e = q / h, i = q - e * h;
    const float* w = W1 + static_cast<int64_t>(e) * m * h + i;
    const float* mk = mask + e * m;
    float a = 0.0f;
#pragma unroll 4
    for (int j = 0; j < m; ++j) a += __fmul_rn(x(r, e, j), mk[j]) * w[j * h];
    hid[p] = sigmoid(a + b1[q]);
  }
  __syncthreads();
  for (int p = threadIdx.x; p < n * k * m; p += blockDim.x) {
    const int q = p / n, r = p - q * n, e = q / m, j = q - e * m;
    const float* w = W2 + static_cast<int64_t>(e) * h * m + j;
    const float* z = hid + e * h * n + r;
    float acc = 0.0f;
#pragma unroll 4
    for (int i = 0; i < h; ++i) acc += z[i * n] * w[i * m];
    const float d = sigmoid(acc + b2[q]) - __fmul_rn(x(r, e, j), mask[q]);
    sq[p] = d * d;
  }
  __syncthreads();
  for (int p = threadIdx.x; p < n * k; p += blockDim.x) {
    const int e = p / n, r = p - e * n;
    const float* mk = mask + e * m;
    const float* s = sq + e * m * n + r;
    float msum = 0.0f, se = 0.0f;
#pragma unroll 4
    for (int j = 0; j < m; ++j) {
      msum += mk[j];
      se += s[j * n] * mk[j];
    }
    put(r, e, sqrtf(se / fmaxf(msum, 1.0f)));
  }
}

// Records a block takes: enough blocks to use every SM of the current
// device where the batch is small, about 256 (record, AE) pairs a block
// where it is large, and at most what fits in `room` bytes at `per_record`
// bytes each (0: none fits).
inline int64_t tile_records(int64_t B, int k, int64_t per_record, int64_t room) {
  int dev = 0, sms = 1;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    sms = 1;
  const int64_t spread = (B + sms - 1) / sms;
  const int64_t R = std::max<int64_t>(1, std::min<int64_t>(spread, std::max(1, 256 / k)));
  return std::min(R, room / per_record);
}

// threads for a tile whose widest phase has `items` items: a multiple of the
// warp, at most MAX_THREADS
inline int block_threads(int64_t items) {
  return static_cast<int>(std::min<int64_t>((items + 31) / 32 * 32, MAX_THREADS));
}

template <class K>
inline cudaError_t allow_smem(K kernel, int smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

}  // namespace kitnet
