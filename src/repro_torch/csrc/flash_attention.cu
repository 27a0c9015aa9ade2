// Flash attention forward for Hopper (sm_90a), on the tensor cores.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py ::
// flash_attention (_attn_kernel).  For each batch b, query head h (kv head
// h / G) and query row i:
//   s_j = q_i . k_j / sqrt(D);  s_j = cap * tanh(s_j / cap) if cap > 0;
//   s_j = -1e30 where masked (causal: i < j; window: i - j >= window);
//   o_i = sum_j softmax(s)_j v_j
// on absolute positions from 0.  Keys past Sk do not exist (no weight).
// The softmax is float32 (accurate expf/tanhf); inputs float32 or bfloat16,
// the output in the input type.  One kernel per (dtype, D), D in {32, 64,
// 128, 256}; the wrapper zero-pads any other head dim up to 256 to the next
// of them and passes the true one for the scale.
//
// What bounds it.  Operations: 4*D a visible (query, key) pair and head.
// bf16: the bf16 tensor rate (989 TFLOP/s dense); the kernel issues 1.5x
// those products (P in two parts).  f32: the products run as split TF32,
// three TF32 tensor-core products each, so its rate is 495/3 = 165
// TFLOP/s.
//
// Why split arithmetic.  Tensor cores take bf16 or TF32 operands; the
// tolerances are those of float32 arithmetic.
// * bf16: S = Q K^T is exact products of bf16 values summed in f32.  P in
//   [0, 1] is f32; rounded once to bf16 for O += P V, it misses the one-ulp
//   bound of the model-shape check by ~100x.  So P = P_hi + P_lo, P_hi =
//   bf16(P), P_lo = bf16(P - P_hi): two wgmmas per 16 keys, P to ~2^-16.
// * f32: a.b = a_hi.b_hi + a_hi.b_lo + a_lo.b_hi in f32.  For A operands
//   (Q, P) a_hi is a rounded to TF32 to nearest and a_lo = a - a_hi; for B
//   operands (K, V) b_hi is b itself, which the tensor core reads as TF32
//   by truncation, and b_lo = b - trunc(b).  Each lo goes over raw and is
//   truncated in turn.  Truncating the A operands too broke the 2e-6
//   bound at the JAX test shapes.
//
// Design.  A block of two warpgroups takes one (batch, head, 128-row q
// tile), longest q tiles first; each warp computes 16 query rows.  Thread 0
// starts TMA loads of the q tile and of the first STAGES key tiles (K and
// V, BK keys each) into a ring in shared memory, each stage completing on
// an mbarrier; after a tile's two products the last unit (warpgroup for
// bf16, warp for f32) to release its stage refills it with the tile STAGES
// ahead, so loads overlap the math of the tiles before them.  Tensor maps
// are 4-d (D, S, heads, batch) with the caller's strides, so the model's
// transposed (B, S, H, D) views are read without a copy; rows past Sq or Sk
// load as zeros.  Tiles lie as TMA's 128-byte swizzle stores them (64-byte
// for bf16 D=32), in column blocks of 128 bytes.
// * bf16: S (64 x 64) = wgmma m64n64k16 with Q and K K-major from shared
//   memory; the softmax on the accumulator fragment in registers; O (64 x
//   D) += P_hi V + P_lo V as wgmma m64nDk16 with A from registers and V
//   N-major (the transpose bit) from shared memory.
// * f32: S (64 x 16) = wgmma m64n16k8 TF32, Q's fragments (ldmatrix)
//   split in registers, K's hi read raw from the tile and K's lo from a
//   third tile of the stage that the block writes when K lands; groups of
//   16 of D run two deep, each summed from zero and added to S in f32.
//   O += P V on mma.sync m16n8k8 TF32: wgmma takes TF32 operands K-major
//   only, and V^T with its lo part would not fit beside the rest (227 KiB
//   at D = 256).  V comes by 16-byte loads, conflict-free on the swizzled
//   tile, from per-lane offsets computed once.  The keys of each 8-key step
//   go in the order 0, 2, 4, 6, 1, 3, 5, 7, so the S accumulator fragment
//   is P's A fragment as it stands, and V's columns in an order that gives
//   each lane 4 neighbouring columns a load (the output is written back in
//   place).  Products are summed from zero a tile at a time, in two sums
//   (a_hi.b_hi and the small terms), and added in f32: the tensor core's
//   accumulation truncates, and into a long-running sum that error grows
//   with it (it doubled the error at D = 256).
// * No producer warp and no setmaxnreg.  Two consumer warpgroups and a
//   producer warp put three warps on one SM sub-partition, whose 16K
//   registers cap each thread at 168; ptxas compiled that layout at 168
//   with spills at D = 256 whether or not setmaxnreg moved registers from
//   the producer, and serialised the wgmmas.  Two warpgroups alone get 255.
// Shared memory per (dtype, D): q tile + STAGES x (K + V tile):
//   bf16: BK 64, 2 stages: 24 / 48 / 96 / 192 KiB at D = 32 / 64 / 128 /
//     256.  Registers: O D/2, S 32, P hi + lo 32 (held until the wgmma
//     completes).
//   f32: BK 16, 2 stages of K, V and K's lo: 28 / 56 / 112 / 224 KiB.
//     Registers: O D/2, S 8, two groups of Q fragments and S sums 64.
//   chip_smoke.py's build record has ptxas's registers and spills for each.
// Masks.  A masked score is the finite -1e30 (with -inf, a row that has
// seen only masked scores would rescale by exp(-inf + inf) = NaN); key
// tiles hidden from every row of the q tile are skipped (exact once a row
// has seen a visible key: exp(-1e30 - m) = 0); masks are applied only on
// tiles where some row needs them; a row with no visible key at all (only
// when Sq > Sk with a window) gets the reference's uniform softmax over all
// Sk keys, so a block holding one visits every tile.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cmath>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr float MASKED = -1e30f;

template <typename T, int D>
struct Cfg {
  static constexpr bool BF16 = sizeof(T) == 2;
  static constexpr int ES = sizeof(T);
  static constexpr int BQ = 128;                            // q rows a block
  static constexpr int THREADS = 256;                        // two warpgroups
  static constexpr int BK = BF16 ? 64 : 16;                 // keys a tile
  static constexpr int TILES = BF16 ? 2 : 3;                // K, V (f32: K's lo part)
  static constexpr int STAGES = 2;                          // stages in the ring
  static constexpr int SWB = D * ES < 128 ? D * ES : 128;  // swizzle width, bytes
  static constexpr int CW = SWB / ES;                       // columns a block
  static constexpr int NCB = D / CW;                        // column blocks
  static constexpr int Q_BYTES = 64 * D * ES;               // 64 rows
  static constexpr int KV_BYTES = BK * D * ES;              // one K or V tile
  static constexpr int SMEM = 2 * Q_BYTES + STAGES * TILES * KV_BYTES;
  static constexpr int SMEM_ALLOC = SMEM + 1024 + 128;      // alignment, barriers, counters
  static_assert(SMEM_ALLOC <= 232448, "shared memory over the block limit");
};

// ---- TMA (shared addresses and mbarriers: common.cuh) ----
// One box of a 4-d tensor map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(smem_u32(bar))
      : "memory");
}

// ---- wgmma (bf16) ----
// Shared-memory matrix descriptor: start address, leading and stride byte
// offsets (16-byte units), swizzle layout (1 = 128 B, 2 = 64 B).
__device__ __forceinline__ uint64_t gmma_desc(uint32_t saddr, uint32_t lbo,
                                              uint32_t sbo, uint32_t layout) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4)
       | (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16)
       | (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32)
       | (static_cast<uint64_t>(layout) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmma's issue and wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

// S (64 x 64) = A (64 x 16, K-major, shared memory) . B^T (64 x 16, K-major,
// shared memory), bf16 in, f32 accumulate; scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// O (64 x 32) += A (64 x 16, registers) . B (16 x 32, N-major in shared
// memory: the transpose bit set), bf16 in, f32 accumulate.
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// O (64 x 64) += A (64 x 16, registers) . B (16 x 64, N-major in shared
// memory: the transpose bit set), bf16 in, f32 accumulate.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// O (64 x 128) += A (64 x 16, registers) . B (16 x 128, N-major in shared
// memory: the transpose bit set), bf16 in, f32 accumulate.
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// O (64 x 256) += A (64 x 16, registers) . B (16 x 256, N-major in shared
// memory: the transpose bit set), bf16 in, f32 accumulate.
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int D>
__device__ __forceinline__ void wgmma_rs(float (&o)[D / 2], const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (D == 32) wgmma_rs_n32(o, a, db);
  else if constexpr (D == 64) wgmma_rs_n64(o, a, db);
  else if constexpr (D == 128) wgmma_rs_n128(o, a, db);
  else wgmma_rs_n256(o, a, db);
}

// ---- split TF32 (f32) ----
// x = hi + lo: hi is x rounded to TF32 (10 mantissa bits) to nearest, ties
// away from zero, as cvt.rna.tf32.f32 rounds, but in two integer operations
// (the conversion runs at a quarter of the integer rate); lo = x - hi is
// exact in float32 and goes to the tensor core as it is, which reads it as
// TF32 by dropping its low 13 bits (truncation, 2^-11 of lo).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// c (16 x 8) += a (16 x 8) . b (8 x 8), TF32 in, f32 accumulate.
__device__ __forceinline__ void mma_tf32(float& c0, float& c1, float& c2, float& c3,
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c0), "+f"(c1), "+f"(c2), "+f"(c3)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d = a . b with a zero accumulator.
__device__ __forceinline__ void mma_tf32_zero(float& d0, float& d1, float& d2, float& d3,
                                              const uint32_t (&a)[4], uint32_t b0,
                                              uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d0), "=f"(d1), "=f"(d2), "=f"(d3)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f));
}

// The B operand (K or V) as hi + lo: hi is b itself, which the tensor core
// reads as TF32 by truncation, and lo = b - trunc(b), exact in float32 (two
// operations, where rounding hi takes three).
__device__ __forceinline__ void split_b(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x);
  lo = __float_as_uint(x - __uint_as_float(hi & 0xFFFFE000u));
}

// One 8-deep step of a split product: big (+)= a_hi.b_hi and small (+)=
// a_hi.b_lo + a_lo.b_hi, from zero if `first`.  The two sums are kept
// apart so that the tensor core's truncating accumulation of the small
// terms is relative to their own size.
__device__ __forceinline__ void mma_3xtf32(float (&big)[4], float (&small)[4],
                                           const uint32_t (&ah)[4], const uint32_t (&al)[4],
                                           float b0, float b1, bool first) {
  uint32_t bh0, bl0, bh1, bl1;
  split_b(b0, bh0, bl0);
  split_b(b1, bh1, bl1);
  if (first) {
    mma_tf32_zero(small[0], small[1], small[2], small[3], al, bh0, bh1);
    mma_tf32_zero(big[0], big[1], big[2], big[3], ah, bh0, bh1);
  } else {
    mma_tf32(small[0], small[1], small[2], small[3], al, bh0, bh1);
    mma_tf32(big[0], big[1], big[2], big[3], ah, bh0, bh1);
  }
  mma_tf32(small[0], small[1], small[2], small[3], ah, bl0, bl1);
}

// The float32 tiles lie as TMA stores them with the 128-byte swizzle:
// column blocks of 32 floats, each rows x 128 bytes, the 16-byte chunk
// index within a row XORed with the row index mod 8.  A lane's loads in
// the f32 products differ only by constants from a few per-lane byte
// offsets, computed once (F32Lanes).

// Four 8x4 float32 blocks (8 rows of 16 bytes, lane L giving the shared
// address of row L % 8 of block L / 8) into the mma.sync fragment layout:
// element (L / 4, L % 4) of block e lands in r[e] of lane L.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ float4 lds128(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "r"(addr));
  return v;
}

// Per-lane byte offsets into the swizzled tiles.  For an even chunk index
// k (a 16-byte chunk of a row's 128-byte block) the swizzle gives
// ((k + x) ^ r) = (k ^ (x ^ r)) for the lane's odd chunk bit x and row r:
// q[k / 2] holds (row, chunk) offsets for Q's ldmatrix rows; v[w] for V's
// 16-byte loads at keys 2t + w.
struct F32Lanes {
  uint32_t q[4], v[2];
  __device__ __forceinline__ F32Lanes(int r0) {
    const int lane = threadIdx.x % 32, rr = lane % 8, mb = lane / 8;
    const int g = lane / 4, t = lane % 4;
    const int qx = (mb >> 1) ^ rr;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      q[k] = (r0 + rr + 8 * (mb & 1)) * 128 + (((2 * k) ^ qx) << 4);
    }
#pragma unroll
    for (int w = 0; w < 2; ++w) v[w] = (2 * t + w) * 128 + ((g ^ (2 * t + w)) << 4);
  }
};

// ---- the online softmax on one tile's scores ----
// s holds the tile as an accumulator fragment (wgmma's and mma.sync's are
// the same): s[4j + 2h + e] is query row `qrow + 8h` and key
// `k0 + 8j + 2(lane % 4) + e`.  Scales, softcaps and (MASK: the tile has a
// masked or missing key for some row of the block) masks the scores, then
// replaces them with exp(s - m_new); m, l per row half, corr the factor
// the accumulator is to be multiplied by.
template <bool MASK, int NS>
__device__ __forceinline__ void online_softmax(float (&s)[NS], float (&m)[2], float (&l)[2],
                                               float (&corr)[2], int qrow, int k0, int Sk,
                                               int causal, int window, float softcap,
                                               float inv_softcap, float scale) {
  const int c0 = k0 + 2 * (threadIdx.x % 4);
  float rmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    const int hh = (i >> 1) & 1;
    float x = s[i] * scale;
    if (softcap > 0.f) x = softcap * tanhf(x * inv_softcap);
    if constexpr (MASK) {
      const int qp = qrow + 8 * hh;
      const int kp = c0 + 8 * (i >> 2) + (i & 1);
      bool ok = true;
      if (causal) ok = ok && qp >= kp;
      if (window > 0) ok = ok && (qp - kp) < window;
      x = ok ? x : MASKED;
      if (kp >= Sk) x = -INFINITY;        // no such key
    }
    s[i] = x;
    rmax[hh] = fmaxf(rmax[hh], x);
  }
  float rsum[2] = {0.f, 0.f};
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float x = rmax[hh];
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
    const float m_new = fmaxf(m[hh], x);
    corr[hh] = expf(m[hh] - m_new);
    m[hh] = m_new;
  }
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    const int hh = (i >> 1) & 1;
    const float p = expf(s[i] - m[hh]);
    s[i] = p;
    rsum[hh] += p;
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float x = rsum[hh];
    x += __shfl_xor_sync(0xffffffffu, x, 1);
    x += __shfl_xor_sync(0xffffffffu, x, 2);
    l[hh] = l[hh] * corr[hh] + x;
  }
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// S (64 x 64) = Q K^T for one warpgroup on the tensor cores (bf16).
template <int D>
__device__ __forceinline__ void scores_bf16(float (&s)[32], uint32_t qs, uint32_t ks) {
  using C = Cfg<__nv_bfloat16, D>;
  constexpr uint32_t LAYOUT = C::SWB == 128 ? 1 : 2;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
  fence_regs(s);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t cb = (kk * 16) / C::CW, cin = (kk * 16) % C::CW * 2;
    wgmma_ss_n64(s, gmma_desc(qs + cb * 64 * C::SWB + cin, 16, 8 * C::SWB, LAYOUT),
                 gmma_desc(ks + cb * C::BK * C::SWB + cin, 16, 8 * C::SWB, LAYOUT),
                 kk > 0);
  }
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(s);
}

// O (64 x D) += (P_hi + P_lo) V for one warpgroup on the tensor cores (bf16).
template <int D>
__device__ __forceinline__ void pv_bf16(float (&o)[D / 2], const float (&p)[32], uint32_t vs) {
  using C = Cfg<__nv_bfloat16, D>;
  constexpr uint32_t LAYOUT = C::SWB == 128 ? 1 : 2;
  uint32_t ph[4][4], pl[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float x = p[8 * kk + 2 * r], y = p[8 * kk + 2 * r + 1];
      const __nv_bfloat162 hi = __floats2bfloat162_rn(x, y);
      const float2 hf = __bfloat1622float2(hi);
      const __nv_bfloat162 lo = __floats2bfloat162_rn(x - hf.x, y - hf.y);
      ph[kk][r] = *reinterpret_cast<const uint32_t*>(&hi);
      pl[kk][r] = *reinterpret_cast<const uint32_t*>(&lo);
    }
  fence_regs(o);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t dv = gmma_desc(vs + kk * 16 * C::SWB, C::BK * C::SWB, 8 * C::SWB, LAYOUT);
    wgmma_rs<D>(o, pl[kk], dv);
    wgmma_rs<D>(o, ph[kk], dv);
  }
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(o);
  // P's registers are read until the wait: keep them alive until here
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) asm volatile("" :: "r"(ph[kk][r]), "r"(pl[kk][r]) : "memory");
}

// ---- the f32 products: split TF32, one warp 16 query rows ----
// S (64 x 16) (+)= A (64 x 8, registers, TF32) . B^T (16 x 8, K-major in
// shared memory, read as TF32); scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_tf32_n16(float (&d)[8], const uint32_t (&a)[4],
                                               uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// S (64 x 16) = Q K^T for one warpgroup, the products on wgmma: Q's
// fragments split in registers (as for mma.sync: the A layouts agree),
// K's hi read raw and K's lo from shared memory.  Summed over 16 of D from
// zero in two sums (a_hi.b_hi, and the small terms) and then added to s;
// while one group of 16 runs on the tensor cores, the next group's Q
// fragments are loaded and split.
template <int D>
__device__ __forceinline__ void wgmma_group(float (&big)[8], float (&small)[8],
                                            uint32_t (&ah)[2][4], uint32_t (&al)[2][4],
                                            uint32_t qs, uint32_t ks, uint32_t klo,
                                            const F32Lanes& ln, int d) {
  constexpr int BK = 16;
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int dd = d + 8 * u, k = (dd / 4) % 8 / 2, blk = dd / 32;
    uint32_t q4[4];
    ldsm_x4(q4, qs + blk * 64 * 128 + ln.q[k]);
#pragma unroll
    for (int e = 0; e < 4; ++e) split_tf32(__uint_as_float(q4[e]), ah[u][e], al[u][e]);
  }
  fence_regs(big);
  fence_regs(small);
  wgmma_fence();
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int dd = d + 8 * u;
    const uint32_t off = (dd / 32) * BK * 128 + (dd % 32) * 4;
    const uint64_t dk = gmma_desc(ks + off, 16, 1024, 1);
    const uint64_t dl = gmma_desc(klo + off, 16, 1024, 1);
    wgmma_tf32_n16(small, al[u], dk, u > 0);
    wgmma_tf32_n16(small, ah[u], dl, 1);
    wgmma_tf32_n16(big, ah[u], dk, u > 0);
  }
  wgmma_commit();
}

template <int D>
__device__ __forceinline__ void scores_f32_wgmma(float (&s)[8], uint32_t qs, uint32_t ks,
                                                 uint32_t klo, const F32Lanes& ln) {
  uint32_t ah[2][2][4], al[2][2][4];
  float big[2][8], small[2][8];
#pragma unroll
  for (int i = 0; i < 8; ++i) s[i] = 0.f;
#pragma unroll
  for (int g = 0; g <= D / 16; ++g) {
    if (g < D / 16)
      wgmma_group<D>(big[g & 1], small[g & 1], ah[g & 1], al[g & 1], qs, ks, klo, ln, 16 * g);
    if (g > 0) {
      const int p = (g - 1) & 1;
      if (g < D / 16)
        asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      else
        wgmma_wait_all();
      fence_regs(big[p]);
      fence_regs(small[p]);
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          asm volatile("" :: "r"(ah[p][u][e]), "r"(al[p][u][e]) : "memory");
#pragma unroll
      for (int i = 0; i < 8; ++i) s[i] += big[p][i] + small[p][i];
    }
  }
}

// P's A fragments, split: within each 8-key step the keys go in the order
// 0, 2, 4, 6, 1, 3, 5, 7, so the S accumulator fragment is P's A fragment
// as it stands (V's rows are read in the same order).
template <int BK>
__device__ __forceinline__ void split_p(const float (&p)[BK / 2], uint32_t (&ph)[BK / 8][4],
                                        uint32_t (&pl)[BK / 8][4]) {
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
    split_tf32(p[4 * j], ph[j][0], pl[j][0]);          // (g, key 2t)
    split_tf32(p[4 * j + 2], ph[j][1], pl[j][1]);      // (g + 8, key 2t)
    split_tf32(p[4 * j + 1], ph[j][2], pl[j][2]);      // (g, key 2t + 1)
    split_tf32(p[4 * j + 3], ph[j][3], pl[j][3]);      // (g + 8, key 2t + 1)
  }
}

// O += P V for one warp.  V's columns are taken in an order that lets each
// lane read 4 neighbouring columns with one 16-byte load: n-tile nd = 4a + b
// (b < 4) holds, at its B-fragment column n, column 32a + 4n + b of V and
// of the output.  So o[4 nd + e] is row g + 8 (e >> 1) of output column
// 32a + 4 (2t + (e & 1)) + b.
template <int D, int BK>
__device__ __forceinline__ void pv_f32(float (&o)[D / 2], const uint32_t (&ph)[BK / 8][4],
                                       const uint32_t (&pl)[BK / 8][4], uint32_t vs,
                                       const F32Lanes& ln) {
#pragma unroll
  for (int a = 0; a < D / 32; ++a)
#pragma unroll
    for (int j = 0; j < BK / 8; j += 2) {
      float4 v[2][2];                      // [key step][key 2t, 2t + 1]
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int w = 0; w < 2; ++w)
          v[u][w] = lds128(vs + a * BK * 128 + 8 * (j + u) * 128 + ln.v[w]);
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) {
        const int nd = 4 * a + bb;
        float big[4], small[4];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const float b0 = bb == 0 ? v[u][0].x : bb == 1 ? v[u][0].y : bb == 2 ? v[u][0].z : v[u][0].w;
          const float b1 = bb == 0 ? v[u][1].x : bb == 1 ? v[u][1].y : bb == 2 ? v[u][1].z : v[u][1].w;
          mma_3xtf32(big, small, ph[j + u], pl[j + u], b0, b1, u == 0);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) o[4 * nd + e] += big[e] + small[e];
      }
    }
}

// K and V of key tile t into stage st, completing on full[st].
template <typename T, int D>
__device__ __forceinline__ void load_kv(uint8_t* KV, uint64_t* full, int st, int t, int kh,
                                        int b, const CUtensorMap* tk, const CUtensorMap* tv) {
  using C = Cfg<T, D>;
  uint8_t* Kt = KV + st * C::TILES * C::KV_BYTES;
  mbar_expect_tx(full + st, 2 * C::KV_BYTES);
#pragma unroll
  for (int c = 0; c < C::NCB; ++c) {
    tma_load(Kt + c * C::BK * C::SWB, tk, full + st, c * C::CW, t * C::BK, kh, b);
    tma_load(Kt + C::KV_BYTES + c * C::BK * C::SWB, tv, full + st, c * C::CW, t * C::BK,
             kh, b);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__((Cfg<T, D>::THREADS), 1)
flash_attention_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv, T* __restrict__ out,
                       int H, int G, int Sq, int Sk,
                       int64_t osb, int64_t osh, int64_t oss,
                       int causal, int window, float softcap, float inv_softcap,
                       float scale) {
  using C = Cfg<T, D>;
  constexpr int BK = C::BK;
  constexpr int STAGES = C::STAGES;
  // units that release a stage: warpgroups (bf16), warps (f32)
  constexpr int UNITS = C::BF16 ? 2 : 8;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  // the swizzle follows shared-address bits: start on a 1024-byte boundary
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* Qs = base;                                   // 2 x (64 x D)
  uint8_t* KV = base + 2 * C::Q_BYTES;                  // stage st: K, V (f32: K's lo)
  uint64_t* full = reinterpret_cast<uint64_t*>(base + C::SMEM);
  uint64_t* lo_full = full + STAGES;                    // K's lo part written (f32)
  uint64_t* qbar = lo_full + STAGES;
  int* released = reinterpret_cast<int*>(qbar + 1);     // per stage

  const int nq = (Sq + C::BQ - 1) / C::BQ;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x)) * C::BQ;  // longest rows first
  const int q1 = min(q0 + C::BQ, Sq) - 1;
  const int b = blockIdx.y / H, h = blockIdx.y % H, kh = h / G;

  // the keys some row of this block sees
  int lo = 0, hi = Sk;
  if (causal) hi = min(Sk, q1 + 1);
  if (window > 0) lo = max(0, q0 - window + 1);
  if (window > 0 && q1 >= Sk + window - 1) {   // a row that sees no key
    lo = 0;
    hi = Sk;
  }
  const int t_lo = lo / BK, t_hi = (hi + BK - 1) / BK;

  // thread 0 sets up the barriers and starts the q tile and the first
  // STAGES key tiles loading
  if (threadIdx.x == 0) {
#pragma unroll
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(full + st, 1);
      mbar_init(lo_full + st, C::THREADS);
      released[st] = 0;
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(qbar, 2 * C::Q_BYTES);
    for (int w = 0; w < 2; ++w)
      for (int c = 0; c < C::NCB; ++c)
        tma_load(Qs + w * C::Q_BYTES + c * 64 * C::SWB, &tq, qbar, c * C::CW,
                 q0 + 64 * w, h, b);
    for (int i = 0; i < STAGES && t_lo + i < t_hi; ++i)
      load_kv<T, D>(KV, full, i, t_lo + i, kh, b, &tk, &tv);
  }
  __syncthreads();

  // 16 query rows a warp, 64 a warpgroup
  const int warp = threadIdx.x / 32;
  const int r0 = 16 * (warp % 4);                              // in its warpgroup's tile
  const int qrow = q0 + 16 * warp + (threadIdx.x % 32) / 4;
  uint8_t* Qw = Qs + (warp / 4) * C::Q_BYTES;
  const F32Lanes lanes(r0);                                    // (f32 only)
  float o[D / 2], m[2] = {MASKED, MASKED}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  mbar_wait(qbar, 0);

  for (int t = t_lo, i = 0; t < t_hi; ++t, ++i) {
    const int st = i % STAGES;
    mbar_wait(full + st, (i / STAGES) & 1);
    uint8_t* Kt = KV + st * C::TILES * C::KV_BYTES;
    uint8_t* Vt = Kt + C::KV_BYTES;
    float s[BK / 2], corr[2];
    if constexpr (C::BF16) {
      scores_bf16<D>(s, smem_u32(Qw), smem_u32(Kt));
    } else {
      // K's lo part, each thread its share of the tile (the swizzle moves
      // raw and lo alike), then S on the tensor cores (wgmma)
      uint8_t* Klo = Kt + 2 * C::KV_BYTES;
      for (int idx = threadIdx.x; idx < C::KV_BYTES / 16; idx += C::THREADS) {
        const float4 x = reinterpret_cast<const float4*>(Kt)[idx];
        float4 lo;
        lo.x = x.x - __uint_as_float(__float_as_uint(x.x) & 0xFFFFE000u);
        lo.y = x.y - __uint_as_float(__float_as_uint(x.y) & 0xFFFFE000u);
        lo.z = x.z - __uint_as_float(__float_as_uint(x.z) & 0xFFFFE000u);
        lo.w = x.w - __uint_as_float(__float_as_uint(x.w) & 0xFFFFE000u);
        reinterpret_cast<float4*>(Klo)[idx] = lo;
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_arrive(lo_full + st);
      mbar_wait(lo_full + st, (i / STAGES) & 1);
      scores_f32_wgmma<D>(s, smem_u32(Qw), smem_u32(Kt), smem_u32(Klo), lanes);
    }
    const int k0 = t * BK;
    const bool mask = (causal && k0 + BK - 1 > q0) || k0 + BK > Sk
                      || (window > 0 && q1 - k0 >= window);
    if (mask)
      online_softmax<true>(s, m, l, corr, qrow, k0, Sk, causal, window, softcap,
                           inv_softcap, scale);
    else
      online_softmax<false>(s, m, l, corr, qrow, k0, Sk, causal, window, softcap,
                            inv_softcap, scale);
    if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
      for (int j = 0; j < D / 2; ++j) o[j] *= corr[(j >> 1) & 1];
    }
    if constexpr (C::BF16) {
      pv_bf16<D>(o, s, smem_u32(Vt));
    } else {
      uint32_t ph[BK / 8][4], pl[BK / 8][4];
      split_p<BK>(s, ph, pl);
      pv_f32<D, BK>(o, ph, pl, smem_u32(Vt), lanes);
    }

    // release the stage: the last unit done with it refills it with key
    // tile t + STAGES, which then loads while all compute on the tiles
    // before it
    if (t + STAGES < t_hi) {
      bool leader;
      if constexpr (C::BF16) {
        asm volatile("bar.sync %0, 128;\n" :: "r"(1 + warp / 4) : "memory");
        leader = threadIdx.x % 128 == 0;
      } else {
        __syncwarp();
        leader = threadIdx.x % 32 == 0;
      }
      if (leader) {
        __threadfence_block();
        // each unit releases a stage once a round: the count's residue
        // says who is last
        if (atomicAdd(released + st, 1) % UNITS == UNITS - 1) {
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          load_kv<T, D>(KV, full, st, t + STAGES, kh, b, &tk, &tv);
        }
      }
    }
  }

  T* ob = out + b * osb + h * osh;
  const int t4 = threadIdx.x % 4;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = qrow + 8 * hh;
    if (row >= Sq) continue;
    const float denom = fmaxf(l[hh], 1e-30f);
    if constexpr (C::BF16) {
#pragma unroll
      for (int nd = 0; nd < D / 8; ++nd)
        store2(ob + row * oss + 8 * nd + 2 * t4, o[4 * nd + 2 * hh] / denom,
               o[4 * nd + 2 * hh + 1] / denom);
    } else {
      // pv_f32's column order: 4 neighbouring columns a store
#pragma unroll
      for (int a = 0; a < D / 32; ++a)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float4 x;
          x.x = o[4 * (4 * a + 0) + 2 * hh + e] / denom;
          x.y = o[4 * (4 * a + 1) + 2 * hh + e] / denom;
          x.z = o[4 * (4 * a + 2) + 2 * hh + e] / denom;
          x.w = o[4 * (4 * a + 3) + 2 * hh + e] / denom;
          *reinterpret_cast<float4*>(ob + row * oss + 32 * a + 4 * (2 * t4 + e)) = x;
        }
    }
  }
}

// ---- host: tensor maps and launch ----
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, found through the runtime (the
// library does not link libcuda).
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                                  cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A (D, rows, heads, batch) map with the caller's element strides; boxes of
// one column block by `box_rows` rows, swizzled as the kernel reads them.
template <typename T, int D>
bool make_map(CUtensorMap* map, const void* ptr, int rows, int heads, int batch,
              int64_t sb, int64_t sh, int64_t ss, int box_rows) {
  using C = Cfg<T, D>;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(heads), static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(ss * C::ES),
                                 static_cast<cuuint64_t>(sh * C::ES),
                                 static_cast<cuuint64_t>(sb * C::ES)};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(C::CW),
                             static_cast<cuuint32_t>(box_rows), 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, C::BF16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                4, const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE,
                C::SWB == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int H, int K, int Sq, int Sk, const int64_t* st,
                   int causal, int window, float softcap, float scale,
                   cudaStream_t stream) {
  using C = Cfg<T, D>;
  CUtensorMap tq, tk, tv;
  if (!make_map<T, D>(&tq, q, Sq, H, B, st[0], st[1], st[2], 64)
      || !make_map<T, D>(&tk, k, Sk, K, B, st[3], st[4], st[5], C::BK)
      || !make_map<T, D>(&tv, v, Sk, K, B, st[6], st[7], st[8], C::BK))
    return cudaErrorInvalidValue;
  auto kern = flash_attention_kernel<T, D>;
  // the attribute is the current device's: set it once on each device that
  // launches this instantiation (bit d of `configured`, devices 0-63)
  static uint64_t configured = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const uint64_t bit = dev < 64 ? uint64_t{1} << dev : 0;
  if (!(configured & bit)) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             C::SMEM_ALLOC);
    if (e != cudaSuccess) return e;
    configured |= bit;
  }
  const dim3 grid((Sq + C::BQ - 1) / C::BQ, B * H);
  kern<<<grid, C::THREADS, C::SMEM_ALLOC, stream>>>(
      tq, tk, tv, static_cast<T*>(out), H, H / K, Sq, Sk, st[9], st[10], st[11],
      causal, window, softcap, softcap > 0.f ? 1.0f / softcap : 0.f, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int D, const void* q, const void* k, const void* v,
                     void* out, int B, int H, int K, int Sq, int Sk,
                     const int64_t* st, int causal, int window, float softcap,
                     float scale, cudaStream_t stream) {
  switch (D) {
    case 32: return launch<T, 32>(q, k, v, out, B, H, K, Sq, Sk, st, causal, window, softcap, scale, stream);
    case 64: return launch<T, 64>(q, k, v, out, B, H, K, Sq, Sk, st, causal, window, softcap, scale, stream);
    case 128: return launch<T, 128>(q, k, v, out, B, H, K, Sq, Sk, st, causal, window, softcap, scale, stream);
    case 256: return launch<T, 256>(q, k, v, out, B, H, K, Sq, Sk, st, causal, window, softcap, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, H, Sq, D), k/v (B, K, Sk, D), out (B, H, Sq, D), each addressed by
// its (batch, head, row) strides in elements with the last dimension
// contiguous; strides of 16 bytes' multiples and 16-byte aligned pointers
// (TMA).  bf16 != 0: every tensor is bfloat16, else float32.  D is the
// built head dim the tensors hold; scores scale by 1/sqrt(d_scale), the
// caller's true head dim when it zero-padded q, k and v up to D (the zero
// columns add exact zeros to every dot product).
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* out,
    int B, int H, int K, int Sq, int Sk, int D, int d_scale,
    int64_t qsb, int64_t qsh, int64_t qss, int64_t ksb, int64_t ksh, int64_t kss,
    int64_t vsb, int64_t vsh, int64_t vss, int64_t osb, int64_t osh, int64_t oss,
    int causal, int window, float softcap, int bf16, void* stream) {
  const int64_t st[12] = {qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss, osb, osh, oss};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d_scale < 1 || d_scale > D) return static_cast<int>(cudaErrorInvalidValue);
  const float scale = 1.0f / sqrtf(static_cast<float>(d_scale));
  const cudaError_t e = bf16
      ? dispatch<__nv_bfloat16>(D, q, k, v, out, B, H, K, Sq, Sk, st, causal, window, softcap, scale, s)
      : dispatch<float>(D, q, k, v, out, B, H, K, Sq, Sk, st, causal, window, softcap, scale, s);
  return static_cast<int>(e);
}

// Dynamic shared memory (bytes) a launch of the (D, dtype) kernel takes;
// 0 for a D it is not built for.
extern "C" int flash_attention_smem(int D, int bf16) {
  switch (D) {
    case 32: return bf16 ? Cfg<__nv_bfloat16, 32>::SMEM_ALLOC : Cfg<float, 32>::SMEM_ALLOC;
    case 64: return bf16 ? Cfg<__nv_bfloat16, 64>::SMEM_ALLOC : Cfg<float, 64>::SMEM_ALLOC;
    case 128: return bf16 ? Cfg<__nv_bfloat16, 128>::SMEM_ALLOC : Cfg<float, 128>::SMEM_ALLOC;
    case 256: return bf16 ? Cfg<__nv_bfloat16, 256>::SMEM_ALLOC : Cfg<float, 256>::SMEM_ALLOC;
    default: return 0;
  }
}
