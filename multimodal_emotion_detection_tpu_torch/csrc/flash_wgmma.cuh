// Hopper building blocks of the bf16 flash kernels (flash_fwd_bf16.cu,
// flash_bwd_bf16.cu): TMA tile loads on mbarriers, warpgroup MMAs (wgmma)
// with operands in shared memory through matrix descriptors or, for A, in
// registers, and the host-side tensor maps.
//
// Tiles.  Every bf16 operand tile is loaded by one TMA copy a 64-column
// block of the head dim: a (rows, 64) box of a (B H, T, Dp) tensor, 128
// bytes a row, with the 128-byte swizzle (the 16-byte chunk c of row r
// lands at chunk c ^ (r % 8)), which is the layout wgmma reads without bank
// conflicts.  A head dim of 128 is two such blocks ("regions"), one after
// the other.  Rows past T and columns past Dp arrive as zeros.  A region
// starts on a 1024-byte boundary (8 rows), as the swizzle's pattern needs.
//
// Descriptors (sm_90 matrix descriptor: start address, leading and stride
// byte offsets, 128-byte swizzle).  An operand read along its rows' 128
// bytes ("K-major": Q, K, V, dO as the k = head-dim side of S = Q K^T or dP
// = dO V^T) takes 16 columns a k-step: the start advances 32 bytes within
// the region, the 8-row groups lie 1024 bytes apart (SBO).  An operand read
// across its rows ("MN-major", transposed: V in P V, K in dS K, Q and dO in
// dS^T Q and P^T dO, where the rows are the k side) takes 16 rows a k-step:
// the start advances 2048 bytes, the 8-row groups lie 1024 bytes apart
// (SBO), and the second 64-column region of a head dim of 128 is LBO bytes
// on.
//
// Fragments.  A wgmma m64nN accumulator gives warp w of the warpgroup rows
// 16w .. 16w + 15: for the 8-column block j, lane (g, t) = (lane / 4, lane %
// 4) holds d[4j] and d[4j + 1] at row g, columns 8j + 2t and + 1, and d[4j +
// 2], d[4j + 3] at row g + 8: mma.sync's m16n8 layout, so flash_mma.cuh's
// quad reductions and Philox mask helpers apply as they are.  The A
// fragment of k-step kk from registers is the accumulator's blocks 2kk and
// 2kk + 1 packed to bf16 pairs (a_frag), which is where P and dS are
// rounded to bf16.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only: nothing links libcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_mma.cuh"

namespace flash_wgmma {

using bf16 = __nv_bfloat16;

constexpr int REGION = 64;            // head-dim columns of one TMA box
constexpr int ROW_BYTES = 2 * REGION;  // 128: one swizzle row
constexpr int KSTEP_K = 32;            // bytes a k-step along a K-major row
constexpr int KSTEP_MN = 16 * ROW_BYTES;  // bytes a k-step across MN-major rows
constexpr int GROUP = 8 * ROW_BYTES;      // 1024: an 8-row group

// ---------------------------------------------------------------- barriers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival that also expects `bytes` of TMA transactions
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// wait until the barrier's phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// 4 bytes from global into shared memory by this thread's cp.async (zeros
// where !in), and the stage barrier's arrival once this thread's copies
// have landed (the barrier's count includes one such arrival a thread)
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(in ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// ---------------------------------------------------------------- TMA

// box (REGION, rows, 1) of a 3-d tensor map at (column c0, row c1, slab c2)
// into shared memory, completing `bytes` on bar
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// rows [r0, r0 + ROWS) of slab bh, every region of the head dim: REGIONS
// boxes into consecutive ROWS x 128-byte regions at dst
template <int ROWS, int REGIONS>
__device__ __forceinline__ void tma_tile(unsigned char* dst, const CUtensorMap* map,
                                         uint64_t* bar, int r0, int bh) {
#pragma unroll
  for (int r = 0; r < REGIONS; ++r)
    tma_load(dst + r * ROWS * ROW_BYTES, map, bar, REGION * r, r0, bh);
}

// the reverse: REGIONS boxes of ROWS rows from shared memory at src to
// (column 64 r, row r0, slab bh) of a tensor map (rows and columns past the
// tensor's are not written), committed as one bulk group; the caller waits
// with tma_store_wait before the shared memory is reused or the CTA ends
template <int ROWS, int REGIONS>
__device__ __forceinline__ void tma_store_tile(const CUtensorMap* map, const unsigned char* src,
                                               int r0, int bh) {
#pragma unroll
  for (int r = 0; r < REGIONS; ++r)
    asm volatile(
        "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
            reinterpret_cast<uint64_t>(map)),
        "r"(smem_u32(src + r * ROWS * ROW_BYTES)), "r"(REGION * r), "r"(r0), "r"(bh)
        : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void tma_store_wait() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// this thread's generic-proxy writes to shared memory made visible to the
// async proxy (TMA, wgmma) before a barrier
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---------------------------------------------------------------- wgmma

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving accesses of registers that an in-flight
// wgmma reads or writes between the wgmma's start and its wait
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[i][e])::"memory");
}

// matrix descriptor of a 128-byte-swizzled operand at p
__device__ __forceinline__ uint64_t desc(const void* p, uint32_t lbo, uint32_t sbo) {
  const uint64_t a = smem_u32(p);
  return ((a & 0x3FFFF) >> 4) | (uint64_t)((lbo >> 4) & 0x3FFF) << 16 |
         (uint64_t)((sbo >> 4) & 0x3FFF) << 32 | 1ull << 62;
}

// k-step ks of a K-major tile of ROWS rows (regions ROWS x 128 bytes apart)
template <int ROWS>
__device__ __forceinline__ uint64_t desc_k(const unsigned char* tile, int ks) {
  return desc(tile + (ks / 4) * ROWS * ROW_BYTES + (ks % 4) * KSTEP_K, 16, GROUP);
}

// k-step kk (rows 16 kk ..) of an MN-major tile of ROWS rows
template <int ROWS>
__device__ __forceinline__ uint64_t desc_mn(const unsigned char* tile, int kk) {
  return desc(tile + kk * KSTEP_MN, ROWS * ROW_BYTES, GROUP);
}

// d (+)= A B^T, m64n32k16: A (64 x 16) and B (32 x 16) both K-major in
// shared memory (descriptors), d in the accumulator layout (16 floats)
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da, uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (+)= A B^T, m64n64k16: A (64 x 16) and B (64 x 16) both K-major in
// shared memory (descriptors), d in the accumulator layout (32 floats)
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += A B, m64n64k16: A (64 x 16) from registers in the accumulator-derived
// fragment layout, B (16 x 64) MN-major in shared memory (transposed)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// d += A B, m64n128k16: A (64 x 16) from registers in the accumulator-derived
// fragment layout, B (16 x 128) MN-major in shared memory (transposed)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// ---------------------------------------------------------------- math

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo: low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float ex2(float x) {  // 2^x; -inf gives 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// Philox4x32-10 as philox.cuh's on N counters at once: each round's
// 32 x 32 -> 64-bit products as one wide multiply, the N independent
// chains interleaved and the key schedule shared by them; the same words
template <int N>
__device__ __forceinline__ void philox_n(uint4 (&c)[N], uint2 k) {
  constexpr uint32_t M0 = 0xD2511F53u, M1 = 0xCD9E8D57u;
  constexpr uint32_t W0 = 0x9E3779B9u, W1 = 0xBB67AE85u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k.x += W0;
      k.y += W1;
    }
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const uint64_t p0 = (uint64_t)M0 * c[n].x, p1 = (uint64_t)M1 * c[n].z;
      c[n] = make_uint4((uint32_t)(p1 >> 32) ^ c[n].y ^ k.x, (uint32_t)p1,
                        (uint32_t)(p0 >> 32) ^ c[n].w ^ k.y, (uint32_t)p0);
    }
  }
}

__device__ __forceinline__ uint32_t keep_word_bits(uint4 w, uint32_t thr) {
  return (uint32_t)(w.x >= thr) | (uint32_t)(w.y >= thr) << 1 | (uint32_t)(w.z >= thr) << 2 |
         (uint32_t)(w.w >= thr) << 3;
}

// The keep bits of a tile, as flash_mma.cuh::keep_bits (query rows as
// accumulator rows, i0 the warp's first; NJ 8-key blocks from j0) or, with
// KV, keep_bits_kv (keys as rows, j0 the warp's first; NJ 8-query blocks
// from i0): the same Philox calls, one a lane and block, in groups of 4,
// each call's 4 bits packed at bits 4j .. 4j + 3 of one word (NJ <= 8).
template <int NJ, bool KV>
__device__ __forceinline__ uint32_t mask_word(uint2 key, int i0, int j0, int h, int b,
                                              uint32_t thr) {
  static_assert(NJ <= 8, "4 bits a block in one word");
  constexpr int G = NJ < 4 ? NJ : 4;
  const int lane = threadIdx.x & 31;
  uint32_t word = 0;
#pragma unroll
  for (int j = 0; j < NJ; j += G) {
    uint4 c[G];
#pragma unroll
    for (int n = 0; n < G; ++n)
      c[n] = KV ? make_uint4((uint32_t)(j0 + (lane & 15)),
                             (uint32_t)(((i0 + 8 * (j + n)) >> 2) + (lane >> 4)), (uint32_t)h,
                             (uint32_t)b)
                : make_uint4((uint32_t)(j0 + 8 * (j + n) + (lane & 7)),
                             (uint32_t)((i0 >> 2) + (lane >> 3)), (uint32_t)h, (uint32_t)b);
    philox_n(c, key);
#pragma unroll
    for (int n = 0; n < G; ++n) word |= keep_word_bits(c[n], thr) << (4 * (j + n));
  }
  return word;
}

// The packed words a lane takes its accumulator elements' bits from, in
// one round of shuffles a tile (every block of a tile has the same source
// lanes), each shifted so that bit 4j (and 4j + 1 in the kv layout) is
// the lane's: flash_mma.cuh::keep_scales' sources (rows g, g + 8 at keys
// 2t, 2t + 1: w[0..3]) and keep_scales_kv's (keys g, g + 8 at queries 2t,
// 2t + 1: w[0..1]).
template <bool KV>
__device__ __forceinline__ void keep_words(uint32_t word, uint32_t (&w)[4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  if (KV) {
    const int src = 16 * (t >> 1) + g, e = 2 * (t & 1);
    w[0] = __shfl_sync(0xffffffffu, word, src) >> e;
    w[1] = __shfl_sync(0xffffffffu, word, src + 8) >> e;
    w[2] = w[3] = 0;
  } else {
    const int src = 8 * (g >> 2) + 2 * t, e = g & 3;
    w[0] = __shfl_sync(0xffffffffu, word, src) >> e;
    w[1] = __shfl_sync(0xffffffffu, word, src + 1) >> e;
    w[2] = __shfl_sync(0xffffffffu, word, src + 16) >> e;
    w[3] = __shfl_sync(0xffffffffu, word, src + 17) >> e;
  }
}

// block j's keep scales m[e] for accumulator elements e (0 or sc), from
// keep_words: keep_scales' order {(g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8,
// 2t + 1)}, and keep_scales_kv's
template <bool KV>
__device__ __forceinline__ void keep_block(const uint32_t (&w)[4], int j, float sc,
                                           float (&m)[4]) {
  if (KV) {
    m[0] = (w[0] >> (4 * j)) & 1u ? sc : 0.0f;
    m[1] = (w[0] >> (4 * j + 1)) & 1u ? sc : 0.0f;
    m[2] = (w[1] >> (4 * j)) & 1u ? sc : 0.0f;
    m[3] = (w[1] >> (4 * j + 1)) & 1u ? sc : 0.0f;
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) m[e] = (w[e] >> (4 * j)) & 1u ? sc : 0.0f;
  }
}

// the A fragment of k-step kk from an accumulator (blocks 2kk, 2kk + 1),
// rounded to bf16 pairs
template <int R>
__device__ __forceinline__ void a_frag(uint32_t (&a)[4], const float (&s)[R], int kk) {
  a[0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
  a[1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
  a[2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
  a[3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
}

// rows r (the lane's row g of its warp) and r + 8 of an (n, dp) bf16 output
// from an m64nN accumulator over columns 0 .. N - 1, each row times its
// factor, rounded once; 4-byte pair stores (dp is even), columns past dp
// skipped
template <int R>
__device__ __forceinline__ void store_acc(bf16* __restrict__ dst, const float (&acc)[R], int r,
                                          int n, int dp, const float (&f)[2]) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    if (r + 8 * hf >= n) continue;
    bf16* row = dst + (size_t)(r + 8 * hf) * dp;
#pragma unroll
    for (int j = 0; j < R / 4; ++j) {
      const int c = 8 * j + 2 * t;
      if (c < dp)
        *reinterpret_cast<uint32_t*>(row + c) =
            pack_bf16(acc[4 * j + 2 * hf] * f[hf], acc[4 * j + 2 * hf + 1] * f[hf]);
    }
  }
}

// an m64nN accumulator, each row times its factor, rounded to bf16 into a
// 64-row tile of 128-byte swizzled regions (the layout TMA loads and
// stores): row r of the warpgroup, column c at region c / 64, 16-byte chunk
// (c % 64 / 8) ^ (r % 8); a warp's 4-byte writes fall in 32 distinct banks
template <int R>
__device__ __forceinline__ void acc_to_tile(unsigned char* tile, const float (&acc)[R],
                                            const float (&f)[2]) {
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = 16 * warp + g + 8 * hf;
#pragma unroll
    for (int j = 0; j < R / 4; ++j) {
      unsigned char* dst = tile + (j / 8) * 64 * ROW_BYTES + r * ROW_BYTES +
                           (((j % 8) ^ (r & 7)) << 4) + 4 * t;
      *reinterpret_cast<uint32_t*>(dst) =
          pack_bf16(acc[4 * j + 2 * hf] * f[hf], acc[4 * j + 2 * hf + 1] * f[hf]);
    }
  }
}

// ---------------------------------------------------------------- host

// the (B H, T, Dp) bf16 tensor at ptr as a 3-d tensor map with (64, rows, 1)
// boxes and the 128-byte swizzle; Dp % 8 == 0 and ptr 16-byte aligned (the
// wrapper pads and copies where they are not).  cuTensorMapEncodeTiled is
// looked up through the runtime (cudaGetDriverEntryPointByVersion), so
// nothing links against libcuda.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline cudaError_t encode_fn(EncodeTiledFn* fn) {
  static EncodeTiledFn cached = nullptr;
  if (cached == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || p == nullptr) return cudaErrorNotSupported;
    cached = reinterpret_cast<EncodeTiledFn>(p);
  }
  *fn = cached;
  return cudaSuccess;
}

inline cudaError_t make_map(CUtensorMap* map, const void* ptr, int slabs, int t, int dp, int rows) {
  EncodeTiledFn fn;
  const cudaError_t err = encode_fn(&fn);
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[3] = {(cuuint64_t)dp, (cuuint64_t)t, (cuuint64_t)slabs};
  const cuuint64_t strides[2] = {(cuuint64_t)dp * 2, (cuuint64_t)t * dp * 2};
  const cuuint32_t box[3] = {(cuuint32_t)REGION, (cuuint32_t)rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace flash_wgmma
