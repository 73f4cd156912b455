// Tensor-core tile core of the flash kernels on mma.sync: the q-major pair
// (flash_fwd.cu, flash_bwd_dq.cu) and the kv-major fused backward
// (flash_bwd_fused.cu, whose warps own keys instead of query rows and
// stage query tiles instead of key tiles; its own index maps are the _kv
// and _cols variants below).  3xTF32 products, cp.async-staged tiles.  The
// bf16 forms run on flash_wgmma.cuh, which takes the quad reductions (and
// philox.cuh) from here.
//
// A CTA of NW warps takes 16 NW query rows; warp w owns rows 16w .. 16w + 15,
// so a row's statistics (max, sum, LSE, Delta) stay inside the warp: lane
// (g, t) = (lane / 4, lane % 4) of an m16n8 fragment holds rows g and g + 8,
// and a row's values sit in the 4 lanes of one quad (shuffle reductions).
//
// Products: mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32.  Each
// float32 operand is split as big = tf32(x), small = tf32(x - big) (cvt.rna:
// round to nearest, ties away), and a product is three MMAs, small*big,
// big*small and big*big, into float32 accumulators; small*small (~2^-22 of
// the product) is dropped.  big + small holds x to ~2^-24, so the products
// keep float32 accuracy where one TF32 pass keeps ~3 digits.
//
// Operands.  The A operand of A B^T (Q; Q and dO) is split once per CTA:
// held in registers, or half or all of it in shared memory where registers
// run short (AFrags).  K and V tiles arrive by cp.async (16-byte .cg where
// the head dim is a multiple of 4 and the pointers 16-byte aligned, 4-byte
// .ca otherwise; zero-filled past the matrix) into a ring of two stages, so
// key tile t + 1 is in flight while tile t is multiplied; each thread splits
// the elements it copied once they land (split_tile), so every K / V value is
// split once per CTA, not once per warp.  Tiles sit row-major with a row
// stride of DP + 4 words (DP the head dim padded to 64 or 128), the small
// halves one matrix after the big ones.  Two reads, both free of bank
// conflicts at that stride:
//   * A B^T (S = Q K^T, dP = dO V^T): one ldmatrix.x4 gives a lane its B
//     words of an (8-key, k-step) block, big and small (mma_abt);
//   * P B (O += P V, dQ += dS K), P in score accumulator layout: the
//     product's k order is permuted so that the accumulator fragment IS the
//     A fragment (k column t of step j is key 8j + 2t, column t + 4 key
//     8j + 2t + 1) and its n order so that one 16-byte read serves four
//     n-tiles (n column c of output tile 4m + e is head dim 32m + 4c + e):
//     P never goes through shared memory or a shuffle (mma_pb), and a lane's
//     outputs are runs of 4 consecutive head dims (store_rows).

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "philox.cuh"

namespace flash_mma {

constexpr int STAGES = 2;  // key tiles in the cp.async ring

// ---------------------------------------------------------------- 3xTF32

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = big + small, both TF32
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = tf32(x);
  small = tf32(x - __uint_as_float(big));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b in 3xTF32, both operands given split
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ab)[4],
                                     const uint32_t (&as)[4],
                                     const uint32_t (&bb)[2],
                                     const uint32_t (&bs)[2]) {
  mma_tf32(d, as, bb[0], bb[1]);
  mma_tf32(d, ab, bs[0], bs[1]);
  mma_tf32(d, ab, bb[0], bb[1]);
}

// ---------------------------------------------------------------- staging

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool in) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool in) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows [r0, r0 + ROWS) of a (n, d) row-major matrix into a (ROWS, DP) tile
// with row stride DP + 4, zeros past n rows and d columns; vec: d % 4 == 0
// and src 16-byte aligned.  A thread copies column chunk c of rows r,
// r + RP, ... (split_tile walks the same elements).
template <int DP, int ROWS, int NT>
__device__ __forceinline__ void load_tile(float* __restrict__ dst,
                                          const float* __restrict__ src,
                                          int r0, int n, int d, bool vec) {
  constexpr int RS = DP + 4;
  if (vec) {
    constexpr int CH = DP / 4, RP = NT / CH;
    static_assert(ROWS % RP == 0, "a tile is a whole number of passes");
    const int r = threadIdx.x / CH, c = 4 * (threadIdx.x % CH);
    const float* s = src + (size_t)(r0 + r) * d + c;
    float* t = dst + r * RS + c;
#pragma unroll
    for (int i = 0; i < ROWS / RP; ++i) {
      const bool in = c < d && r0 + r + RP * i < n;
      cp_async16(t + RP * RS * i, in ? s : src, in);
      s += (size_t)RP * d;
    }
  } else {
    for (int e = threadIdx.x; e < ROWS * DP; e += NT) {
      const int r = e / DP, c = e % DP;
      const bool in = r0 + r < n && c < d;
      cp_async4(dst + r * RS + c, in ? src + (size_t)(r0 + r) * d + c : src,
                in);
    }
  }
}

// keys [k0, k0 + n) of one batch row's (tk) bias
template <int NT>
__device__ __forceinline__ void load_bias(float* __restrict__ dst,
                                          const float* __restrict__ bias,
                                          int k0, int n, int tk) {
  for (int j = threadIdx.x; j < n; j += NT) {
    const bool in = k0 + j < tk;
    cp_async4(dst + j, in ? bias + k0 + j : bias, in);
  }
}

// A key tile's ring stage: K's big and small halves, V's, each (TK, RS),
// then the TK key biases
template <int DP, int TK>
struct Stage {
  static constexpr int RS = DP + 4;
  static constexpr int MAT = TK * RS;
  static constexpr int V = 2 * MAT;
  static constexpr int BIAS = 4 * MAT;
  static constexpr int FLOATS = BIAS + TK;
};

// split the elements of a staged (ROWS, DP) tile that this thread copied
// (load_tile's partition), once its copies have landed: big in place,
// small ROWS x RS words on
template <int DP, int ROWS, int NT>
__device__ __forceinline__ void split_tile(float* tile, int d, bool vec) {
  constexpr int RS = DP + 4, MAT = ROWS * RS;
  uint32_t* bt = reinterpret_cast<uint32_t*>(tile);
  if (vec) {
    constexpr int CH = DP / 4, RP = NT / CH;
    const int o0 = (threadIdx.x / CH) * RS + 4 * (threadIdx.x % CH);
#pragma unroll
    for (int i = 0; i < ROWS / RP; ++i) {
      const int o = o0 + RP * RS * i;
      const float4 x = *reinterpret_cast<const float4*>(tile + o);
      uint4 b, sm;
      split(x.x, b.x, sm.x);
      split(x.y, b.y, sm.y);
      split(x.z, b.z, sm.z);
      split(x.w, b.w, sm.w);
      *reinterpret_cast<uint4*>(bt + o) = b;
      *reinterpret_cast<uint4*>(bt + MAT + o) = sm;
    }
  } else {
    for (int e = threadIdx.x; e < ROWS * DP; e += NT) {
      const int o = (e / DP) * RS + e % DP;
      uint32_t b, sm;
      split(tile[o], b, sm);
      bt[o] = b;
      bt[MAT + o] = sm;
    }
  }
}

// ---------------------------------------------------------------- operands

// four 8 x 4 matrices of 32-bit words from shared memory: lane 8i + r gives
// the address of row r of matrix i; lane (g, t) gets word t of row g of each
// (ldmatrix's 8 x 8 16-bit layout read as 32-bit words)
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

enum AMode { kRegs = 0, kHalf = 1, kShared = 2 };

// The A operand of A B^T: the warp's 16 rows of a staged (16 NW, DP) tile,
// split once.  kRegs: big and small in registers (DP / 2 words each);
// kHalf: big in registers, small written back over the staged floats;
// kShared: the CTA splits the tile in place (big over the staged floats,
// small in the 16 NW x RS words after them).  A half in shared memory is
// read with one ldmatrix.x4 per k-step (matrices rows 0-7 and 8-15 of
// columns 8ks .. + 3, then of + 4 .. + 7: the fragment's order), which
// reads other lanes' writes: outside kRegs the caller syncs before get().
template <int DP, int MODE, int NW>
struct AFrags {
  static constexpr int NT = 32 * NW, TQ = 16 * NW, RS = DP + 4;
  static constexpr bool BIG_REGS = MODE != kShared;
  static constexpr bool SMALL_REGS = MODE == kRegs;
  uint32_t big[BIG_REGS ? DP / 8 : 1][4], small[SMALL_REGS ? DP / 8 : 1][4];
  const uint32_t* bp;  // this lane's ldmatrix row address, k-step 0
  const uint32_t* sp;

  // word i of the A fragment at k-step ks: rows g, g + 8, columns t, t + 4
  __device__ __forceinline__ static int off(int ks, int i) {
    return (i & 1) * 8 * RS + 8 * ks + (i >> 1) * 4;
  }

  __device__ __forceinline__ void init(float* tile) {
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    uint32_t* words = reinterpret_cast<uint32_t*>(tile);
    // ldmatrix: lane 8i + r addresses row r (+ 8 for odd i) at column 4 (i / 2)
    const int lm = (16 * w + (lane & 7) + 8 * ((lane >> 3) & 1)) * RS +
                   4 * (lane >> 4);
    if (MODE == kShared) {
      for (int e = threadIdx.x; e < TQ * RS; e += NT) {
        uint32_t b, sm;
        split(tile[e], b, sm);
        words[e] = b;
        words[TQ * RS + e] = sm;
      }
      bp = words + lm;
      sp = words + TQ * RS + lm;
      return;
    }
    const int r = (16 * w + (lane >> 2)) * RS + (lane & 3);
#pragma unroll
    for (int ks = 0; ks < DP / 8; ++ks)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        uint32_t b, sm;
        split(tile[r + off(ks, i)], b, sm);
        big[BIG_REGS ? ks : 0][i] = b;
        if (SMALL_REGS)
          small[ks][i] = sm;
        else
          words[r + off(ks, i)] = sm;
      }
    sp = words + lm;
  }

  __device__ __forceinline__ void get(int ks, uint32_t (&b)[4],
                                      uint32_t (&s)[4]) const {
    if (BIG_REGS) {
#pragma unroll
      for (int i = 0; i < 4; ++i) b[i] = big[BIG_REGS ? ks : 0][i];
    } else {
      ldsm_x4(b, bp + 8 * ks);
    }
    if (SMALL_REGS) {
#pragma unroll
      for (int i = 0; i < 4; ++i) s[i] = small[SMALL_REGS ? ks : 0][i];
    } else {
      ldsm_x4(s, sp + 8 * ks);
    }
  }
};

// shared-memory floats of `tiles` A operands; kRegs's are dead once init()
// is done, so the ring may reuse them
template <int DP, int MODE, int NW>
__host__ __device__ constexpr int a_floats(int tiles) {
  return (MODE == kShared ? 2 : 1) * tiles * 16 * NW * (DP + 4);
}

// one k-step of s[j] = a x (rows 8j .. 8j + 7 of the split (8 NJ, DP) tile
// bt)^T: ldmatrix matrices big columns 8ks .. + 3 and + 4 .. + 7, then
// small's, from the lane's offset lo (mma_abt's)
template <int DP, int NJ, int MAT, class A>
__device__ __forceinline__ void abt_step(const A& a, const float* bt, int ks, int lo,
                                         float (&s)[NJ][4]) {
  constexpr int RS = DP + 4;
  uint32_t ab[4], as[4];
  a.get(ks, ab, as);
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    uint32_t f[4];
    ldsm_x4(f, reinterpret_cast<const uint32_t*>(bt) + lo + 8 * j * RS + 8 * ks);
    const uint32_t bb[2] = {f[0], f[1]}, bs[2] = {f[2], f[3]};
    mma3(s[j], ab, as, bb, bs);
  }
}

// s[i][j] = a_i x (rows 8j .. 8j + 7 of the split (8 NJ, DP) tile bt[i])^T
// for each of the products at once (a_i of any AFrags kind: the kv-major
// kernel's K in shared memory and V in registers): the products'
// accumulators are independent chains, so two products in one walk (S and
// dP) keep more MMAs in flight than one after the other
template <int DP, int NJ, int MAT, class... A>
__device__ __forceinline__ void mma_abt(float (&s)[sizeof...(A)][NJ][4],
                                        const float* const (&bt)[sizeof...(A)],
                                        const A&... a) {
#pragma unroll
  for (int i = 0; i < (int)sizeof...(A); ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][j][e] = 0.0f;
  const int lane = threadIdx.x & 31;
  const int lo = (lane & 7) * (DP + 4) + 4 * ((lane >> 3) & 1) + (lane >> 4) * MAT;
#pragma unroll
  for (int ks = 0; ks < DP / 8; ++ks) {
    int i = 0;
    ((abt_step<DP, NJ, MAT>(a, bt[i], ks, lo, s[i]), ++i), ...);
  }
}

// acc += P x over MN of the head dim's 32-wide blocks from block m0 (the
// split (8 NJ, DP) tile x), P (16 x 8 NJ) in accumulator layout: p[j] =
// rows g, g + 8 at keys 8j + 2t, 8j + 2t + 1.  Output tile 4 mm + e, n
// column c is head dim 32 (m0 + mm) + 4c + e.
template <int DP, int NJ, int MAT, int MN>
__device__ __forceinline__ void mma_pb_cols(const float (&p)[NJ][4],
                                            const float* __restrict__ x, int m0,
                                            float (&acc)[4 * MN][4]) {
  constexpr int RS = DP + 4;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const uint32_t* u = reinterpret_cast<const uint32_t*>(x);
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    uint32_t ab[4], as[4];
    split(p[j][0], ab[0], as[0]);
    split(p[j][2], ab[1], as[1]);
    split(p[j][1], ab[2], as[2]);
    split(p[j][3], ab[3], as[3]);
    const int o = (8 * j + 2 * t) * RS + 4 * g + 32 * m0;
#pragma unroll
    for (int mm = 0; mm < MN; ++mm) {
      // keys 8j + 2t (r = 0) and 8j + 2t + 1 (r = 1), dims 32m + 4g .. + 3
      uint4 b[2], s[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        b[r] = *reinterpret_cast<const uint4*>(u + o + r * RS + 32 * mm);
        s[r] = *reinterpret_cast<const uint4*>(u + MAT + o + r * RS + 32 * mm);
      }
      const uint32_t bb[4][2] = {{b[0].x, b[1].x}, {b[0].y, b[1].y},
                                 {b[0].z, b[1].z}, {b[0].w, b[1].w}};
      const uint32_t bs[4][2] = {{s[0].x, s[1].x}, {s[0].y, s[1].y},
                                 {s[0].z, s[1].z}, {s[0].w, s[1].w}};
#pragma unroll
      for (int e = 0; e < 4; ++e) mma3(acc[4 * mm + e], ab, as, bb[e], bs[e]);
    }
  }
}

// acc += P x over the whole head dim.  Output tile 4m + e, n column c is
// head dim 32m + 4c + e.
template <int DP, int NJ, int MAT>
__device__ __forceinline__ void mma_pb(const float (&p)[NJ][4],
                                       const float* __restrict__ x,
                                       float (&acc)[DP / 8][4]) {
  mma_pb_cols<DP, NJ, MAT, DP / 32>(p, x, 0, acc);
}

// rows r (the lane's row g) and r + 8 of a (n, d) output from
// mma_pb_cols's acc over MN blocks from m0, each times its factor, stored
// or, with add, added to what is there: tile 4 mm + e gives dims
// 32 (m0 + mm) + 8t + e (and + 4); vec: d % 4 == 0 and dst 16-byte aligned
template <int MN>
__device__ __forceinline__ void store_rows_cols(float* __restrict__ dst,
                                                const float (&acc)[4 * MN][4], int r,
                                                int n, int d, int m0, const float (&f)[2],
                                                bool vec, bool add) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    if (r + 8 * hf >= n) continue;
    float* row = dst + (size_t)(r + 8 * hf) * d;
#pragma unroll
    for (int mm = 0; mm < MN; ++mm)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int c = 32 * (m0 + mm) + 8 * t + 4 * half;
        float x[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) x[e] = acc[4 * mm + e][2 * hf + half] * f[hf];
        if (vec && c < d) {
          float4* o = reinterpret_cast<float4*>(row + c);
          if (add) {
            const float4 y = *o;
            x[0] += y.x;
            x[1] += y.y;
            x[2] += y.z;
            x[3] += y.w;
          }
          *o = make_float4(x[0], x[1], x[2], x[3]);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (c + e < d) row[c + e] = add ? row[c + e] + x[e] : x[e];
        }
      }
  }
}

// rows r and r + 8 of a (n, d) output from mma_pb's acc, each times its
// factor: tile 4m + e gives dims 32m + 8t + e (and + 4)
template <int DP>
__device__ __forceinline__ void store_rows(float* __restrict__ dst,
                                           const float (&acc)[DP / 8][4],
                                           int r, int n, int d,
                                           const float (&f)[2], bool vec) {
  store_rows_cols<DP / 32>(dst, acc, r, n, d, 0, f, vec, false);
}

// ---------------------------------------------------------------- rows

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// The dropout mask of an n-tile's accumulator fragment (rows g, g + 8 of
// the warp's rows from i0, keys j0 + 2t, + 1), in two steps so that the
// Philox work can be scheduled ahead, among the products.  keep_bits: the warp
// makes the tile's 32 Philox calls (4 four-row groups x 8 keys), one per
// lane, and packs each call's 4 keep bits; keep_scales hands them out by
// shuffle as 0 or 1 / (1 - rate).  The mask is philox.cuh's, a pure function
// of the coordinates.
__device__ __forceinline__ uint32_t keep_bits(uint2 key, int i0, int j0, int h,
                                              int b, uint32_t thr) {
  const int lane = threadIdx.x & 31;
  const uint4 w = flash::philox4x32_10(
      make_uint4((uint32_t)(j0 + (lane & 7)), (uint32_t)((i0 >> 2) + (lane >> 3)),
                 (uint32_t)h, (uint32_t)b),
      key);
  return (uint32_t)(w.x >= thr) | (uint32_t)(w.y >= thr) << 1 |
         (uint32_t)(w.z >= thr) << 2 | (uint32_t)(w.w >= thr) << 3;
}

__device__ __forceinline__ void keep_scales(uint32_t bits, float sc,
                                            float (&m)[4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int src = 8 * (g >> 2) + 2 * t, e = g & 3;
  // rows g (group g / 4) and g + 8 (group g / 4 + 2: 16 lanes on)
  const uint32_t k00 = __shfl_sync(0xffffffffu, bits, src);
  const uint32_t k01 = __shfl_sync(0xffffffffu, bits, src + 1);
  const uint32_t k10 = __shfl_sync(0xffffffffu, bits, src + 16);
  const uint32_t k11 = __shfl_sync(0xffffffffu, bits, src + 17);
  m[0] = (k00 >> e & 1u) ? sc : 0.0f;
  m[1] = (k01 >> e & 1u) ? sc : 0.0f;
  m[2] = (k10 >> e & 1u) ? sc : 0.0f;
  m[3] = (k11 >> e & 1u) ? sc : 0.0f;
}

// The kv-major form of the two (flash_bwd_fused.cu), where an accumulator
// fragment holds keys (rows g, g + 8 of the warp's 16 from j0) by queries
// (n columns 2t, 2t + 1 of an 8-query tile from i0, a multiple of 4):
// keep_bits_kv: the warp makes the tile's 32 Philox calls (16 keys x 2
// four-query groups), lane L the call of key j0 + L % 16 and group i0 / 4 +
// L / 16, and packs its 4 keep bits; keep_scales_kv hands lane (g, t) the
// bits of its two keys in its group t / 2, words 2 (t % 2) and + 1, as
// m = {(g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1)}.
__device__ __forceinline__ uint32_t keep_bits_kv(uint2 key, int i0, int j0, int h,
                                                 int b, uint32_t thr) {
  const int lane = threadIdx.x & 31;
  const uint4 w = flash::philox4x32_10(
      make_uint4((uint32_t)(j0 + (lane & 15)), (uint32_t)((i0 >> 2) + (lane >> 4)),
                 (uint32_t)h, (uint32_t)b),
      key);
  return (uint32_t)(w.x >= thr) | (uint32_t)(w.y >= thr) << 1 |
         (uint32_t)(w.z >= thr) << 2 | (uint32_t)(w.w >= thr) << 3;
}

__device__ __forceinline__ void keep_scales_kv(uint32_t bits, float sc, float (&m)[4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int src = 16 * (t >> 1) + g, e = 2 * (t & 1);
  const uint32_t k0 = __shfl_sync(0xffffffffu, bits, src);      // key g
  const uint32_t k1 = __shfl_sync(0xffffffffu, bits, src + 8);  // key g + 8
  m[0] = (k0 >> e & 1u) ? sc : 0.0f;
  m[1] = (k0 >> (e + 1) & 1u) ? sc : 0.0f;
  m[2] = (k1 >> e & 1u) ? sc : 0.0f;
  m[3] = (k1 >> (e + 1) & 1u) ? sc : 0.0f;
}

// 16-byte alignment of a pointer (a null one passes)
__host__ __forceinline__ bool aligned16(const void* p) {
  return ((uintptr_t)p & 15u) == 0;
}

}  // namespace flash_mma
