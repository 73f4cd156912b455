// Float32 tiles of the kv-major dK / dV pass (flash_bwd.cu), the one flash
// kernel still on the CUDA cores.
//
// A CTA of 256 threads works on 64 x 64 tiles of (query row, key).  Thread
// (tx, ty) = (tid % 16, tid / 16) owns query rows 4ty .. 4ty + 3 of a
// score tile and keys tx + 16c, c = 0..3, and, of a (64, D) output tile,
// rows (or keys) 4ty .. 4ty + 3 and head-dim columns 4tx + 64g.  Operand
// tiles sit row-major in shared memory with a row stride of DP + 4 floats,
// so the 16 key rows a half-warp reads at one column fall into distinct
// bank groups, and the float4 reads of the 4 rows of a thread broadcast.
// DP is the head dim padded to 64 or 128; the padding is zero-filled.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace flash {

constexpr int NT = 256;       // threads per CTA
constexpr int TQ = 64;        // query rows per tile
constexpr int TK = 64;        // keys per tile
constexpr int SS = TK + 4;    // row stride of a score tile in shared memory

// rows [r0, r0 + 64) of a (n, d) row-major matrix into a (64, DP) tile with
// row stride DP + 4; zeros past n rows and d columns
template <int DP>
__device__ __forceinline__ void load_tile(float* __restrict__ dst,
                                          const float* __restrict__ src,
                                          int r0, int n, int d) {
  constexpr int RS = DP + 4;
  for (int e = threadIdx.x; e < 64 * DP; e += NT) {
    const int r = e / DP, c = e % DP;
    dst[r * RS + c] =
        (r0 + r < n && c < d) ? __ldg(src + (size_t)(r0 + r) * d + c) : 0.0f;
  }
}

// out[i][c] = sum over the head dim of a[4ty + i][.] * bt[tx + 16c][.]
template <int DP>
__device__ __forceinline__ void tile_dot(const float* __restrict__ a,
                                         const float* __restrict__ bt, int tx,
                                         int ty, float (&out)[4][4]) {
  constexpr int RS = DP + 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) out[i][c] = 0.0f;
#pragma unroll 4
  for (int x = 0; x < DP; x += 4) {
    float4 av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      av[i] = *reinterpret_cast<const float4*>(a + (4 * ty + i) * RS + x);
#pragma unroll
    for (int c = 0; c < 4; ++c)
      bv[c] = *reinterpret_cast<const float4*>(bt + (tx + 16 * c) * RS + x);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        out[i][c] += av[i].x * bv[c].x + av[i].y * bv[c].y +
                     av[i].z * bv[c].z + av[i].w * bv[c].w;
  }
}

// acc[i][4g + e] += sum over 64 r of w[r][4ty + i] * x[r][4tx + 64g + e]:
// w a (64, SS) score tile read along its columns, x a (64, DP) operand tile
template <int DP>
__device__ __forceinline__ void tile_tn(const float* __restrict__ w,
                                        const float* __restrict__ x, int tx,
                                        int ty, float (&acc)[4][DP / 16]) {
  constexpr int RS = DP + 4;
#pragma unroll 4
  for (int r = 0; r < 64; ++r) {
    const float4 wv = *reinterpret_cast<const float4*>(w + r * SS + 4 * ty);
    const float wr[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
    for (int g = 0; g < DP / 64; ++g) {
      const float4 xv =
          *reinterpret_cast<const float4*>(x + r * RS + 4 * tx + 64 * g);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[i][4 * g + 0] += wr[i] * xv.x;
        acc[i][4 * g + 1] += wr[i] * xv.y;
        acc[i][4 * g + 2] += wr[i] * xv.z;
        acc[i][4 * g + 3] += wr[i] * xv.w;
      }
    }
  }
}

// rows 4ty + i of a (n, d) output from acc, columns 4tx + 64g + e < d
template <int DP>
__device__ __forceinline__ void store_rows(float* __restrict__ dst,
                                           const float (&acc)[4][DP / 16],
                                           int r0, int n, int d, int tx,
                                           int ty) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + 4 * ty + i;
    if (r >= n) continue;
    float* row = dst + (size_t)r * d;
#pragma unroll
    for (int g = 0; g < DP / 64; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 4 * tx + 64 * g + e;
        if (c < d) row[c] = acc[i][4 * g + e];
      }
  }
}

// the (TK) key biases of keys [k0, k0 + TK): bias[b][k], 0 without a bias,
// -inf past tk (a key outside the sequence gets no probability)
__device__ __forceinline__ void load_key_bias(float* __restrict__ kb,
                                              const float* __restrict__ bias,
                                              int b, int k0, int tk) {
  for (int j = threadIdx.x; j < TK; j += NT) {
    const int key = k0 + j;
    kb[j] = key >= tk ? -INFINITY
                      : (bias ? __ldg(bias + (size_t)b * tk + key) : 0.0f);
  }
}

}  // namespace flash
