// The state tile loader of the first 2-layer training forward design,
// which the GRU's legacy form (gru2_train_fwd_legacy.cu) keeps.
//
// A CTA of NW warps copies rows [bt0, bt0 + nb) (nb <= 32) of a state
// series into a (32, H + 1) tile in shared memory; the odd row stride puts
// the 32 rows of one column in distinct banks.  The lanes of a warp take
// consecutive float4 columns of one row and warp w takes rows w, w + NW, ..,
// so each load reads 512 contiguous bytes whatever the row stride: H for the
// (B, H) keep mask, 10H or 12H for the h lanes of the packed rows.  On the
// H100 this took the legacy LSTM forward's phase from 15.5 us (a row per
// lane, 16-byte loads 4H bytes or more apart) to 10.0 us.  H must be a
// multiple of 4; src == nullptr loads the zero state.

#pragma once

#include <cuda_runtime.h>

namespace state_tile {

// LOADS float4 loads are in flight per thread before their stores
template <int NW, int LOADS>
__device__ __forceinline__ void load_rows(const float* src, float* tile, int bt0,
                                          int nb, int H, int stride, int lane,
                                          int warp) {
  const int h4 = H / 4;
  const int per_row = (h4 + 31) / 32;  // float4 per lane and row
  const int total = (nb - warp + NW - 1) / NW * per_row;
  for (int e0 = 0; e0 < total; e0 += LOADS) {
    float4 v[LOADS];
#pragma unroll
    for (int u = 0; u < LOADS; ++u) {
      const int e = e0 + u, r = warp + NW * (e / per_row), q = lane + 32 * (e % per_row);
      v[u] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (src != nullptr && e < total && q < h4)
        v[u] = __ldcg(reinterpret_cast<const float4*>(src + (size_t)(bt0 + r) * stride) + q);
    }
#pragma unroll
    for (int u = 0; u < LOADS; ++u) {
      const int e = e0 + u, r = warp + NW * (e / per_row), q = lane + 32 * (e % per_row);
      if (e < total && q < h4) {
        float* d = tile + r * (H + 1) + 4 * q;
        d[0] = v[u].x; d[1] = v[u].y; d[2] = v[u].z; d[3] = v[u].w;
      }
    }
  }
}

}  // namespace state_tile
