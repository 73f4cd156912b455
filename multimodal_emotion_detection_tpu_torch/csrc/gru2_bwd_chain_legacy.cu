// 2-layer GRU reverse chain in the legacy layout for Hopper (sm_90a): the
// first design of the 2-layer chain, kept for this form.
//
// Replaces: multimodal_emotion_detection_tpu/ops/lstm_kernel.py::
// gru2_bwd_chain_pallas (kernel body _gru2_bwd_kernel, per-step math
// _gru_cell_bwd_k).  Same function as the plain PyTorch version
// ops/lstm_kernel.py::gru2_bwd_chain_legacy_reference: over the older
// layout's residuals res0, res1 (T, B, 5H) = [h_prev | r | z | n | hn], the
// keep mask (T, B, H), where one is given the sequence output's cotangent
// dys (T, B, H; without it the stream is not read) and the cotangent of
// layer 1's final hidden state dh_final (B, H), walk t = T-1 .. 0 with
// carries dh1 (dh_final at the start) and dh0 (zero):
//
//   (dih1, dhn1, dd1) = cell_bwd(dh1 + dys[t], h1p[t], r1, z1, n1, hn1)
//   dh1 = dd1 + [dih1[:, :2H] | dhn1] @ w_hh1^T ;  dx1 = dih1 @ w_ih1^T
//   (dih0, dhn0, dd0) = cell_bwd(dh0 + dx1 * keep[t], h0p[t], r0, ..)
//   dh0 = dd0 + [dih0[:, :2H] | dhn0] @ w_hh0^T
//
// cell_bwd(dh, h_prev, r, z, n, hn): dn_pre = dh (1 - z)(1 - n^2),
// dr_pre = dn_pre hn r (1 - r), dz_pre = dh (h_prev - n) z (1 - z),
// dih = [dr_pre | dz_pre | dn_pre], dhn = dn_pre r, dd = dh z.  It writes,
// as the TPU kernel does, the full dhh: out (T, B, 12H) = [dih0 | dhh0 |
// dih1 | dhh1], whose r and z lanes of dhh are copies of dih's.  The
// hoisted weight gradients are plain matrix products outside
// (ops/lstm_vjp.py).  The residual-native chain (row 15) is
// gru2_bwd_chain.cu, on the 2-layer core rnn2_bwd_chain.cuh.
//
// What bounds it on the H100: the serial chain.  At the GRU config's shape
// (B=32, T=372, H=256) the three products per step are 14.0 GFLOP and the
// streams 283 MB (~0.21 ms at 67 TFLOP/s), but each step needs the whole
// dhh / dih row of the step before, so T+1 device-wide exchanges set the
// time.
//
// Design: lstm2_bwd_chain.cu's first one.  The forward's partition of
// hidden units over a cooperative grid, transposed: dh[b][j] = sum_m
// dhh[b][m] W[j][m] runs over all 3H gate columns, which every CTA produces
// a slice of, so each CTA keeps its UPC rows j of w_hh1, w_ih1 and w_hh0
// (3H wide; 18 KB at H=256, UPC=2) in shared memory and, every phase, reads
// the whole dih1 / dhh1 / dih0 / dhh0 rows of the phase before from the
// output itself (the exchange; through L2, ld.cg): a float4 column c <
// 2H/4 of dih serves both dhh and dih, a column past it takes dhh's from
// the dhn lane.  Warp w takes batch rows w, w+8, ..; a lane takes float4
// columns of the row, so a warp's loads are contiguous, and the partial
// dot products meet by shuffles.  The layers are wavefronted in reverse:
// phase q runs layer 1 at step T-1-q and layer 0 at step T-q, which
// consumes dx1 from layer 1's dih1 of the phase before; one grid barrier
// per phase, T+1 in all.  The direct parts dd = dh z stay in the CTA, with
// the thread that owns the (row, unit).  The cell threads load their
// residuals before the products, to hide that latency.  Exactly T steps
// run; any B >= 1.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 256;           // threads per CTA
constexpr int NW = NT / 32;       // warps
constexpr int ROWS = 32;          // batch rows per pass
constexpr int RPW = ROWS / NW;    // rows per warp and pass
constexpr int LOADS = 6;          // float4 loads in flight per array and thread
constexpr int kUnsupported = -1;  // shape the kernel does not take

__device__ __forceinline__ float dot4(const float4 a, const float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

// one step of the GRU cell backward for one (row, unit): dh, h_prev and
// the activations a[4] = {r, z, n, hn} -> d[4] = {dr_pre, dz_pre, dn_pre,
// dhn}; returns the direct part dh * z of dh_prev
__device__ __forceinline__ float cell_bwd(float dh, float h_prev,
                                          const float* a, float* d) {
  const float r = a[0], z = a[1], n = a[2], hn = a[3];
  const float dn_pre = dh * (1.0f - z) * (1.0f - n * n);
  d[0] = dn_pre * hn * r * (1.0f - r);
  d[1] = dh * (h_prev - n) * z * (1.0f - z);
  d[2] = dn_pre;
  d[3] = dn_pre * r;
  return dh * z;
}

// res_l (T, B, 5H) = [h_prev | r | z | n | hn]; dih_l, dhh_l = [dr | dz |
// dhn] and so dhn_l at lanes 6H*l, 6H*l + 3H and 6H*l + 5H of the (T, B,
// 12H) out rows
template <int UPC>
__global__ void __launch_bounds__(NT) gru2_bwd_chain_kernel(
    const float* __restrict__ act0,      // (T, B, .) layer 0's r, z, n, hn
    const float* __restrict__ act1,      // (T, B, .) layer 1's
    const float* __restrict__ h0p,       // (T, B, .) layer 0's h_prev
    const float* __restrict__ h1p,       // (T, B, .) layer 1's
    const float* __restrict__ dys,       // (T, B, H) or null
    const float* __restrict__ keep,      // (T, B, H)
    const float* __restrict__ dh_final,  // (B, H)
    const float* __restrict__ w_hh0,     // (H, 3H)
    const float* __restrict__ w_hh1,     // (H, 3H)
    const float* __restrict__ w_ih1,     // (H, 3H)
    float* dih0,                         // (T, B, .) out, also the exchange
    float* dhn0,                         // (T, B, .) out, also the exchange
    float* dih1,                         // (T, B, .) out, also the exchange
    float* dhn1,                         // (T, B, .) out, also the exchange
    int batch, int t_len, int hidden) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) float smem[];
  const int H = hidden;
  const int H3 = 3 * H;
  const int AS = 5 * H;   // row strides: activations,
  const int HS = 5 * H;   // h_prev,
  const int IS = 12 * H;  // dih,
  const int NS = 12 * H;  // dhn
  // wr[(m*UPC + u)*3H + col] = W_m[j0 + u][col]; m: 0 w_hh1, 1 w_ih1, 2 w_hh0
  float* wr = smem;                     // 3 * UPC * 3H
  float* red = wr + 3 * UPC * H3;       // ROWS * UPC * 3 reduced products
  float* dd0s = red + ROWS * UPC * 3;   // batch * UPC direct parts, layer 0
  float* dd1s = dd0s + batch * UPC;     // batch * UPC direct parts, layer 1

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int j0 = blockIdx.x * UPC;
  const size_t BH = (size_t)batch * H;
  const size_t BI = (size_t)batch * IS;
  const size_t BN = (size_t)batch * NS;

  for (int i = tid; i < UPC * H3; i += NT) {
    const int u = i / H3, col = i % H3;
    const size_t src = (size_t)(j0 + u) * H3 + col;
    wr[(0 * UPC + u) * H3 + col] = w_hh1[src];
    wr[(1 * UPC + u) * H3 + col] = w_ih1[src];
    wr[(2 * UPC + u) * H3 + col] = w_hh0[src];
  }
  // layer 1's carry starts as dh_final (its products are zero in phase 0)
  for (int i = tid; i < batch * UPC; i += NT) {
    dd0s[i] = 0.0f;
    dd1s[i] = dh_final[(size_t)(i / UPC) * H + j0 + i % UPC];
  }

  // this thread's cell update, if any: row cr, unit cu, layer cl
  const bool has_cell = tid < 2 * UPC * ROWS;
  const int cr = tid % ROWS;
  const int cu = (tid / ROWS) % UPC;
  const int cl = tid / (ROWS * UPC);
  const int j = j0 + cu;
  const int h4 = H / 4;   // float4 columns of an H row
  const int g4 = 3 * h4;  // float4 columns of a 3H row
  __syncthreads();

  for (int q = 0; q <= t_len; ++q) {
    const bool do1 = q < t_len;   // layer 1 at step t1
    const bool do0 = q >= 1;      // layer 0 at step t0
    const int t1 = t_len - 1 - q;
    const int t0 = t_len - q;
    // layer 1's outputs at t0 feed dh1 of step t1 and dx1 of step t0;
    // layer 0's at t0+1 feed dh0 of step t0
    const bool have1 = q >= 1, have0 = q >= 2;

    for (int bt0 = 0; bt0 < batch; bt0 += ROWS) {
      const int nb = min(ROWS, batch - bt0);
      const bool cell = has_cell && cr < nb;
      const int cb = bt0 + cr;
      const size_t o = (size_t)cb * H + j;
      // the cell's residuals come from device memory: start them first
      float act[4], hp = 0.0f, kv = 0.0f, dy = 0.0f;
      if (cell && cl == 1 && do1) {
        const size_t r = (size_t)t1 * batch + cb;
        const float* pk = act1 + r * AS + j;
#pragma unroll
        for (int i = 0; i < 4; ++i) act[i] = __ldg(pk + i * H);
        hp = __ldg(h1p + r * HS + j);
        if (dys != nullptr) dy = __ldg(dys + (size_t)t1 * BH + o);
      }
      if (cell && cl == 0 && do0) {
        const size_t r = (size_t)t0 * batch + cb;
        const float* pk = act0 + r * AS + j;
#pragma unroll
        for (int i = 0; i < 4; ++i) act[i] = __ldg(pk + i * H);
        hp = __ldg(h0p + r * HS + j);
        kv = __ldg(keep + (size_t)t0 * BH + o);
      }

      // acc[r][u][m]: row warp + NW*r, unit u, product m
      float acc[RPW][UPC][3];
#pragma unroll
      for (int r = 0; r < RPW; ++r)
#pragma unroll
        for (int u = 0; u < UPC; ++u) acc[r][u][0] = acc[r][u][1] = acc[r][u][2] = 0.0f;
      if (have1) {
#pragma unroll
        for (int r = 0; r < RPW; ++r) {
          const int row = bt0 + warp + NW * r;
          if (row >= batch) continue;  // warp-uniform
          const float4* i1 = reinterpret_cast<const float4*>(dih1 + (size_t)t0 * BI + (size_t)row * IS);
          const float4* n1 = reinterpret_cast<const float4*>(dhn1 + (size_t)t0 * BN + (size_t)row * NS);
          const float4* i0 = nullptr;
          const float4* n0 = nullptr;
          if (have0) {
            i0 = reinterpret_cast<const float4*>(dih0 + (size_t)(t0 + 1) * BI + (size_t)row * IS);
            n0 = reinterpret_cast<const float4*>(dhn0 + (size_t)(t0 + 1) * BN + (size_t)row * NS);
          }
          for (int c0 = lane; c0 < g4; c0 += 32 * LOADS) {
            // vi1: dih1 (the hop's row); vh1, vh0: dhh1, dhh0
            float4 vi1[LOADS], vh1[LOADS], vh0[LOADS];
#pragma unroll
            for (int l = 0; l < LOADS; ++l) {
              const int c = c0 + 32 * l;
              vi1[l] = vh1[l] = vh0[l] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
              if (c < g4) {
                const bool shared_lane = c < 2 * h4;
                vi1[l] = __ldcg(i1 + c);
                vh1[l] = shared_lane ? vi1[l] : __ldcg(n1 + (c - 2 * h4));
                if (i0 != nullptr)
                  vh0[l] = __ldcg(shared_lane ? i0 + c : n0 + (c - 2 * h4));
              }
            }
#pragma unroll
            for (int l = 0; l < LOADS; ++l) {
              const int c = c0 + 32 * l;
              if (c < g4) {
#pragma unroll
                for (int u = 0; u < UPC; ++u) {
                  const float4* w = reinterpret_cast<const float4*>(wr) + c;
                  acc[r][u][0] += dot4(vh1[l], w[(0 * UPC + u) * g4]);
                  acc[r][u][1] += dot4(vi1[l], w[(1 * UPC + u) * g4]);
                  acc[r][u][2] += dot4(vh0[l], w[(2 * UPC + u) * g4]);
                }
              }
            }
          }
        }
      }
      // the lanes' partial sums meet by shuffles; lane 0 writes the totals
#pragma unroll
      for (int r = 0; r < RPW; ++r)
#pragma unroll
        for (int u = 0; u < UPC; ++u)
#pragma unroll
          for (int m = 0; m < 3; ++m) {
            float v = acc[r][u][m];
#pragma unroll
            for (int off = 16; off > 0; off /= 2) v += __shfl_xor_sync(0xffffffffu, v, off);
            acc[r][u][m] = v;
          }
      if (lane == 0) {
#pragma unroll
        for (int r = 0; r < RPW; ++r)
#pragma unroll
          for (int u = 0; u < UPC; ++u)
#pragma unroll
            for (int m = 0; m < 3; ++m)
              red[((warp + NW * r) * UPC + u) * 3 + m] = acc[r][u][m];
      }
      __syncthreads();

      const float* rd = red + (cr * UPC + cu) * 3;
      if (cell && cl == 1 && do1) {
        float* dd = dd1s + cb * UPC + cu;
        float dh = *dd + rd[0];
        if (dys != nullptr) dh += dy;
        float d[4];
        *dd = cell_bwd(dh, hp, act, d);
        float* out = dih1 + (size_t)t1 * BI + (size_t)cb * IS + j;
#pragma unroll
        for (int i = 0; i < 3; ++i) out[i * H] = d[i];
        out[3 * H] = d[0];  // dhh's r and z lanes
        out[4 * H] = d[1];
        dhn1[(size_t)t1 * BN + (size_t)cb * NS + j] = d[3];
      }
      if (cell && cl == 0 && do0) {
        float* dd = dd0s + cb * UPC + cu;
        float d[4];
        *dd = cell_bwd((*dd + rd[2]) + rd[1] * kv, hp, act, d);
        float* out = dih0 + (size_t)t0 * BI + (size_t)cb * IS + j;
#pragma unroll
        for (int i = 0; i < 3; ++i) out[i * H] = d[i];
        out[3 * H] = d[0];
        out[4 * H] = d[1];
        dhn0[(size_t)t0 * BN + (size_t)cb * NS + j] = d[3];
      }
      __syncthreads();  // red is rewritten by the next pass
    }
    grid.sync();
  }
}

template <int UPC>
int launch(const float* act0, const float* act1, const float* h0p,
           const float* h1p, const float* dys, const float* keep,
           const float* dh_final, const float* w_hh0, const float* w_hh1,
           const float* w_ih1, float* dih0, float* dhn0, float* dih1,
           float* dhn1, int batch, int t_len, int hidden, int max_smem,
           cudaStream_t stream) {
  const size_t smem =
      (size_t)(3 * UPC * 3 * hidden + ROWS * UPC * 3 + 2 * batch * UPC) *
      sizeof(float);
  if (smem > (size_t)max_smem) return kUnsupported;
  const void* fn = reinterpret_cast<const void*>(&gru2_bwd_chain_kernel<UPC>);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  void* args[] = {(void*)&act0,  (void*)&act1,     (void*)&h0p,
                  (void*)&h1p,   (void*)&dys,      (void*)&keep,
                  (void*)&dh_final, (void*)&w_hh0, (void*)&w_hh1,
                  (void*)&w_ih1, (void*)&dih0,     (void*)&dhn0,
                  (void*)&dih1,  (void*)&dhn1,     (void*)&batch,
                  (void*)&t_len, (void*)&hidden};
  // refuses (cudaErrorCooperativeLaunchTooLarge) a grid that cannot be
  // resident all at once, so the grid barrier cannot deadlock
  err = cudaLaunchCooperativeKernel(fn, dim3(hidden / UPC), dim3(NT), args,
                                    smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Units per CTA: the fewest that keep the grid within one CTA per SM, the
// forward's partition.  UPC 1 and 2 cover H up to twice the SM count (264
// on the H100); larger H is refused as unsupported.
int dispatch(const float* act0, const float* act1, const float* h0p,
             const float* h1p, const float* dys, const float* keep,
             const float* dh_final, const float* w_hh0, const float* w_hh1,
             const float* w_ih1, float* dih0, float* dhn0, float* dih1,
             float* dhn1, int batch, int t_len, int hidden, void* stream) {
  if (batch < 1 || t_len < 1 || hidden < 1 || hidden % 4 != 0) {
    return kUnsupported;
  }
  int dev = 0, sms = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&max_smem,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = (cudaStream_t)stream;
#define GRU2_TRY(U)                                                          \
  if (hidden % (U) == 0 && hidden / (U) <= sms)                              \
    return launch<U>(act0, act1, h0p, h1p, dys, keep, dh_final, w_hh0,      \
                     w_hh1, w_ih1, dih0, dhn0, dih1, dhn1, batch, t_len,      \
                     hidden, max_smem, s);
  GRU2_TRY(1)
  GRU2_TRY(2)
#undef GRU2_TRY
  return kUnsupported;
}

}  // namespace

// the legacy form: res0, res1 (T, B, 5H) = [h_prev | r | z | n | hn], dys
// (T, B, H) or null; out (T, B, 12H) = [dih0 | dhh0 | dih1 | dhh1]
extern "C" int gru2_bwd_chain_legacy_launch(
    const float* res0, const float* res1, const float* dys, const float* keep,
    const float* dh_final, const float* w_hh0, const float* w_hh1,
    const float* w_ih1, float* out, int batch, int t_len, int hidden,
    void* stream) {
  const size_t h = (size_t)hidden;
  return dispatch(res0 + h, res1 + h, res0, res1, dys, keep, dh_final, w_hh0,
                  w_hh1, w_ih1, out, out + 5 * h, out + 6 * h, out + 11 * h, batch,
                  t_len, hidden, stream);
}

extern "C" const char* gru2_bwd_chain_legacy_error_string(int err) {
  if (err == kUnsupported) return "shape not supported by gru2_bwd_chain_legacy";
  return cudaGetErrorString((cudaError_t)err);
}
