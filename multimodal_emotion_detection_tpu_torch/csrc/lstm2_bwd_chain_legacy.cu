// 2-layer LSTM reverse dgates chain in the legacy layout for Hopper
// (sm_90a): the first design of the 2-layer chain, kept for this form.
//
// Replaces: multimodal_emotion_detection_tpu/ops/lstm_kernel.py::
// lstm2_bwd_chain_pallas (kernel body _lstm2_bwd_kernel).  Same function
// as the plain PyTorch version ops/lstm_kernel.py::
// lstm2_bwd_chain_legacy_reference: over the older layout's separate
// series g0, g1 (T, B, 4H) and c0_prev, c1_prev (T, B, H), the keep mask
// (T, B, H), where one is given the sequence output's cotangent dys
// (T, B, H; without it the stream is not read) and the cotangent of layer
// 1's final hidden state dh_final (B, H), walk t = T-1 .. 0 with carries
// dh1, dc1, dh0, dc0 (dh1 = dh_final, the rest zero, at the start):
//
//   (dg1, dc1) = cell_bwd(g1[t], c1_prev[t], dh1 + dys[t], dc1)
//   dh1 = dg1 @ w_hh1^T ;  dx1 = dg1 @ w_ih1^T
//   (dg0, dc0) = cell_bwd(g0[t], c0_prev[t], dh0 + dx1 * keep[t], dc0)
//   dh0 = dg0 @ w_hh0^T
//
// and write dg (T, B, 8H) = [dg0 | dg1].  The hoisted weight gradients are
// plain matrix products outside (ops/lstm_vjp.py).  The residual-native
// chain (row 12) is lstm2_bwd_chain.cu, on the 2-layer core
// rnn2_bwd_chain.cuh.
//
// What bounds it on the H100: the serial chain.  At the flagship shape
// (B=32, T=372, H=256) the three products per step are 18.7 GFLOP and the
// streams 231 MB (~0.28 ms at 67 TFLOP/s), but each step needs the whole
// dgates row of the step before, so T+1 device-wide exchanges set the time.
//
// Design: the forward's partition of hidden units over a cooperative grid,
// transposed.  dh[b][j] = sum_m dg[b][m] W[j][m] runs over all 4H gate
// columns, which every CTA produces a slice of, so each CTA keeps ROWS j of
// w_hh1, w_ih1 and w_hh0 (4H wide; 24 KB at H=256, UPC=2) in shared memory
// and, every phase, reads the whole dg1 and dg0 rows of the phase before
// from the output itself (the exchange; through L2, ld.cg): 4x the bytes
// the forward exchanges, 256 KB per CTA per phase at B=32.  Warp w takes
// batch rows w, w+8, ..; a lane takes float4 columns of the row, so a
// warp's loads are contiguous, and the partial dot products meet by
// shuffles.  The layers are wavefronted in reverse: phase q runs layer 1 at
// step T-1-q and layer 0 at step T-q, which consumes dx1 from layer 1's
// dg1 of the phase before; one grid barrier per phase, T+1 in all.  The
// cell threads load their residuals before the products, to hide that
// latency.  Exactly T steps run; any B >= 1.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 256;           // threads per CTA
constexpr int NW = NT / 32;       // warps
constexpr int ROWS = 32;          // batch rows per pass
constexpr int RPW = ROWS / NW;    // rows per warp and pass
constexpr int LOADS = 8;          // float4 loads in flight per array and thread
constexpr int kUnsupported = -1;  // shape the kernel does not take

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__device__ __forceinline__ float dot4(const float4 a, const float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

// one step of the cell backward for one (row, unit): gates g[4] (i, f, g,
// o pre-activations), c_prev, dh, dc -> dgates d[4]; returns dc_prev
__device__ __forceinline__ float cell_bwd(const float* g, float c_prev,
                                          float dh, float dc, float* d) {
  const float si = sigmoidf(g[0]), sf = sigmoidf(g[1]), so = sigmoidf(g[3]);
  const float tg = tanhf(g[2]);
  const float tc = tanhf(sf * c_prev + si * tg);
  const float dcs = dc + dh * so * (1.0f - tc * tc);
  d[0] = dcs * tg * si * (1.0f - si);
  d[1] = dcs * c_prev * sf * (1.0f - sf);
  d[2] = dcs * si * (1.0f - tg * tg);
  d[3] = dh * tc * so * (1.0f - so);
  return dcs * sf;
}

// g0, g1 (T, B, 4H) and cp0, cp1 (T, B, H) apart; dg0 and dg1 at lanes 0
// and 4H of the (T, B, 8H) out rows
template <int UPC>
__global__ void __launch_bounds__(NT) lstm2_bwd_chain_kernel(
    const float* __restrict__ g0,        // (T, B, .) layer 0's gates
    const float* __restrict__ g1,        // (T, B, .) layer 1's gates
    const float* __restrict__ cp0,       // (T, B, .) layer 0's c_prev
    const float* __restrict__ cp1,       // (T, B, .) layer 1's c_prev
    const float* __restrict__ dys,       // (T, B, H) or null
    const float* __restrict__ keep,      // (T, B, H)
    const float* __restrict__ dh_final,  // (B, H)
    const float* __restrict__ w_hh0,     // (H, 4H)
    const float* __restrict__ w_hh1,     // (H, 4H)
    const float* __restrict__ w_ih1,     // (H, 4H)
    float* dg0,                          // (T, B, .) out, also the exchange
    float* dg1,                          // (T, B, .) out, also the exchange
    int batch, int t_len, int hidden) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) float smem[];
  const int H = hidden;
  const int H4 = 4 * H;
  const int GS = H4;     // row strides: gates,
  const int CS = H;      // c_prev,
  const int DS = 8 * H;  // dgates
  // wr[(m*UPC + u)*4H + col] = W_m[j0 + u][col]; m: 0 w_hh1, 1 w_ih1, 2 w_hh0
  float* wr = smem;                     // 3 * UPC * 4H
  float* red = wr + 3 * UPC * H4;       // ROWS * UPC * 3 reduced products
  float* dc0s = red + ROWS * UPC * 3;   // batch * UPC
  float* dc1s = dc0s + batch * UPC;     // batch * UPC

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int j0 = blockIdx.x * UPC;
  const size_t BH = (size_t)batch * H;
  const size_t BG = (size_t)batch * DS;

  for (int i = tid; i < UPC * H4; i += NT) {
    const int u = i / H4, col = i % H4;
    const size_t src = (size_t)(j0 + u) * H4 + col;
    wr[(0 * UPC + u) * H4 + col] = w_hh1[src];
    wr[(1 * UPC + u) * H4 + col] = w_ih1[src];
    wr[(2 * UPC + u) * H4 + col] = w_hh0[src];
  }
  for (int i = tid; i < batch * UPC; i += NT) dc0s[i] = dc1s[i] = 0.0f;

  // this thread's cell update, if any: row cr, unit cu, layer cl
  const bool has_cell = tid < 2 * UPC * ROWS;
  const int cr = tid % ROWS;
  const int cu = (tid / ROWS) % UPC;
  const int cl = tid / (ROWS * UPC);
  const int j = j0 + cu;
  const int h4 = H;  // float4 columns of a 4H row
  __syncthreads();

  for (int q = 0; q <= t_len; ++q) {
    const bool do1 = q < t_len;   // layer 1 at step t1
    const bool do0 = q >= 1;      // layer 0 at step t0
    const int t1 = t_len - 1 - q;
    const int t0 = t_len - q;
    // dg1(t0) feeds dh1 of step t1 and dx1 of step t0; dg0(t0+1) feeds dh0
    const float* src1 = q >= 1 ? dg1 + (size_t)t0 * BG : nullptr;
    const float* src0 = q >= 2 ? dg0 + (size_t)(t0 + 1) * BG : nullptr;

    for (int bt0 = 0; bt0 < batch; bt0 += ROWS) {
      const int nb = min(ROWS, batch - bt0);
      const bool cell = has_cell && cr < nb;
      const int cb = bt0 + cr;
      const size_t o = (size_t)cb * H + j;
      // the cell's residuals come from device memory: start them first
      float g[4], c_prev = 0.0f, kv = 0.0f, dhf = 0.0f, dy = 0.0f;
      if (cell && cl == 1 && do1) {
        const size_t r = (size_t)t1 * batch + cb;
        const float* pk = g1 + r * GS + j;
#pragma unroll
        for (int i = 0; i < 4; ++i) g[i] = __ldg(pk + i * H);
        c_prev = __ldg(cp1 + r * CS + j);
        if (q == 0) dhf = __ldg(dh_final + o);
        if (dys != nullptr) dy = __ldg(dys + (size_t)t1 * BH + o);
      }
      if (cell && cl == 0 && do0) {
        const size_t r = (size_t)t0 * batch + cb;
        const float* pk = g0 + r * GS + j;
#pragma unroll
        for (int i = 0; i < 4; ++i) g[i] = __ldg(pk + i * H);
        c_prev = __ldg(cp0 + r * CS + j);
        kv = __ldg(keep + (size_t)t0 * BH + o);
      }

      // acc[r][u][m]: row warp + NW*r, unit u, product m
      float acc[RPW][UPC][3];
#pragma unroll
      for (int r = 0; r < RPW; ++r)
#pragma unroll
        for (int u = 0; u < UPC; ++u) acc[r][u][0] = acc[r][u][1] = acc[r][u][2] = 0.0f;
      if (src1 != nullptr) {
#pragma unroll
        for (int r = 0; r < RPW; ++r) {
          const int row = bt0 + warp + NW * r;
          if (row >= batch) continue;  // warp-uniform
          const float4* r1 = reinterpret_cast<const float4*>(src1 + (size_t)row * DS);
          const float4* r0 = src0 != nullptr
              ? reinterpret_cast<const float4*>(src0 + (size_t)row * DS) : nullptr;
          for (int c0 = lane; c0 < h4; c0 += 32 * LOADS) {
            float4 v1[LOADS], v0[LOADS];
#pragma unroll
            for (int l = 0; l < LOADS; ++l) {
              const int c = c0 + 32 * l;
              v1[l] = v0[l] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
              if (c < h4) {
                v1[l] = __ldcg(r1 + c);
                if (r0 != nullptr) v0[l] = __ldcg(r0 + c);
              }
            }
#pragma unroll
            for (int l = 0; l < LOADS; ++l) {
              const int c = c0 + 32 * l;
              if (c < h4) {
#pragma unroll
                for (int u = 0; u < UPC; ++u) {
                  const float4* w = reinterpret_cast<const float4*>(wr) + c;
                  acc[r][u][0] += dot4(v1[l], w[(0 * UPC + u) * h4]);
                  acc[r][u][1] += dot4(v1[l], w[(1 * UPC + u) * h4]);
                  acc[r][u][2] += dot4(v0[l], w[(2 * UPC + u) * h4]);
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
        float dh = q == 0 ? dhf : rd[0];
        if (dys != nullptr) dh += dy;
        float d[4];
        dc1s[cb * UPC + cu] = cell_bwd(g, c_prev, dh, dc1s[cb * UPC + cu], d);
        float* out = dg1 + (size_t)t1 * BG + (size_t)cb * DS + j;
#pragma unroll
        for (int i = 0; i < 4; ++i) out[i * H] = d[i];
      }
      if (cell && cl == 0 && do0) {
        const float dh = rd[2] + rd[1] * kv;
        float d[4];
        dc0s[cb * UPC + cu] = cell_bwd(g, c_prev, dh, dc0s[cb * UPC + cu], d);
        float* out = dg0 + (size_t)t0 * BG + (size_t)cb * DS + j;
#pragma unroll
        for (int i = 0; i < 4; ++i) out[i * H] = d[i];
      }
      __syncthreads();  // red is rewritten by the next pass
    }
    grid.sync();
  }
}

template <int UPC>
int launch(const float* g0, const float* g1, const float* cp0,
           const float* cp1, const float* dys, const float* keep,
           const float* dh_final, const float* w_hh0, const float* w_hh1,
           const float* w_ih1, float* dg0, float* dg1, int batch, int t_len,
           int hidden, int max_smem, cudaStream_t stream) {
  const size_t smem =
      (size_t)(3 * UPC * 4 * hidden + ROWS * UPC * 3 + 2 * batch * UPC) *
      sizeof(float);
  if (smem > (size_t)max_smem) return kUnsupported;
  const void* fn = reinterpret_cast<const void*>(&lstm2_bwd_chain_kernel<UPC>);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  void* args[] = {(void*)&g0,    (void*)&g1,       (void*)&cp0,
                  (void*)&cp1,   (void*)&dys,      (void*)&keep,
                  (void*)&dh_final, (void*)&w_hh0, (void*)&w_hh1,
                  (void*)&w_ih1, (void*)&dg0,      (void*)&dg1,
                  (void*)&batch, (void*)&t_len,    (void*)&hidden};
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
int dispatch(const float* g0, const float* g1, const float* cp0,
             const float* cp1, const float* dys, const float* keep,
             const float* dh_final, const float* w_hh0, const float* w_hh1,
             const float* w_ih1, float* dg0, float* dg1, int batch, int t_len,
             int hidden, void* stream) {
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
#define LSTM2_TRY(U)                                                         \
  if (hidden % (U) == 0 && hidden / (U) <= sms)                              \
    return launch<U>(g0, g1, cp0, cp1, dys, keep, dh_final, w_hh0, w_hh1,  \
                     w_ih1, dg0, dg1, batch, t_len, hidden, max_smem, s);
  LSTM2_TRY(1)
  LSTM2_TRY(2)
#undef LSTM2_TRY
  return kUnsupported;
}

}  // namespace

// g0, g1 (T, B, 4H), cp0, cp1 (T, B, H), dys (T, B, H) or null; dg
// (T, B, 8H) = [dg0 | dg1]
extern "C" int lstm2_bwd_chain_legacy_launch(
    const float* g0, const float* g1, const float* cp0, const float* cp1,
    const float* dys, const float* keep, const float* dh_final,
    const float* w_hh0, const float* w_hh1, const float* w_ih1, float* dg,
    int batch, int t_len, int hidden, void* stream) {
  return dispatch(g0, g1, cp0, cp1, dys, keep, dh_final, w_hh0, w_hh1, w_ih1,
                  dg, dg + 4 * (size_t)hidden, batch, t_len, hidden, stream);
}

extern "C" const char* lstm2_bwd_chain_legacy_error_string(int err) {
  if (err == kUnsupported) return "shape not supported by lstm2_bwd_chain_legacy";
  return cudaGetErrorString((cudaError_t)err);
}
