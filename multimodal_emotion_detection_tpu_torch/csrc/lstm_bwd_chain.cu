// One LSTM layer's reverse dgates chain for Hopper (sm_90a).
//
// Replaces: multimodal_emotion_detection_tpu/ops/lstm_kernel.py::
// lstm_bwd_chain_pallas (kernel body _lstm_bwd_kernel).  Same function as
// the plain PyTorch version ops/lstm_kernel.py::lstm_bwd_chain_reference:
// over one layer's residuals of lstm1_fwd (g (T, B, 4H) gate
// pre-activations, c_prev (T, B, H)), the per-step cotangent from the
// layer above dh_series (T, B, H; may be absent = zeros) and the final
// hidden state's dh_final (B, H), walk t = T-1 .. 0 with carries dh
// (dh_final at the start) and dc (zero):
//
//   (dg[t], dc) = cell_bwd(g[t], c_prev[t], dh + dh_series[t], dc)
//   dh = dg[t] @ w_hh^T
//
// and write dg (T, B, 4H).  The hop into the layer below and the hoisted
// weight gradients are plain matrix products outside (ops/lstm_vjp.py).
//
// What bounds it on the H100: the serial chain.  At the big sweep config's
// shape (B=32, T=372, H=512) the products are 24.96 GFLOP per layer
// (~0.37 ms at 67 TFLOP/s) and the streams ~0.2 GB, but each step needs the
// whole dgates row of the step before, so T device-wide exchanges set the
// time.
//
// Design: csrc/lstm2_bwd_chain.cu's, for one layer and general H.
// dh[b][j] = sum_m dg[b][m] w_hh[j][m] runs over all 4H gate columns, which
// every CTA produces a slice of, so the forward's partition is transposed:
// CTA c keeps rows j in [c*UPC, (c+1)*UPC) of w_hh (UPC x 4H; 32 KB at
// H=512, UPC=4) in shared memory and, every step, reads the whole dg row
// of the step before from the output itself (the exchange; through L2,
// ld.cg), B x 4H floats (256 KB at B=32).  Warp w takes batch rows w, w+8,
// ..; a lane takes float4 columns of the row, so a warp's loads are
// contiguous, and the partial dot products meet by shuffles.  The cell
// threads load their residuals before the products, to hide that latency.
// One grid barrier per step, T in all.  Exactly T steps run; any B >= 1.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 256;           // threads per CTA
constexpr int NW = NT / 32;       // warps
constexpr int ROWS = 32;          // batch rows per pass
constexpr int RPW = ROWS / NW;    // rows per warp and pass
constexpr int LOADS = 8;          // float4 loads in flight per thread
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

template <int UPC>
__global__ void __launch_bounds__(NT) lstm_bwd_chain_kernel(
    const float* __restrict__ g_res,     // (T, B, 4H)
    const float* __restrict__ c_prev,    // (T, B, H)
    const float* __restrict__ dh_series, // (T, B, H) or nullptr (zeros)
    const float* __restrict__ dh_final,  // (B, H)
    const float* __restrict__ w_hh,      // (H, 4H)
    float* dg,                           // (T, B, 4H) out, also the exchange
    int batch, int t_len, int hidden) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) float smem[];
  const int H = hidden;
  const int H4 = 4 * H;
  float* wr = smem;                // UPC * 4H: wr[u*4H + col] = w_hh[j0+u][col]
  float* red = wr + UPC * H4;      // ROWS * UPC reduced products
  float* dcs = red + ROWS * UPC;   // batch * UPC

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int j0 = blockIdx.x * UPC;
  const size_t BH = (size_t)batch * H;
  const size_t BG = (size_t)batch * H4;

  for (int i = tid; i < UPC * H4; i += NT) wr[i] = w_hh[(size_t)j0 * H4 + i];
  for (int i = tid; i < batch * UPC; i += NT) dcs[i] = 0.0f;

  // this thread's cell update, if any: row cr, unit cu
  const bool has_cell = tid < UPC * ROWS;
  const int cr = tid % ROWS;
  const int cu = tid / ROWS;
  const int j = j0 + cu;
  const int h4 = H;  // float4 columns of a 4H row
  const float4* w4 = reinterpret_cast<const float4*>(wr);
  __syncthreads();

  for (int q = 0; q < t_len; ++q) {
    const int t = t_len - 1 - q;
    // dg(t+1) feeds this step's dh
    const float* src = q >= 1 ? dg + (size_t)(t + 1) * BG : nullptr;

    for (int bt0 = 0; bt0 < batch; bt0 += ROWS) {
      const int nb = min(ROWS, batch - bt0);
      const bool cell = has_cell && cr < nb;
      const int cb = bt0 + cr;
      const size_t o = (size_t)cb * H + j;
      // the cell's residuals come from device memory: start them first
      float gv[4], cp = 0.0f, dhs = 0.0f, dhf = 0.0f;
      if (cell) {
        const float* p = g_res + ((size_t)t * batch + cb) * H4 + j;
#pragma unroll
        for (int i = 0; i < 4; ++i) gv[i] = __ldg(p + i * H);
        cp = __ldg(c_prev + (size_t)t * BH + o);
        if (dh_series != nullptr) dhs = __ldg(dh_series + (size_t)t * BH + o);
        if (q == 0) dhf = __ldg(dh_final + o);
      }

      // acc[r][u]: row bt0 + warp + NW*r, unit u
      float acc[RPW][UPC];
#pragma unroll
      for (int r = 0; r < RPW; ++r)
#pragma unroll
        for (int u = 0; u < UPC; ++u) acc[r][u] = 0.0f;
      if (src != nullptr) {
#pragma unroll
        for (int r = 0; r < RPW; ++r) {
          const int row = bt0 + warp + NW * r;
          if (row >= batch) continue;  // warp-uniform
          const float4* rp = reinterpret_cast<const float4*>(src + (size_t)row * H4);
          for (int c0 = lane; c0 < h4; c0 += 32 * LOADS) {
            float4 v[LOADS];
#pragma unroll
            for (int l = 0; l < LOADS; ++l) {
              const int c = c0 + 32 * l;
              v[l] = c < h4 ? __ldcg(rp + c) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            }
#pragma unroll
            for (int l = 0; l < LOADS; ++l) {
              const int c = c0 + 32 * l;
              if (c < h4) {
#pragma unroll
                for (int u = 0; u < UPC; ++u) acc[r][u] += dot4(v[l], w4[u * h4 + c]);
              }
            }
          }
        }
      }
      // the lanes' partial sums meet by shuffles; lane 0 writes the totals
#pragma unroll
      for (int r = 0; r < RPW; ++r)
#pragma unroll
        for (int u = 0; u < UPC; ++u) {
          float v = acc[r][u];
#pragma unroll
          for (int off = 16; off > 0; off /= 2) v += __shfl_xor_sync(0xffffffffu, v, off);
          acc[r][u] = v;
        }
      if (lane == 0) {
#pragma unroll
        for (int r = 0; r < RPW; ++r)
#pragma unroll
          for (int u = 0; u < UPC; ++u) red[(warp + NW * r) * UPC + u] = acc[r][u];
      }
      __syncthreads();

      if (cell) {
        const float dh = (q == 0 ? dhf : red[cr * UPC + cu]) + dhs;
        float d[4];
        dcs[cb * UPC + cu] = cell_bwd(gv, cp, dh, dcs[cb * UPC + cu], d);
        float* out = dg + (size_t)t * BG + (size_t)cb * H4 + j;
#pragma unroll
        for (int i = 0; i < 4; ++i) out[i * H] = d[i];
      }
      __syncthreads();  // red is rewritten by the next pass
    }
    grid.sync();
  }
}

template <int UPC>
int launch(const float* g, const float* c_prev, const float* dh_series,
           const float* dh_final, const float* w_hh, float* dg, int batch,
           int t_len, int hidden, int max_smem, cudaStream_t stream) {
  const size_t smem =
      (size_t)(UPC * 4 * hidden + ROWS * UPC + batch * UPC) * sizeof(float);
  if (smem > (size_t)max_smem) return kUnsupported;
  const void* fn = reinterpret_cast<const void*>(&lstm_bwd_chain_kernel<UPC>);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  void* args[] = {(void*)&g,        (void*)&c_prev, (void*)&dh_series,
                  (void*)&dh_final, (void*)&w_hh,   (void*)&dg,
                  (void*)&batch,    (void*)&t_len,  (void*)&hidden};
  // refuses (cudaErrorCooperativeLaunchTooLarge) a grid that cannot be
  // resident all at once, so the grid barrier cannot deadlock
  err = cudaLaunchCooperativeKernel(fn, dim3(hidden / UPC), dim3(NT), args,
                                    smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// Units per CTA: the fewest that keep the grid within one CTA per SM, the
// forward's partition.  UPC 1, 2, 4 and 8 cover H up to 8 times the SM
// count (1056 on the H100), as far as shared memory allows; other shapes
// are refused as unsupported.
extern "C" int lstm_bwd_chain_launch(const float* g, const float* c_prev,
                                     const float* dh_series,
                                     const float* dh_final, const float* w_hh,
                                     float* dg, int batch, int t_len,
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
#define LSTM_BWD_TRY(U)                                                      \
  if (hidden % (U) == 0 && hidden / (U) <= sms)                              \
    return launch<U>(g, c_prev, dh_series, dh_final, w_hh, dg, batch, t_len, \
                     hidden, max_smem, s);
  LSTM_BWD_TRY(1)
  LSTM_BWD_TRY(2)
  LSTM_BWD_TRY(4)
  LSTM_BWD_TRY(8)
#undef LSTM_BWD_TRY
  return kUnsupported;
}

extern "C" const char* lstm_bwd_chain_error_string(int err) {
  if (err == kUnsupported) return "shape not supported by lstm_bwd_chain";
  return cudaGetErrorString((cudaError_t)err);
}
