// One LSTM layer's forward recurrence for Hopper (sm_90a): the training
// form with residuals, and the eval form.
//
// Replaces: multimodal_emotion_detection_tpu/ops/lstm_kernel.py::
// lstm1_train_fwd_pallas (kernel body _lstm1_fwd_train_kernel), and the
// XLA scan the JAX package runs at eval for LSTM depths other than 2
// (ops/lstm_vjp.py::_fwd_scan).  Same function as the plain PyTorch
// versions ops/lstm_kernel.py::lstm1_train_fwd_reference and
// lstm1_infer_reference: given the layer's hoisted input projection
// ih = x @ w_ih + b (T, B, 4H, time-major), run from zero state for
// t = 0..T-1
//
//   g = ih[t] + h @ w_hh ;  (h, c) = cell(g, c)
//
// Training form (lstm1_fwd_train_launch) stores what the backward
// consumes, in the JAX package's layout: g[t] (B, 4H), h_prev[t] and
// c_prev[t] (B, H), the state BEFORE step t, and finals (B, 2H) = [h | c]
// after step T-1.  Eval form (lstm1_fwd_infer_launch) stores only h:
// every step's (T, B, H) when the next layer needs the series, else two
// (B, H) slots used in turn, of which slot (T-1) % 2 holds the final h.
//
// What bounds it on the H100: the serial chain.  At the big sweep config's
// shape (B=32, T=372, H=512) the recurrent products are 24.96 GFLOP per
// layer (~0.37 ms at 67 TFLOP/s) and the training form's streams ~0.24 GB
// (~0.07 ms at 3.35 TB/s), but every step needs the whole previous hidden
// state of all units, so T device-wide exchanges set the time.
//
// Design: csrc/lstm2_train_fwd.cu's, for one layer and general H.  One
// persistent cooperative launch; CTA c owns hidden units [c*UPC,
// (c+1)*UPC), keeps their 4*UPC gate columns of w_hh in shared memory
// (32 KB at H=512, UPC=4) and their cell state in the CTA.  UPC is the
// fewest units that keep the grid within one CTA per SM (4 at H=512 on
// 132 SMs, 8 up to H=1056).  One grid barrier per step, T in all.  The h
// output is itself the exchange: step t reads the previous h through L2
// (ld.cg) from h_prev[t] (training) or the series / the other slot (eval),
// and writes a row no CTA reads in the same step.  The previous h of 32
// batch rows is staged in shared memory in chunks of KC of its H columns
// (KC = H where it fits), loaded by coalesced float4 rows; warp w sums
// k = w, w+8, .. of each chunk for one batch row per lane into the CTA's
// 4*UPC columns, and the warps' partial sums meet in shared memory.
// Exactly T steps run; any B >= 1.  Built with -DRNN_CHAIN_TIMERS=1
// (rnn_timers.cuh) each warp splits its step into the timer buckets.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include "rnn_timers.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 256;          // threads per CTA
constexpr int NW = NT / 32;      // warps = slices of each dot product
constexpr int ROWS = 32;         // batch rows per pass: one per lane
constexpr int LOADS = 8;         // float4 loads in flight per thread
constexpr int kUnsupported = -1; // shape the kernel does not take

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// columns [k0, k0 + kn) of rows [bt0, bt0 + nb) of a (B, H) state into a
// (ROWS, ld) tile; consecutive threads read consecutive float4s of a row
__device__ __forceinline__ void load_tile(const float* src, float* tile,
                                          int bt0, int nb, int H, int k0,
                                          int kn, int ld, int tid) {
  const int n4 = kn / 4;
  const int total = nb * n4;
  for (int f0 = tid; f0 < total; f0 += NT * LOADS) {
    float4 v[LOADS];
#pragma unroll
    for (int u = 0; u < LOADS; ++u) {
      const int f = f0 + NT * u;
      if (f < total) {
        const int r = f / n4, q = f % n4;
        v[u] = __ldcg(reinterpret_cast<const float4*>(
                          src + (size_t)(bt0 + r) * H + k0) + q);
      }
    }
#pragma unroll
    for (int u = 0; u < LOADS; ++u) {
      const int f = f0 + NT * u;
      if (f < total) {
        const int r = f / n4, q = f % n4;
        float* e = tile + r * ld + 4 * q;
        e[0] = v[u].x; e[1] = v[u].y; e[2] = v[u].z; e[3] = v[u].w;
      }
    }
  }
}

template <int UPC, bool TRAIN>
__global__ void __launch_bounds__(NT) lstm1_fwd_kernel(
    const float* __restrict__ ih,    // (T, B, 4H)
    const float* __restrict__ w_hh,  // (H, 4H)
    float* __restrict__ g_out,       // training: (T, B, 4H) out
    float* h_x,                      // training: h_prev (T, B, H) out;
                                     // eval: h series (T, B, H) or 2 slots
    float* __restrict__ c_out,       // training: c_prev (T, B, H) out
    float* __restrict__ finals,      // training: (B, 2H) out
    int batch, int t_len, int hidden, int kc, int series) {
  constexpr int G = 4 * UPC;  // gate columns a CTA owns
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) float smem[];
  const int H = hidden;
  const int H4 = 4 * H;
  const int ld = kc + 1;             // odd row stride: rows in distinct banks
  float* w = smem;                   // H * G
  float* red = w + H * G;            // NW * G * ROWS partial sums
  float* tile = red + NW * G * ROWS; // ROWS * ld
  float* cs = tile + ROWS * ld;      // batch * UPC

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int j0 = blockIdx.x * UPC;
  const size_t BH = (size_t)batch * H;

  // column col = g*UPC + u of the CTA <-> column g*H + j0 + u of w_hh
  for (int i = tid; i < H * G; i += NT) {
    const int k = i / G, col = i % G;
    w[i] = w_hh[(size_t)k * H4 + (col / UPC) * H + j0 + col % UPC];
  }
  for (int i = tid; i < batch * UPC; i += NT) cs[i] = 0.0f;

  // this thread's cell update, if any: row cr, unit cu
  const bool has_cell = tid < UPC * ROWS;
  const int cr = tid % ROWS;
  const int cu = tid / ROWS;
  const int j = j0 + cu;
  rnn_timer::Timer tm;

  for (int t = 0; t < t_len; ++t) {
    // the state before step t, and where this step's h goes
    const float* src = nullptr;
    float* dst = nullptr;
    if (TRAIN) {
      if (t > 0) src = h_x + (size_t)t * BH;
      if (t + 1 < t_len) dst = h_x + (size_t)(t + 1) * BH;
    } else {
      if (t > 0) src = h_x + (size_t)(series ? t - 1 : (t - 1) & 1) * BH;
      dst = h_x + (size_t)(series ? t : t & 1) * BH;
    }

    for (int bt0 = 0; bt0 < batch; bt0 += ROWS) {
      const int nb = min(ROWS, batch - bt0);
      const bool cell = has_cell && cr < nb;
      const int cb = bt0 + cr;
      // the cell's input projection comes from device memory: start first
      float ihv[4];
      if (cell) {
        const float* p = ih + ((size_t)t * batch + cb) * H4 + j;
#pragma unroll
        for (int g = 0; g < 4; ++g) ihv[g] = __ldg(p + g * H);
      }

      float a[G];
#pragma unroll
      for (int col = 0; col < G; ++col) a[col] = 0.0f;
      if (src != nullptr) {
        for (int k0 = 0; k0 < H; k0 += kc) {
          const int kn = min(kc, H - k0);
          __syncthreads();  // the tile's previous chunk has been read
          load_tile(src, tile, bt0, nb, H, k0, kn, ld, tid);
          __syncthreads();
          tm.mark(rnn_timer::kExchange);
          if (lane < nb) {
            const float* row = tile + lane * ld;
            for (int k = warp; k < kn; k += NW) {
              const float v = row[k];
              const float4* wk = reinterpret_cast<const float4*>(w + (k0 + k) * G);
#pragma unroll
              for (int q = 0; q < G / 4; ++q) {
                const float4 e = wk[q];
                a[4 * q + 0] += v * e.x; a[4 * q + 1] += v * e.y;
                a[4 * q + 2] += v * e.z; a[4 * q + 3] += v * e.w;
              }
            }
          }
          tm.mark(rnn_timer::kProducts);
        }
      }
      // red[(w*G + col)*ROWS + row]: lanes write consecutive words
#pragma unroll
      for (int col = 0; col < G; ++col) red[(warp * G + col) * ROWS + lane] = a[col];
      __syncthreads();
      tm.mark(rnn_timer::kReduce);

      if (cell) {
        float g4[4];
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          const int col = g * UPC + cu;
          float acc = 0.0f;
#pragma unroll
          for (int w8 = 0; w8 < NW; ++w8) acc += red[(w8 * G + col) * ROWS + cr];
          g4[g] = ihv[g] + acc;
        }
        const float c_prev = cs[cb * UPC + cu];
        const float c = sigmoidf(g4[1]) * c_prev + sigmoidf(g4[0]) * tanhf(g4[2]);
        const float h = sigmoidf(g4[3]) * tanhf(c);
        cs[cb * UPC + cu] = c;
        const size_t o = (size_t)cb * H + j;  // (b, j) in a (B, H) array
        if (TRAIN) {
          float* gp = g_out + ((size_t)t * batch + cb) * H4 + j;
#pragma unroll
          for (int g = 0; g < 4; ++g) gp[g * H] = g4[g];
          c_out[(size_t)t * BH + o] = c_prev;
          if (t == 0) h_x[o] = 0.0f;
          if (dst != nullptr) {
            dst[o] = h;
          } else {
            finals[(size_t)cb * 2 * H + j] = h;
            finals[(size_t)cb * 2 * H + H + j] = c;
          }
        } else {
          dst[o] = h;
        }
      }
      __syncthreads();  // red is rewritten by the next pass
      tm.mark(rnn_timer::kCell);
    }
    grid.sync();
    tm.mark(rnn_timer::kBarrier);
  }
  tm.flush();
}

size_t smem_bytes(int upc, int hidden, int kc, int batch) {
  const int G = 4 * upc;
  return (size_t)(hidden * G + NW * G * ROWS + ROWS * (kc + 1) + batch * upc) *
         sizeof(float);
}

template <int UPC, bool TRAIN>
int launch(const float* ih, const float* w_hh, float* g_out, float* h_x,
           float* c_out, float* finals, int batch, int t_len, int hidden,
           int series, int max_smem, cudaStream_t stream) {
  // stage the whole previous h row where it fits, else chunks of it (a
  // multiple of 4 columns, so every chunk loads as float4s)
  int kc = hidden;
  const int chunks[] = {512, 256, 128};
  for (int i = 0; i < 3; ++i) {
    if (smem_bytes(UPC, hidden, kc, batch) <= (size_t)max_smem) break;
    if (chunks[i] < hidden) kc = chunks[i];
  }
  const size_t smem = smem_bytes(UPC, hidden, kc, batch);
  if (smem > (size_t)max_smem) return kUnsupported;
  const void* fn = reinterpret_cast<const void*>(&lstm1_fwd_kernel<UPC, TRAIN>);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  void* args[] = {(void*)&ih,     (void*)&w_hh,   (void*)&g_out,
                  (void*)&h_x,    (void*)&c_out,  (void*)&finals,
                  (void*)&batch,  (void*)&t_len,  (void*)&hidden,
                  (void*)&kc,     (void*)&series};
  // refuses (cudaErrorCooperativeLaunchTooLarge) a grid that cannot be
  // resident all at once, so the grid barrier cannot deadlock
  err = cudaLaunchCooperativeKernel(fn, dim3(hidden / UPC), dim3(NT), args,
                                    smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Units per CTA: the fewest that keep the grid within one CTA per SM.
// UPC 1, 2, 4 and 8 cover H up to 8 times the SM count (1056 on the
// H100), as far as shared memory allows; other shapes are refused.
template <bool TRAIN>
int dispatch(const float* ih, const float* w_hh, float* g_out, float* h_x,
             float* c_out, float* finals, int batch, int t_len, int hidden,
             int series, void* stream) {
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
#define LSTM1_TRY(U)                                                          \
  if (hidden % (U) == 0 && hidden / (U) <= sms)                               \
    return launch<U, TRAIN>(ih, w_hh, g_out, h_x, c_out, finals, batch,       \
                            t_len, hidden, series, max_smem, s);
  LSTM1_TRY(1)
  LSTM1_TRY(2)
  LSTM1_TRY(4)
  LSTM1_TRY(8)
#undef LSTM1_TRY
  return kUnsupported;
}

}  // namespace

extern "C" int lstm1_fwd_train_launch(const float* ih, const float* w_hh,
                                      float* g, float* h_prev, float* c_prev,
                                      float* finals, int batch, int t_len,
                                      int hidden, void* stream) {
  return dispatch<true>(ih, w_hh, g, h_prev, c_prev, finals, batch, t_len,
                        hidden, 0, stream);
}

extern "C" int lstm1_fwd_infer_launch(const float* ih, const float* w_hh,
                                      float* h_out, int batch, int t_len,
                                      int hidden, int series, void* stream) {
  return dispatch<false>(ih, w_hh, nullptr, h_out, nullptr, nullptr, batch,
                         t_len, hidden, series, stream);
}

RNN_TIMERS_EXPORT(lstm1_fwd)

extern "C" const char* lstm1_fwd_error_string(int err) {
  if (err == kUnsupported) return "shape not supported by lstm1_fwd";
  return cudaGetErrorString((cudaError_t)err);
}
