// 2-layer LSTM training forward in the legacy layout for Hopper (sm_90a):
// the first design of the 2-layer training forward, kept for this form.
//
// Replaces: multimodal_emotion_detection_tpu/ops/lstm_kernel.py::
// lstm2_train_fwd_pallas (kernel body _lstm2_fwd_train_kernel).  Same
// function as the plain PyTorch version ops/lstm_kernel.py::
// lstm2_train_fwd_legacy_reference: given layer 0's hoisted input
// projection ih0 = x @ w_ih0 + b0 (T, B, 4H, time-major) and the
// layer-0 -> 1 keep mask (T, B, H), run from zero state for t = 0..T-1
//
//   g0 = ih0[t] + h0 @ w_hh0                 ; (h0, c0) = cell(g0, c0)
//   x1 = h0 * keep[t]
//   g1 = (x1 @ w_ih1 + b1) + h1 @ w_hh1      ; (h1, c1) = cell(g1, c1)
//
// and store the older layout of the TPU kernel _lstm2_fwd_train_kernel:
//   res[t] (B, 12H) = [g0 | g1 | h0 | h1 | c0 | c1], the states AFTER step t
//   h_final (B, H) = h1 after step T-1.
// The residual-native layout (rows 11 and 11n) is lstm2_train_fwd.cu, on
// the 2-layer forward core rnn2_fwd_chain.cuh.
//
// What bounds it on the H100: the serial chain, as for lstm2_infer.  At the
// flagship shape (B=32, T=372, H=256) the recurrent products are 18.7 GFLOP
// and the residual stores 146 MB (~0.28 ms at 67 TFLOP/s, ~0.04 ms at
// 3.35 TB/s), but every step needs the whole previous hidden state of all
// units, so T+1 device-wide exchanges set the time.
//
// Design: one persistent cooperative launch; CTA c owns hidden units
// [c*UPC, (c+1)*UPC) of both layers, keeps their gate columns of w_hh0,
// w_ih1 and w_hh1 in shared memory and their cell state in the CTA.  The
// layers are wavefronted: phase p runs layer 0 at step p and layer 1 at
// step p-1, one grid barrier per phase, T+1 in all.  The residual output
// is itself the exchange, through its own h lanes: phase p reads h0(p-1) =
// res[p-1] lane 8H and h1(p-2) = res[p-2] lane 9H (rows 12H apart, through
// L2, ld.cg), rows no CTA writes in the same phase, and forms layer 1's
// input x1(p-1) = h0(p-1) * keep[p-1] from the same tile and a tile of
// keep inside the product, so it stores no x1.  The state tiles load a row
// per warp (state_tile.cuh).  A cell thread stores its unit's 4 gates, h
// and c as single floats spread over the 12H row: the stores are not
// coalesced, which L2 absorbs before they reach device memory.  Exactly T
// steps run; any B >= 1.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include "state_tile.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 256;          // threads per CTA
constexpr int NW = NT / 32;      // warps = slices of each dot product
constexpr int ROWS = 32;         // batch rows per pass: one per lane
constexpr int LOADS = 8;         // float4 loads in flight per thread and tile
constexpr int kUnsupported = -1; // shape the kernel does not take

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.0f / (1.0f + expf(-x));
}

template <int UPC>
__global__ void __launch_bounds__(NT) lstm2_train_fwd_legacy_kernel(
    const float* __restrict__ ih0,    // (T, B, 4H)
    const float* __restrict__ keep,   // (T, B, H)
    const float* __restrict__ w_hh0,  // (H, 4H)
    const float* __restrict__ w_ih1,  // (H, 4H)
    const float* __restrict__ b1,     // (4H)
    const float* __restrict__ w_hh1,  // (H, 4H)
    float* res,                       // (T, B, 12H) out, also the h exchange
    float* __restrict__ h_final,      // (B, H) out
    int batch, int t_len, int hidden) {
  constexpr int G = 4 * UPC;  // gate columns a CTA owns
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) float smem[];
  const int H = hidden;
  const int H4 = 4 * H;
  const int PW = 12 * H;             // res row width
  const int HP = H + 1;              // odd row stride: rows in distinct banks
  float* w0 = smem;                  // H * G
  float* wi1 = w0 + H * G;           // H * G
  float* wh1 = wi1 + H * G;          // H * G
  float* red = wh1 + H * G;          // NW * 3 * G * ROWS partial sums
  float* ta = red + NW * 3 * G * ROWS;  // ROWS * HP : h0(p-1)
  float* tx = ta + ROWS * HP;        // ROWS * HP : keep[p-1]
  float* tb = tx + ROWS * HP;        // ROWS * HP : h1(p-2)
  float* c0s = tb + ROWS * HP;       // batch * UPC
  float* c1s = c0s + batch * UPC;    // batch * UPC

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int j0 = blockIdx.x * UPC;
  const size_t BH = (size_t)batch * H;

  // column col = g*UPC + u of the CTA <-> column g*H + j0 + u of W
  for (int i = tid; i < H * G; i += NT) {
    const int k = i / G, col = i % G;
    const size_t src = (size_t)k * H4 + (col / UPC) * H + j0 + col % UPC;
    w0[i] = w_hh0[src];
    wi1[i] = w_ih1[src];
    wh1[i] = w_hh1[src];
  }
  for (int i = tid; i < batch * UPC; i += NT) c0s[i] = c1s[i] = 0.0f;

  // this thread's cell update, if any: row cr, unit cu, layer cl
  const bool has_cell = tid < 2 * UPC * ROWS;
  const int cr = tid % ROWS;
  const int cu = (tid / ROWS) % UPC;
  const int cl = tid / (ROWS * UPC);
  const int j = j0 + cu;
  float bias[4];
#pragma unroll
  for (int g = 0; g < 4; ++g)
    bias[g] = (has_cell && cl == 1) ? b1[g * H + j] : 0.0f;

  for (int p = 0; p <= t_len; ++p) {
    const bool do0 = p < t_len;  // layer 0 at step p
    const bool do1 = p >= 1;     // layer 1 at step s = p-1
    const int s = p - 1;
    const size_t RW = (size_t)batch * PW;
    // h0(p-1), keep[p-1] and h1(p-2)
    const float* src_a = p >= 1 ? res + (size_t)(p - 1) * RW + 8 * H : nullptr;
    const float* src_x = do1 ? keep + (size_t)s * BH : nullptr;
    const float* src_b = p >= 2 ? res + (size_t)(p - 2) * RW + 9 * H : nullptr;

    for (int bt0 = 0; bt0 < batch; bt0 += ROWS) {
      const int nb = min(ROWS, batch - bt0);
      const bool cell = has_cell && cr < nb;
      const int cb = bt0 + cr;
      const size_t o = (size_t)cb * H + j;  // (b, j) in a (B, H) array
      // layer 0's ih0 values come from device memory: start first
      float ihv[4];
      if (cell && cl == 0 && do0) {
        const float* src = ih0 + ((size_t)p * batch + cb) * H4 + j;
#pragma unroll
        for (int g = 0; g < 4; ++g) ihv[g] = __ldg(src + g * H);
      }

      __syncthreads();
      state_tile::load_rows<NW, LOADS>(src_a, ta, bt0, nb, H, PW, lane, warp);
      state_tile::load_rows<NW, LOADS>(src_x, tx, bt0, nb, H, H, lane, warp);
      state_tile::load_rows<NW, LOADS>(src_b, tb, bt0, nb, H, PW, lane, warp);
      __syncthreads();

      float a0[G], a1[G], a2[G];
#pragma unroll
      for (int col = 0; col < G; ++col) a0[col] = a1[col] = a2[col] = 0.0f;
      if (lane < nb) {
        const float* ra = ta + lane * HP;
        const float* rx = tx + lane * HP;
        const float* rb = tb + lane * HP;
        for (int k = warp; k < H; k += NW) {
          const float va_ = ra[k];
          // x1 = h0 * keep, the product the residual-native form stores
          const float vx_ = va_ * rx[k];
          const float vb_ = rb[k];
          const float4* wa = reinterpret_cast<const float4*>(w0 + k * G);
          const float4* wb = reinterpret_cast<const float4*>(wi1 + k * G);
          const float4* wc = reinterpret_cast<const float4*>(wh1 + k * G);
#pragma unroll
          for (int q = 0; q < G / 4; ++q) {
            const float4 ea = wa[q], eb = wb[q], ec = wc[q];
            a0[4 * q + 0] += va_ * ea.x; a0[4 * q + 1] += va_ * ea.y;
            a0[4 * q + 2] += va_ * ea.z; a0[4 * q + 3] += va_ * ea.w;
            a1[4 * q + 0] += vx_ * eb.x; a1[4 * q + 1] += vx_ * eb.y;
            a1[4 * q + 2] += vx_ * eb.z; a1[4 * q + 3] += vx_ * eb.w;
            a2[4 * q + 0] += vb_ * ec.x; a2[4 * q + 1] += vb_ * ec.y;
            a2[4 * q + 2] += vb_ * ec.z; a2[4 * q + 3] += vb_ * ec.w;
          }
        }
      }
      // red[((w*3 + m)*G + col)*ROWS + row]: lanes write consecutive words
#pragma unroll
      for (int col = 0; col < G; ++col) {
        red[((warp * 3 + 0) * G + col) * ROWS + lane] = a0[col];
        red[((warp * 3 + 1) * G + col) * ROWS + lane] = a1[col];
        red[((warp * 3 + 2) * G + col) * ROWS + lane] = a2[col];
      }
      __syncthreads();

      if (cell && cl == 0 && do0) {
        float g4[4];
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          const int col = g * UPC + cu;
          float acc = 0.0f;
#pragma unroll
          for (int w = 0; w < NW; ++w) acc += red[((w * 3 + 0) * G + col) * ROWS + cr];
          g4[g] = ihv[g] + acc;
        }
        const float c_prev = c0s[cb * UPC + cu];
        const float c = sigmoidf(g4[1]) * c_prev + sigmoidf(g4[0]) * tanhf(g4[2]);
        const float h = sigmoidf(g4[3]) * tanhf(c);
        c0s[cb * UPC + cu] = c;
        float* pk = res + ((size_t)p * batch + cb) * PW + j;
#pragma unroll
        for (int g = 0; g < 4; ++g) pk[g * H] = g4[g];
        pk[8 * H] = h;
        pk[10 * H] = c;
      }
      if (cell && cl == 1 && do1) {
        float g4[4];
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          const int col = g * UPC + cu;
          float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
          for (int w = 0; w < NW; ++w) {
            s1 += red[((w * 3 + 1) * G + col) * ROWS + cr];
            s2 += red[((w * 3 + 2) * G + col) * ROWS + cr];
          }
          g4[g] = (s1 + bias[g]) + s2;
        }
        const float c_prev = c1s[cb * UPC + cu];
        const float c = sigmoidf(g4[1]) * c_prev + sigmoidf(g4[0]) * tanhf(g4[2]);
        const float h = sigmoidf(g4[3]) * tanhf(c);
        c1s[cb * UPC + cu] = c;
        float* pk = res + ((size_t)s * batch + cb) * PW + j;
#pragma unroll
        for (int g = 0; g < 4; ++g) pk[(4 + g) * H] = g4[g];
        pk[9 * H] = h;
        pk[11 * H] = c;
        if (s + 1 == t_len) h_final[o] = h;
      }
    }
    grid.sync();
  }
}

template <int UPC>
int launch(const float* ih0, const float* keep, const float* w_hh0,
           const float* w_ih1, const float* b1, const float* w_hh1, float* res,
           float* h_final, int batch, int t_len, int hidden, int max_smem,
           cudaStream_t stream) {
  constexpr int G = 4 * UPC;
  const size_t smem =
      (size_t)(3 * hidden * G + NW * 3 * G * ROWS + 3 * ROWS * (hidden + 1) +
               2 * batch * UPC) * sizeof(float);
  if (smem > (size_t)max_smem) return kUnsupported;
  const void* fn = reinterpret_cast<const void*>(&lstm2_train_fwd_legacy_kernel<UPC>);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  void* args[] = {(void*)&ih0,   (void*)&keep,    (void*)&w_hh0, (void*)&w_ih1,
                  (void*)&b1,    (void*)&w_hh1,   (void*)&res,   (void*)&h_final,
                  (void*)&batch, (void*)&t_len,   (void*)&hidden};
  // refuses (cudaErrorCooperativeLaunchTooLarge) a grid that cannot be
  // resident all at once, so the grid barrier cannot deadlock
  err = cudaLaunchCooperativeKernel(fn, dim3(hidden / UPC), dim3(NT), args,
                                    smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// res (T, B, 12H) = [g0 | g1 | h0 | h1 | c0 | c1] after each step, h_final
// (B, H).  Units per CTA: the fewest that keep the grid within one CTA per
// SM; UPC 1 and 2 cover H up to twice the SM count (264 on the H100);
// larger H is refused as unsupported.
extern "C" int lstm2_train_fwd_legacy_launch(
    const float* ih0, const float* keep, const float* w_hh0,
    const float* w_ih1, const float* b1, const float* w_hh1, float* res,
    float* h_final, int batch, int t_len, int hidden, void* stream) {
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
#define LSTM2_TRY(U)                                                          \
  if (hidden % (U) == 0 && hidden / (U) <= sms)                               \
    return launch<U>(ih0, keep, w_hh0, w_ih1, b1, w_hh1, res, h_final, batch, \
                     t_len, hidden, max_smem, s);
  LSTM2_TRY(1)
  LSTM2_TRY(2)
#undef LSTM2_TRY
  return kUnsupported;
}

extern "C" const char* lstm2_train_fwd_legacy_error_string(int err) {
  if (err == kUnsupported) return "shape not supported by lstm2_train_fwd_legacy";
  return cudaGetErrorString((cudaError_t)err);
}
