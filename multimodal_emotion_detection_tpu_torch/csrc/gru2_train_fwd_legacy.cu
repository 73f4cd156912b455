// 2-layer GRU training forward in the legacy layout for Hopper (sm_90a):
// the first design of the 2-layer training forward, kept for this form.
//
// Replaces: multimodal_emotion_detection_tpu/ops/lstm_kernel.py::
// gru2_train_fwd_pallas (kernel body _gru2_fwd_train_kernel).  Same
// function as the plain PyTorch version ops/lstm_kernel.py::
// gru2_train_fwd_legacy_reference: given layer 0's hoisted input
// projection ih0 = x @ w_ih0 + b_ih0 (T, B, 3H, time-major) and the
// layer-0 -> 1 keep mask (T, B, H), run from zero state for t = 0..T-1
//
//   h0 = gru(h0, ih0[t], w_hh0, b_hh0)
//   x1 = h0 * keep[t]
//   h1 = gru(h1, x1 @ w_ih1 + b_ih1, w_hh1, b_hh1)
//
// (gru as in gru2_infer.cu) and store the older layout of the TPU kernel
// _gru2_fwd_train_kernel:
//   res[t] (B, 10H) = [r0 | z0 | n0 | hn0 | h0 | r1 | z1 | n1 | hn1 | h1],
//                     activations, hn = h_prev @ W_hn + b_hn before r, and
//                     h the state AFTER step t
//   h_final (B, H) = h1 after step T-1.
// The residual-native layout (row 14) is gru2_train_fwd.cu, on the 2-layer
// forward core rnn2_fwd_chain.cuh.
//
// What bounds it on the H100: the serial chain, as for gru2_infer.  At the
// GRU config's shape (B=32, T=372, D=64, H=256) the input projection and
// the recurrent products are 15.2 GFLOP and the residual stores ~122 MB
// (~0.23 ms at 67 TFLOP/s, ~0.04 ms at 3.35 TB/s), but every step needs
// the whole previous hidden state of all units, so T+1 device-wide
// exchanges set the time.
//
// Design: the first 2-layer design, with the GRU cell.  One persistent
// cooperative launch; CTA c owns hidden units [c*UPC, (c+1)*UPC) of both
// layers and keeps their gate columns of w_hh0, w_ih1 and w_hh1 in shared
// memory.  The layers are wavefronted: phase p runs layer 0 at step p and
// layer 1 at step p-1, one grid barrier per phase, T+1 in all.  The
// residual output is itself the exchange, through its own h lanes: phase
// p reads h0(p-1) = res[p-1] lane 4H and h1(p-2) = res[p-2] lane 9H (rows
// 10H apart, through L2, ld.cg), rows no CTA writes in the same phase, and
// forms layer 1's input x1(p-1) = h0(p-1) * keep[p-1] from the same tile
// and a tile of keep inside the product, so it stores no x1; a unit's own
// previous h comes back from the tile.  The state tiles load a row per
// warp (state_tile.cuh).  A cell thread stores its unit's r, z, n, hn and
// h as single floats spread over the 10H row: the stores are not
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

// acc[c] += x * w[c] over the G gate columns of one weight row in shared
// memory, in float2 pieces where G is even
template <int G>
__device__ __forceinline__ void fma_cols(float (&acc)[G], float x, const float* w) {
  if constexpr (G % 2 == 0) {
    const float2* w2 = reinterpret_cast<const float2*>(w);
#pragma unroll
    for (int q = 0; q < G / 2; ++q) {
      const float2 v = w2[q];
      acc[2 * q] += x * v.x;
      acc[2 * q + 1] += x * v.y;
    }
  } else {
#pragma unroll
    for (int c = 0; c < G; ++c) acc[c] += x * w[c];
  }
}

// the GRU cell for one (row, unit): input part ih[3] and recurrent part
// hh[3] (biases included) of the r, z, n gates, previous h -> new h, and
// the activations a[4] = {r, z, n, hn} the backward reads
__device__ __forceinline__ float gru_cell(const float* ih, const float* hh,
                                          float h, float* a) {
  a[0] = sigmoidf(ih[0] + hh[0]);
  a[1] = sigmoidf(ih[1] + hh[1]);
  a[2] = tanhf(ih[2] + a[0] * hh[2]);
  a[3] = hh[2];
  return (1.0f - a[1]) * a[2] + a[1] * h;
}

template <int UPC>
__global__ void __launch_bounds__(NT) gru2_train_fwd_legacy_kernel(
    const float* __restrict__ ih0,    // (T, B, 3H)
    const float* __restrict__ keep,   // (T, B, H)
    const float* __restrict__ w_hh0,  // (H, 3H)
    const float* __restrict__ b_hh0,  // (3H)
    const float* __restrict__ w_ih1,  // (H, 3H)
    const float* __restrict__ b_ih1,  // (3H)
    const float* __restrict__ w_hh1,  // (H, 3H)
    const float* __restrict__ b_hh1,  // (3H)
    float* res,                       // (T, B, 10H) out, also the h exchange
    float* __restrict__ h_final,      // (B, H) out
    int batch, int t_len, int hidden) {
  constexpr int G = 3 * UPC;  // gate columns a CTA owns
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) float smem[];
  const int H = hidden;
  const int H3 = 3 * H;
  const int PW = 10 * H;             // res row width
  const int HP = H + 1;              // odd row stride: rows in distinct banks
  float* w0 = smem;                  // H * G
  float* wi1 = w0 + H * G;           // H * G
  float* wh1 = wi1 + H * G;          // H * G
  float* red = wh1 + H * G;          // NW * 3 * G * ROWS partial sums
  float* ta = red + NW * 3 * G * ROWS;  // ROWS * HP : h0(p-1)
  float* tx = ta + ROWS * HP;        // ROWS * HP : keep[p-1]
  float* tb = tx + ROWS * HP;        // ROWS * HP : h1(p-2)

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int j0 = blockIdx.x * UPC;
  const size_t BH = (size_t)batch * H;

  // column col = g*UPC + u of the CTA <-> column g*H + j0 + u of W
  for (int i = tid; i < H * G; i += NT) {
    const int k = i / G, col = i % G;
    const size_t src = (size_t)k * H3 + (col / UPC) * H + j0 + col % UPC;
    w0[i] = w_hh0[src];
    wi1[i] = w_ih1[src];
    wh1[i] = w_hh1[src];
  }

  // this thread's cell update, if any: row cr, unit cu, layer cl
  const bool has_cell = tid < 2 * UPC * ROWS;
  const int cr = tid % ROWS;
  const int cu = (tid / ROWS) % UPC;
  const int cl = tid / (ROWS * UPC);
  const int j = j0 + cu;
  float bhh[3], bih[3];
#pragma unroll
  for (int g = 0; g < 3; ++g) {
    bhh[g] = has_cell ? (cl == 0 ? b_hh0 : b_hh1)[g * H + j] : 0.0f;
    bih[g] = (has_cell && cl == 1) ? b_ih1[g * H + j] : 0.0f;
  }

  for (int p = 0; p <= t_len; ++p) {
    const bool do0 = p < t_len;  // layer 0 at step p
    const bool do1 = p >= 1;     // layer 1 at step s = p-1
    const int s = p - 1;
    const size_t RW = (size_t)batch * PW;
    // h0(p-1), keep[p-1] and h1(p-2)
    const float* src_a = p >= 1 ? res + (size_t)(p - 1) * RW + 4 * H : nullptr;
    const float* src_x = do1 ? keep + (size_t)s * BH : nullptr;
    const float* src_b = p >= 2 ? res + (size_t)(p - 2) * RW + 9 * H : nullptr;

    for (int bt0 = 0; bt0 < batch; bt0 += ROWS) {
      const int nb = min(ROWS, batch - bt0);
      const bool cell = has_cell && cr < nb;
      const int cb = bt0 + cr;
      const size_t o = (size_t)cb * H + j;  // (b, j) in a (B, H) array
      // layer 0's ih0 values come from device memory: start first
      float ihv[3];
      if (cell && cl == 0 && do0) {
        const float* src = ih0 + ((size_t)p * batch + cb) * H3 + j;
#pragma unroll
        for (int g = 0; g < 3; ++g) ihv[g] = __ldg(src + g * H);
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
          fma_cols<G>(a0, ra[k], w0 + k * G);
          // x1 = h0 * keep, the product the residual-native form stores
          fma_cols<G>(a1, ra[k] * rx[k], wi1 + k * G);
          fma_cols<G>(a2, rb[k], wh1 + k * G);
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
        float hh[3], act[4];
#pragma unroll
        for (int g = 0; g < 3; ++g) {
          const int col = g * UPC + cu;
          float acc = 0.0f;
#pragma unroll
          for (int w = 0; w < NW; ++w) acc += red[((w * 3 + 0) * G + col) * ROWS + cr];
          hh[g] = acc + bhh[g];
        }
        const float h = gru_cell(ihv, hh, ta[cr * HP + j], act);
        float* pk = res + ((size_t)p * batch + cb) * PW + j;
#pragma unroll
        for (int g = 0; g < 4; ++g) pk[g * H] = act[g];
        pk[4 * H] = h;
      }
      if (cell && cl == 1 && do1) {
        float ih[3], hh[3], act[4];
#pragma unroll
        for (int g = 0; g < 3; ++g) {
          const int col = g * UPC + cu;
          float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
          for (int w = 0; w < NW; ++w) {
            s1 += red[((w * 3 + 1) * G + col) * ROWS + cr];
            s2 += red[((w * 3 + 2) * G + col) * ROWS + cr];
          }
          ih[g] = s1 + bih[g];
          hh[g] = s2 + bhh[g];
        }
        const float h = gru_cell(ih, hh, tb[cr * HP + j], act);
        float* pk = res + ((size_t)s * batch + cb) * PW + 5 * H + j;
#pragma unroll
        for (int g = 0; g < 4; ++g) pk[g * H] = act[g];
        pk[4 * H] = h;
        if (s + 1 == t_len) h_final[o] = h;
      }
    }
    grid.sync();
  }
}

template <int UPC>
int launch(const float* ih0, const float* keep, const float* w_hh0,
           const float* b_hh0, const float* w_ih1, const float* b_ih1,
           const float* w_hh1, const float* b_hh1, float* res, float* h_final,
           int batch, int t_len, int hidden, int max_smem, cudaStream_t stream) {
  constexpr int G = 3 * UPC;
  const size_t smem =
      (size_t)(3 * hidden * G + NW * 3 * G * ROWS + 3 * ROWS * (hidden + 1)) *
      sizeof(float);
  if (smem > (size_t)max_smem) return kUnsupported;
  const void* fn = reinterpret_cast<const void*>(&gru2_train_fwd_legacy_kernel<UPC>);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  void* args[] = {(void*)&ih0,   (void*)&keep,  (void*)&w_hh0,   (void*)&b_hh0,
                  (void*)&w_ih1, (void*)&b_ih1, (void*)&w_hh1,   (void*)&b_hh1,
                  (void*)&res,   (void*)&h_final, (void*)&batch, (void*)&t_len,
                  (void*)&hidden};
  // refuses (cudaErrorCooperativeLaunchTooLarge) a grid that cannot be
  // resident all at once, so the grid barrier cannot deadlock
  err = cudaLaunchCooperativeKernel(fn, dim3(hidden / UPC), dim3(NT), args,
                                    smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// res (T, B, 10H) = [r0|z0|n0|hn0|h0 | r1|z1|n1|hn1|h1] after each step,
// h_final (B, H).  Units per CTA: the fewest that keep the grid within one
// CTA per SM; UPC 1 and 2 cover H up to twice the SM count (264 on the
// H100); larger H is refused as unsupported.
extern "C" int gru2_train_fwd_legacy_launch(
    const float* ih0, const float* keep, const float* w_hh0,
    const float* b_hh0, const float* w_ih1, const float* b_ih1,
    const float* w_hh1, const float* b_hh1, float* res, float* h_final,
    int batch, int t_len, int hidden, void* stream) {
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
    return launch<U>(ih0, keep, w_hh0, b_hh0, w_ih1, b_ih1, w_hh1, b_hh1,    \
                     res, h_final, batch, t_len, hidden, max_smem, s);
  GRU2_TRY(1)
  GRU2_TRY(2)
#undef GRU2_TRY
  return kUnsupported;
}

extern "C" const char* gru2_train_fwd_legacy_error_string(int err) {
  if (err == kUnsupported) return "shape not supported by gru2_train_fwd_legacy";
  return cudaGetErrorString((cudaError_t)err);
}
