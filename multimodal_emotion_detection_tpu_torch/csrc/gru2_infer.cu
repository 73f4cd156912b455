// 2-layer GRU inference (final hidden state only) for Hopper (sm_90a).
//
// Replaces: multimodal_emotion_detection_tpu/ops/lstm_kernel.py::
// gru2_infer_pallas (kernel body _gru2_infer_kernel).  Same function as the
// plain PyTorch version ops/lstm_kernel.py::gru2_infer_reference: given
// layer 0's hoisted input projection ih0 = x @ w_ih0 + b_ih0 (B, T, 3H), run
//
//   h0 = gru(h0, ih0[:, t], w_hh0, b_hh0)
//   h1 = gru(h1, h0 @ w_ih1 + b_ih1, w_hh1, b_hh1)
//
// for t = 0..T-1 from zero state and write the last h1 (B, H).  Gate order
// r, z, n; gru(h, ih, W, b): hh = h @ W + b, r = sig(ih_r + hh_r),
// z = sig(ih_z + hh_z), n = tanh(ih_n + r * hh_n), h' = (1 - z) n + z h.
// b_hh stays beside h @ W: its n third sits inside the reset product.
//
// What bounds it on the H100: the serial chain.  At the flagship shape
// (B=32, T=372, D=64, H=256) the input projection and the three recurrent
// products are 15.2 GFLOP (~0.23 ms at the 67 TFLOP/s float32 rate); but
// every step of each layer needs the whole previous hidden state of all
// units, so the work is 2 x 372 dependent steps whose latency (a
// device-wide exchange of h per step) rather than arithmetic sets the time.
//
// Design: lstm2_infer.cu's, with three gates instead of four.  The TPU
// kernel keeps the three 768 KB recurrent matrices in one core's VMEM; here
// they are split over one persistent cooperative launch: CTA c owns the
// hidden units j in [c*UPC, (c+1)*UPC) of both layers and keeps the three
// gate columns {r,z,n}*H + j of w_hh0, w_ih1 and w_hh1 in shared memory
// for the whole sequence (18 KB at H=256, UPC=2, 128 CTAs).  h is the
// whole state: it travels through small double-buffered global arrays,
// read through L2 (ld.cg) in float4 pieces, all of a thread's pieces in
// flight at once, and a unit's own previous h is read back from the tile.
// The layers are wavefronted: phase p runs layer 0 at step p and layer 1
// at step p-1, both of which read h0(p-1), so one grid barrier per phase
// suffices: T+1 barriers in all instead of 2T.
//
// Inside a CTA, lane r of every warp holds batch row r and warp w one
// strided slice k = w, w+8, ... of the H-long dot products, for all of the
// CTA's gate columns.  The 8 partial sums meet in shared memory, where one
// thread per (row, unit, layer) adds them up and runs its cell update.
// Exactly T steps run: no padding of T, any B >= 1.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

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
// hh[3] (biases included) of the r, z, n gates, previous h
__device__ __forceinline__ float gru_cell(const float* ih, const float* hh, float h) {
  const float r = sigmoidf(ih[0] + hh[0]);
  const float z = sigmoidf(ih[1] + hh[1]);
  const float n = tanhf(ih[2] + r * hh[2]);
  return (1.0f - z) * n + z * h;
}

template <int UPC>
__global__ void __launch_bounds__(NT) gru2_infer_kernel(
    const float* __restrict__ ih0,    // (B, T, 3H)
    const float* __restrict__ w_hh0,  // (H, 3H)
    const float* __restrict__ b_hh0,  // (3H)
    const float* __restrict__ w_ih1,  // (H, 3H)
    const float* __restrict__ b_ih1,  // (3H)
    const float* __restrict__ w_hh1,  // (H, 3H)
    const float* __restrict__ b_hh1,  // (3H)
    float* h0buf,                     // (2, B, H), slot 1 zero on entry
    float* h1buf,                     // (2, B, H), slot 1 zero on entry
    float* __restrict__ out,          // (B, H)
    int batch, int t_len, int hidden) {
  constexpr int G = 3 * UPC;  // gate columns a CTA owns
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) float smem[];
  const int H = hidden;
  const int H3 = 3 * H;
  const int HP = H + 1;              // odd row stride: rows in distinct banks
  float* w0 = smem;                  // H * G
  float* wi1 = w0 + H * G;           // H * G
  float* wh1 = wi1 + H * G;          // H * G
  float* red = wh1 + H * G;          // NW * 3 * G * ROWS partial sums
  float* ha = red + NW * 3 * G * ROWS;  // ROWS * HP : h0(p-1) tile
  float* hb = ha + ROWS * HP;        // ROWS * HP : h1(p-2) tile

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int j0 = blockIdx.x * UPC;

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
    const bool do1 = p >= 1;     // layer 1 at step p-1
    const float* h0prev = h0buf + (size_t)((p + 1) & 1) * batch * H;  // h0(p-1)
    float* h0new = h0buf + (size_t)(p & 1) * batch * H;               // h0(p)
    const float* h1prev = h1buf + (size_t)(p & 1) * batch * H;        // h1(p-2)
    float* h1new = h1buf + (size_t)((p + 1) & 1) * batch * H;         // h1(p-1)

    for (int bt0 = 0; bt0 < batch; bt0 += ROWS) {
      const int nb = min(ROWS, batch - bt0);
      const bool cell = has_cell && cr < nb;
      const int cb = bt0 + cr;
      // layer 0's ih0 values come from device memory: start them first
      float ihv[3];
      if (cell && cl == 0 && do0) {
        const float* src = ih0 + ((size_t)cb * t_len + p) * H3 + j;
#pragma unroll
        for (int g = 0; g < 3; ++g) ihv[g] = __ldg(src + g * H);
      }

      // lane = row, warp = strided float4 columns (H % 4 == 0)
      __syncthreads();
      if (lane < nb) {
        const float4* r0 = reinterpret_cast<const float4*>(h0prev + (size_t)(bt0 + lane) * H);
        const float4* r1 = reinterpret_cast<const float4*>(h1prev + (size_t)(bt0 + lane) * H);
        float* d0 = ha + lane * HP;
        float* d1 = hb + lane * HP;
        const int h4 = H / 4;
        for (int q0 = warp; q0 < h4; q0 += NW * LOADS) {
          float4 v0[LOADS], v1[LOADS];
#pragma unroll
          for (int u = 0; u < LOADS; ++u) {
            const int q = q0 + NW * u;
            if (q < h4) {
              v0[u] = __ldcg(r0 + q);
              v1[u] = __ldcg(r1 + q);
            }
          }
#pragma unroll
          for (int u = 0; u < LOADS; ++u) {
            const int q = q0 + NW * u;
            if (q < h4) {
              float* e0 = d0 + 4 * q;
              float* e1 = d1 + 4 * q;
              e0[0] = v0[u].x; e0[1] = v0[u].y; e0[2] = v0[u].z; e0[3] = v0[u].w;
              e1[0] = v1[u].x; e1[1] = v1[u].y; e1[2] = v1[u].z; e1[3] = v1[u].w;
            }
          }
        }
      }
      __syncthreads();

      float a0[G], a1[G], a2[G];
#pragma unroll
      for (int col = 0; col < G; ++col) a0[col] = a1[col] = a2[col] = 0.0f;
      if (lane < nb) {
        const float* hr0 = ha + lane * HP;
        const float* hr1 = hb + lane * HP;
        for (int k = warp; k < H; k += NW) {
          const float x = hr0[k];
          const float y = hr1[k];
          fma_cols<G>(a0, x, w0 + k * G);
          fma_cols<G>(a1, x, wi1 + k * G);
          fma_cols<G>(a2, y, wh1 + k * G);
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
        float hh[3];
#pragma unroll
        for (int g = 0; g < 3; ++g) {
          const int col = g * UPC + cu;
          float s = 0.0f;
#pragma unroll
          for (int w = 0; w < NW; ++w) s += red[((w * 3 + 0) * G + col) * ROWS + cr];
          hh[g] = s + bhh[g];
        }
        h0new[(size_t)cb * H + j] = gru_cell(ihv, hh, ha[cr * HP + j]);
      }
      if (cell && cl == 1 && do1) {
        float ih[3], hh[3];
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
        const float h = gru_cell(ih, hh, hb[cr * HP + j]);
        h1new[(size_t)cb * H + j] = h;
        if (p == t_len) out[(size_t)cb * H + j] = h;
      }
    }
    grid.sync();
  }
}

template <int UPC>
int launch(const float* ih0, const float* w_hh0, const float* b_hh0,
           const float* w_ih1, const float* b_ih1, const float* w_hh1,
           const float* b_hh1, float* h0buf, float* h1buf, float* out,
           int batch, int t_len, int hidden, int max_smem, cudaStream_t stream) {
  constexpr int G = 3 * UPC;
  const size_t smem =
      (size_t)(3 * hidden * G + NW * 3 * G * ROWS + 2 * ROWS * (hidden + 1)) *
      sizeof(float);
  if (smem > (size_t)max_smem) return kUnsupported;
  const void* fn = reinterpret_cast<const void*>(&gru2_infer_kernel<UPC>);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  void* args[] = {(void*)&ih0,   (void*)&w_hh0, (void*)&b_hh0, (void*)&w_ih1,
                  (void*)&b_ih1, (void*)&w_hh1, (void*)&b_hh1, (void*)&h0buf,
                  (void*)&h1buf, (void*)&out,   (void*)&batch, (void*)&t_len,
                  (void*)&hidden};
  // refuses (cudaErrorCooperativeLaunchTooLarge) a grid that cannot be
  // resident all at once, so the grid barrier cannot deadlock
  err = cudaLaunchCooperativeKernel(fn, dim3(hidden / UPC), dim3(NT), args,
                                    smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// Units per CTA: the fewest that keep the grid within one CTA per SM, as in
// lstm2_infer.cu.  UPC 1 and 2 cover H up to twice the SM count (264 on the
// H100); larger H is refused as unsupported.
extern "C" int gru2_infer_launch(const float* ih0, const float* w_hh0,
                                 const float* b_hh0, const float* w_ih1,
                                 const float* b_ih1, const float* w_hh1,
                                 const float* b_hh1, float* h0buf,
                                 float* h1buf, float* out, int batch,
                                 int t_len, int hidden, void* stream) {
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
    return launch<U>(ih0, w_hh0, b_hh0, w_ih1, b_ih1, w_hh1, b_hh1, h0buf,   \
                     h1buf, out, batch, t_len, hidden, max_smem, s);
  GRU2_TRY(1)
  GRU2_TRY(2)
#undef GRU2_TRY
  return kUnsupported;
}

extern "C" const char* gru2_infer_error_string(int err) {
  if (err == kUnsupported) return "shape not supported by gru2_infer";
  return cudaGetErrorString((cudaError_t)err);
}
