// One GRU layer's reverse chain for Hopper (sm_90a).
//
// Replaces: multimodal_emotion_detection_tpu/ops/lstm_kernel.py::
// gru_bwd_chain_pallas (kernel body _gru_bwd_kernel, per-step math
// _gru_cell_bwd_k).  Same function as the plain PyTorch version
// ops/lstm_kernel.py::gru_bwd_chain_reference: over one layer's residuals
// of gru1_fwd (gates (T, B, 4H) = [r | z | n | hn], h_prev (T, B, H)), the
// per-step cotangent from the layer above dh_series (T, B, H; may be
// absent = zeros) and the final hidden state's dh_final (B, H), walk
// t = T-1 .. 0 with the carry dh (dh_final at the start):
//
//   dh_t = dh + dh_series[t]
//   dn_pre = dh_t (1 - z)(1 - n^2) ;  dr_pre = dn_pre hn r (1 - r)
//   dz_pre = dh_t (h_prev - n) z (1 - z) ;  dhn = dn_pre r
//   dih[t] = [dr_pre | dz_pre | dn_pre]
//   dh = dh_t z + [dr_pre | dz_pre | dhn] @ w_hh^T
//
// and write dih (T, B, 3H) and dhn (T, B, H).  The TPU kernel writes dhh
// = [dr_pre | dz_pre | dhn] whole; it shares its first 2H lanes with dih,
// so only its n lane is stored here (as csrc/gru2_bwd_chain.cu does).  The
// hop into the layer below and the hoisted weight gradients are plain
// matrix products outside (ops/lstm_vjp.py).
//
// What bounds it on the H100: the serial chain.  At the big sweep
// config's shape (B=32, T=372, H=512) the products are 18.72 GFLOP per
// layer (~0.28 ms at 67 TFLOP/s) and the streams ~0.24 GB, but each step
// needs the whole dhh row of the step before, so T device-wide exchanges
// set the time.
//
// Design: csrc/lstm_bwd_chain.cu's with csrc/gru2_bwd_chain.cu's cell.
// dh[b][j] = sum_m dhh[b][m] w_hh[j][m] runs over all 3H gate columns,
// which every CTA produces a slice of, so the forward's partition is
// transposed: CTA c keeps rows j in [c*UPC, (c+1)*UPC) of w_hh (UPC x 3H;
// 24 KB at H=512, UPC=4) in shared memory and, every step, reads the
// whole dhh row of the step before from the outputs themselves (the
// exchange; through L2, ld.cg): a float4 column c < 2H/4 from dih, a
// column past it from dhn.  Warp w takes batch rows w, w+8, ..; a lane
// takes float4 columns of the row, so a warp's loads are contiguous, and
// the partial dot products meet by shuffles.  The direct part dh_t z stays
// in the CTA, with the thread that owns the (row, unit); it starts as
// dh_final, when the products are zero.  The cell threads load their
// residuals before the products, to hide that latency.  One grid barrier
// per step, T in all.  Exactly T steps run; any B >= 1.

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

template <int UPC>
__global__ void __launch_bounds__(NT) gru_bwd_chain_kernel(
    const float* __restrict__ gates,     // (T, B, 4H)
    const float* __restrict__ h_prev,    // (T, B, H)
    const float* __restrict__ dh_series, // (T, B, H) or nullptr (zeros)
    const float* __restrict__ dh_final,  // (B, H)
    const float* __restrict__ w_hh,      // (H, 3H)
    float* dih,                          // (T, B, 3H) out, also the exchange
    float* dhn,                          // (T, B, H) out, also the exchange
    int batch, int t_len, int hidden) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) float smem[];
  const int H = hidden;
  const int H3 = 3 * H;
  const int H4 = 4 * H;
  float* wr = smem;                // UPC * 3H: wr[u*3H + col] = w_hh[j0+u][col]
  float* red = wr + UPC * H3;      // ROWS * UPC reduced products
  float* dds = red + ROWS * UPC;   // batch * UPC direct parts dh_t z

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int j0 = blockIdx.x * UPC;
  const size_t BH = (size_t)batch * H;
  const size_t BG = (size_t)batch * H3;

  for (int i = tid; i < UPC * H3; i += NT) wr[i] = w_hh[(size_t)j0 * H3 + i];
  // the carry starts as dh_final (the products are zero at the first step)
  for (int i = tid; i < batch * UPC; i += NT) {
    dds[i] = dh_final[(size_t)(i / UPC) * H + j0 + i % UPC];
  }

  // this thread's cell update, if any: row cr, unit cu
  const bool has_cell = tid < UPC * ROWS;
  const int cr = tid % ROWS;
  const int cu = tid / ROWS;
  const int j = j0 + cu;
  const int h4 = H / 4;   // float4 columns of an H row
  const int g4 = 3 * h4;  // float4 columns of a 3H row
  const float4* w4 = reinterpret_cast<const float4*>(wr);
  __syncthreads();

  for (int q = 0; q < t_len; ++q) {
    const int t = t_len - 1 - q;
    // dih(t+1) and dhn(t+1) feed this step's dh
    const bool have = q >= 1;

    for (int bt0 = 0; bt0 < batch; bt0 += ROWS) {
      const int nb = min(ROWS, batch - bt0);
      const bool cell = has_cell && cr < nb;
      const int cb = bt0 + cr;
      const size_t o = (size_t)cb * H + j;
      // the cell's residuals come from device memory: start them first
      float act[4], hp = 0.0f, dhs = 0.0f;
      if (cell) {
        const float* p = gates + ((size_t)t * batch + cb) * H4 + j;
#pragma unroll
        for (int i = 0; i < 4; ++i) act[i] = __ldg(p + i * H);
        hp = __ldg(h_prev + (size_t)t * BH + o);
        if (dh_series != nullptr) dhs = __ldg(dh_series + (size_t)t * BH + o);
      }

      // acc[r][u]: row bt0 + warp + NW*r, unit u
      float acc[RPW][UPC];
#pragma unroll
      for (int r = 0; r < RPW; ++r)
#pragma unroll
        for (int u = 0; u < UPC; ++u) acc[r][u] = 0.0f;
      if (have) {
#pragma unroll
        for (int r = 0; r < RPW; ++r) {
          const int row = bt0 + warp + NW * r;
          if (row >= batch) continue;  // warp-uniform
          const float4* ip = reinterpret_cast<const float4*>(
              dih + (size_t)(t + 1) * BG + (size_t)row * H3);
          const float4* np = reinterpret_cast<const float4*>(
              dhn + (size_t)(t + 1) * BH + (size_t)row * H);
          for (int c0 = lane; c0 < g4; c0 += 32 * LOADS) {
            float4 v[LOADS];
#pragma unroll
            for (int l = 0; l < LOADS; ++l) {
              const int c = c0 + 32 * l;
              v[l] = c < g4 ? __ldcg(c < 2 * h4 ? ip + c : np + (c - 2 * h4))
                            : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            }
#pragma unroll
            for (int l = 0; l < LOADS; ++l) {
              const int c = c0 + 32 * l;
              if (c < g4) {
#pragma unroll
                for (int u = 0; u < UPC; ++u) acc[r][u] += dot4(v[l], w4[u * g4 + c]);
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
        float* dd = dds + cb * UPC + cu;
        float d[4];
        *dd = cell_bwd(*dd + red[cr * UPC + cu] + dhs, hp, act, d);
        float* out = dih + (size_t)t * BG + (size_t)cb * H3 + j;
#pragma unroll
        for (int i = 0; i < 3; ++i) out[i * H] = d[i];
        dhn[(size_t)t * BH + o] = d[3];
      }
      __syncthreads();  // red is rewritten by the next pass
    }
    grid.sync();
  }
}

template <int UPC>
int launch(const float* gates, const float* h_prev, const float* dh_series,
           const float* dh_final, const float* w_hh, float* dih, float* dhn,
           int batch, int t_len, int hidden, int max_smem,
           cudaStream_t stream) {
  const size_t smem =
      (size_t)(UPC * 3 * hidden + ROWS * UPC + batch * UPC) * sizeof(float);
  if (smem > (size_t)max_smem) return kUnsupported;
  const void* fn = reinterpret_cast<const void*>(&gru_bwd_chain_kernel<UPC>);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  void* args[] = {(void*)&gates,    (void*)&h_prev, (void*)&dh_series,
                  (void*)&dh_final, (void*)&w_hh,   (void*)&dih,
                  (void*)&dhn,      (void*)&batch,  (void*)&t_len,
                  (void*)&hidden};
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
extern "C" int gru_bwd_chain_launch(const float* gates, const float* h_prev,
                                    const float* dh_series,
                                    const float* dh_final, const float* w_hh,
                                    float* dih, float* dhn, int batch,
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
#define GRU_BWD_TRY(U)                                                       \
  if (hidden % (U) == 0 && hidden / (U) <= sms)                              \
    return launch<U>(gates, h_prev, dh_series, dh_final, w_hh, dih, dhn,     \
                     batch, t_len, hidden, max_smem, s);
  GRU_BWD_TRY(1)
  GRU_BWD_TRY(2)
  GRU_BWD_TRY(4)
  GRU_BWD_TRY(8)
#undef GRU_BWD_TRY
  return kUnsupported;
}

extern "C" const char* gru_bwd_chain_error_string(int err) {
  if (err == kUnsupported) return "shape not supported by gru_bwd_chain";
  return cudaGetErrorString((cudaError_t)err);
}
