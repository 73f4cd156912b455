// Flash-attention backward for Hopper (sm_90a): the kv-major dK / dV pass
// of the two-pass form.
//
// Replaces: multimodal_emotion_detection_tpu/ops/flash_attention.py::
// _flash_bwd_call's kv-major pass of the two-pass form (Tk > 4096), kernel
// body _bwd_dkv_kernel -> flash_bwd_dkv_launch.  The two-pass form's dQ
// pass (_bwd_dq_kernel) is csrc/flash_bwd_dq.cu, the fused form
// (_bwd_fused_kernel) csrc/flash_bwd_fused.cu.  Same function as
// flash_bwd_reference(...)[1:] in ops/flash_attention.py: with P =
// exp(S - LSE) recomputed from the forward's logsumexp and M the forward's
// keep mask (1 / (1 - rate) where kept),
//
//   dV = (P M)^T dO,  dS = P (M (dO V^T) - Delta) / sqrt(D),
//   dK = dS^T Q,      Delta = rowsum(dO O) (given).
//
// What bounds it on the H100: arithmetic.  4 products per (query, key)
// pair, 8 B H Tq Tk D = 102.4 GFLOP at (2, 4, 5000, 64): 1.53 ms at the 67
// TFLOP/s float32 rate.  Float32 FFMA on the CUDA cores.
//
// Design: one CTA of 256 threads per (64-key tile, head, batch row).  The
// CTA stages K, V and the key biases, keeps dK and dV for the tile in
// registers, and walks every 64-row query tile: it stages Q, dO, LSE and
// Delta, recomputes S and P, forms dP = dO V^T, applies the mask (one
// Philox call per 4-row group and key, philox.cuh) and dS, writes P M and
// dS to shared memory, and after one barrier accumulates dV += (P M)^T dO
// and dK += dS^T Q.  Rows past Tq get LSE = +inf (so P = 0) and Delta = 0;
// keys past Tk get a bias of -inf (flash_common.cuh::load_key_bias).

#include "flash_common.cuh"
#include "philox.cuh"

namespace {

using namespace flash;

template <int DP>
constexpr size_t bwd_smem_bytes() {
  // q, dO, k, v tiles (64 x (DP + 4)), P M and dS (64 x SS), LSE, Delta
  // (TQ each), key biases (TK)
  return sizeof(float) * (4 * 64 * (DP + 4) + 2 * 64 * SS + 2 * TQ + TK);
}

struct Args {
  const float* q;
  const float* k;
  const float* v;
  const float* bias;
  const unsigned long long* seed;
  const float* dout;
  const float* lse;
  const float* delta;
  float* dk;
  float* dv;
  int heads, tq, tk, d;
  float scale;
  uint32_t drop_thr;
  float drop_scale;
};

// LSE and Delta of query rows [q0, q0 + TQ)
__device__ __forceinline__ void load_row_stats(float* ls, float* ds,
                                               const Args& a, size_t bh,
                                               int q0) {
  for (int i = threadIdx.x; i < TQ; i += NT) {
    const int r = q0 + i;
    const bool in = r < a.tq;
    ls[i] = in ? __ldg(a.lse + bh * a.tq + r) : INFINITY;
    ds[i] = in ? __ldg(a.delta + bh * a.tq + r) : 0.0f;
  }
}

// P M -> pm and dS -> dst, both (TQ, SS) row-major, for the
// query tile at q0 and the key tile at k0 staged in shared memory
template <int DP>
__device__ __forceinline__ void probs_and_ds(
    const float* qs, const float* dos, const float* ks, const float* vs,
    const float* kb, const float* ls, const float* dls, float* pm, float* dst,
    const Args& a, uint2 key, int q0, int k0, int h, int b) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float p[4][4], dp[4][4];
  tile_dot<DP>(qs, ks, tx, ty, p);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      p[i][c] = expf(p[i][c] * a.scale + kb[tx + 16 * c] - ls[4 * ty + i]);
  tile_dot<DP>(dos, vs, tx, ty, dp);
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    float keep[4] = {1.0f, 1.0f, 1.0f, 1.0f};
    if (a.seed != nullptr)
      keep_scales(key, q0 + 4 * ty, k0 + tx + 16 * c, h, b, a.drop_thr,
                  a.drop_scale, keep);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 4 * ty + i, j = tx + 16 * c;
      pm[r * SS + j] = p[i][c] * keep[i];
      dst[r * SS + j] = p[i][c] * (dp[i][c] * keep[i] - dls[r]) * a.scale;
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(NT, DP == 64 ? 2 : 1)
    flash_bwd_dkv_kernel(const Args a) {
  constexpr int RS = DP + 4;
  constexpr int DC = DP / 16;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;              // [64][RS]
  float* dos = qs + 64 * RS;     // [64][RS]
  float* ks = dos + 64 * RS;     // [64][RS]
  float* vs = ks + 64 * RS;      // [64][RS]
  float* pm = vs + 64 * RS;      // [TQ][SS]: P M
  float* dss = pm + 64 * SS;     // [TQ][SS]: dS
  float* ls = dss + 64 * SS;     // [TQ]
  float* dls = ls + TQ;          // [TQ]
  float* kb = dls + TQ;          // [TK]

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int h = blockIdx.y, b = blockIdx.z;
  const size_t bh = (size_t)b * a.heads + h;
  const size_t qoff = bh * a.tq * a.d, koff = bh * a.tk * a.d;
  const uint2 key = a.seed != nullptr ? philox_key(a.seed) : make_uint2(0u, 0u);
  const int k0 = blockIdx.x * TK;
  float dk[4][DC], dv[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) dk[i][c] = dv[i][c] = 0.0f;
  load_tile<DP>(ks, a.k + koff, k0, a.tk, a.d);
  load_tile<DP>(vs, a.v + koff, k0, a.tk, a.d);
  load_key_bias(kb, a.bias, b, k0, a.tk);

  for (int q0 = 0; q0 < a.tq; q0 += TQ) {
    __syncthreads();  // the previous query tile's reads are done
    load_tile<DP>(qs, a.q + qoff, q0, a.tq, a.d);
    load_tile<DP>(dos, a.dout + qoff, q0, a.tq, a.d);
    load_row_stats(ls, dls, a, bh, q0);
    __syncthreads();
    probs_and_ds<DP>(qs, dos, ks, vs, kb, ls, dls, pm, dss, a, key, q0, k0, h, b);
    __syncthreads();
    tile_tn<DP>(pm, dos, tx, ty, dv);
    tile_tn<DP>(dss, qs, tx, ty, dk);
  }
  store_rows<DP>(a.dk + koff, dk, k0, a.tk, a.d, tx, ty);
  store_rows<DP>(a.dv + koff, dv, k0, a.tk, a.d, tx, ty);
}

template <int DP>
cudaError_t run(const Args& a, int batch, int k_tiles, cudaStream_t stream) {
  constexpr size_t smem = bwd_smem_bytes<DP>();
  const cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  flash_bwd_dkv_kernel<DP><<<dim3(k_tiles, a.heads, batch), NT, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// The backward entries' common signature (ops/flash_attention.py's
// _BWD_ARGS); dq and per_span are not read by this pass.
extern "C" int flash_bwd_dkv_launch(const float* q, const float* k, const float* v,
                                    const float* bias, const unsigned long long* seed,
                                    const float* dout, const float* lse,
                                    const float* delta, float* dq, float* dk, float* dv,
                                    int batch, int heads, int tq, int tk, int d,
                                    int per_span, float scale, unsigned drop_thr,
                                    float drop_scale, void* stream) {
  (void)dq;
  (void)per_span;
  if (batch < 1 || heads < 1 || tq < 1 || tk < 1 || d < 1 || d > 128 ||
      batch > 65535 || heads > 65535 || dk == nullptr || dv == nullptr) {
    return cudaErrorInvalidValue;
  }
  const Args a{q,     k,  v,  bias, seed, dout,  lse,      delta,     dk,
               dv,    heads, tq, tk, d,   scale, drop_thr, drop_scale};
  const cudaStream_t s = (cudaStream_t)stream;
  const int k_tiles = (tk + TK - 1) / TK;
  return d <= 64 ? run<64>(a, batch, k_tiles, s) : run<128>(a, batch, k_tiles, s);
}

extern "C" const char* flash_bwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
