// Flash-attention backward for Hopper (sm_90a): the kv-major kernel, two
// entry points.
//
// Replaces: multimodal_emotion_detection_tpu/ops/flash_attention.py::
// _flash_bwd_call, i.e. the kernel bodies
//   * _bwd_fused_kernel over _bwd_kv_major (fused form, Tk <= 4096)
//     -> flash_bwd_fused_launch;
//   * _bwd_dkv_kernel (two-pass form, dK and dV)  -> flash_bwd_dkv_launch.
// The two-pass form's dQ pass (_bwd_dq_kernel) is csrc/flash_bwd_dq.cu.
// Same function as the plain PyTorch version ops/flash_attention.py::
// flash_bwd_reference: with P = exp(S - LSE) recomputed from the forward's
// logsumexp and M the forward's keep mask (1 / (1 - rate) where kept),
//
//   dV = (P M)^T dO,  dS = P (M (dO V^T) - Delta) / sqrt(D),
//   dQ = dS K,        dK = dS^T Q,        Delta = rowsum(dO O) (given).
//
// What bounds it on the H100: arithmetic.  The fused form does 5 products
// per (query, key) pair, 10 B H Tq Tk D = 11.3 GFLOP at the transformer
// encoder's shape (B=32, H=4, T=372, D=64): 0.17 ms at the 67 TFLOP/s
// float32 rate against ~0.05 ms for its bytes; the dK / dV form does 4.
// Float32 FFMA on the CUDA cores.
//
// Design.  kv-major kernel (template on the fused form): one CTA of 256
// threads per (kv span, head, batch row); a span is `per_span` 64-key
// tiles (the wrapper picks at most 8 spans, so the fused form's dQ partials
// stay <= 8 x |dQ|).  For each of its key tiles the CTA stages K, V and the
// key biases, keeps dK and dV for the tile in registers, and walks every
// 64-row query tile: it stages Q, dO, LSE and Delta, recomputes S and P,
// forms dP = dO V^T, applies the mask (one Philox call per 4-row group and
// key, philox.cuh) and dS, writes P M and dS to shared memory, and after
// one barrier accumulates dV += (P M)^T dO and dK += dS^T Q.  The fused form
// also forms this tile's dQ contribution dS K and writes it to the span's
// own slot of an (n_spans, B, H, Tq, D) buffer (the first key tile of the
// span stores, later ones add; one CTA owns the slot), which the wrapper
// sums: no atomics, so the result is deterministic.  Rows past Tq get
// LSE = +inf (so P = 0) and Delta = 0; keys past Tk get a bias of -inf
// (flash_common.cuh::load_key_bias).

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
  float* dq;  // fused: (n_spans, B, H, Tq, D) partials; dq form: (B, H, Tq, D)
  float* dk;
  float* dv;
  int batch, heads, tq, tk, d, per_span;
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

// P M -> pm (if given) and dS -> dst, both (TQ, SS) row-major, for the
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
      if (pm) pm[r * SS + j] = p[i][c] * keep[i];
      dst[r * SS + j] = p[i][c] * (dp[i][c] * keep[i] - dls[r]) * a.scale;
    }
  }
}

template <int DP, bool FUSED>
__global__ void __launch_bounds__(NT, DP == 64 ? 2 : 1)
    flash_bwd_kv_kernel(const Args a) {
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
  // this span's dQ partial slot
  float* dqp = FUSED ? a.dq + ((size_t)blockIdx.x * a.batch * a.heads + bh) *
                                  a.tq * a.d
                     : nullptr;
  const int t_first = blockIdx.x * a.per_span;
  const int t_end = min(t_first + a.per_span, (a.tk + TK - 1) / TK);

  for (int t = t_first; t < t_end; ++t) {
    const int k0 = t * TK;
    float dk[4][DC], dv[4][DC];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < DC; ++c) dk[i][c] = dv[i][c] = 0.0f;
    __syncthreads();  // the previous key tile's reads are done
    load_tile<DP>(ks, a.k + koff, k0, a.tk, a.d);
    load_tile<DP>(vs, a.v + koff, k0, a.tk, a.d);
    load_key_bias(kb, a.bias, b, k0, a.tk);

    for (int q0 = 0; q0 < a.tq; q0 += TQ) {
      __syncthreads();  // the previous query tile's reads are done
      load_tile<DP>(qs, a.q + qoff, q0, a.tq, a.d);
      load_tile<DP>(dos, a.dout + qoff, q0, a.tq, a.d);
      load_row_stats(ls, dls, a, bh, q0);
      __syncthreads();
      probs_and_ds<DP>(qs, dos, ks, vs, kb, ls, dls, pm, dss, a, key, q0, k0,
                       h, b);
      __syncthreads();
      tile_tn<DP>(pm, dos, tx, ty, dv);
      tile_tn<DP>(dss, qs, tx, ty, dk);
      if (FUSED) {
        float dq[4][DC];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < DC; ++c) dq[i][c] = 0.0f;
        tile_nn<DP>(dss, ks, tx, ty, dq);
        store_rows<DP>(dqp, dq, q0, a.tq, a.d, tx, ty, t != t_first);
      }
    }
    store_rows<DP>(a.dk + koff, dk, k0, a.tk, a.d, tx, ty, false);
    store_rows<DP>(a.dv + koff, dv, k0, a.tk, a.d, tx, ty, false);
  }
}

template <typename Kernel>
cudaError_t run(Kernel kernel, size_t smem, dim3 grid, const Args& a,
                cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, NT, smem, stream>>>(a);
  return cudaGetLastError();
}

enum Form { kFused, kDkv };

int launch(Form form, const float* q, const float* k, const float* v,
           const float* bias, const unsigned long long* seed,
           const float* dout, const float* lse, const float* delta, float* dq,
           float* dk, float* dv, int batch, int heads, int tq, int tk, int d,
           int per_span, float scale, unsigned drop_thr, float drop_scale,
           void* stream) {
  if (batch < 1 || heads < 1 || tq < 1 || tk < 1 || d < 1 || d > 128 ||
      batch > 65535 || heads > 65535 || per_span < 1 ||
      (form == kFused && dq == nullptr) || dk == nullptr || dv == nullptr) {
    return cudaErrorInvalidValue;
  }
  const Args a{q,     k,  v,  bias,  seed,  dout,     lse,      delta,
               dq,    dk, dv, batch, heads, tq,       tk,       d,
               per_span, scale, drop_thr, drop_scale};
  const cudaStream_t s = (cudaStream_t)stream;
  const int k_tiles = (tk + TK - 1) / TK;
  const dim3 grid((k_tiles + per_span - 1) / per_span, heads, batch);
  if (form == kFused)
    return d <= 64 ? run(flash_bwd_kv_kernel<64, true>, bwd_smem_bytes<64>(),
                         grid, a, s)
                   : run(flash_bwd_kv_kernel<128, true>, bwd_smem_bytes<128>(),
                         grid, a, s);
  return d <= 64 ? run(flash_bwd_kv_kernel<64, false>, bwd_smem_bytes<64>(),
                       grid, a, s)
                 : run(flash_bwd_kv_kernel<128, false>, bwd_smem_bytes<128>(),
                       grid, a, s);
}

}  // namespace

#define FLASH_BWD_ENTRY(name, form)                                          \
  extern "C" int name(const float* q, const float* k, const float* v,       \
                      const float* bias, const unsigned long long* seed,    \
                      const float* dout, const float* lse,                  \
                      const float* delta, float* dq, float* dk, float* dv,  \
                      int batch, int heads, int tq, int tk, int d,          \
                      int per_span, float scale, unsigned drop_thr,         \
                      float drop_scale, void* stream) {                     \
    return launch(form, q, k, v, bias, seed, dout, lse, delta, dq, dk, dv,  \
                  batch, heads, tq, tk, d, per_span, scale, drop_thr,       \
                  drop_scale, stream);                                      \
  }

FLASH_BWD_ENTRY(flash_bwd_fused_launch, kFused)
FLASH_BWD_ENTRY(flash_bwd_dkv_launch, kDkv)

extern "C" const char* flash_bwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
