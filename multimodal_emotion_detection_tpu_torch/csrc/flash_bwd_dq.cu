// Flash-attention backward, dQ pass (two-pass form), for Hopper (sm_90a),
// on the tensor cores.
//
// Replaces: multimodal_emotion_detection_tpu/ops/flash_attention.py::
// _flash_bwd_call's q-major pass (kernel body _bwd_dq_kernel), which runs
// past 8 key blocks beside the kv-major dK / dV pass (csrc/flash_bwd_fused.cu's
// dK / dV form).
// Same function as flash_bwd_reference(...)[0] in ops/flash_attention.py:
// with P = exp(S - LSE) recomputed from the forward's logsumexp and M the
// forward's keep mask (1 / (1 - rate) where kept),
//
//   dS = P (M (dO V^T) - Delta) / sqrt(D),   dQ = dS K,
//   Delta = rowsum(dO O) (given).
//
// Float32 operands; the bf16 form is csrc/flash_bwd_bf16.cu's dQ form
// (flash_bwd_dq_bf16_launch).
//
// What bounds it on the H100: arithmetic.  Three products per (query, key)
// pair, 6 B H Tq Tk D = 76.8 GFLOP at (2, 4, 5000, 64): 1.146 ms at the
// 67 TFLOP/s float32 rate; in 3xTF32 on the tensor cores (flash_mma.cuh)
// 3 x 76.8 GFLOP at 495 TFLOP/s, 0.465 ms.  Its bytes (q, k, v, dO, dQ,
// LSE, Delta, bias) take 0.013 ms at 3.35 TB/s.
//
// Design: one CTA of 4 warps per (64-row query tile, head, batch row), 3
// resident per SM.  Q and dO are staged once and split into TF32 halves:
// the big halves in registers and the small ones in shared memory at D <= 64
// (both in registers would leave one CTA an SM), both in shared memory at
// D 128; each lane keeps the LSE and Delta of its rows g, g + 8.  The CTA
// walks the key tiles of 16 (K, V and the key biases by cp.async in a ring
// of two, tile t + 1 loading under tile t's products, each value split once
// as it lands): a warp forms S = Q K^T and dP = dO V^T with m16n8k8 MMAs
// in one walk over the k-steps (twice the independent accumulators), then
// P, the mask (flash_mma.cuh::keep_bits, computed ahead of the products: one
// Philox call per 4-row group and key; the kernel is compiled with and
// without it) and dS in registers, and accumulates dQ += dS K from the
// accumulator registers.  Rows past Tq get LSE = +inf (so P = 0) and
// Delta = 0; keys past Tk get a bias of -inf.
//
// Built with -DFLASH_DQ_TIMERS=1 (scripts/flash_ab.py --dq-timers) each warp
// adds clock64() time per phase of the key walk into fm_timers, read back
// by flash_bwd_dq_timers(); the default build has neither.

#include "flash_mma.cuh"

namespace {

using namespace flash_mma;

constexpr int NW = 4;  // warps per CTA: 64 query rows

#ifndef FLASH_DQ_TIMERS
#define FLASH_DQ_TIMERS 0
#endif
#if FLASH_DQ_TIMERS
// wait, split + barrier, S and dP, dS, dQ, barrier, next tile's copies
__device__ unsigned long long fm_timers[7];
#define PHASE(i)                      \
  {                                   \
    const long long now = clock64();  \
    tacc[i] += now - tprev;           \
    tprev = now;                      \
  }
#else
#define PHASE(i)
#endif

struct Args {
  const float* q;
  const float* k;
  const float* v;
  const float* bias;
  const unsigned long long* seed;
  const float* dout;
  const float* lse;
  const float* delta;
  float* dq;
  int heads, tq, tk, d;
  float scale;
  uint32_t drop_thr;
  float drop_scale;
  bool vec;
};

template <int DP, int MODE, int TK>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) *
         (a_floats<DP, MODE, NW>(2) + STAGES * Stage<DP, TK>::FLOATS);
}

// 3 CTAs an SM: at most 168 registers (ptxas: 166, no spill), 70 KB of
// shared memory at D 64
template <int DP, int MODE, int TK, bool DROP>
__global__ void __launch_bounds__(32 * NW, 3) flash_bwd_dq_kernel(const Args a) {
  static_assert(MODE != kRegs, "the staged Q and dO stay: no aliasing");
  using St = Stage<DP, TK>;
  constexpr int NT = 32 * NW, TQ = 16 * NW, NJ = TK / 8;
  extern __shared__ __align__(16) float smem[];
  float* do_tile = smem + a_floats<DP, MODE, NW>(1);
  float* ring = smem + a_floats<DP, MODE, NW>(2);

  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * TQ, h = blockIdx.y, b = blockIdx.z;
  const size_t bh = (size_t)b * a.heads + h;
  const size_t qoff = bh * a.tq * a.d, koff = bh * a.tk * a.d;
  const float* bg = a.bias ? a.bias + (size_t)b * a.tk : nullptr;

  load_tile<DP, TQ, NT>(smem, a.q + qoff, q0, a.tq, a.d, a.vec);
  load_tile<DP, TQ, NT>(do_tile, a.dout + qoff, q0, a.tq, a.d, a.vec);
  cp_commit();
  const int r = q0 + 16 * w + g;
  float ls[2], dl[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const bool in = r + 8 * hf < a.tq;
    ls[hf] = in ? __ldg(a.lse + bh * a.tq + r + 8 * hf) : INFINITY;
    dl[hf] = in ? __ldg(a.delta + bh * a.tq + r + 8 * hf) : 0.0f;
  }
  cp_wait<0>();
  __syncthreads();
  AFrags<DP, MODE, NW> qa, da;
  qa.init(smem);
  da.init(do_tile);
  __syncthreads();

  const int n_tiles = (a.tk + TK - 1) / TK;
  auto fetch = [&](int tile) {
    if (tile < n_tiles) {
      float* st = ring + (tile % STAGES) * St::FLOATS;
      load_tile<DP, TK, NT>(st, a.k + koff, tile * TK, a.tk, a.d, a.vec);
      load_tile<DP, TK, NT>(st + St::V, a.v + koff, tile * TK, a.tk, a.d, a.vec);
      if (bg) load_bias<NT>(st + St::BIAS, bg, tile * TK, TK, a.tk);
    }
    cp_commit();  // an empty group past the end keeps the count uniform
  };
#pragma unroll
  for (int s = 0; s < STAGES; ++s) fetch(s);

  const uint2 key = DROP ? flash::philox_key(a.seed) : make_uint2(0u, 0u);
  float acc[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;

#if FLASH_DQ_TIMERS
  long long tacc[7] = {0, 0, 0, 0, 0, 0, 0}, tprev = clock64();
#endif
  for (int tile = 0; tile < n_tiles; ++tile) {
    cp_wait<STAGES - 1>();
    PHASE(0)
    float* st = ring + (tile % STAGES) * St::FLOATS;
    // this thread's own copies have landed: split them
    split_tile<DP, TK, NT>(st, a.d, a.vec);
    split_tile<DP, TK, NT>(st + St::V, a.d, a.vec);
    __syncthreads();  // tile's K, V and biases are in for every thread
    PHASE(1)
    const float* kb = st + St::BIAS;
    const int k0 = tile * TK;

    uint32_t kbits[NJ];  // the mask's Philox work, ahead of the products
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      kbits[j] = DROP ? keep_bits(key, q0 + 16 * w, k0 + 8 * j, h, b, a.drop_thr) : 0u;
    // S = Q K^T and dP = dO V^T in one walk
    float sd[2][NJ][4];
    mma_abt<DP, NJ, St::MAT>(sd, {st, st + St::V}, qa, da);
    PHASE(2)
    auto& s = sd[0];
    auto& dp = sd[1];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = 8 * j + 2 * t;
      const float2 bj = bg ? *reinterpret_cast<const float2*>(kb + c)
                           : make_float2(0.0f, 0.0f);
      const float kbias[2] = {k0 + c < a.tk ? bj.x : -INFINITY,
                              k0 + c + 1 < a.tk ? bj.y : -INFINITY};
      float keep[4] = {1.0f, 1.0f, 1.0f, 1.0f};
      if (DROP) keep_scales(kbits[j], a.drop_scale, keep);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[j][e] * a.scale + kbias[e & 1] - ls[e >> 1]);
        s[j][e] = p * (dp[j][e] * keep[e] - dl[e >> 1]) * a.scale;
      }
    }
    PHASE(3)
    mma_pb<DP, NJ, St::MAT>(s, st, acc);
    PHASE(4)
    __syncthreads();  // every warp is done with this stage
    PHASE(5)
    fetch(tile + STAGES);
    PHASE(6)
  }
  cp_wait<0>();
#if FLASH_DQ_TIMERS
  for (int i = 0; i < 7; ++i)
    atomicAdd(&fm_timers[i], (unsigned long long)tacc[i]);
#endif

  const float one[2] = {1.0f, 1.0f};
  store_rows<DP>(a.dq + qoff, acc, r, a.tq, a.d, one, a.vec);
}

template <int DP, int MODE, int TK>
cudaError_t launch(const Args& a, int batch, cudaStream_t stream) {
  const size_t smem = dq_smem_bytes<DP, MODE, TK>();
  auto kernel = a.seed ? flash_bwd_dq_kernel<DP, MODE, TK, true>
                       : flash_bwd_dq_kernel<DP, MODE, TK, false>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.tq + 16 * NW - 1) / (16 * NW), a.heads, batch);
  kernel<<<grid, 32 * NW, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// The backward entries' common signature (ops/flash_attention.py's
// _BWD_ARGS); dk, dv and per_span are not read by this pass.
extern "C" int flash_bwd_dq_launch(const float* q, const float* k,
                                   const float* v, const float* bias,
                                   const unsigned long long* seed,
                                   const float* dout, const float* lse,
                                   const float* delta, float* dq, float* dk,
                                   float* dv, int batch, int heads, int tq,
                                   int tk, int d, int per_span, float scale,
                                   unsigned drop_thr, float drop_scale,
                                   void* stream) {
  (void)dk;
  (void)dv;
  (void)per_span;
  if (batch < 1 || heads < 1 || tq < 1 || tk < 1 || d < 1 || d > 128 ||
      batch > 65535 || heads > 65535 || dq == nullptr) {
    return cudaErrorInvalidValue;
  }
  const bool vec = d % 4 == 0 && aligned16(q) && aligned16(k) &&
                   aligned16(v) && aligned16(dout) && aligned16(dq);
  const Args a{q,     k,     v,  bias, seed, dout,  lse,      delta,      dq,
               heads, tq,    tk, d,    scale, drop_thr, drop_scale, vec};
  const cudaStream_t s = (cudaStream_t)stream;
  // 16-key tiles at both widths; at D 128 both halves in shared memory
  return d <= 64 ? launch<64, kHalf, 16>(a, batch, s)
                 : launch<128, kShared, 16>(a, batch, s);
}

#if FLASH_DQ_TIMERS
// the summed phase times (clock cycles over all warps) since the last
// reset; reset: zero them after reading
extern "C" int flash_bwd_dq_timers(unsigned long long* out, int reset) {
  cudaError_t err = cudaMemcpyFromSymbol(out, fm_timers, sizeof(fm_timers));
  if (err == cudaSuccess && reset) {
    const unsigned long long zero[7] = {0, 0, 0, 0, 0, 0, 0};
    err = cudaMemcpyToSymbol(fm_timers, zero, sizeof(zero));
  }
  return err;
}
#endif

extern "C" const char* flash_bwd_dq_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
