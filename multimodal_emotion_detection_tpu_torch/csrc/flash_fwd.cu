// Flash-attention forward for Hopper (sm_90a), on the tensor cores.
//
// Replaces: multimodal_emotion_detection_tpu/ops/flash_attention.py::
// _flash_fwd_call (kernel body _fwd_kernel).  Same function as the plain
// PyTorch version ops/flash_attention.py::flash_fwd_reference: per (b, h)
//
//   s   = q k^T / sqrt(D) + bias[b]        (keys past Tk excluded)
//   lse = logsumexp_j s,   p = exp(s - lse)
//   o   = (p * keep) v                     (keep: the Philox dropout mask
//                                           scaled by 1 / (1 - rate), or 1)
//
// The normaliser comes from the undropped p; only the p v stream is masked
// (torch's dropout-after-softmax, as the JAX kernel).  Float32 operands, in
// 3xTF32; the bf16 form is csrc/flash_fwd_bf16.cu.
//
// What bounds it on the H100: arithmetic.  At the transformer encoder's
// shape (B=32, H=4, T=372, D=64) it does 4 B H T^2 D = 4.535 GFLOP against
// 49 MB of q, k, v, o and lse (0.015 ms at 3.35 TB/s).  On the CUDA cores'
// float32 rate (67 TFLOP/s) that is 0.068 ms; this kernel runs the products
// on the tensor cores in 3xTF32 (flash_mma.cuh), three TF32 MMAs per
// product at 495 TFLOP/s: 0.0275 ms, with float32 accuracy kept.
//
// Design: one CTA of 4 warps per (64-row query tile, head, batch row), grid
// (ceil(Tq/64), H, B): 768 CTAs at the encoder's shape, 3 resident per SM.
// The query tile is staged once and split into TF32 halves held in
// registers (D <= 64; at D 128 in shared memory).  The CTA walks the key
// tiles of 32: K, V and the key biases staged by cp.async in a ring of two
// (tile t + 1 loads while tile t is multiplied), each K / V value split once
// as it lands.  A warp forms its 16 x 32 scores with m16n8k8 MMAs, keeps the
// running max m, sum l and its 16 x D output accumulator in registers
// (online softmax, row reductions across a quad), and multiplies its
// probabilities by V straight from the accumulator registers
// (flash_mma.cuh::mma_pb).  The dropout mask is one Philox call per (4-row
// group, key), 32 per warp and 8-key tile, computed ahead of the products and
// shared by shuffle (flash_mma.cuh::keep_bits / keep_scales), so it is the
// plain version's whatever the tiling; the kernel is compiled with and
// without it.  mma.sync does not reach the 495 TFLOP/s that wgmma does
// (PERF.md, scripts/flash_ab.py --mma-rate).

#include "flash_mma.cuh"

namespace {

using namespace flash_mma;

constexpr int NW = 4;   // warps per CTA: 64 query rows
constexpr int TK = 32;  // keys per tile

template <int DP, int MODE>
constexpr size_t fwd_smem_bytes() {
  constexpr int ring = STAGES * Stage<DP, TK>::FLOATS;
  constexpr int a = a_floats<DP, MODE, NW>(1);
  // kRegs: the staged Q is dead before the ring fills, so they share
  return sizeof(float) * (MODE == kRegs ? (a > ring ? a : ring) : a + ring);
}

// 3 CTAs an SM: at most 168 registers (ptxas: 168 at D 64, no spill), and
// 70 KB of shared memory at D 64
template <int DP, int MODE, bool DROP>
__global__ void __launch_bounds__(32 * NW, 3) flash_fwd_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ bias,
    const unsigned long long* __restrict__ seed, float* __restrict__ o,
    float* __restrict__ lse, int heads, int tq, int tk, int d, float scale,
    uint32_t drop_thr, float drop_scale, bool vec) {
  using St = Stage<DP, TK>;
  constexpr int NJ = TK / 8;
  extern __shared__ __align__(16) float smem[];
  float* ring = MODE == kRegs ? smem : smem + a_floats<DP, MODE, NW>(1);

  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  constexpr int NT = 32 * NW, TQ = 16 * NW;
  const int q0 = blockIdx.x * TQ, h = blockIdx.y, b = blockIdx.z;
  const size_t bh = (size_t)b * heads + h;
  const float* kg = k + bh * tk * d;
  const float* vg = v + bh * tk * d;
  const float* bg = bias ? bias + (size_t)b * tk : nullptr;

  load_tile<DP, TQ, NT>(smem, q + bh * tq * d, q0, tq, d, vec);
  cp_commit();
  cp_wait<0>();
  __syncthreads();
  AFrags<DP, MODE, NW> qa;
  qa.init(smem);
  __syncthreads();

  const int n_tiles = (tk + TK - 1) / TK;
  auto fetch = [&](int tile) {
    if (tile < n_tiles) {
      float* st = ring + (tile % STAGES) * St::FLOATS;
      load_tile<DP, TK, NT>(st, kg, tile * TK, tk, d, vec);
      load_tile<DP, TK, NT>(st + St::V, vg, tile * TK, tk, d, vec);
      if (bg) load_bias<NT>(st + St::BIAS, bg, tile * TK, TK, tk);
    }
    cp_commit();  // an empty group past the end keeps the count uniform
  };
#pragma unroll
  for (int s = 0; s < STAGES; ++s) fetch(s);

  const uint2 key = DROP ? flash::philox_key(seed) : make_uint2(0u, 0u);
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
  float acc[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;

  for (int tile = 0; tile < n_tiles; ++tile) {
    cp_wait<STAGES - 1>();
    float* st = ring + (tile % STAGES) * St::FLOATS;
    // this thread's own copies have landed: split them
    split_tile<DP, TK, NT>(st, d, vec);
    split_tile<DP, TK, NT>(st + St::V, d, vec);
    __syncthreads();  // tile's K, V and biases are in for every thread
    const float* kb = st + St::BIAS;
    const int k0 = tile * TK;

    uint32_t kbits[NJ];  // the mask's Philox work, ahead of the products
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      kbits[j] = DROP ? keep_bits(key, q0 + 16 * w, k0 + 8 * j, h, b, drop_thr) : 0u;
    float sc[1][NJ][4];
    mma_abt<DP, NJ, St::MAT>(sc, {st}, qa);
    float (&s)[NJ][4] = sc[0];
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = 8 * j + 2 * t;
      const float2 bj = bg ? *reinterpret_cast<const float2*>(kb + c)
                           : make_float2(0.0f, 0.0f);
      const float b0 = k0 + c < tk ? bj.x : -INFINITY;
      const float b1 = k0 + c + 1 < tk ? bj.y : -INFINITY;
      s[j][0] = s[j][0] * scale + b0;
      s[j][1] = s[j][1] * scale + b1;
      s[j][2] = s[j][2] * scale + b0;
      s[j][3] = s[j][3] * scale + b1;
      mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
    }
    float alpha[2], sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      // every key tile holds a key inside the sequence: m_new is finite
      const float m_new = fmaxf(m[r], quad_max(mx[r]));
      alpha[r] = expf(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = expf(s[j][e] - m[e >> 1]);
        sum[e >> 1] += s[j][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + quad_sum(sum[r]);
#pragma unroll
    for (int n = 0; n < DP / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];
    if (DROP) {
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        float keep[4];
        keep_scales(kbits[j], drop_scale, keep);
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] *= keep[e];
      }
    }
    mma_pb<DP, NJ, St::MAT>(s, st + St::V, acc);
    __syncthreads();  // every warp is done with this stage
    fetch(tile + STAGES);
  }
  cp_wait<0>();

  const int r = q0 + 16 * w + g;
  const float inv[2] = {1.0f / l[0], 1.0f / l[1]};
  store_rows<DP>(o + bh * tq * d, acc, r, tq, d, inv, vec);
  if (t == 0) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
      if (r + 8 * hf < tq) lse[bh * tq + r + 8 * hf] = m[hf] + logf(l[hf]);
  }
}

template <int DP, int MODE>
cudaError_t launch(const float* q, const float* k, const float* v,
                   const float* bias, const unsigned long long* seed,
                   float* o, float* lse, int batch, int heads, int tq, int tk,
                   int d, float scale, uint32_t drop_thr, float drop_scale,
                   cudaStream_t stream) {
  const size_t smem = fwd_smem_bytes<DP, MODE>();
  auto kernel = seed ? flash_fwd_kernel<DP, MODE, true>
                     : flash_fwd_kernel<DP, MODE, false>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const bool vec = d % 4 == 0 && aligned16(q) && aligned16(k) &&
                   aligned16(v) && aligned16(o);
  const dim3 grid((tq + 16 * NW - 1) / (16 * NW), heads, batch);
  kernel<<<grid, 32 * NW, smem, stream>>>(q, k, v, bias, seed, o, lse, heads,
                                          tq, tk, d, scale, drop_thr,
                                          drop_scale, vec);
  return cudaGetLastError();
}

}  // namespace

extern "C" int flash_fwd_launch(const float* q, const float* k,
                                const float* v, const float* bias,
                                const unsigned long long* seed, float* o,
                                float* lse, int batch, int heads, int tq,
                                int tk, int d, float scale, unsigned drop_thr,
                                float drop_scale, void* stream) {
  if (batch < 1 || heads < 1 || tq < 1 || tk < 1 || d < 1 || d > 128 ||
      batch > 65535 || heads > 65535) {
    return cudaErrorInvalidValue;
  }
  const cudaStream_t s = (cudaStream_t)stream;
  // Q's split halves in registers at D <= 64, in shared memory at D 128
  return d <= 64
             ? launch<64, kRegs>(q, k, v, bias, seed, o, lse, batch, heads, tq,
                                 tk, d, scale, drop_thr, drop_scale, s)
             : launch<128, kShared>(q, k, v, bias, seed, o, lse, batch, heads,
                                    tq, tk, d, scale, drop_thr, drop_scale, s);
}

extern "C" const char* flash_fwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
