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
// (torch's dropout-after-softmax, as the JAX kernel).  Two forms: float32
// operands in 3xTF32 (flash_fwd_launch) and bf16 operands, one bf16 MMA a
// product, as the JAX kernel runs on bf16 inputs (flash_fwd_bf16_launch,
// at the end of this file).
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

// ---------------------------------------------------------------- bf16 form
//
// q, k, v and O in bf16, LSE float32 (flash_fwd_bf16_launch).  The same CTA
// shape and online softmax; the query tile's A fragments are read once by
// ldmatrix into registers, each product is one m16n8k16 bf16 MMA with
// float32 accumulators (flash_mma.cuh's bf16 section), and key tiles are 64
// keys at D <= 64, 32 at D 128 (bf16 tiles take half the float32 ones'
// shared memory).  The rounding points are the JAX kernel's: S, the scale,
// bias, max, exp, l and LSE in float32; P (times the keep mask) rounded to
// bf16 as the A operand of P V; O = acc / l rounded once.  P is taken
// relative to the running max, so where a row's max moves after its first
// key tile the rounded P differs by an ulp from a P taken after the final
// max (the plain version's, and JAX's within one 512-key block).  Bound at
// the encoder's shape: 4.535 GFLOP at 989 TFLOP/s, 0.0046 ms, against 24.5
// MB of bf16 q, k, v, O and float32 LSE, 0.0073 ms at 3.35 TB/s: bytes.

template <int DP, int TK, bool DROP>
__global__ void __launch_bounds__(32 * NW, DP == 64 ? 3 : 2) flash_fwd_bf16_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const float* __restrict__ bias, const unsigned long long* __restrict__ seed,
    bf16* __restrict__ o, float* __restrict__ lse, int heads, int tq, int tk, int d,
    float scale, uint32_t drop_thr, float drop_scale, bool vec) {
  constexpr int NT = 32 * NW, TQ = 16 * NW, NJ = TK / 8, RS = DP + 8;
  constexpr int MAT = TK * RS;                          // halves of a K or V tile
  constexpr int STAGE = 4 * MAT + 4 * TK;               // bytes: K, V, biases
  extern __shared__ __align__(16) unsigned char smem_h[];
  bf16* qs = reinterpret_cast<bf16*>(smem_h);
  unsigned char* ring = smem_h + 2 * TQ * RS;

  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * TQ, h = blockIdx.y, b = blockIdx.z;
  const size_t bh = (size_t)b * heads + h;
  const bf16* kg = k + bh * tk * d;
  const bf16* vg = v + bh * tk * d;
  const float* bg = bias ? bias + (size_t)b * tk : nullptr;

  load_tile_h<DP, TQ, NT>(qs, q + bh * tq * d, q0, tq, d, vec);
  cp_commit();
  cp_wait<0>();
  __syncthreads();
  uint32_t qa[DP / 16][4];
#pragma unroll
  for (int ks = 0; ks < DP / 16; ++ks) ld_a<RS>(qa[ks], qs, 16 * w, ks);

  const int n_tiles = (tk + TK - 1) / TK;
  auto fetch = [&](int tile) {
    if (tile < n_tiles) {
      bf16* st = reinterpret_cast<bf16*>(ring + (tile % STAGES) * STAGE);
      load_tile_h<DP, TK, NT>(st, kg, tile * TK, tk, d, vec);
      load_tile_h<DP, TK, NT>(st + MAT, vg, tile * TK, tk, d, vec);
      if (bg) load_bias<NT>(reinterpret_cast<float*>(st + 2 * MAT), bg, tile * TK, TK, tk);
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
    __syncthreads();  // tile's K, V and biases are in for every thread
    const bf16* ks = reinterpret_cast<const bf16*>(ring + (tile % STAGES) * STAGE);
    const bf16* vs = ks + MAT;
    const float* kb = reinterpret_cast<const float*>(ks + 2 * MAT);
    const int k0 = tile * TK;

    uint32_t kbits[NJ];  // the mask's Philox work, ahead of the products
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      kbits[j] = DROP ? keep_bits(key, q0 + 16 * w, k0 + 8 * j, h, b, drop_thr) : 0u;
    float s[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
    mma_abt_h<DP, NJ, RS>(s, ks, [&](int kstep, uint32_t(&a)[4]) {
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qa[kstep][i];
    });
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
    mma_pb_h<NJ, DP / 16, RS>(s, vs, 0, acc);  // P rounded to bf16 here
    __syncthreads();  // every warp is done with this stage
    fetch(tile + STAGES);
  }
  cp_wait<0>();

  const int r = q0 + 16 * w + g;
  const float inv[2] = {1.0f / l[0], 1.0f / l[1]};
  store_rows_h<DP / 8>(o + bh * tq * d, acc, r, tq, d, 0, inv);
  if (t == 0) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
      if (r + 8 * hf < tq) lse[bh * tq + r + 8 * hf] = m[hf] + logf(l[hf]);
  }
}

template <int DP, int TK>
constexpr size_t fwd_bf16_smem_bytes() {
  return 2 * 16 * NW * (DP + 8) + STAGES * (4 * TK * (DP + 8) + 4 * TK);
}

template <int DP, int TK>
cudaError_t launch_bf16(const bf16* q, const bf16* k, const bf16* v, const float* bias,
                        const unsigned long long* seed, bf16* o, float* lse, int batch,
                        int heads, int tq, int tk, int d, float scale, uint32_t drop_thr,
                        float drop_scale, cudaStream_t stream) {
  const size_t smem = fwd_bf16_smem_bytes<DP, TK>();
  auto kernel = seed ? flash_fwd_bf16_kernel<DP, TK, true>
                     : flash_fwd_bf16_kernel<DP, TK, false>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const bool vec = d % 8 == 0 && aligned16(q) && aligned16(k) && aligned16(v);
  const dim3 grid((tq + 16 * NW - 1) / (16 * NW), heads, batch);
  kernel<<<grid, 32 * NW, smem, stream>>>(q, k, v, bias, seed, o, lse, heads, tq, tk, d,
                                          scale, drop_thr, drop_scale, vec);
  return cudaGetLastError();
}

}  // namespace

// The bf16 form: q, k, v, o bf16 (B, H, T, D); bias and lse float32.
extern "C" int flash_fwd_bf16_launch(const void* q, const void* k, const void* v,
                                     const float* bias, const unsigned long long* seed,
                                     void* o, float* lse, int batch, int heads, int tq,
                                     int tk, int d, float scale, unsigned drop_thr,
                                     float drop_scale, void* stream) {
  if (batch < 1 || heads < 1 || tq < 1 || tk < 1 || d < 1 || d > 128 ||
      batch > 65535 || heads > 65535) {
    return cudaErrorInvalidValue;
  }
  const cudaStream_t s = (cudaStream_t)stream;
  const bf16 *qh = (const bf16*)q, *kh = (const bf16*)k, *vh = (const bf16*)v;
  return d <= 64 ? launch_bf16<64, 64>(qh, kh, vh, bias, seed, (bf16*)o, lse, batch, heads,
                                       tq, tk, d, scale, drop_thr, drop_scale, s)
                 : launch_bf16<128, 32>(qh, kh, vh, bias, seed, (bf16*)o, lse, batch,
                                        heads, tq, tk, d, scale, drop_thr, drop_scale, s);
}

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
