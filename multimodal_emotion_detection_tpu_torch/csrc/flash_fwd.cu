// Flash-attention forward for Hopper (sm_90a).
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
// (torch's dropout-after-softmax, as the JAX kernel).
//
// What bounds it on the H100: arithmetic.  At the transformer encoder's
// shape (B=32, H=4, T=372, D=64) it does 4 B H T^2 D = 4.5 GFLOP (0.068 ms
// at the 67 TFLOP/s float32 rate) against 49 MB of q, k, v, o and lse
// (0.015 ms at 3.35 TB/s).  The products stay float32 on the CUDA cores, as
// the reference computes them (TF32 keeps 3 digits).
//
// Design: one CTA of 256 threads per (64-row query tile, head, batch row),
// grid (ceil(Tq/64), H, B): 768 CTAs at the encoder's shape.  The query
// tile stays in shared memory; the CTA walks the key tiles, staging K and V
// (dynamic shared memory, 69 KB at D 64, 118 KB at D 128) and keeping the
// running max m, sum l and the output accumulator in registers (online
// softmax): scores and probabilities never leave the SM.  A thread computes
// a 4 x 4 block of scores (its 4 query rows, keys tx + 16c) from float4
// reads, reduces row maxima and sums across its half-warp with shuffles,
// writes its dropped probabilities key-major into shared memory, and after
// one barrier accumulates its 4 rows x 4 (or 8) head-dim columns of P V.
// The dropout mask is one Philox call per (4-row group, key) (philox.cuh),
// a pure function of the coordinates, so the tiling does not change it.

#include "flash_common.cuh"
#include "philox.cuh"

namespace {

using namespace flash;

template <int DP>
constexpr size_t fwd_smem_bytes() {
  // q, k tiles (64 x (DP + 4)), v tile (64 x (DP + 4)), P^T (64 x SS),
  // key biases (TK)
  return sizeof(float) * (3 * 64 * (DP + 4) + 64 * SS + TK);
}

template <int DP>
__global__ void __launch_bounds__(NT, 2) flash_fwd_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ bias,
    const unsigned long long* __restrict__ seed, float* __restrict__ o,
    float* __restrict__ lse, int heads, int tq, int tk, int d, float scale,
    uint32_t drop_thr, float drop_scale) {
  constexpr int RS = DP + 4;
  constexpr int DC = DP / 16;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;               // [64][RS]
  float* ks = qs + 64 * RS;       // [64][RS]
  float* vs = ks + 64 * RS;       // [64][RS]
  float* pt = vs + 64 * RS;       // [TK][SS]: dropped P, key-major
  float* kb = pt + 64 * SS;       // [TK]

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int q0 = blockIdx.x * TQ, h = blockIdx.y, b = blockIdx.z;
  const size_t bh = (size_t)b * heads + h;
  const float* kg = k + bh * tk * d;
  const float* vg = v + bh * tk * d;
  load_tile<DP>(qs, q + bh * tq * d, q0, tq, d);

  const bool drop = seed != nullptr;
  const uint2 key = drop ? philox_key(seed) : make_uint2(0u, 0u);
  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.0f;
  }

  for (int k0 = 0; k0 < tk; k0 += TK) {
    __syncthreads();  // the previous tile's reads of ks, vs, pt, kb are done
    load_tile<DP>(ks, kg, k0, tk, d);
    load_tile<DP>(vs, vg, k0, tk, d);
    load_key_bias(kb, bias, b, k0, tk);
    __syncthreads();

    float s[4][4];
    tile_dot<DP>(qs, ks, tx, ty, s);
    float alpha[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[i][c] = s[i][c] * scale + kb[tx + 16 * c];
        mx = fmaxf(mx, s[i][c]);
      }
      // every key tile holds a key inside the sequence: m_new is finite
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      alpha[i] = expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[i][c] = expf(s[i][c] - m_new);
        sum += s[i][c];
      }
      l[i] = l[i] * alpha[i] + half_warp_sum(sum);
      m[i] = m_new;
    }
    if (drop) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float keep[4];
        keep_scales(key, q0 + 4 * ty, k0 + tx + 16 * c, h, b, drop_thr,
                    drop_scale, keep);
#pragma unroll
        for (int i = 0; i < 4; ++i) s[i][c] *= keep[i];
      }
    }
#pragma unroll
    for (int c = 0; c < 4; ++c)
      *reinterpret_cast<float4*>(pt + (tx + 16 * c) * SS + 4 * ty) =
          make_float4(s[0][c], s[1][c], s[2][c], s[3][c]);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha[i];
    __syncthreads();
    tile_tn<DP>(pt, vs, tx, ty, acc);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] /= l[i];
  store_rows<DP>(o + bh * tq * d, acc, q0, tq, d, tx, ty, false);
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + 4 * ty + i;
      if (r < tq) lse[bh * tq + r] = m[i] + logf(l[i]);
    }
  }
}

template <int DP>
cudaError_t launch(const float* q, const float* k, const float* v,
                   const float* bias, const unsigned long long* seed,
                   float* o, float* lse, int batch, int heads, int tq, int tk,
                   int d, float scale, uint32_t drop_thr, float drop_scale,
                   cudaStream_t stream) {
  const size_t smem = fwd_smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((tq + TQ - 1) / TQ, heads, batch);
  flash_fwd_kernel<DP><<<grid, NT, smem, stream>>>(
      q, k, v, bias, seed, o, lse, heads, tq, tk, d, scale, drop_thr,
      drop_scale);
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
  return d <= 64 ? launch<64>(q, k, v, bias, seed, o, lse, batch, heads, tq,
                              tk, d, scale, drop_thr, drop_scale, s)
                 : launch<128>(q, k, v, bias, seed, o, lse, batch, heads, tq,
                               tk, d, scale, drop_thr, drop_scale, s);
}

extern "C" const char* flash_fwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
