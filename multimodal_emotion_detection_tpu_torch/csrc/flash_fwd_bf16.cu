// Flash-attention forward on bf16 operands for Hopper (sm_90a): warpgroup
// MMAs on TMA-staged tiles.
//
// Replaces: multimodal_emotion_detection_tpu/ops/flash_attention.py::
// _flash_fwd_call on bf16 inputs (kernel body _fwd_kernel, which keeps q, k
// and v in the input dtype, :175-177).  Same function as the plain PyTorch
// version ops/flash_attention.py::flash_fwd_reference on bf16 operands: per
// (b, h)
//
//   s   = q k^T / sqrt(D) + bias[b]        (keys past Tk excluded)
//   lse = logsumexp_j s,   p = exp(s - lse)
//   o   = (p * keep) v                     (keep: the Philox dropout mask
//                                           scaled by 1 / (1 - rate), or 1)
//
// with the JAX kernel's rounding points: S, the scale, bias, max, exp, l and
// LSE in float32; P (times the keep mask) rounded to bf16 as the A operand
// of P V; O = acc / l rounded to bf16 once.  P is taken relative to the
// running max of the key tiles walked so far, so where a row's max moves
// after its first tile the rounded P can differ by an ulp from a P taken
// after the final max (the plain version's).
//
// What bounds it on the H100: bytes.  At the transformer encoder's shape
// (B=32, H=4, T=372, D=64) it moves 24.57 MB of bf16 q, k, v, O and float32
// LSE (0.0073 ms at 3.35 TB/s) for 4.535 GFLOP (0.0046 ms at 989 TFLOP/s).
//
// Design (the second; the first, mma.sync m16n8k16 from four independent
// warps with cp.async tiles, ran 0.0834 ms there, 1.55x SDPA).  One CTA
// of one warpgroup per (64-row query tile, head, batch row), four CTAs an
// SM at D <= 64.  Its thread 0 loads the query tile once and each 64-key
// tile's K and V by TMA into a ring of two stages, K and V on barriers of
// their own, so S = Q K^T starts as soon as K lands; a stage is refilled
// once every warp is done with it.  The warpgroup starts S = Q K^T as
// wgmma m64n64k16 with Q and K read from shared memory through descriptors
// (128-byte swizzle, no bank conflicts), makes the tile's Philox mask bits
// while the tensor cores run, then runs the online softmax in the
// accumulator registers (in log2 units: one FMA and one ex2 an element;
// row max and sum over the quad), rescales O, rounds P M to bf16 straight
// into the A fragments of O += P V (wgmma with A from registers, V read
// transposed), rescaling O only where a row's max moved.  O stays in
// registers (m64nD, float32) until the epilogue, which rounds it into the
// Q tile and stores it by TMA.  The kernel is compiled with and without a
// key bias: without one, only the last key tile masks keys past Tk.
// The mask is a pure function of (seed, b, h, i, j) (flash_wgmma.cuh::
// mask_word: a lane's Philox bits for the tile in one word, handed out by
// one round of shuffles a tile), so it is the plain version's whatever the
// tiling; the kernel is compiled with and without it.
//
// Built with -DFLASH_FWD_TIMERS=1 (scripts/flash_ab.py --fwd-timers) each
// thread adds clock64() time per phase into fwd_timers, read back
// by flash_fwd_bf16_timers(); the default build has neither.

#include "flash_wgmma.cuh"

namespace {

using namespace flash_wgmma;
using flash_mma::quad_max;
using flash_mma::quad_sum;

constexpr int TQ = 64;       // query rows a CTA: one warpgroup's m64
constexpr int TK = 64;       // keys a tile
constexpr int STAGES = 2;    // K / V ring
constexpr int NT = 128;      // one warpgroup
constexpr int TILE = TK * ROW_BYTES;  // bytes of a 64-row, 64-column region

#ifndef FLASH_FWD_TIMERS
#define FLASH_FWD_TIMERS 0
#endif
#if FLASH_FWD_TIMERS
constexpr int kPhases = 7;
__device__ unsigned long long fwd_timers[kPhases];
#define PHASE(i)                      \
  {                                   \
    const long long now = clock64();  \
    tacc[i] += now - tprev;           \
    tprev = now;                      \
  }
#else
#define PHASE(i)
#endif

// Dynamic shared memory in bytes for a head dim padded to DP: Q, then the
// ring's stages of K and V, each DP / 64 regions of 64 rows, plus the slack
// that aligns the first region to 1024 bytes.  ops/flash_attention.py::
// flash_bf16_plan mirrors it.
template <int DP>
constexpr int fwd_smem() {
  return (1 + 2 * STAGES) * (DP / REGION) * TILE + 1024;
}

struct Params {
  CUtensorMap mq, mk, mv, mo;  // (B H, T, Dp) maps, (64, 64, 1) boxes
  const float* bias;
  const unsigned long long* seed;
  float* lse;
  int heads, tq, tk, dp;
  float scale;
  uint32_t drop_thr;
  float drop_scale;
};

template <int DP, bool DROP, bool BIAS>
__global__ void __launch_bounds__(NT, DP == 64 ? 4 : 2)
    flash_fwd_bf16_kernel(const __grid_constant__ Params p) {
  constexpr int R = DP / REGION;  // regions of the head dim
  constexpr int NO = DP / 2;      // O accumulator floats a thread
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t q_full, k_full[STAGES], v_full[STAGES];
  unsigned char* qs = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* ring = qs + R * TILE;  // stage s: K at s * 2 R TILE, V R TILE on

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * TQ, h = blockIdx.y, b = blockIdx.z;
  const int bh = b * p.heads + h;
  const int n_tiles = (p.tk + TK - 1) / TK;
  // thread 0 starts every copy: a tile's K and V on barriers of their own
  auto fetch = [&](int tile) {
    const int s = tile % STAGES;
    unsigned char* st = ring + s * 2 * R * TILE;
    mbar_expect_tx(&k_full[s], R * TILE);
    tma_tile<TK, R>(st, &p.mk, &k_full[s], tile * TK, bh);
    mbar_expect_tx(&v_full[s], R * TILE);
    tma_tile<TK, R>(st + R * TILE, &p.mv, &v_full[s], tile * TK, bh);
  };
  if (threadIdx.x == 0) {
    mbar_init(&q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
    }
    mbar_fence_init();
    mbar_expect_tx(&q_full, R * TILE);
    tma_tile<TQ, R>(qs, &p.mq, &q_full, q0, bh);
    for (int tile = 0; tile < STAGES && tile < n_tiles; ++tile) fetch(tile);
  }
  __syncthreads();

  // warp w owns query rows q0 + 16 w ..
  const float* bg = BIAS ? p.bias + (size_t)b * p.tk : nullptr;
  const uint2 key = DROP ? flash::philox_key(p.seed) : make_uint2(0u, 0u);
  const float sl2 = p.scale * LOG2E;  // scores in log2 units: P = 2^(S sl2 + bias log2 e - m)
#if FLASH_FWD_TIMERS
  long long tacc[kPhases] = {}, tprev = clock64();
#endif
  float o[NO], sacc[32];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < 32; ++i) sacc[i] = 0.0f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
  mbar_wait(&q_full, 0);
  PHASE(0)

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int s = tile % STAGES;
    const uint32_t ph = (tile / STAGES) & 1;
    const unsigned char* kst = ring + s * 2 * R * TILE;
    const unsigned char* vst = kst + R * TILE;
    const int k0 = tile * TK;
    mbar_wait(&k_full[s], ph);
    PHASE(1)
    // S = Q K^T over the head dim, on the tensor cores while the mask bits
    // and the key biases are made
    wg_fence();
#pragma unroll
    for (int kstep = 0; kstep < DP / 16; ++kstep)
      wgmma_ss_n64(sacc, desc_k<TQ>(qs, kstep), desc_k<TK>(kst, kstep), kstep > 0);
    wg_commit();
    uint32_t kw[4];  // the lane's keep bits' source words
    if (DROP)
      keep_words<false>(mask_word<TK / 8, false>(key, q0 + 16 * warp, k0, h, b, p.drop_thr), kw);
    // the lane's keys' biases in log2 units, -inf past Tk; without a bias
    // only the last tile has keys to mask
    const bool edge = k0 + TK > p.tk;
    float kb[TK / 4];
    if (BIAS || edge) {
#pragma unroll
      for (int j = 0; j < TK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = k0 + 8 * j + 2 * t + e;
          kb[2 * j + e] = c < p.tk ? (BIAS ? __ldg(bg + c) * LOG2E : 0.0f) : -INFINITY;
        }
    }
    PHASE(2)
    wg_wait<0>();
    reg_fence(sacc);
    PHASE(3)

    float mx[2] = {-INFINITY, -INFINITY};
    if (BIAS || edge) {
#pragma unroll
      for (int j = 0; j < TK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sacc[4 * j + e] = fmaf(sacc[4 * j + e], sl2, kb[2 * j + (e & 1)]);
          mx[e >> 1] = fmaxf(mx[e >> 1], sacc[4 * j + e]);
        }
    } else {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        sacc[i] *= sl2;
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sacc[i]);
      }
    }
    float alpha[2], sum[2] = {0.0f, 0.0f};
    bool moved = false;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      // every key tile holds a key inside the sequence: m_new is finite
      const float m_new = fmaxf(m[r], quad_max(mx[r]));
      moved |= m_new != m[r];
      alpha[r] = m_new == m[r] ? 1.0f : ex2(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int j = 0; j < TK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sacc[4 * j + e] = ex2(sacc[4 * j + e] - m[e >> 1]);
        sum[e >> 1] += sacc[4 * j + e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + quad_sum(sum[r]);
    // O rescaled where a row's max moved (a warp's vote)
    if (__any_sync(0xffffffffu, moved)) {
#pragma unroll
      for (int i = 0; i < NO; ++i) o[i] *= alpha[(i >> 1) & 1];
    }
    PHASE(4)
    if (DROP) {
#pragma unroll
      for (int j = 0; j < TK / 8; ++j) {
        float keep[4];
        keep_block<false>(kw, j, p.drop_scale, keep);
#pragma unroll
        for (int e = 0; e < 4; ++e) sacc[4 * j + e] *= keep[e];
      }
    }
    uint32_t pa[TK / 16][4];  // P M rounded to bf16: the A operand of P V
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk) a_frag(pa[kk], sacc, kk);
    PHASE(2)
    mbar_wait(&v_full[s], ph);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk) {
      if constexpr (DP == 64)
        wgmma_rs_n64(o, pa[kk], desc_mn<TK>(vst, kk), 1);
      else
        wgmma_rs_n128(o, pa[kk], desc_mn<TK>(vst, kk), 1);
    }
    wg_commit();
    wg_wait<0>();
    reg_fence(o);
    reg_fence(pa);  // the A registers stay live until the products have read them
    PHASE(5)
    if (tile + STAGES < n_tiles) {
      __syncthreads();  // every warp is done with this stage
      if (threadIdx.x == 0) fetch(tile + STAGES);
    }
  }

  // O / l rounded to bf16 into the Q tile (its products are done), then one
  // TMA store a region
  const int r = q0 + 16 * warp + g;
  const float inv[2] = {1.0f / l[0], 1.0f / l[1]};
  acc_to_tile(qs, o, inv);
  fence_async_shared();
  __syncthreads();  // every row is in
  if (threadIdx.x == 0) {
    tma_store_tile<TQ, R>(&p.mo, qs, q0, bh);
    tma_store_wait();
  }
  if (t == 0) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
      if (r + 8 * hf < p.tq) p.lse[(size_t)bh * p.tq + r + 8 * hf] = m[hf] * LN2 + logf(l[hf]);
  }
  PHASE(6)
#if FLASH_FWD_TIMERS
  for (int i = 0; i < kPhases; ++i) atomicAdd(&fwd_timers[i], (unsigned long long)tacc[i]);
#endif
}

template <int DP, bool DROP>
cudaError_t launch_k(const Params& p, int batch, int grid_x, int smem, cudaStream_t stream) {
  auto kernel = p.bias ? flash_fwd_bf16_kernel<DP, DROP, true>
                       : flash_fwd_bf16_kernel<DP, DROP, false>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(grid_x, p.heads, batch), NT, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch(Params& p, const void* q, const void* k, const void* v, void* o, int batch,
                   int grid_x, int smem, cudaStream_t stream) {
  if (smem != fwd_smem<DP>() || grid_x != (p.tq + TQ - 1) / TQ) return cudaErrorInvalidValue;
  const int slabs = batch * p.heads;
  cudaError_t err = make_map(&p.mq, q, slabs, p.tq, p.dp, TQ);
  if (err == cudaSuccess) err = make_map(&p.mk, k, slabs, p.tk, p.dp, TK);
  if (err == cudaSuccess) err = make_map(&p.mv, v, slabs, p.tk, p.dp, TK);
  if (err == cudaSuccess) err = make_map(&p.mo, o, slabs, p.tq, p.dp, TQ);
  if (err != cudaSuccess) return err;
  return p.seed ? launch_k<DP, true>(p, batch, grid_x, smem, stream)
                : launch_k<DP, false>(p, batch, grid_x, smem, stream);
}

}  // namespace

// q, k, v, o bf16 (B, H, T, dp) with dp % 8 == 0 (the wrapper pads the head
// dim) and 16-byte aligned; bias (B, Tk) and lse (B, H, Tq) float32.
// grid_x and smem are the wrapper's plan (ops/flash_attention.py::
// flash_bf16_plan), checked against this source's.
extern "C" int flash_fwd_bf16_launch(const void* q, const void* k, const void* v,
                                     const float* bias, const unsigned long long* seed, void* o,
                                     float* lse, int batch, int heads, int tq, int tk, int dp,
                                     int grid_x, int smem, float scale, unsigned drop_thr,
                                     float drop_scale, void* stream) {
  if (batch < 1 || heads < 1 || tq < 1 || tk < 1 || dp < 8 || dp > 128 || dp % 8 != 0 ||
      batch > 65535 || heads > 65535 ||
      ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
        reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o)) & 15) != 0) {
    return cudaErrorInvalidValue;
  }
  Params p{};
  p.bias = bias;
  p.seed = seed;
  p.lse = lse;
  p.heads = heads;
  p.tq = tq;
  p.tk = tk;
  p.dp = dp;
  p.scale = scale;
  p.drop_thr = drop_thr;
  p.drop_scale = drop_scale;
  const cudaStream_t s = (cudaStream_t)stream;
  return dp <= 64 ? launch<64>(p, q, k, v, o, batch, grid_x, smem, s)
                  : launch<128>(p, q, k, v, o, batch, grid_x, smem, s);
}

#if FLASH_FWD_TIMERS
// the summed phase times (clock cycles over all consumer threads) since the
// last reset; reset: zero them after reading
extern "C" int flash_fwd_bf16_timers(unsigned long long* out, int reset) {
  cudaError_t err = cudaMemcpyFromSymbol(out, fwd_timers, sizeof(fwd_timers));
  if (err == cudaSuccess && reset) {
    const unsigned long long zero[kPhases] = {};
    err = cudaMemcpyToSymbol(fwd_timers, zero, sizeof(zero));
  }
  return err;
}

extern "C" const char* flash_fwd_bf16_timer_names() {
  return "Q wait and prologue,wait for K,S start + mask bits + biases + P to bf16,"
         "S = Q K^T (wait),softmax,wait for V + P V,epilogue";
}
#endif

extern "C" const char* flash_fwd_bf16_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
