// Flash-attention backward on bf16 operands for Hopper (sm_90a): the fused
// form (dQ, dK and dV in one launch) and the two-pass form's dK / dV pass
// and dQ pass, on warpgroup MMAs over TMA-staged tiles.
//
// Replaces: multimodal_emotion_detection_tpu/ops/flash_attention.py::
// _flash_bwd_call on bf16 inputs, in its fused form (Tk <= 4096; kernel
// body _bwd_fused_kernel over _bwd_kv_major) -> flash_bwd_fused_bf16_launch,
// and the two-pass form's kv-major pass (Tk > 4096; _bwd_dkv_kernel) ->
// flash_bwd_dkv_bf16_launch, the same kernel without its dQ role (DQ =
// false), and its q-major pass (_bwd_dq_kernel) -> flash_bwd_dq_bf16_launch,
// a kernel of its own (the dQ form, below).  Same function as
// ops/flash_attention.py::flash_bwd_reference on bf16 operands:
// with P = exp(S - LSE) recomputed from the forward's logsumexp and M the
// forward's keep mask (1 / (1 - rate) where kept),
//
//   dV = (P M)^T dO,  dS = P (M (dO V^T) - Delta) / sqrt(D),
//   dK = dS^T Q,      dQ = dS K,          Delta = rowsum(dO O) (given),
//
// at the JAX kernel's rounding points: S, P, dP and dS in float32, P M and
// dS rounded to bf16 as the operands of their products, dK and dV rounded
// once, dQ summed in float32 over every key and rounded once.
//
// What bounds it on the H100: bytes.  At the transformer encoder's shape
// (B=32, H=4, T=372, D=64) the function reads bf16 q, k, v, dO and float32
// LSE, Delta and writes bf16 dQ, dK, dV: 43.05 MB, 0.0128 ms at 3.35 TB/s;
// its five products a (query, key) pair are 11.34 GFLOP, 0.0115 ms at 989
// TFLOP/s.  This design forms S and dP twice (once in each role below): 7
// products a pair, 15.9 GFLOP, 0.0161 ms at that rate.  The two-pass form
// at (B=2, H=4, T=5000, D=64) is bound by operations: the dK / dV pass's
// four products a pair 102.4 GFLOP (0.1035 ms), the dQ pass's three 76.8
// GFLOP (0.0777 ms), against 31.1 MB and 26.0 MB moved (0.0093 / 0.0077
// ms at 3.35 TB/s).
//
// Design (the second; the first, mma.sync from four warps over kv spans,
// wrote a float32 dQ partial a span that the wrapper summed: 0.1831 ms
// there, ~73 MB of partials written and read).  One launch, two roles of
// CTA per (head, batch row), each CTA one warpgroup whose thread 0 starts
// every TMA copy; three CTAs an SM at D <= 64:
//
// * kv role (blockIdx.x < kv_ctas): a 64-key tile, K and V staged once.
//   It walks the query tiles (64 rows at D <= 64, 32 at D 128): Q and dO by
//   TMA into a ring of three stages, the tile's LSE and Delta by one cp.async
//   a thread on the same stage barrier.  Per tile the warpgroup starts S^T
//   = K Q^T and dP^T = V dO^T (wgmma, K / V and Q / dO from shared memory),
//   makes the tile's mask bits while they run, forms P^T (one ex2 an
//   element, log2 e folded into the scale) and dS^T in the accumulator
//   registers, rounds P M and dS to bf16 straight into the A fragments of
//   dV += (P M)^T dO and dK += dS^T Q (wgmma with A from registers, dO and
//   Q read transposed), and refills the stage once every warp is done with
//   it.  dK and dV stay float32 in registers over the walk and are rounded
//   to bf16 once.
// * q role (blockIdx.x >= kv_ctas, fused form only): a 64-row query tile,
//   Q and dO staged once.  It walks every key tile, K and V through the
//   ring: S = Q K^T and dP = dO V^T, then dS (the same function of the same
//   values), and dQ += dS K with dS rounded to bf16 into the A fragments, K
//   read transposed.  dQ is summed over every key in float32 registers, in
//   key order, and rounded to bf16 once: it reaches device memory once, with
//   no partial slots and no atomics, so two runs are bit for bit equal.
//
// The dK / dV form launches the kv role alone: its dK and dV are the fused
// form's bit for bit (the same code on the same values).  Rows past Tq get
// LSE = +inf (P = 0) and Delta = 0; keys past Tk a bias of -inf; the tiles
// there arrive as zeros.  The mask is philox.cuh's, a pure function of
// (seed, b, h, i, j) (flash_wgmma.cuh::mask_word / keep_words /
// keep_block, keys as rows in the kv role).
//
// Built with -DFLASH_BWD_TIMERS=1 (scripts/flash_ab.py --bf16-fused-timers,
// --bf16-dq-timers) each thread adds clock64() time per phase into
// bwd_timers, read back by flash_bwd_bf16_timers(); the default build has
// neither.

#include <type_traits>

#include "flash_wgmma.cuh"

namespace {

using namespace flash_wgmma;

constexpr int TKV = 64;     // keys of a kv-role CTA and of a q-role key tile
constexpr int TQR = 64;     // query rows of a q-role CTA
constexpr int STAGES = 3;   // the ring of either role
constexpr int NT = 128;     // one warpgroup

#ifndef FLASH_BWD_TIMERS
#define FLASH_BWD_TIMERS 0
#endif
#if FLASH_BWD_TIMERS
constexpr int kPhases = 15;  // kv role 0-4, q role 5-9, the dQ form 10-14
__device__ unsigned long long bwd_timers[kPhases];
#define PHASE(i)                      \
  {                                   \
    const long long now = clock64();  \
    tacc[i] += now - tprev;           \
    tprev = now;                      \
  }
#define TIMERS_START long long tacc[kPhases] = {}, tprev = clock64();
#define TIMERS_END \
  for (int i = 0; i < kPhases; ++i) atomicAdd(&bwd_timers[i], (unsigned long long)tacc[i]);
#else
#define PHASE(i)
#define TIMERS_START
#define TIMERS_END
#endif

// Tile sizes in bytes for a head dim padded to DP, and the dynamic shared
// memory of each role (ops/flash_attention.py::flash_bf16_plan mirrors it)
template <int DP>
struct Geo {
  static constexpr int R = DP / REGION;           // 64-column regions
  static constexpr int QN = DP == 64 ? 64 : 32;   // queries a kv-role tile
  static constexpr int KT = TKV * ROW_BYTES * R;  // a 64-row tile
  static constexpr int QT = QN * ROW_BYTES * R;   // a kv-role query tile
  static constexpr int STATS = 2 * STAGES * QT + 2 * KT;  // LSE and Delta of each stage
  static constexpr int KV_BYTES = STATS + STAGES * 2 * QN * 4;
  static constexpr int Q_BYTES = 2 * KT + STAGES * 2 * KT;
};

template <int DP, bool DQ>
constexpr int bwd_smem() {
  using G = Geo<DP>;
  return (DQ && G::Q_BYTES > G::KV_BYTES ? G::Q_BYTES : G::KV_BYTES) + 1024;
}

struct Params {
  CUtensorMap mq_kv, mdo_kv;   // (B H, Tq, Dp), (64, QN, 1) boxes: the kv role's
  CUtensorMap mq, mdo, mk, mv;  // (64, 64, 1) boxes
  const float* bias;
  const unsigned long long* seed;
  const float* lse;
  const float* delta;
  bf16* dq;
  bf16* dk;
  bf16* dv;
  int heads, tq, tk, dp, kv_ctas;
  float scale;
  uint32_t drop_thr;
  float drop_scale;
};

struct Bars {
  uint64_t* fixed;  // the CTA's own tiles
  uint64_t* full;   // [STAGES]: a stage's tiles (and the kv role's LSE / Delta)
};

template <int DP>
__device__ __forceinline__ void rs_product(float (&d)[DP / 2], const uint32_t (&a)[4],
                                           uint64_t db) {
  if constexpr (DP == 64)
    wgmma_rs_n64(d, a, db, 1);
  else
    wgmma_rs_n128(d, a, db, 1);
}

template <int N>
__device__ __forceinline__ void ss_product(float (&d)[N / 2], uint64_t da, uint64_t db,
                                           int accumulate) {
  if constexpr (N == 64)
    wgmma_ss_n64(d, da, db, accumulate);
  else
    wgmma_ss_n32(d, da, db, accumulate);
}

template <int DP, bool DROP>
__device__ __forceinline__ void kv_role(const Params& p, unsigned char* base, const Bars& bar,
                                        int kt, int h, int b, int bh) {
  using G = Geo<DP>;
  constexpr int R = G::R, QN = G::QN, NS = QN / 2, NJ = QN / 8;
  unsigned char* ks = base;
  unsigned char* vs = base + G::KT;
  unsigned char* ring = base + 2 * G::KT;  // stage s: Q at s * 2 QT, dO QT on
  float* stats = reinterpret_cast<float*>(base + G::STATS);  // stage s: LSE at 2 QN s, Delta QN on
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = kt * TKV;
  const int n_q = (p.tq + QN - 1) / QN;
  const float* lse_g = p.lse + (size_t)bh * p.tq;
  const float* delta_g = p.delta + (size_t)bh * p.tq;
  // a query tile into its stage: Q and dO by thread 0's TMA, LSE and Delta
  // by every thread's cp.async (one value each), all on the stage barrier
  auto fetch = [&](int i) {
    const int s = i % STAGES;
    if (threadIdx.x == 0) {
      unsigned char* st = ring + s * 2 * G::QT;
      mbar_expect_tx(&bar.full[s], 2 * G::QT);
      tma_tile<QN, R>(st, &p.mq_kv, &bar.full[s], i * QN, bh);
      tma_tile<QN, R>(st + G::QT, &p.mdo_kv, &bar.full[s], i * QN, bh);
    }
    const int j = threadIdx.x % QN, c = i * QN + j;
    if (threadIdx.x < 2 * QN)
      cp_async4(stats + 2 * QN * s + threadIdx.x, (threadIdx.x < QN ? lse_g : delta_g) +
                (c < p.tq ? c : 0), c < p.tq);
    cp_async_arrive(&bar.full[s]);
  };
  if (threadIdx.x == 0) {
    mbar_expect_tx(bar.fixed, 2 * G::KT);
    tma_tile<TKV, R>(ks, &p.mk, bar.fixed, k0, bh);
    tma_tile<TKV, R>(vs, &p.mv, bar.fixed, k0, bh);
  }
  for (int i = 0; i < STAGES && i < n_q; ++i) fetch(i);

  // warp w owns keys k0 + 16 w ..; accumulators are (key, query) fragments
  const uint2 key = DROP ? flash::philox_key(p.seed) : make_uint2(0u, 0u);
  const float sl2 = p.scale * LOG2E;  // P = 2^(S^T sl2 + bias log2 e - LSE log2 e)
  TIMERS_START
  float kb[2];  // the lane's keys g, g + 8: biases in log2 units, -inf past Tk
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int kk = k0 + 16 * warp + g + 8 * hf;
    kb[hf] = kk >= p.tk ? -INFINITY
                        : (p.bias ? __ldg(p.bias + (size_t)b * p.tk + kk) * LOG2E : 0.0f);
  }
  float dk[DP / 2], dv[DP / 2], st_[NS], dpt[NS];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dk[i] = dv[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < NS; ++i) st_[i] = dpt[i] = 0.0f;
  mbar_wait(bar.fixed, 0);

  for (int i = 0; i < n_q; ++i) {
    const int s = i % STAGES;
    const int q0 = i * QN;
    const unsigned char* qt = ring + s * 2 * G::QT;
    const unsigned char* dot = qt + G::QT;
    const float* lse_s = stats + 2 * QN * s;
    const float* delta_s = lse_s + QN;
    mbar_wait(&bar.full[s], (i / STAGES) & 1);
    PHASE(0)
    // S^T = K Q^T and dP^T = V dO^T, while the mask bits are made
    wg_fence();
#pragma unroll
    for (int kstep = 0; kstep < DP / 16; ++kstep)
      ss_product<QN>(st_, desc_k<TKV>(ks, kstep), desc_k<QN>(qt, kstep), kstep > 0);
#pragma unroll
    for (int kstep = 0; kstep < DP / 16; ++kstep)
      ss_product<QN>(dpt, desc_k<TKV>(vs, kstep), desc_k<QN>(dot, kstep), kstep > 0);
    wg_commit();
    uint32_t kw[4];  // the lane's keep bits' source words
    if (DROP)
      keep_words<true>(mask_word<NJ, true>(key, q0, k0 + 16 * warp, h, b, p.drop_thr), kw);
    PHASE(1)
    wg_wait<0>();
    reg_fence(st_);
    reg_fence(dpt);
    PHASE(2)
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      float keep[4] = {1.0f, 1.0f, 1.0f, 1.0f};
      if (DROP) keep_block<true>(kw, j, p.drop_scale, keep);
      const int c = 8 * j + 2 * t;  // the lane's queries q0 + c, + 1
      const float2 l2 = *reinterpret_cast<const float2*>(lse_s + c);
      const float2 d2 = *reinterpret_cast<const float2*>(delta_s + c);
      // +inf / 0 past Tq
      const float lse[2] = {q0 + c < p.tq ? l2.x * LOG2E : INFINITY,
                            q0 + c + 1 < p.tq ? l2.y * LOG2E : INFINITY};
      const float dl[2] = {d2.x, d2.y};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pr = ex2(fmaf(st_[4 * j + e], sl2, kb[e >> 1]) - lse[e & 1]);
        st_[4 * j + e] = pr * keep[e];
        dpt[4 * j + e] = pr * (dpt[4 * j + e] * keep[e] - dl[e & 1]) * p.scale;
      }
    }
    // (P M)^T and dS^T rounded to bf16: the A operands
    uint32_t pa[QN / 16][4], da[QN / 16][4];
#pragma unroll
    for (int kk = 0; kk < QN / 16; ++kk) {
      a_frag(pa[kk], st_, kk);
      a_frag(da[kk], dpt, kk);
    }
    PHASE(3)
    // dV += (P M)^T dO and dK += dS^T Q, dO and Q read transposed
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < QN / 16; ++kk) rs_product<DP>(dv, pa[kk], desc_mn<QN>(dot, kk));
#pragma unroll
    for (int kk = 0; kk < QN / 16; ++kk) rs_product<DP>(dk, da[kk], desc_mn<QN>(qt, kk));
    wg_commit();
    wg_wait<0>();
    reg_fence(dv);
    reg_fence(dk);
    reg_fence(pa);  // the A registers stay live until the products have read them
    reg_fence(da);
    PHASE(4)
    if (i + STAGES < n_q) {
      __syncthreads();  // every warp is done with this stage
      fetch(i + STAGES);
    }
  }

  const int r = k0 + 16 * warp + g;
  const float one[2] = {1.0f, 1.0f};
  store_acc(p.dk + (size_t)bh * p.tk * p.dp, dk, r, p.tk, p.dp, one);
  store_acc(p.dv + (size_t)bh * p.tk * p.dp, dv, r, p.tk, p.dp, one);
  TIMERS_END
}

template <int DP, bool DROP, bool BIAS>
__device__ __forceinline__ void q_role(const Params& p, unsigned char* base, const Bars& bar,
                                       int qi, int h, int b, int bh) {
  using G = Geo<DP>;
  constexpr int R = G::R, NJ = TKV / 8;
  unsigned char* qs = base;
  unsigned char* dos = base + G::KT;
  unsigned char* ring = base + 2 * G::KT;  // stage s: K at s * 2 KT, V KT on
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = qi * TQR;
  const int n_k = (p.tk + TKV - 1) / TKV;
  auto fetch = [&](int j) {  // thread 0: a key tile's K and V into its stage
    const int s = j % STAGES;
    unsigned char* st = ring + s * 2 * G::KT;
    mbar_expect_tx(&bar.full[s], 2 * G::KT);
    tma_tile<TKV, R>(st, &p.mk, &bar.full[s], j * TKV, bh);
    tma_tile<TKV, R>(st + G::KT, &p.mv, &bar.full[s], j * TKV, bh);
  };
  if (threadIdx.x == 0) {
    mbar_expect_tx(bar.fixed, 2 * G::KT);
    tma_tile<TQR, R>(qs, &p.mq, bar.fixed, q0, bh);
    tma_tile<TQR, R>(dos, &p.mdo, bar.fixed, q0, bh);
    for (int j = 0; j < STAGES && j < n_k; ++j) fetch(j);
  }

  // warp w owns query rows q0 + 16 w ..; accumulators are (query, key)
  // fragments
  const uint2 key = DROP ? flash::philox_key(p.seed) : make_uint2(0u, 0u);
  const float sl2 = p.scale * LOG2E;
  TIMERS_START
  float lse[2], dl[2];  // the lane's rows g, g + 8: LSE in log2 units; +inf / 0 past Tq
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = q0 + 16 * warp + g + 8 * hf;
    lse[hf] = r < p.tq ? __ldg(p.lse + (size_t)bh * p.tq + r) * LOG2E : INFINITY;
    dl[hf] = r < p.tq ? __ldg(p.delta + (size_t)bh * p.tq + r) : 0.0f;
  }
  const float* bg = BIAS ? p.bias + (size_t)b * p.tk : nullptr;
  float dq[DP / 2], sacc[32], dpacc[32];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dq[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < 32; ++i) sacc[i] = dpacc[i] = 0.0f;
  mbar_wait(bar.fixed, 0);

  for (int j = 0; j < n_k; ++j) {
    const int s = j % STAGES;
    const int k0 = j * TKV;
    const unsigned char* kst = ring + s * 2 * G::KT;
    const unsigned char* vst = kst + G::KT;
    mbar_wait(&bar.full[s], (j / STAGES) & 1);
    PHASE(5)
    // S = Q K^T and dP = dO V^T, while the mask bits and key biases load
    wg_fence();
#pragma unroll
    for (int kstep = 0; kstep < DP / 16; ++kstep)
      wgmma_ss_n64(sacc, desc_k<TQR>(qs, kstep), desc_k<TKV>(kst, kstep), kstep > 0);
#pragma unroll
    for (int kstep = 0; kstep < DP / 16; ++kstep)
      wgmma_ss_n64(dpacc, desc_k<TQR>(dos, kstep), desc_k<TKV>(vst, kstep), kstep > 0);
    wg_commit();
    uint32_t kw[4];  // the lane's keep bits' source words
    if (DROP)
      keep_words<false>(mask_word<NJ, false>(key, q0 + 16 * warp, k0, h, b, p.drop_thr), kw);
    // the lane's keys' biases in log2 units, -inf past Tk; without a bias
    // only the last tile has keys to mask
    const bool edge = k0 + TKV > p.tk;
    float kb[2 * NJ];
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = k0 + 8 * jj + 2 * t + e;
        kb[2 * jj + e] = BIAS || edge
                             ? (c < p.tk ? (BIAS ? __ldg(bg + c) * LOG2E : 0.0f) : -INFINITY)
                             : 0.0f;
      }
    PHASE(6)
    wg_wait<0>();
    reg_fence(sacc);
    reg_fence(dpacc);
    PHASE(7)
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      float keep[4] = {1.0f, 1.0f, 1.0f, 1.0f};
      if (DROP) keep_block<false>(kw, jj, p.drop_scale, keep);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pr = ex2(fmaf(sacc[4 * jj + e], sl2, kb[2 * jj + (e & 1)]) - lse[e >> 1]);
        dpacc[4 * jj + e] = pr * (dpacc[4 * jj + e] * keep[e] - dl[e >> 1]) * p.scale;
      }
    }
    uint32_t da[TKV / 16][4];  // dS rounded to bf16: the A operand of dS K
#pragma unroll
    for (int kk = 0; kk < TKV / 16; ++kk) a_frag(da[kk], dpacc, kk);
    PHASE(8)
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < TKV / 16; ++kk) rs_product<DP>(dq, da[kk], desc_mn<TKV>(kst, kk));
    wg_commit();
    wg_wait<0>();
    reg_fence(dq);
    reg_fence(da);  // the A registers stay live until the product has read them
    PHASE(9)
    if (j + STAGES < n_k) {
      __syncthreads();  // every warp is done with this stage
      if (threadIdx.x == 0) fetch(j + STAGES);
    }
  }

  const float one[2] = {1.0f, 1.0f};
  store_acc(p.dq + (size_t)bh * p.tq * p.dp, dq, q0 + 16 * warp + g, p.tq, p.dp, one);
  TIMERS_END
}

// ---------------------------------------------------------------- dQ form
//
// The two-pass form's dQ pass (flash_bwd_dq_bf16_launch): the q role's
// function on a grid of query tiles alone, one warpgroup a CTA (Q and dO of
// its 64-row tile staged once) walking every key tile through a K / V ring
// of DQ_STAGES stages, three CTAs an SM at D <= 64.  It keeps the tensor
// cores fed across the walk: with key tile j's dS in A registers, it starts
// S and dP of tile j + 1 and then dQ += dS_j K_j, makes tile j + 1's mask
// bits and key biases while both run, waits for S and dP alone and forms
// dS_{j+1} (into the other A register set) while dQ's product still runs.
// Whether a tile follows is known where the code is compiled: tested at run
// time between the starts and the waits, it made ptxas serialize the
// products (C7514).  The same values in the same order as the q role: dQ is
// the fused form's bit for bit.  A warp arrives on its stage's empty
// barrier once its products are done with the stage; thread 0 refills it
// once all four have.
constexpr int DQ_STAGES = 3;  // the K / V ring

template <int DP>
constexpr int dq_smem() {
  return (1 + DQ_STAGES) * 2 * Geo<DP>::KT + 1024;
}

template <int DP, bool DROP, bool BIAS>
__global__ void __launch_bounds__(NT, DP == 64 ? 3 : 1)
    flash_bwd_dq_bf16_kernel(const __grid_constant__ Params p) {
  using G = Geo<DP>;
  constexpr int R = G::R, NJ = TKV / 8, NA = TKV / 16;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t fixed, full[DQ_STAGES], empty[DQ_STAGES];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int h = blockIdx.y, b = blockIdx.z;
  const int bh = b * p.heads + h;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * TQR;
  unsigned char* qs = base;
  unsigned char* dos = base + G::KT;
  unsigned char* ring = base + 2 * G::KT;  // stage s: K at s * 2 KT, V KT on
  const int n_k = (p.tk + TKV - 1) / TKV;
  if (threadIdx.x == 0) {
    mbar_init(&fixed, 1);
    for (int s = 0; s < DQ_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);  // one arrival a warp
    }
    mbar_fence_init();
  }
  __syncthreads();
  auto fetch = [&](int j) {  // thread 0: a key tile's K and V into its stage
    const int s = j % DQ_STAGES;
    unsigned char* st = ring + s * 2 * G::KT;
    mbar_expect_tx(&full[s], 2 * G::KT);
    tma_tile<TKV, R>(st, &p.mk, &full[s], j * TKV, bh);
    tma_tile<TKV, R>(st + G::KT, &p.mv, &full[s], j * TKV, bh);
  };
  if (threadIdx.x == 0) {
    mbar_expect_tx(&fixed, 2 * G::KT);
    tma_tile<TQR, R>(qs, &p.mq, &fixed, q0, bh);
    tma_tile<TQR, R>(dos, &p.mdo, &fixed, q0, bh);
    for (int j = 0; j < DQ_STAGES && j < n_k; ++j) fetch(j);
  }

  // warp w owns query rows q0 + 16 w ..; accumulators are (query, key)
  // fragments, as the q role's
  const uint2 key = DROP ? flash::philox_key(p.seed) : make_uint2(0u, 0u);
  const float sl2 = p.scale * LOG2E;
  TIMERS_START
  float lse[2], dl[2];  // the lane's rows g, g + 8: LSE in log2 units; +inf / 0 past Tq
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = q0 + 16 * warp + g + 8 * hf;
    lse[hf] = r < p.tq ? __ldg(p.lse + (size_t)bh * p.tq + r) * LOG2E : INFINITY;
    dl[hf] = r < p.tq ? __ldg(p.delta + (size_t)bh * p.tq + r) : 0.0f;
  }
  const float* bg = BIAS ? p.bias + (size_t)b * p.tk : nullptr;
  float dq[DP / 2], sacc[32], dpacc[32];
  uint32_t da[2][NA][4];  // dS of two key tiles, rounded to bf16: A operands of dS K
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dq[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < 32; ++i) sacc[i] = dpacc[i] = 0.0f;
  uint32_t kw[4];    // the lane's keep bits' source words for the next tile
  float kb[2 * NJ];  // the lane's keys' biases in log2 units, -inf past Tk

  // S = Q K^T and dP = dO V^T of key tile j, started
  auto start_s = [&](int j) {
    const int s = j % DQ_STAGES;
    const unsigned char* kst = ring + s * 2 * G::KT;
    mbar_wait(&full[s], (j / DQ_STAGES) & 1);
    PHASE(10)
    wg_fence();
#pragma unroll
    for (int kstep = 0; kstep < DP / 16; ++kstep)
      wgmma_ss_n64(sacc, desc_k<TQR>(qs, kstep), desc_k<TKV>(kst, kstep), kstep > 0);
#pragma unroll
    for (int kstep = 0; kstep < DP / 16; ++kstep)
      wgmma_ss_n64(dpacc, desc_k<TQR>(dos, kstep), desc_k<TKV>(kst + G::KT, kstep), kstep > 0);
    wg_commit();
  };
  // key tile j's mask bits and key biases, made while products run (without
  // a bias only the last tile has keys to mask)
  auto mask_bias = [&](int j) {
    const int k0 = j * TKV;
    if (DROP)
      keep_words<false>(mask_word<NJ, false>(key, q0 + 16 * warp, k0, h, b, p.drop_thr), kw);
    const bool edge = k0 + TKV > p.tk;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = k0 + 8 * jj + 2 * t + e;
        kb[2 * jj + e] = BIAS || edge
                             ? (c < p.tk ? (BIAS ? __ldg(bg + c) * LOG2E : 0.0f) : -INFINITY)
                             : 0.0f;
      }
  };
  // dS from S and dP in the accumulators, rounded to bf16 into a
  auto form_ds = [&](uint32_t(&a)[NA][4]) {
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      float keep[4] = {1.0f, 1.0f, 1.0f, 1.0f};
      if (DROP) keep_block<false>(kw, jj, p.drop_scale, keep);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pr = ex2(fmaf(sacc[4 * jj + e], sl2, kb[2 * jj + (e & 1)]) - lse[e >> 1]);
        dpacc[4 * jj + e] = pr * (dpacc[4 * jj + e] * keep[e] - dl[e >> 1]) * p.scale;
      }
    }
#pragma unroll
    for (int kk = 0; kk < NA; ++kk) a_frag(a[kk], dpacc, kk);
  };
  // key tile j, its dS in a; where a tile follows (next), tile j + 1's dS
  // into nxt
  auto step = [&](auto next, int j, uint32_t(&a)[NA][4], uint32_t(&nxt)[NA][4]) {
    if constexpr (decltype(next)::value) start_s(j + 1);
    // dQ += dS_j K_j, K read transposed
    const unsigned char* kst = ring + (j % DQ_STAGES) * 2 * G::KT;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < NA; ++kk) rs_product<DP>(dq, a[kk], desc_mn<TKV>(kst, kk));
    wg_commit();
    if constexpr (decltype(next)::value) {
      mask_bias(j + 1);
      PHASE(11)
      wg_wait<1>();  // S and dP of tile j + 1; dQ's product may still run
      reg_fence(sacc);
      reg_fence(dpacc);
      PHASE(12)
      form_ds(nxt);
      PHASE(13)
    }
    wg_wait<0>();
    reg_fence(dq);
    reg_fence(a);  // the A registers stay live until the product has read them
    PHASE(14)
    if (lane == 0) mbar_arrive(&empty[j % DQ_STAGES]);  // this warp is done with tile j
    // once every warp is done with tile j, its stage takes tile j + DQ_STAGES
    if (threadIdx.x == 0 && j + DQ_STAGES < n_k) {
      mbar_wait(&empty[j % DQ_STAGES], (j / DQ_STAGES) & 1);
      fetch(j + DQ_STAGES);
    }
    PHASE(10)
  };

  mbar_wait(&fixed, 0);
  start_s(0);
  mask_bias(0);
  PHASE(11)
  wg_wait<0>();
  reg_fence(sacc);
  reg_fence(dpacc);
  PHASE(12)
  form_ds(da[0]);
  PHASE(13)
  // two key tiles an iteration, so that each A register set keeps its
  // name, and the last one or two apart, so that whether a tile follows is
  // known where the code is compiled
  constexpr std::true_type more{};
  constexpr std::false_type last{};
  int j = 0;
  for (; j + 2 < n_k; j += 2) {
    step(more, j, da[0], da[1]);
    step(more, j + 1, da[1], da[0]);
  }
  if (j + 1 < n_k) {
    step(more, j, da[0], da[1]);
    step(last, j + 1, da[1], da[0]);
  } else {
    step(last, j, da[0], da[1]);
  }

  const float one[2] = {1.0f, 1.0f};
  store_acc(p.dq + (size_t)bh * p.tq * p.dp, dq, q0 + 16 * warp + g, p.tq, p.dp, one);
  TIMERS_END
}

// D <= 64: three CTAs an SM (registers); D 128: one
template <int DP, bool DROP, bool DQ, bool BIAS>
__global__ void __launch_bounds__(NT, DP == 64 ? 3 : 1)
    flash_bwd_bf16_kernel(const __grid_constant__ Params p) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t fixed, full[STAGES];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int h = blockIdx.y, b = blockIdx.z;
  const int bh = b * p.heads + h;
  const bool kv = !DQ || (int)blockIdx.x < p.kv_ctas;
  if (threadIdx.x == 0) {
    mbar_init(&fixed, 1);
    // the kv role's stages also take one cp.async arrival a thread
    for (int s = 0; s < STAGES; ++s) mbar_init(&full[s], kv ? 1 + NT : 1);
    mbar_fence_init();
  }
  __syncthreads();
  const Bars bar{&fixed, full};
  if (kv)
    kv_role<DP, DROP>(p, base, bar, blockIdx.x, h, b, bh);
  else
    q_role<DP, DROP, BIAS>(p, base, bar, blockIdx.x - p.kv_ctas, h, b, bh);
}

template <int DP, bool DQ>
cudaError_t launch(Params& p, const void* q, const void* k, const void* v, const void* dout,
                   int batch, int q_ctas, int smem, cudaStream_t stream) {
  if (smem != bwd_smem<DP, DQ>() || p.kv_ctas != (p.tk + TKV - 1) / TKV ||
      q_ctas != (DQ ? (p.tq + TQR - 1) / TQR : 0)) {
    return cudaErrorInvalidValue;
  }
  const int slabs = batch * p.heads;
  cudaError_t err = make_map(&p.mq_kv, q, slabs, p.tq, p.dp, Geo<DP>::QN);
  if (err == cudaSuccess) err = make_map(&p.mdo_kv, dout, slabs, p.tq, p.dp, Geo<DP>::QN);
  if (err == cudaSuccess) err = make_map(&p.mq, q, slabs, p.tq, p.dp, TQR);
  if (err == cudaSuccess) err = make_map(&p.mdo, dout, slabs, p.tq, p.dp, TQR);
  if (err == cudaSuccess) err = make_map(&p.mk, k, slabs, p.tk, p.dp, TKV);
  if (err == cudaSuccess) err = make_map(&p.mv, v, slabs, p.tk, p.dp, TKV);
  if (err != cudaSuccess) return err;
  // the q role with and without a key bias (the kv role reads a bias a key)
  auto kernel = p.seed ? (p.bias ? flash_bwd_bf16_kernel<DP, true, DQ, true>
                                 : flash_bwd_bf16_kernel<DP, true, DQ, false>)
                       : (p.bias ? flash_bwd_bf16_kernel<DP, false, DQ, true>
                                 : flash_bwd_bf16_kernel<DP, false, DQ, false>);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(p.kv_ctas + q_ctas, p.heads, batch), NT, smem, stream>>>(p);
  return cudaGetLastError();
}

// the launch of the dQ form: only the tensor maps it reads
template <int DP>
cudaError_t launch_dq(Params& p, const void* q, const void* k, const void* v, const void* dout,
                      int batch, int q_ctas, int smem, cudaStream_t stream) {
  if (smem != dq_smem<DP>() || p.kv_ctas != 0 || q_ctas != (p.tq + TQR - 1) / TQR) {
    return cudaErrorInvalidValue;
  }
  const int slabs = batch * p.heads;
  cudaError_t err = make_map(&p.mq, q, slabs, p.tq, p.dp, TQR);
  if (err == cudaSuccess) err = make_map(&p.mdo, dout, slabs, p.tq, p.dp, TQR);
  if (err == cudaSuccess) err = make_map(&p.mk, k, slabs, p.tk, p.dp, TKV);
  if (err == cudaSuccess) err = make_map(&p.mv, v, slabs, p.tk, p.dp, TKV);
  if (err != cudaSuccess) return err;
  auto kernel = p.seed ? (p.bias ? flash_bwd_dq_bf16_kernel<DP, true, true>
                                 : flash_bwd_dq_bf16_kernel<DP, true, false>)
                       : (p.bias ? flash_bwd_dq_bf16_kernel<DP, false, true>
                                 : flash_bwd_dq_bf16_kernel<DP, false, false>);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(q_ctas, p.heads, batch), NT, smem, stream>>>(p);
  return cudaGetLastError();
}

enum Form { kFused, kDkv, kDq };

template <Form F>
cudaError_t run(const void* q, const void* k, const void* v, const float* bias,
                const unsigned long long* seed, const void* dout, const float* lse,
                const float* delta, void* dq, void* dk, void* dv, int batch, int heads, int tq,
                int tk, int dp, int kv_ctas, int q_ctas, int smem, float scale,
                unsigned drop_thr, float drop_scale, void* stream) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout);
  if (batch < 1 || heads < 1 || tq < 1 || tk < 1 || dp < 8 || dp > 128 || dp % 8 != 0 ||
      batch > 65535 || heads > 65535 || (addr & 15) != 0 || (F != kDkv && dq == nullptr) ||
      (F != kDq && (dk == nullptr || dv == nullptr))) {
    return cudaErrorInvalidValue;
  }
  Params p{};
  p.bias = bias;
  p.seed = seed;
  p.lse = lse;
  p.delta = delta;
  p.dq = (bf16*)dq;
  p.dk = (bf16*)dk;
  p.dv = (bf16*)dv;
  p.heads = heads;
  p.tq = tq;
  p.tk = tk;
  p.dp = dp;
  p.kv_ctas = kv_ctas;
  p.scale = scale;
  p.drop_thr = drop_thr;
  p.drop_scale = drop_scale;
  const cudaStream_t s = (cudaStream_t)stream;
  if constexpr (F == kDq)
    return dp <= 64 ? launch_dq<64>(p, q, k, v, dout, batch, q_ctas, smem, s)
                    : launch_dq<128>(p, q, k, v, dout, batch, q_ctas, smem, s);
  constexpr bool DQ = F == kFused;
  return dp <= 64 ? launch<64, DQ>(p, q, k, v, dout, batch, q_ctas, smem, s)
                  : launch<128, DQ>(p, q, k, v, dout, batch, q_ctas, smem, s);
}

}  // namespace

// q, k, v, dout, dq, dk, dv bf16 (B, H, T, dp) with dp % 8 == 0 (the wrapper
// pads the head dim) and 16-byte aligned; bias (B, Tk), lse and delta (B, H,
// Tq) float32.  kv_ctas, q_ctas and smem are the wrapper's plan
// (ops/flash_attention.py::flash_bf16_plan), checked against this source's.
extern "C" int flash_bwd_fused_bf16_launch(const void* q, const void* k, const void* v,
                                           const float* bias, const unsigned long long* seed,
                                           const void* dout, const float* lse,
                                           const float* delta, void* dq, void* dk, void* dv,
                                           int batch, int heads, int tq, int tk, int dp,
                                           int kv_ctas, int q_ctas, int smem, float scale,
                                           unsigned drop_thr, float drop_scale, void* stream) {
  return run<kFused>(q, k, v, bias, seed, dout, lse, delta, dq, dk, dv, batch, heads, tq, tk, dp,
                   kv_ctas, q_ctas, smem, scale, drop_thr, drop_scale, stream);
}

// The dK / dV form: the kv role alone (q_ctas 0; dq is not read).
extern "C" int flash_bwd_dkv_bf16_launch(const void* q, const void* k, const void* v,
                                         const float* bias, const unsigned long long* seed,
                                         const void* dout, const float* lse, const float* delta,
                                         void* dq, void* dk, void* dv, int batch, int heads,
                                         int tq, int tk, int dp, int kv_ctas, int q_ctas,
                                         int smem, float scale, unsigned drop_thr,
                                         float drop_scale, void* stream) {
  (void)dq;
  return run<kDkv>(q, k, v, bias, seed, dout, lse, delta, nullptr, dk, dv, batch, heads, tq, tk,
                   dp, kv_ctas, q_ctas, smem, scale, drop_thr, drop_scale, stream);
}

// The dQ form: query tiles alone (kv_ctas 0; dk and dv are not read).
extern "C" int flash_bwd_dq_bf16_launch(const void* q, const void* k, const void* v,
                                        const float* bias, const unsigned long long* seed,
                                        const void* dout, const float* lse, const float* delta,
                                        void* dq, void* dk, void* dv, int batch, int heads,
                                        int tq, int tk, int dp, int kv_ctas, int q_ctas,
                                        int smem, float scale, unsigned drop_thr,
                                        float drop_scale, void* stream) {
  (void)dk;
  (void)dv;
  return run<kDq>(q, k, v, bias, seed, dout, lse, delta, dq, nullptr, nullptr, batch, heads, tq,
                  tk, dp, kv_ctas, q_ctas, smem, scale, drop_thr, drop_scale, stream);
}

#if FLASH_BWD_TIMERS
// the summed phase times (clock cycles over all consumer threads) since the
// last reset; reset: zero them after reading
extern "C" int flash_bwd_bf16_timers(unsigned long long* out, int reset) {
  cudaError_t err = cudaMemcpyFromSymbol(out, bwd_timers, sizeof(bwd_timers));
  if (err == cudaSuccess && reset) {
    const unsigned long long zero[kPhases] = {};
    err = cudaMemcpyToSymbol(bwd_timers, zero, sizeof(zero));
  }
  return err;
}

extern "C" const char* flash_bwd_bf16_timer_names() {
  return "kv: wait for Q / dO,kv: mask bits + LSE / Delta,kv: S^T and dP^T (wait),"
         "kv: P / dS to bf16,kv: dV and dK,q: wait for K / V,q: mask bits + biases,"
         "q: S and dP (wait),q: dS to bf16,q: dQ,dq: wait for K / V + refill,"
         "dq: start S / dP / dQ + mask bits + biases,dq: S and dP (wait),dq: dS to bf16,"
         "dq: dQ (wait)";
}
#endif

extern "C" const char* flash_bwd_bf16_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
