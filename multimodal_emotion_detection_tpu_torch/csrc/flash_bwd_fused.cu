// Flash-attention backward, kv-major, for Hopper (sm_90a), on the tensor
// cores: the fused form and the two-pass form's dK / dV pass.
//
// Replaces: multimodal_emotion_detection_tpu/ops/flash_attention.py::
// _flash_bwd_call in its fused form (Tk <= 4096), kernel body
// _bwd_fused_kernel over _bwd_kv_major -> flash_bwd_fused_launch, and the
// two-pass form's kv-major pass (Tk > 4096), kernel body _bwd_dkv_kernel
// (_bwd_kv_major with dq_ref=None) -> flash_bwd_dkv_launch, the same
// kernel compiled without its dQ phase (DQ = false).  The two-pass form's
// dQ pass is csrc/flash_bwd_dq.cu.  Same function as the plain PyTorch
// version ops/flash_attention.py::flash_bwd_reference: with P = exp(S -
// LSE) recomputed from the forward's logsumexp and M the forward's keep
// mask (1 / (1 - rate) where kept),
//
//   dV = (P M)^T dO,  dS = P (M (dO V^T) - Delta) / sqrt(D),
//   dK = dS^T Q,      dQ = dS K,          Delta = rowsum(dO O) (given).
//
// Float32 operands; the bf16 forms of both entries are
// csrc/flash_bwd_bf16.cu.
//
// What bounds it on the H100: arithmetic.  Five products per (query, key)
// pair, 10 B H Tq Tk D = 11.34 GFLOP at the transformer encoder's shape
// (B=32, H=4, T=372, D=64): 0.169 ms at the 67 TFLOP/s float32 rate; in
// 3xTF32 on the tensor cores (flash_mma.cuh) 3 x 11.34 GFLOP at 495
// TFLOP/s, 0.069 ms.  Its bytes (q, k, v, dO, LSE, Delta read, dQ, dK, dV
// written) take 0.02 ms at 3.35 TB/s; the dQ partials (one slot a kv span,
// summed by the wrapper) add 6 x 12.2 MB written and read there.  The dK /
// dV form: four products a pair, 8 B H Tq Tk D = 102.4 GFLOP at the long
// sequence's (2, 4, 5000, 64): 1.53 ms at the float32 rate, 0.62 ms in
// 3xTF32.
//
// Design: kv-major, on the q-major kernels' tile core turned round.  One
// CTA of 4 warps per (kv span, head, batch row); a span is `per_span`
// 64-key tiles (the wrapper picks at most 8 spans).  Warp w owns keys
// 16w .. 16w + 15 of a key tile, so its accumulators are (key, query)
// fragments: lane (g, t) holds keys g, g + 8 and queries 2t, 2t + 1 of
// each 8-query n-tile.  For each key tile the CTA stages K and V once: K
// split into TF32 halves in place in shared memory (the A operand of
// S^T = K Q^T through ldmatrix, and the B operand of dQ = dS K), V's
// halves in registers at D <= 64 (the A operand of dP^T = V dO^T; staged
// through the ring's second stage first) or in shared memory at D 128.
// dK and dV stay in registers for the key tile.  The CTA walks the query
// tiles of 32 rows: Q, dO, LSE and Delta arrive by cp.async in a ring
// (two stages at D <= 64, one at D 128), each Q / dO value split once as
// it lands.  Per query tile a warp forms S^T and dP^T in one walk over the
// k-steps (mma_abt), then P^T = exp(S^T / sqrt(D) + key bias - LSE) with
// LSE and Delta indexed by the accumulator's columns, the mask (one Philox
// call per (key, 4-query group), shared by shuffle: flash_mma.cuh::
// keep_bits_kv / keep_scales_kv; compiled with and without it) and dS^T in
// registers.  (P M)^T and dS^T are already the A fragments of mma_pb, so
// dV += (P M)^T dO and dK += dS^T Q read dO and Q from the staged tile with
// no trip through shared memory.  dQ needs dS with queries as rows and all
// 64 keys of the tile: each warp writes its dS^T transposed into a (32,
// 64) tile, one barrier, and warp w forms query rows 16 (w % 2) .. + 15 by
// head-dim half w / 2 of the tile's dQ = dS K (flash_mma.cuh::
// mma_pb_cols, K the B operand), stored into the span's own slot of an
// (n_spans, B, H, Tq, D) buffer (the span's first key tile stores, later
// ones add; one CTA owns the slot), which the wrapper sums: no atomics, so
// the result is deterministic.  Rows past Tq get LSE = +inf (so P = 0) and
// Delta = 0; keys past Tk a bias of -inf.  Shared memory: 114,176 bytes at
// D <= 64 (two CTAs an SM), 212,224 at D 128.
//
// The dK / dV form (DQ = false) walks one 64-key tile a CTA and drops the
// dS^T transpose, its barrier, the dS tile (104,960 bytes at D <= 64) and
// the dQ product; its dK and dV are the fused form's bit for bit (the same
// products in the same order).  With two ring stages the next query tile's
// copies start right after a tile's first barrier, into the stage every
// warp finished in the tile before; with one (D 128) after a barrier at the
// tile's end.
//
// Built with -DFLASH_BWD_TIMERS=1 (scripts/flash_ab.py --fused-timers) each
// warp adds clock64() time per phase of the query walk into fb_timers, read
// back by flash_bwd_fused_timers(); the default build has neither.

#include "flash_mma.cuh"

namespace {

using namespace flash_mma;

constexpr int NW = 4;        // warps per CTA
constexpr int NT = 32 * NW;
constexpr int TK = 16 * NW;  // keys per tile: 16 a warp (ops/flash_attention.py KV_TILE)
constexpr int TQ = 32;       // query rows per staged tile
constexpr int NJ = TQ / 8;   // 8-query n-tiles of a query tile
constexpr int SD = TK + 8;   // row stride of the (TQ, TK) dS tile: the float2
                             // reads of the dQ product free of bank conflicts

#ifndef FLASH_BWD_TIMERS
#define FLASH_BWD_TIMERS 0
#endif
#if FLASH_BWD_TIMERS
// wait, split + barrier, S^T and dP^T, P / mask / dS, dV and dK, dS
// transpose + barrier, dQ
constexpr int kPhases = 7;
__device__ unsigned long long fb_timers[kPhases];
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
  float* dq;  // (n_spans, B, H, Tq, D): each kv span's dQ partial
  float* dk;
  float* dv;
  int batch, heads, tq, tk, d, per_span;
  float scale;
  uint32_t drop_thr;
  float drop_scale;
  bool vec;
};

// A query tile's ring stage: Q's big and small halves, dO's, each (TQ, RS),
// then the TQ LSE and the TQ Delta
template <int DP>
struct QStage {
  static constexpr int RS = DP + 4;
  static constexpr int MAT = TQ * RS;
  static constexpr int DO = 2 * MAT;
  static constexpr int LSE = 4 * MAT;
  static constexpr int DELTA = LSE + TQ;
  static constexpr int FLOATS = DELTA + TQ;
};

// Shared memory in floats: K's halves, V's (kShared), the ring, dS (DQ)
template <int DP, int VMODE, int STAGES, bool DQ>
struct Smem {
  static constexpr int KMAT = TK * (DP + 4);
  static constexpr int V = 2 * KMAT;
  static constexpr int RING = V + (VMODE == kShared ? 2 * KMAT : 0);
  static constexpr int DS = RING + STAGES * QStage<DP>::FLOATS;
  static constexpr int FLOATS = DS + (DQ ? TQ * SD : 0);
  static_assert(VMODE == kShared || (STAGES > 1 && KMAT <= QStage<DP>::FLOATS),
                "V in registers is staged through the ring's second stage");
};

// the query tile at q0: Q and dO staged, LSE and Delta (zero past Tq,
// masked where read)
template <int DP>
__device__ __forceinline__ void fetch_queries(float* st, const Args& a, size_t qoff,
                                              size_t bh, int q0) {
  using St = QStage<DP>;
  load_tile<DP, TQ, NT>(st, a.q + qoff, q0, a.tq, a.d, a.vec);
  load_tile<DP, TQ, NT>(st + St::DO, a.dout + qoff, q0, a.tq, a.d, a.vec);
  for (int i = threadIdx.x; i < 2 * TQ; i += NT) {
    const int r = q0 + i % TQ;
    const bool in = r < a.tq;
    const float* src = (i < TQ ? a.lse : a.delta) + bh * a.tq;
    cp_async4(st + St::LSE + i, in ? src + r : src, in);
  }
}

template <int DP, int VMODE, int STAGES, bool DROP, bool DQ>
__global__ void __launch_bounds__(NT, DP == 64 ? 2 : 1)
    flash_bwd_fused_kernel(const Args a) {
  using St = QStage<DP>;
  using Sm = Smem<DP, VMODE, STAGES, DQ>;
  // the dK / dV form refills a ring stage right after a tile's first
  // barrier, one tile ahead, where it has a second stage
  constexpr bool EARLY = !DQ && STAGES > 1;
  constexpr int MW = DP / 64;  // 32-wide head-dim blocks of a warp's dQ
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;
  float* ring = smem + Sm::RING;
  float* dss = smem + Sm::DS;
  // V's staged floats: its own region, or (V in registers) the ring's
  // second stage, free until the first query tile's second fetch
  float* vst = VMODE == kShared ? smem + Sm::V : ring + St::FLOATS;

  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int h = blockIdx.y, b = blockIdx.z;
  const size_t bh = (size_t)b * a.heads + h;
  const size_t qoff = bh * a.tq * a.d, koff = bh * a.tk * a.d;
  const uint2 key = DROP ? flash::philox_key(a.seed) : make_uint2(0u, 0u);
  // this span's dQ partial slot
  float* dqp = DQ ? a.dq + ((size_t)blockIdx.x * a.batch * a.heads + bh) * a.tq * a.d
                  : nullptr;
  const int t_first = blockIdx.x * a.per_span;
  const int t_end = min(t_first + a.per_span, (a.tk + TK - 1) / TK);
  const int n_q = (a.tq + TQ - 1) / TQ;
  // the dQ product's share of a warp: query rows 16 (w % 2) .., head-dim
  // blocks from m0
  const int rq = 16 * (w & 1) + g, m0 = (w >> 1) * MW;
  const float one[2] = {1.0f, 1.0f};
  auto fetch = [&](int i) {
    if (i < n_q) fetch_queries<DP>(ring + (i % STAGES) * St::FLOATS, a, qoff, bh, TQ * i);
    cp_commit();  // an empty group past the end keeps the count uniform
  };
#if FLASH_BWD_TIMERS
  long long tacc[kPhases] = {}, tprev = clock64();
#endif

  for (int kt = t_first; kt < t_end; ++kt) {
    const int k0 = kt * TK;
    // the previous key tile's reads of K, V, the ring and dS are done
    __syncthreads();
    load_tile<DP, TK, NT>(ks, a.k + koff, k0, a.tk, a.d, a.vec);
    load_tile<DP, TK, NT>(vst, a.v + koff, k0, a.tk, a.d, a.vec);
    fetch(0);
    cp_wait<0>();
    __syncthreads();
    AFrags<DP, kShared, NW> ka;
    AFrags<DP, VMODE, NW> va;
    ka.init(ks);
    va.init(vst);
    __syncthreads();  // K's and V's halves are in; V's staged floats are read
#pragma unroll
    for (int s = 1; s < (EARLY ? STAGES - 1 : STAGES); ++s) fetch(s);
    // the key biases of the lane's keys g, g + 8: -inf past Tk
    float kb[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int kk = k0 + 16 * w + g + 8 * hf;
      kb[hf] = kk >= a.tk ? -INFINITY : (a.bias ? __ldg(a.bias + (size_t)b * a.tk + kk) : 0.0f);
    }
    float dk[DP / 8][4], dv[DP / 8][4];
#pragma unroll
    for (int n = 0; n < DP / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.0f;

    for (int i = 0; i < n_q; ++i) {
      const int q0 = TQ * i;
      cp_wait<EARLY ? STAGES - 2 : STAGES - 1>();
      PHASE(0)
      float* st = ring + (i % STAGES) * St::FLOATS;
      // this thread's own copies have landed: split them
      split_tile<DP, TQ, NT>(st, a.d, a.vec);
      split_tile<DP, TQ, NT>(st + St::DO, a.d, a.vec);
      // every thread's halves are in; every warp is done reading dS and
      // the previous tile's stage
      __syncthreads();
      if (EARLY) fetch(i + STAGES - 1);
      PHASE(1)

      uint32_t kbits[NJ];  // the mask's Philox work, ahead of the products
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        kbits[j] = DROP ? keep_bits_kv(key, q0 + 8 * j, k0 + 16 * w, h, b, a.drop_thr) : 0u;
      // S^T = K Q^T and dP^T = V dO^T in one walk
      float sd[2][NJ][4];
      mma_abt<DP, NJ, St::MAT>(sd, {st, st + St::DO}, ka, va);
      PHASE(2)
      auto& pm = sd[0];
      auto& ds = sd[1];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = 8 * j + 2 * t;
        const float2 l2 = *reinterpret_cast<const float2*>(st + St::LSE + c);
        const float2 d2 = *reinterpret_cast<const float2*>(st + St::DELTA + c);
        const float lse[2] = {q0 + c < a.tq ? l2.x : INFINITY,
                              q0 + c + 1 < a.tq ? l2.y : INFINITY};
        const float dl[2] = {d2.x, d2.y};  // zero past Tq
        float keep[4] = {1.0f, 1.0f, 1.0f, 1.0f};
        if (DROP) keep_scales_kv(kbits[j], a.drop_scale, keep);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = expf(pm[j][e] * a.scale + kb[e >> 1] - lse[e & 1]);
          pm[j][e] = p * keep[e];
          ds[j][e] = p * (ds[j][e] * keep[e] - dl[e & 1]) * a.scale;
        }
      }
      PHASE(3)
      // dV += (P M)^T dO, dK += dS^T Q, from the accumulator registers
      mma_pb<DP, NJ, St::MAT>(pm, st + St::DO, dv);
      mma_pb<DP, NJ, St::MAT>(ds, st, dk);
      PHASE(4)
      if constexpr (!DQ) {
        if (!EARLY) {
          __syncthreads();  // every warp is done with the one stage
          fetch(i + STAGES);
        }
      } else {
        // dS^T into the (TQ, TK) tile, queries as rows
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            dss[(8 * j + 2 * t + (e & 1)) * SD + 16 * w + g + 8 * (e >> 1)] = ds[j][e];
        __syncthreads();  // dS is whole; every warp is done with this stage
        fetch(i + STAGES);
        PHASE(5)
        // dQ = dS K for the warp's rows and head-dim blocks, over the tile's
        // 64 keys: the A fragments read from dS in accumulator layout
        float pq[TK / 8][4];
#pragma unroll
        for (int j = 0; j < TK / 8; ++j)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const float2 x =
                *reinterpret_cast<const float2*>(dss + (rq + 8 * hf) * SD + 8 * j + 2 * t);
            pq[j][2 * hf] = x.x;
            pq[j][2 * hf + 1] = x.y;
          }
        float dq[4 * MW][4];
#pragma unroll
        for (int n = 0; n < 4 * MW; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) dq[n][e] = 0.0f;
        mma_pb_cols<DP, TK / 8, Sm::KMAT, MW>(pq, ks, m0, dq);
        store_rows_cols<MW>(dqp, dq, q0 + rq, a.tq, a.d, m0, one, a.vec, kt != t_first);
        PHASE(6)
      }
    }
    cp_wait<0>();
    store_rows<DP>(a.dk + koff, dk, k0 + 16 * w + g, a.tk, a.d, one, a.vec);
    store_rows<DP>(a.dv + koff, dv, k0 + 16 * w + g, a.tk, a.d, one, a.vec);
  }
#if FLASH_BWD_TIMERS
  for (int i = 0; i < kPhases; ++i) atomicAdd(&fb_timers[i], (unsigned long long)tacc[i]);
#endif
}

template <int DP, int VMODE, int STAGES, bool DQ>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  constexpr size_t smem = sizeof(float) * Smem<DP, VMODE, STAGES, DQ>::FLOATS;
  auto kernel = a.seed ? flash_bwd_fused_kernel<DP, VMODE, STAGES, true, DQ>
                       : flash_bwd_fused_kernel<DP, VMODE, STAGES, false, DQ>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int k_tiles = (a.tk + TK - 1) / TK;
  const dim3 grid((k_tiles + a.per_span - 1) / a.per_span, a.heads, a.batch);
  kernel<<<grid, NT, smem, stream>>>(a);
  return cudaGetLastError();
}

template <bool DQ>
cudaError_t run(const float* q, const float* k, const float* v, const float* bias,
                const unsigned long long* seed, const float* dout, const float* lse,
                const float* delta, float* dq, float* dk, float* dv, int batch,
                int heads, int tq, int tk, int d, int per_span, float scale,
                unsigned drop_thr, float drop_scale, void* stream) {
  if (batch < 1 || heads < 1 || tq < 1 || tk < 1 || d < 1 || d > 128 ||
      batch > 65535 || heads > 65535 || per_span < 1 || (DQ && dq == nullptr) ||
      dk == nullptr || dv == nullptr) {
    return cudaErrorInvalidValue;
  }
  const bool vec = d % 4 == 0 && aligned16(q) && aligned16(k) && aligned16(v) &&
                   aligned16(dout) && aligned16(dq) && aligned16(dk) && aligned16(dv);
  const Args a{q,     k,     v,  bias, seed, dout,     lse,      delta,      dq,  dk,
               dv,    batch, heads, tq, tk, d,        per_span, scale, drop_thr,
               drop_scale, vec};
  const cudaStream_t s = (cudaStream_t)stream;
  // D <= 64: V's halves in registers, two stages, two CTAs an SM; D 128:
  // V's halves in shared memory, one stage
  return d <= 64 ? launch<64, kRegs, 2, DQ>(a, s) : launch<128, kShared, 1, DQ>(a, s);
}

}  // namespace

// The backward entries' common signature (ops/flash_attention.py's
// _BWD_ARGS): dq is the (n_spans, B, H, Tq, D) partials buffer.
extern "C" int flash_bwd_fused_launch(const float* q, const float* k, const float* v,
                                      const float* bias, const unsigned long long* seed,
                                      const float* dout, const float* lse,
                                      const float* delta, float* dq, float* dk, float* dv,
                                      int batch, int heads, int tq, int tk, int d,
                                      int per_span, float scale, unsigned drop_thr,
                                      float drop_scale, void* stream) {
  return run<true>(q, k, v, bias, seed, dout, lse, delta, dq, dk, dv, batch, heads, tq,
                   tk, d, per_span, scale, drop_thr, drop_scale, stream);
}

// The dK / dV form, one 64-key tile a CTA; dq and per_span are not read.
extern "C" int flash_bwd_dkv_launch(const float* q, const float* k, const float* v,
                                    const float* bias, const unsigned long long* seed,
                                    const float* dout, const float* lse,
                                    const float* delta, float* dq, float* dk, float* dv,
                                    int batch, int heads, int tq, int tk, int d,
                                    int per_span, float scale, unsigned drop_thr,
                                    float drop_scale, void* stream) {
  (void)dq;
  (void)per_span;
  return run<false>(q, k, v, bias, seed, dout, lse, delta, nullptr, dk, dv, batch, heads,
                    tq, tk, d, 1, scale, drop_thr, drop_scale, stream);
}

#if FLASH_BWD_TIMERS
// the summed phase times (clock cycles over all warps) since the last
// reset; reset: zero them after reading
extern "C" int flash_bwd_fused_timers(unsigned long long* out, int reset) {
  cudaError_t err = cudaMemcpyFromSymbol(out, fb_timers, sizeof(fb_timers));
  if (err == cudaSuccess && reset) {
    const unsigned long long zero[kPhases] = {};
    err = cudaMemcpyToSymbol(fb_timers, zero, sizeof(zero));
  }
  return err;
}
#endif

extern "C" const char* flash_bwd_fused_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
