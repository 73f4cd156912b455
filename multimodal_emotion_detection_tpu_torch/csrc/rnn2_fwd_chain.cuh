// The 2-layer forward core for Hopper (sm_90a), built like the one-layer
// forward core rnn_fwd_chain.cuh.  Its eval form (the final h) is
// instantiated by gru2_infer.cu with GruCell and lstm2_infer.cu with
// LstmCell; its training form (TRAIN: the residuals the reverse chains
// read) by gru2_train_fwd.cu with GruCell, lstm2_train_fwd.cu with
// LstmCell and, without the gates, LstmNoGatesCell, and by the legacy
// layout's two, lstm2_train_fwd_legacy.cu with LstmLegacyCell (12H rows)
// and gru2_train_fwd_legacy.cu with GruLegacyCell (10H rows).
//
// Both layers walk t = 0 .. T-1 from zero state.  Layer 0's step needs,
// for each batch row b and each of its W H gate columns,
//
//   rec0[b][q H + j] = sum_k h0(t-1)[b][k] w_hh0[k][q H + j],
//
// and layer 1's step both
//
//   rec1[b][q H + j] = sum_k h1(t-1)[b][k] w_hh1[k][q H + j]   and
//   in1[b][q H + j]  = sum_k h0(t)[b][k]   w_ih1[k][q H + j]
//
// (GRU: W = 3, r, z, n; LSTM: W = 4, i, f, g, o; the input projection of
// layer 0, ih0 = x w_ih0 + b_ih0 (LSTM + b0), is one matrix product
// outside, batch-major (B, T, W H) in the eval form, time-major (T, B, W H)
// in the training form).
//
// What bounded the first designs (every source's before this core):
// every CTA owned units of both layers and
// read h0 and h1 (training: and x1) whole from L2 every phase (64 KiB a CTA
// at (32, 372, 256), training 96), its 8 warps' partial sums met in shared
// memory, and one grid.sync() a phase.
//
// Design: rnn2_bwd_chain.cuh's, transposed.  The two layers run on
// disjoint CTA sets of one cooperative launch, each a one-layer forward
// core as rnn_fwd_chain.cuh's:
//
// * The lead set (blockIdx < H / UPC: layer 0) is the one-layer forward
//   over h0 with w_hh0; it stores the whole h0 series (T, B, H), so it
//   never waits for layer 1 and runs ahead.
// * The follow set (the next H / UPC CTAs: layer 1) is the one-layer
//   forward over the row [h1(t-1) | h0(t)] (2H) with the gate columns
//   [w_hh1 ; w_ih1] (2H long).  Its clusters split that row's columns, so
//   with an even cluster the first half of the ranks form the recurrent
//   product and the second half the input one; a rank whose share spans
//   both (a cluster of 1) forms them one after the other.  The partials
//   meet per segment through distributed shared memory; the GRU cell adds
//   b_ih1 to the input's, b_hh1 to the recurrent's (its n third inside the
//   reset product), the LSTM cell its one bias b1.  Its step t waits for its own set's step t-1 and the
//   lead set's step t.  It keeps h1 in two (B, H) slots used in turn, of
//   which slot (T-1) % 2 holds the final h1; a CTA releases step t only
//   after its cp.async reads of step t's sources have completed.
// * Everything else is the one-layer forward core's, its products
//   (rnn_fwd::piece_products) included: the launch plan
//   (ops/lstm_kernel.py::chain_plan with forward=True, layers=2,
//   re-checked here), row groups, 8 rows x 2 units' gate columns of
//   register-blocked accumulators with the reduce-scatter unrolled at
//   compile time, cp.async-staged shares, a release / acquire flag per
//   CTA instead of grid.sync() (the follow set polls both blocks at
//   once), the carry (GRU h, LSTM c) in the cell thread's register where
//   one pass covers the row group, else in a (2, B, H) buffer of zeros.
// * The lead set's first step has no product, the follow set's first step
//   only the input one; exactly T steps run in each set, T + 1 phases on
//   the critical path.
//
// The training form (TRAIN) keeps the products, plan, flags, clusters and
// carries; only the sources and the stores differ.  Layer 1's input is
// x1 = h0(t) keep[t] (the layer-0 -> 1 keep mask), not h0(t).  The
// exchange is the residual series themselves, each (T, B, H) and never
// overwritten: the lead set reads its h of step t - 1 from h0p[t], the
// follow set its own from h1p[t] and its feed from x1[t], which the lead
// set's cells store.  The cells store, in the JAX package's layout,
// packed[t] (LSTM [g0 | g1 | c0_prev | c1_prev], 10H, or without the gates
// [c0_prev | c1_prev], 2H; GRU [r0 | z0 | n0 | hn0 | r1 | z1 | n1 | hn1],
// 8H, hn = h_prev w_hn + b_hn before r), h0p / h1p (the state before each
// step, row 0 zero), x1, and after step T - 1 the finals (LSTM [h0, c0, h1,
// c1], GRU [h0, h1], each (B, H)).  The legacy cells store instead
// res[t], the LSTM's (12H) = [g0 | g1 | h0 | h1 | c0 | c1], the GRU's (10H)
// = [r0 | z0 | n0 | hn0 | h0 | r1 | z1 | n1 | hn1 | h1], with the states
// AFTER the step, and after step T - 1 h1 alone (finals (B, H)); their
// h0p / h1p / x1 are the exchange only (scratch the caller allocates; row
// 0 of h0p / h1p is neither written nor read).
//
// The training form's bf16 form (a cell of storage type bf16,
// rnn_chain_common.cuh: lstm2_train_fwd.cu's LstmCell16 and, without the
// gates, LstmNoGatesCell16, gru2_train_fwd.cu's GruCell16) stores packed
// (LstmNoGatesCell16's 2H [c0_prev | c1_prev]), h0p, h1p and x1 in bf16
// (packed16, hp16, x116),
// each rounded from the float32 value the float32 form stores; the finals
// stay float32.  Its exchange stays float32, in scratch the caller
// allocates: the x1 series whole (the lead set runs ahead of the follow
// set), each layer's own h in two (B, H) slots used in turn (rows t & 1 of
// hp, which only its own set reads, a step behind its writes); so the
// forward's value is the float32 form's bit for bit.
//
// Any B >= 1; H % 4 == 0 with 2 H / UPC <= the SM count.  Built with
// -DRNN_CHAIN_TIMERS=1 each warp splits its steps into the buckets of
// rnn_timers.cuh.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include "rnn_chain_common.cuh"
#include "rnn_fwd_chain.cuh"
#include "rnn_timers.cuh"

namespace rnn2_fwd {

namespace cg = cooperative_groups;
using namespace rnn_chain;
using rnn_fwd::group_warps;
using rnn_fwd::piece_products;

struct Args {
  const float* ih;        // layer 0's hoisted input projection: eval (B, T, W H),
                          // training (T, B, W H)
  const float* w_own[2];  // layer l's w_hh (H, W H)
  const float* w_feed;    // w_ih1 (H, W H)
  const float* b_own[2];  // GRU: layer l's b_hh (W H); LSTM unused
  const float* b_feed;    // GRU: b_ih1 (W H); LSTM: layer 1's b1 (W H)
  float* h0;              // eval: (T, B, H), layer 0's h series
  float* h1;              // eval: (2, B, H), layer 1's h, two slots used in turn
  float* carry;           // (2, B, H) zeros: layer l's (GRU h, LSTM c) at l B H
  unsigned* flags;        // 2 x kPairSetFlags (zero): the lead set's, then the follow set's
  int batch, t_len, hidden, upc, ncl, rgroups, kc;
  // the training form's
  const float* keep;      // (T, B, H): the layer-0 -> 1 keep mask
  float* hp[2];           // (T, B, H): layer l's h before each step
  float* x1;              // (T, B, H): layer 1's input h0 keep
  float* packed;          // (T, B, 10H, 2H or 8H; legacy LSTM 12H, GRU 10H): the
                          // cells' residuals
  float* finals;          // LSTM (4, B, H) [h0, c0, h1, c1]; GRU (2, B, H) [h0, h1];
                          // legacy cells (B, H) h1
  // the bf16 form's stored series, beside the float32 exchange hp / x1
  bf16* packed16;         // in place of packed
  bf16* hp16[2];          // (T, B, H): layer l's h before each step
  bf16* x116;             // (T, B, H): layer 1's input h0 keep
};

// the row of a layer's own exchanged h (hp) that holds step t's: the
// series' own in the float32 form, one of two slots in the bf16 form
template <class S>
__device__ __forceinline__ size_t hp_row(int t) {
  return kHalfStore<S> ? (size_t)(t & 1) : (size_t)t;
}

// shared memory of a plan, in floats: the weights W NU x ldw over the
// follow set's share (the wider), the chunk slots x PH x ldx, the warps'
// partials where a column group spans several warps, the cluster partials
// 2 (pass parity) x 2 (segment) x PH x W NU
__host__ __device__ inline int smem_floats(int width, int hidden, int upc,
                                           int ncl, int rgroups, int kc) {
  const int nu = upc * ncl * rgroups, no = width * nu;
  const int cs4 = (2 * hidden / 4 + ncl - 1) / ncl;
  const int chunks = (cs4 + kc - 1) / kc;
  const int slots = chunks <= 8 ? chunks : 2;
  const int ldw = round32(4 * cs4) + 4;
  const int ldx = round32(4 * kc) + 4;
  const int kw = group_warps(nu);
  return no * ldw + slots * PH * ldx + (kw > 1 ? kw * PH * no : 0) + 4 * PH * no;
}

// a cell's h of step t: layer 0's into its series, layer 1's into slot t % 2
__device__ __forceinline__ void put_h(const Args& a, int layer, int t, int b, int j,
                                      float h) {
  const size_t o = (size_t)b * a.hidden + j;
  if (layer == 0) {
    a.h0[(size_t)t * a.batch * a.hidden + o] = h;
  } else {
    a.h1[(size_t)(t & 1) * a.batch * a.hidden + o] = h;
  }
}

// a training cell's h of step t, and layer 0's x1 = h keep: into layer l's
// h_prev series at row t + 1, or after the last step into row fh of the
// finals; the bf16 form (S = bf16) also into its bf16 series
template <class S>
__device__ __forceinline__ void put_train(const Args& a, int layer, int t, int b, int j,
                                          float h, float k, int fh) {
  const size_t BH = (size_t)a.batch * a.hidden, o = (size_t)b * a.hidden + j;
  float* hp = of_layer(a.hp, layer);
  [[maybe_unused]] bf16* hp16 = of_layer(a.hp16, layer);
  if (layer == 0) {
    const float x = h * k;
    a.x1[t * BH + o] = x;
    if constexpr (kHalfStore<S>) st_res(a.x116 + t * BH + o, x);
  }
  if (t == 0) {
    hp[o] = 0.0f;
    if constexpr (kHalfStore<S>) st_res(hp16 + o, 0.0f);
  }
  if (t + 1 < a.t_len) {
    hp[hp_row<S>(t + 1) * BH + o] = h;
    if constexpr (kHalfStore<S>) st_res(hp16 + (t + 1) * BH + o, h);
  } else {
    a.finals[fh * BH + o] = h;
  }
}

// a legacy cell's h of step t: the exchange only (into layer l's h_prev
// series at row t + 1, layer 0's x1 = h keep; row 0 of the h_prev series is
// neither written nor read), and after the last step layer 1's h into
// finals (B, H)
__device__ __forceinline__ void put_legacy(const Args& a, int layer, int t, int b, int j,
                                           float h, float k) {
  const size_t BH = (size_t)a.batch * a.hidden, o = (size_t)b * a.hidden + j;
  if (layer == 0) a.x1[t * BH + o] = h * k;
  if (t + 1 < a.t_len) {
    of_layer(a.hp, layer)[(t + 1) * BH + o] = h;
  } else if (layer == 1) {
    a.finals[o] = h;
  }
}

// float4 column c of row b of segment seg read at step t: the layer's own
// h of step t - 1, or (seg 1) the feed, h0 of step t (training: x1[t];
// the training cell's residuals stored in S)
template <bool TRAIN, class S>
__device__ __forceinline__ const float* h_src(const Args& a, int layer, int seg, int t,
                                              int b, int c) {
  const int H = a.hidden;
  if constexpr (TRAIN) {
    if (seg == 1) return a.x1 + ((size_t)t * a.batch + b) * H + 4 * c;
    return of_layer(a.hp, layer) + (hp_row<S>(t) * a.batch + b) * H + 4 * c;
  }
  if (seg == 1 || layer == 0) {
    const int step = seg == 1 ? t : t - 1;
    return a.h0 + ((size_t)step * a.batch + b) * H + 4 * c;
  }
  return a.h1 + ((size_t)((t - 1) & 1) * a.batch + b) * H + 4 * c;
}

// Two GRU layers: gates r, z, n with b_hh beside the recurrent product
// (its n third inside the reset product: hn = h w_hn + b_hn); the input
// part is layer 0's ih0, or layer 1's product with its feed plus b_ih1.
// The carry is h.  The training form stores its residuals in S.
template <class S>
struct GruCellT {
  using Store = S;
  static constexpr int kWidth = 3;
  struct In {
    float x[3], bh[3];  // x: ih0 (layer 0) or b_ih1 (layer 1)
    float k;            // training, layer 0: keep
  };
  template <bool TRAIN>
  __device__ static void load(const Args& a, int layer, int t, int b, int j, In& in) {
    const int H = a.hidden;
    const size_t row = TRAIN ? (size_t)t * a.batch + b : (size_t)b * a.t_len + t;
    const float* bh = of_layer(a.b_own, layer);
    const float* x = layer == 0 ? a.ih + row * 3 * H : a.b_feed;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      in.x[i] = __ldg(x + i * H + j);
      in.bh[i] = __ldg(bh + i * H + j);
    }
    if (TRAIN && layer == 0) in.k = __ldg(a.keep + row * H + j);
  }
  // the activations g = [r, z, n, hn] (hn = h_prev w_hn + b_hn, before r)
  // from the products (own: the recurrent ones of the unit's 3 gate
  // columns; feed: the input ones, layer 1; zero for layer 0) and the
  // carry h before the step; returns h after it
  __device__ static float gates(const In& in, const float (&own)[3],
                                const float (&feed)[3], float hp, float (&g)[4]) {
    const float hn = own[2] + in.bh[2];
    const float r = sigmoidf_(in.x[0] + feed[0] + own[0] + in.bh[0]);
    const float z = sigmoidf_(in.x[1] + feed[1] + own[1] + in.bh[1]);
    const float n = tanhf(in.x[2] + feed[2] + r * hn);
    g[0] = r;
    g[1] = z;
    g[2] = n;
    g[3] = hn;
    return (1.0f - z) * n + z * hp;
  }
  template <bool TRAIN>
  __device__ static float step(const Args& a, int layer, int t, int b, int j,
                               const In& in, const float (&own)[3],
                               const float (&feed)[3], float hp) {
    float g[4];
    const float h = gates(in, own, feed, hp, g);
    if constexpr (TRAIN) {
      const int H = a.hidden;
      S* pk = res_of<S>(a.packed, a.packed16) + ((size_t)t * a.batch + b) * 8 * H +
              4 * H * layer + j;
#pragma unroll
      for (int i = 0; i < 4; ++i) st_res(pk + i * H, g[i]);
      put_train<S>(a, layer, t, b, j, h, in.k, layer);
    } else {
      put_h(a, layer, t, b, j, h);
    }
    return h;
  }
};

using GruCell = GruCellT<float>;
using GruCell16 = GruCellT<bf16>;

// Two LSTM layers: gates i, f, g, o; the input part is layer 0's ih0 (b0
// inside it), or layer 1's product with its feed plus b1.  The carry is c;
// h goes out through the h0 series or h1's slots (training: the h_prev
// series).  The training form stores the gates and c_prev, or with
// kStoreGates false only c_prev, in S.
template <bool kStoreGates, class S = float>
struct LstmCellT {
  using Store = S;
  static constexpr int kWidth = 4;
  struct In {
    float x[4];  // ih0 (layer 0) or b1 (layer 1)
    float k;     // training, layer 0: keep
  };
  template <bool TRAIN>
  __device__ static void load(const Args& a, int layer, int t, int b, int j, In& in) {
    const int H = a.hidden;
    const size_t row = TRAIN ? (size_t)t * a.batch + b : (size_t)b * a.t_len + t;
    const float* x = layer == 0 ? a.ih + row * 4 * H : a.b_feed;
#pragma unroll
    for (int i = 0; i < 4; ++i) in.x[i] = __ldg(x + i * H + j);
    if (TRAIN && layer == 0) in.k = __ldg(a.keep + row * H + j);
  }
  // the gate pre-activations g and h of the step from its products (own:
  // the recurrent ones of the unit's 4 gate columns; feed: the input ones,
  // layer 1; zero for layer 0) and the carry c before it; returns c after
  __device__ static float gates(const In& in, const float (&own)[4],
                                const float (&feed)[4], float cp, float (&g)[4],
                                float& h) {
#pragma unroll
    for (int i = 0; i < 4; ++i) g[i] = in.x[i] + feed[i] + own[i];
    const float c = sigmoidf_(g[1]) * cp + sigmoidf_(g[0]) * tanhf(g[2]);
    h = sigmoidf_(g[3]) * tanhf(c);
    return c;
  }
  template <bool TRAIN>
  __device__ static float step(const Args& a, int layer, int t, int b, int j,
                               const In& in, const float (&own)[4],
                               const float (&feed)[4], float cp) {
    float g[4], h;
    const float c = gates(in, own, feed, cp, g, h);
    if constexpr (TRAIN) {
      const int H = a.hidden;
      const size_t row = (size_t)t * a.batch + b;
      S* packed = res_of<S>(a.packed, a.packed16);
      if constexpr (kStoreGates) {
        S* pk = packed + row * 10 * H + j;
#pragma unroll
        for (int i = 0; i < 4; ++i) st_res(pk + (4 * layer + i) * H, g[i]);
        st_res(pk + (8 + layer) * H, cp);
      } else {
        st_res(packed + row * 2 * H + layer * H + j, cp);
      }
      put_train<S>(a, layer, t, b, j, h, in.k, 2 * layer);
      if (t + 1 == a.t_len) {
        a.finals[(size_t)(2 * layer + 1) * a.batch * H + (size_t)b * H + j] = c;
      }
    } else {
      put_h(a, layer, t, b, j, h);
    }
    return c;
  }
};
using LstmCell = LstmCellT<true>;
using LstmNoGatesCell = LstmCellT<false>;
using LstmCell16 = LstmCellT<true, bf16>;
using LstmNoGatesCell16 = LstmCellT<false, bf16>;

// LstmCell's training form in the legacy layout: the cell stores res[t]
// (12H) = [g0 | g1 | h0 | h1 | c0 | c1], the gates at 4H layer and h and c
// AFTER the step at (8 + layer) H and (10 + layer) H, a CTA's units of a
// lane as one contiguous run; the exchange and h_final are put_legacy's.
struct LstmLegacyCell : LstmCell {
  template <bool TRAIN>
  __device__ static float step(const Args& a, int layer, int t, int b, int j,
                               const In& in, const float (&own)[4],
                               const float (&feed)[4], float cp) {
    static_assert(TRAIN, "the legacy layout is a training form");
    float g[4], h;
    const float c = gates(in, own, feed, cp, g, h);
    const int H = a.hidden;
    float* r = a.packed + ((size_t)t * a.batch + b) * 12 * H + j;
#pragma unroll
    for (int i = 0; i < 4; ++i) r[(4 * layer + i) * H] = g[i];
    r[(8 + layer) * H] = h;
    r[(10 + layer) * H] = c;
    put_legacy(a, layer, t, b, j, h, in.k);
    return c;
  }
};

// GruCell's training form in the legacy layout: the cell stores res[t]
// (10H) = [r0 | z0 | n0 | hn0 | h0 | r1 | z1 | n1 | hn1 | h1], layer l's
// activations at 5 l H and its h AFTER the step at (5 l + 4) H, a CTA's
// units of a lane as one contiguous run, through GruCell's own arithmetic
// (gates), so it agrees with the residual-native form bit for bit; the
// exchange is put_legacy's.
struct GruLegacyCell : GruCell {
  template <bool TRAIN>
  __device__ static float step(const Args& a, int layer, int t, int b, int j,
                               const In& in, const float (&own)[3],
                               const float (&feed)[3], float hp) {
    static_assert(TRAIN, "the legacy layout is a training form");
    float g[4];
    const float h = gates(in, own, feed, hp, g);
    const int H = a.hidden;
    float* r = a.packed + ((size_t)t * a.batch + b) * 10 * H + 5 * H * layer + j;
#pragma unroll
    for (int i = 0; i < 4; ++i) r[i * H] = g[i];
    r[4 * H] = h;
    put_legacy(a, layer, t, b, j, h, in.k);
    return h;
  }
};

template <class Cell, int NU, bool TRAIN>
__global__ void __launch_bounds__(NT, 1) pair_kernel(const Args a) {
  constexpr int W = Cell::kWidth;
  constexpr int NO = W * NU;           // the cluster's gate columns
  constexpr int KW = group_warps(NU);  // warps whose sums meet in shared memory
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();

  const int H = a.hidden, grid = H / a.upc;
  const bool follow = (int)blockIdx.x >= grid;  // layer 1; the lead set is layer 0
  const int layer = follow ? 1 : 0;
  const int cta = (int)blockIdx.x - (follow ? grid : 0);
  const int own4 = H / 4;  // float4 columns of a layer's own h row
  const int n4 = follow ? 2 * own4 : own4;
  const int ncl = a.ncl, R = a.rgroups, kc = a.kc;
  const int upc = a.upc * R;  // units per CTA (the cells')
  const int rank = (int)cluster.block_rank();
  const int cid = cta / ncl;  // cluster: row group g, unit block
  const int g = cid % R;
  const int u0 = (cid / R) * NU;
  const int c_lo = (int)((long long)rank * n4 / ncl);
  const int cs4 = (int)((long long)(rank + 1) * n4 / ncl) - c_lo;
  // the buffers are the follow set's, whose share is the wider
  const int cs4max = (2 * own4 + ncl - 1) / ncl;
  const int chunks_max = (cs4max + kc - 1) / kc;
  const int slots = chunks_max <= 8 ? chunks_max : 2;
  const int ldw = round32(4 * cs4max) + 4;
  const int ldx = round32(4 * kc) + 4;
  float* wl = smem;                      // NO x ldw
  float* xs = wl + NO * ldw;             // slots x PH x ldx
  float* part = xs + slots * PH * ldx;   // KW x PH x NO where KW > 1
  float* xpart = part + (KW > 1 ? KW * PH * NO : 0);  // 2 x 2 x PH x NO
  const int bg = (a.batch + R - 1) / R;
  const int gb0 = min(a.batch, g * bg), gb1 = min(a.batch, gb0 + bg);
  const int npass = (bg + PH - 1) / PH;
  // a flag per CTA of the row group and set: the steps it has stored
  const int per_group = grid / R;
  const unsigned* lead_flags = a.flags + kFlagsPerGroup * g;
  unsigned* own_flags = a.flags + (follow ? kPairSetFlags : 0) + kFlagsPerGroup * g;
  unsigned* my_flag = own_flags + (cid / R) * ncl + rank;

  // the ranks of the cluster whose share holds a piece of segment 0 (the
  // own row) and of segment 1 (the feed)
  unsigned has_seg[2];
  pair_ranks(follow, n4, ncl, own4, has_seg);

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  // row u W + q of wl: gate column q H + u0 + u over this CTA's share of k
  // in [h1 | h0] (w_hh1 over the first H, w_ih1 over the second; the lead
  // set's w_hh0 over its H); neighbouring threads read neighbouring units
  {
    const float* w_own = of_layer(a.w_own, layer);
    for (int i = tid; i < NO * 4 * cs4; i += NT) {
      const int u = i % NU, rest = i / NU;
      const int q = rest % W, k = rest / W, kk = 4 * c_lo + k;
      const float* w = kk < H ? w_own + (size_t)kk * W * H : a.w_feed + (size_t)(kk - H) * W * H;
      wl[(u * W + q) * ldw + k] = __ldg(w + q * H + u0 + u);
    }
  }

  const bool has_cell = tid < upc * PH;
  const int cu = tid % upc, cr = tid / upc;
  const int j = u0 + rank * upc + cu;
  const int oc = (rank * upc + cu) * W;  // its first gate column in the partials
  const int T = a.t_len;
  float* carry_buf = a.carry + (size_t)layer * a.batch * H;
  typename Cell::In in;
  float carry = 0.0f;
  const auto prefetch = [&](int t, int b) {
    Cell::template load<TRAIN>(a, layer, t, b, j, in);
    if (npass > 1) carry = carry_buf[(size_t)b * H + j];
  };
  int xpar = 0;
  rnn_timer::Timer tm;

  if (has_cell && gb0 + cr < gb1) prefetch(0, gb0 + cr);
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    // the own set's step t - 1 and, for the follow set, the lead set's
    // step t
    if (t > 0 || follow) {
      if (warp == 0) {
        if (follow) {
          wait_flags2(own_flags, (unsigned)t, lead_flags, (unsigned)t + 1, per_group, lane);
        } else {
          wait_flags(own_flags, per_group, (unsigned)t, lane);
        }
      }
      __syncthreads();
      tm.mark(rnn_timer::kBarrier);
    }
    for (int p = 0; p < npass; ++p) {
      const int bt0 = gb0 + p * PH, nb = max(0, min(PH, gb1 - bt0));
      const bool cell = has_cell && cr < nb;
      if (p > 0 && cell) prefetch(t, bt0 + cr);
      float rec[W], fed[W];
#pragma unroll
      for (int i = 0; i < W; ++i) rec[i] = fed[i] = 0.0f;
      if (t > 0 || follow) {
        float* mine = xpart + xpar * 2 * PH * NO;
        // the own h (of step t - 1; none at the first step), then the feed:
        // this CTA's partials over its pieces of them
        for (int seg = 0; seg < 2; ++seg) {
          int p0, p1;
          pair_piece(seg, follow, c_lo, c_lo + cs4, own4, &p0, &p1);
          if (p0 >= p1 || (seg == 0 && t == 0)) continue;
          const int c0 = p0 - (seg == 0 ? 0 : own4);
          piece_products<W, NU>(
              [&](int r, int c) {
                return h_src<TRAIN, typename Cell::Store>(a, layer, seg, t, bt0 + r, c0 + c);
              },
              nb, p1 - p0, kc, slots, wl + 4 * (p0 - c_lo), ldw, xs, ldx, part,
              mine + seg * PH * NO, tm);
        }
        // the cluster's CTAs' partials, per segment, through distributed
        // shared memory (also a CTA barrier: xs and part are free again)
        cluster_sync_();
        if (cell) {
          for (int r = 0; r < ncl; ++r) {
            const float* pr =
                (r == rank ? mine : cluster.map_shared_rank(mine, r)) + cr * NO + oc;
            if ((has_seg[0] >> r & 1u) && t > 0) {
#pragma unroll
              for (int i = 0; i < W; ++i) rec[i] += pr[i];
            }
            if (has_seg[1] >> r & 1u) {
#pragma unroll
              for (int i = 0; i < W; ++i) fed[i] += pr[PH * NO + i];
            }
          }
        }
        xpar ^= 1;
        tm.mark(rnn_timer::kCluster);
      }
      if (cell) {
        carry = Cell::template step<TRAIN>(a, layer, t, bt0 + cr, j, in, rec, fed, carry);
        if (npass > 1) carry_buf[(size_t)(bt0 + cr) * H + j] = carry;
      }
      tm.mark(rnn_timer::kCell);
    }
    // arrive: this step's stores are made and its reads of the sources are
    // complete; prefetch the next step's input before waiting for the others
    __syncthreads();
    if (tid == 0) st_release(my_flag, (unsigned)t + 1);
    if (t + 1 < T && has_cell && gb0 + cr < gb1) prefetch(t + 1, gb0 + cr);
    tm.mark(rnn_timer::kCell);
  }
  cluster_sync_();  // no CTA leaves while a peer may read its partials
  tm.flush(follow ? 1 : 0);
}

template <class Cell, bool TRAIN>
const void* kernel_for(int nu) {
  switch (nu) {
    case 1: return (const void*)&pair_kernel<Cell, 1, TRAIN>;
    case 2: return (const void*)&pair_kernel<Cell, 2, TRAIN>;
    case 4: return (const void*)&pair_kernel<Cell, 4, TRAIN>;
    case 8: return (const void*)&pair_kernel<Cell, 8, TRAIN>;
    case 16: return (const void*)&pair_kernel<Cell, 16, TRAIN>;
    case 32: return (const void*)&pair_kernel<Cell, 32, TRAIN>;
    case 64: return (const void*)&pair_kernel<Cell, 64, TRAIN>;
    default: return nullptr;
  }
}

// The launch configuration of a plan: kernel, grid (both sets), cluster,
// shared memory; kPlanMismatch where the plan does not fit the shape or
// the card.
template <class Cell, bool TRAIN>
int configure(int hidden, int upc, int ncl, int rgroups, int kc,
              const void** fn, cudaLaunchConfig_t* cfg,
              cudaLaunchAttribute* attr) {
  if (!pair_plan_ok(hidden, upc, ncl, rgroups, kc)) return kPlanMismatch;
  *fn = kernel_for<Cell, TRAIN>(upc * ncl * rgroups);
  const int need = (int)sizeof(float) *
                   smem_floats(Cell::kWidth, hidden, upc, ncl, rgroups, kc);
  return rnn_chain::configure(*fn, 2 * hidden / upc, ncl, need, cfg, attr);
}

// Re-check the plan against the shape and the card, then launch
// cooperatively with the cluster dimension.
template <class Cell, bool TRAIN>
int launch(const Args& a, cudaStream_t stream) {
  if (a.batch < 1 || a.t_len < 1 || a.hidden < 4 || a.hidden % 4 != 0) {
    return kUnsupported;
  }
  const void* fn = nullptr;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[2];
  const int err =
      configure<Cell, TRAIN>(a.hidden, a.upc, a.ncl, a.rgroups, a.kc, &fn, &cfg, attr);
  if (err != cudaSuccess) return err;
  void* args[] = {(void*)&a};
  return launch_resident(fn, &cfg, attr, a.ncl, args, stream);
}

// How many clusters of a plan's kernel the card holds at once, into
// *count; 0 where the plan does not fit.
template <class Cell, bool TRAIN>
int max_clusters(int hidden, int upc, int ncl, int rgroups, int kc, int* count) {
  const void* fn = nullptr;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  *count = 0;
  const int err = configure<Cell, TRAIN>(hidden, upc, ncl, rgroups, kc, &fn, &cfg, attr);
  if (err == kPlanMismatch) return cudaSuccess;
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveClusters(count, fn, &cfg);
}

}  // namespace rnn2_fwd
