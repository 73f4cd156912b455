// The 2-layer reverse chain core for Hopper (sm_90a), built like the
// one-layer core rnn_bwd_chain.cuh; gru2_bwd_chain.cu instantiates it with
// GruCell, lstm2_bwd_chain.cu with LstmCell.
//
// Both layers' reverse chains walk t = T-1 .. 0.  Layer 1's step needs
//
//   dh1[b][j] = carry1 + sum_m x1[b][m] w_hh1[j][m]
//
// over x1, the row layer 1 wrote at step t+1; layer 0's step needs
//
//   dh0[b][j] = carry0 + sum_m x0[b][m] w_hh0[j][m]
//                      + keep[t][b][j] sum_m f[b][m] w_ih1[j][m]
//
// over x0, the row layer 0 wrote at step t+1, and f, the row layer 1 wrote
// at step t (the hop into the layer below).  GRU: x = [dih[:, :2H] | dhn],
// f = dih1, all 3H wide, and carry_l the direct part dh z; LSTM: x = dg,
// f = dg1, all 4H wide, and no carry term in dh (dh_final enters at layer
// 1's first step; the cell carries dc).
//
// What bounded the first designs (csrc/gru2_bwd_chain.cu and
// lstm2_bwd_chain.cu before this core; the legacy forms
// gru2_bwd_chain_legacy.cu and lstm2_bwd_chain_legacy.cu keep them): every
// CTA owned units of both layers and read, every phase, the whole
// exchanged rows of both (dih1 | dhn1 | dih0 | dhn0, 2 x B x 3H floats;
// dg1 | dg0, 2 x B x 4H) from L2, its 8 warps one batch row each, and one
// grid.sync() a phase.
//
// Design.  The two layers run on disjoint CTA sets of one cooperative
// launch, each a one-layer core as rnn_bwd_chain.cuh's:
//
// * The lead set (blockIdx < H / UPC: layer 1) is the one-layer chain over
//   x1 with w_hh1.  It waits only for itself, so it runs ahead.
// * The follow set (the next H / UPC CTAs: layer 0) is the one-layer chain
//   over the row [x0 | f] (6H wide for the GRU, 8H for the LSTM) with the
//   weight row [w_hh0[j] | w_ih1[j]].  Its clusters split that row's
//   columns as the one-layer core splits its own, so with an even cluster
//   the first half of the ranks form the recurrent product and the second
//   half the hop; a rank whose share spans both (a cluster of 1) forms them
//   one after the other.  The partials meet per segment through
//   distributed shared memory, and the cell adds keep[t] x the hop's.  Its step t waits for
//   its own set's step t+1 and for the lead set's step t.
// * Everything else is the one-layer core's, its products
//   (rnn_bwd::piece_products) included: the launch plan
//   (ops/lstm_kernel.py::chain_plan with layers=2, re-checked here) gives
//   both sets the same UPC, cluster size, row groups and chunk (the grid
//   2 H / UPC CTAs, one per SM; shared memory sized by the follow set's
//   share); row groups (rows of dh need only their own row); 8 rows x UB
//   units of register-blocked accumulators with the shuffle
//   reduce-scatter unrolled at compile time; cp.async-staged shares; a
//   release / acquire flag per CTA, a flag block per set and row group,
//   instead of grid.sync() (the follow set polls both blocks at once).
// * The lead set's first step has no product (dh_final enters through its
//   carry for the GRU, through the cell's own load for the LSTM), the
//   follow set's first step only the hop; exactly T steps run in each set,
//   T + 1 phases on the critical path.
//
// Any B >= 1; H % 4 == 0 with 2 H / UPC <= the SM count.  Built with
// -DRNN_CHAIN_TIMERS=1 each warp splits its steps into the buckets of
// rnn_timers.cuh.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include "rnn_bwd_chain.cuh"
#include "rnn_chain_common.cuh"
#include "rnn_timers.cuh"

namespace rnn2_bwd {

namespace cg = cooperative_groups;
using namespace rnn_chain;
using rnn_bwd::piece_products;
using rnn_bwd::unit_block;

struct Args {
  const float* res;       // GRU: packed (T, B, 8H), layer l's [r | z | n | hn] at 4H l;
                          // LSTM: packed (T, B, 10H) = [g0 | g1 | c0_prev | c1_prev]
  const float* prev[2];   // GRU: layer l's h_prev (T, B, H); LSTM unused
  const float* keep;      // (T, B, H): the hop's mask
  const float* dh_final;  // LSTM: (B, H), read at layer 1's first step; GRU unused
  const float* w_own[2];  // layer l's w_hh (H, G)
  const float* w_feed;    // w_ih1 (H, G): the hop
  float* out[2];          // GRU: layer l's dih (T, B, 3H); LSTM: its dg (T, B, 4H)
  float* out_n[2];        // GRU: layer l's dhn (T, B, H); LSTM unused
  float* carry;           // (2, B, H): layer l's at l B H (GRU: layer 1's starts as
                          // dh_final; LSTM: dc, zeros)
  unsigned* flags;        // 2 x kPairSetFlags (zero): the lead set's, then the follow set's
  int batch, t_len, hidden, upc, ncl, rgroups, kc;
};

// shared memory of a plan, in floats: the weights NU x ldw over the follow
// set's share (the wider), the chunk slots x PH x ldx, the warps' partials
// 64 x UB, the cluster partials 2 (pass parity) x 2 (segment) x PH x NU
__host__ __device__ inline int smem_floats(int width, int hidden, int upc,
                                           int ncl, int rgroups, int kc) {
  const int nu = upc * ncl * rgroups;
  const int n4 = 2 * width * hidden / 4;
  const int cs4 = (n4 + ncl - 1) / ncl;
  const int chunks = (cs4 + kc - 1) / kc;
  const int slots = chunks <= 8 ? chunks : 2;
  const int ldw = round32(4 * cs4) + 4;
  const int ldx = round32(4 * kc) + 4;
  return nu * ldw + slots * PH * ldx + 64 * unit_block(nu) + 4 * PH * nu;
}

// Two GRU layers: residuals [r | z | n | hn] and h_prev; the exchanged row
// is [dr_pre | dz_pre | dhn] = [dih[:, :2H] | dhn] (3H) and the feed
// layer 1's dih; the carry is the direct part dh_t z.
struct GruCell {
  static constexpr int kWidth = 3;
  struct Res {
    float act[4], hp, keep, carry;
  };
  __device__ static void load(const Args& a, int layer, int t, int b, int j, Res& r) {
    const int H = a.hidden;
    const size_t BH = (size_t)a.batch * H, o = (size_t)b * H + j;
    const float* p = a.res + ((size_t)t * a.batch + b) * 8 * H + 4 * H * layer + j;
#pragma unroll
    for (int i = 0; i < 4; ++i) r.act[i] = __ldg(p + i * H);
    r.hp = __ldg(of_layer(a.prev, layer) + t * BH + o);
    r.keep = layer == 0 ? __ldg(a.keep + t * BH + o) : 0.0f;
    r.carry = a.carry[layer * BH + o];
  }
  // own: the recurrent product's dh; feed: the hop's (layer 0)
  __device__ static void step(const Args& a, int layer, int t, int b, int j,
                              const Res& res, float own, float feed) {
    const int H = a.hidden;
    const size_t BH = (size_t)a.batch * H, o = (size_t)b * H + j;
    const float dh = res.carry + own + res.keep * feed;
    const float r = res.act[0], z = res.act[1], n = res.act[2], hn = res.act[3];
    const float dn_pre = dh * (1.0f - z) * (1.0f - n * n);
    float* out = of_layer(a.out, layer) + ((size_t)t * a.batch + b) * 3 * H + j;
    out[0] = dn_pre * hn * r * (1.0f - r);
    out[H] = dh * (res.hp - n) * z * (1.0f - z);
    out[2 * H] = dn_pre;
    of_layer(a.out_n, layer)[t * BH + o] = dn_pre * r;
    a.carry[layer * BH + o] = dh * z;
  }
  // float4 column c of row b of segment seg at step t: the layer's own
  // exchanged row, or (seg 1) layer 1's dih
  __device__ static const float* src(const Args& a, int layer, int seg, int t, int b,
                                     int c) {
    const int H = a.hidden;
    const size_t row = (size_t)t * a.batch + b;
    if (seg == 1) return a.out[1] + row * 3 * H + 4 * c;
    return c < H / 2 ? of_layer(a.out, layer) + row * 3 * H + 4 * c
                     : of_layer(a.out_n, layer) + row * H + 4 * (c - H / 2);
  }
};

// Two LSTM layers: residuals from the packed row [g0 | g1 | c0_prev |
// c1_prev] (layer l's gates at 4H l, its c_prev at 8H + H l); the exchanged
// row is dg (4H) and the feed layer 1's dg; the carry is dc.  dh_final
// enters at layer 1's first step, loaded there, so no register holds it
// across the products.
struct LstmCell {
  static constexpr int kWidth = 4;
  struct Res {
    float g[4], cp, keep, carry;
  };
  __device__ static void load(const Args& a, int layer, int t, int b, int j, Res& r) {
    const int H = a.hidden;
    const size_t BH = (size_t)a.batch * H, o = (size_t)b * H + j;
    const float* p = a.res + ((size_t)t * a.batch + b) * 10 * H + j;
#pragma unroll
    for (int i = 0; i < 4; ++i) r.g[i] = __ldg(p + 4 * H * layer + i * H);
    r.cp = __ldg(p + 8 * H + H * layer);
    r.keep = layer == 0 ? __ldg(a.keep + t * BH + o) : 0.0f;
    r.carry = a.carry[layer * BH + o];
  }
  // own: the recurrent product's dh; feed: the hop's (layer 0)
  __device__ static void step(const Args& a, int layer, int t, int b, int j,
                              const Res& r, float own, float feed) {
    const int H = a.hidden;
    const size_t BH = (size_t)a.batch * H, o = (size_t)b * H + j;
    float dh = own + r.keep * feed;
    if (layer == 1 && t == a.t_len - 1) dh += __ldg(a.dh_final + o);
    a.carry[layer * BH + o] = rnn_bwd::lstm_cell_bwd(
        r.g, r.cp, dh, r.carry,
        of_layer(a.out, layer) + ((size_t)t * a.batch + b) * 4 * H + j, H);
  }
  // float4 column c of row b of segment seg at step t: the layer's own dg,
  // or (seg 1) layer 1's
  __device__ static const float* src(const Args& a, int layer, int seg, int t, int b,
                                     int c) {
    const size_t row = (size_t)t * a.batch + b;
    return (seg == 1 ? a.out[1] : of_layer(a.out, layer)) + row * 4 * a.hidden + 4 * c;
  }
};

template <class Cell, int NU>
__global__ void __launch_bounds__(NT, 1) pair_kernel(const Args a) {
  constexpr int KW = 8 / (NU / unit_block(NU));  // warps of columns
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();

  const int H = a.hidden, grid = H / a.upc;
  const bool follow = (int)blockIdx.x >= grid;  // layer 0; the lead set is layer 1
  const int layer = follow ? 0 : 1;
  const int cta = (int)blockIdx.x - (follow ? grid : 0);
  const int own4 = Cell::kWidth * H / 4;  // float4 columns of a layer's own row
  const int n4 = follow ? 2 * own4 : own4;
  const int ncl = a.ncl, R = a.rgroups, kc = a.kc;
  const int upc = a.upc * R;  // units per CTA (the cell's)
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
  float* wl = smem;                      // NU x ldw
  float* xs = wl + NU * ldw;             // slots x PH x ldx
  float* part = xs + slots * PH * ldx;   // KW x PH x NU
  float* xpart = part + KW * PH * NU;    // 2 x 2 x PH x NU
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
  // the cluster's units' weights over this CTA's share of [own | feed]
  for (int i = tid; i < NU * cs4; i += NT) {
    const int u = i / cs4, c = i % cs4, col = c_lo + c;
    const float* w =
        col < own4 ? of_layer(a.w_own, layer) + 4 * col : a.w_feed + 4 * (col - own4);
    const float4 v = __ldg(reinterpret_cast<const float4*>(w + (size_t)(u0 + u) * 4 * own4));
    *reinterpret_cast<float4*>(wl + u * ldw + 4 * c) = v;
  }

  const bool has_cell = tid < upc * PH;
  const int cu = tid % upc, cr = tid / upc;
  const int j = u0 + rank * upc + cu;
  const int T = a.t_len;
  typename Cell::Res res;
  int xpar = 0;
  rnn_timer::Timer tm;

  if (has_cell && gb0 + cr < gb1) Cell::load(a, layer, T - 1, gb0 + cr, j, res);
  __syncthreads();

  for (int s = 0; s < T; ++s) {
    const int t = T - 1 - s;
    // the own set's step t + 1 and, for the follow set, the lead set's step
    // t: warp 0 polls the flags, a lane each
    if (s > 0 || follow) {
      if (warp == 0) {
        if (follow) {
          wait_flags2(own_flags, (unsigned)s, lead_flags, (unsigned)s + 1, per_group, lane);
        } else {
          wait_flags(own_flags, per_group, (unsigned)s, lane);
        }
      }
      __syncthreads();
      tm.mark(rnn_timer::kBarrier);
    }
    for (int p = 0; p < npass; ++p) {
      const int bt0 = gb0 + p * PH, nb = max(0, min(PH, gb1 - bt0));
      const bool cell = has_cell && cr < nb;
      if (p > 0 && cell) Cell::load(a, layer, t, bt0 + cr, j, res);
      float rec[2] = {0.0f, 0.0f};
      if (s > 0 || follow) {
        float* mine = xpart + xpar * 2 * PH * NU;
        // the own row (from step t + 1; none at the first step), then the
        // feed: this CTA's partials over its pieces of them
        for (int seg = 0; seg < 2; ++seg) {
          int p0, p1;
          pair_piece(seg, follow, c_lo, c_lo + cs4, own4, &p0, &p1);
          if (p0 >= p1 || (seg == 0 && s == 0)) continue;
          const int step = seg == 0 ? t + 1 : t, c0 = p0 - (seg == 0 ? 0 : own4);
          piece_products<NU>(
              [&](int r, int c) { return Cell::src(a, layer, seg, step, bt0 + r, c0 + c); },
              nb, p1 - p0, kc, slots, wl + 4 * (p0 - c_lo), ldw, xs, ldx, part,
              mine + seg * PH * NU, tm);
        }
        // the cluster's CTAs' partials, per segment, through distributed
        // shared memory (also a CTA barrier: xs and part are free again)
        cluster_sync_();
        if (cell) {
          const int o = cr * NU + rank * upc + cu;
          for (int r = 0; r < ncl; ++r) {
            const float* pr = cluster.map_shared_rank(mine, r);
            if ((has_seg[0] >> r & 1u) && s > 0) rec[0] += pr[o];
            if (has_seg[1] >> r & 1u) rec[1] += pr[PH * NU + o];
          }
        }
        xpar ^= 1;
        tm.mark(rnn_timer::kCluster);
      }
      if (cell) Cell::step(a, layer, t, bt0 + cr, j, res, rec[0], rec[1]);
      tm.mark(rnn_timer::kCell);
    }
    // arrive: this step's stores are made; load the next step's residuals
    // before waiting for the others
    __syncthreads();
    if (tid == 0) st_release(my_flag, (unsigned)s + 1);
    if (s + 1 < T && has_cell && gb0 + cr < gb1) {
      Cell::load(a, layer, t - 1, gb0 + cr, j, res);
    }
    tm.mark(rnn_timer::kCell);
  }
  cluster_sync_();  // no CTA leaves while a peer may read its partials
  tm.flush(follow ? 1 : 0);
}

template <class Cell>
const void* kernel_for(int nu) {
  switch (nu) {
    case 1: return (const void*)&pair_kernel<Cell, 1>;
    case 2: return (const void*)&pair_kernel<Cell, 2>;
    case 4: return (const void*)&pair_kernel<Cell, 4>;
    case 8: return (const void*)&pair_kernel<Cell, 8>;
    case 16: return (const void*)&pair_kernel<Cell, 16>;
    case 32: return (const void*)&pair_kernel<Cell, 32>;
    case 64: return (const void*)&pair_kernel<Cell, 64>;
    default: return nullptr;
  }
}

// The launch configuration of a plan: kernel, grid (both sets),
// cluster, shared memory; kPlanMismatch where the plan does not fit the
// shape or the card.
template <class Cell>
int configure(int hidden, int upc, int ncl, int rgroups, int kc,
              const void** fn, cudaLaunchConfig_t* cfg,
              cudaLaunchAttribute* attr) {
  if (!pair_plan_ok(hidden, upc, ncl, rgroups, kc)) return kPlanMismatch;
  *fn = kernel_for<Cell>(upc * ncl * rgroups);
  const int need = (int)sizeof(float) *
                   smem_floats(Cell::kWidth, hidden, upc, ncl, rgroups, kc);
  return rnn_chain::configure(*fn, 2 * hidden / upc, ncl, need, cfg, attr);
}

// Re-check the plan against the shape and the card, then launch
// cooperatively with the cluster dimension.
template <class Cell>
int launch(const Args& a, cudaStream_t stream) {
  if (a.batch < 1 || a.t_len < 1 || a.hidden < 4 || a.hidden % 4 != 0) {
    return kUnsupported;
  }
  const void* fn = nullptr;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[2];
  const int err = configure<Cell>(a.hidden, a.upc, a.ncl, a.rgroups, a.kc, &fn, &cfg, attr);
  if (err != cudaSuccess) return err;
  void* args[] = {(void*)&a};
  return launch_resident(fn, &cfg, attr, a.ncl, args, stream);
}

// How many clusters of a plan's kernel the card holds at once, into
// *count; 0 where the plan does not fit.
template <class Cell>
int max_clusters(int hidden, int upc, int ncl, int rgroups, int kc, int* count) {
  const void* fn = nullptr;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  *count = 0;
  const int err = configure<Cell>(hidden, upc, ncl, rgroups, kc, &fn, &cfg, attr);
  if (err == kPlanMismatch) return cudaSuccess;
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveClusters(count, fn, &cfg);
}

}  // namespace rnn2_bwd
