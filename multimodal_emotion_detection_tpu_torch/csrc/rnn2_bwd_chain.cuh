// The 2-layer reverse chain core for Hopper (sm_90a), built like the
// one-layer core rnn_bwd_chain.cuh; gru2_bwd_chain.cu instantiates it with
// GruCell, lstm2_bwd_chain.cu with LstmCell, gru2_bwd_chain_legacy.cu with
// GruLegacyCell (the legacy layout's rows, dys, the full dhh),
// lstm2_bwd_chain_legacy.cu with LstmLegacyCell (dys, the 8H rows [dg0 |
// dg1]) and lstm2_bwd_chain_remat.cu with LstmRematCell (the gates
// recomputed ahead of the chain in blocks of steps, GateBlocksT).
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
// What bounded the first designs (csrc/gru2_bwd_chain.cu,
// lstm2_bwd_chain.cu and their legacy forms before this core): every
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
// The bf16 forms (a cell of storage type bf16, rnn_chain_common.cuh:
// lstm2_bwd_chain.cu's LstmCell16, gru2_bwd_chain.cu's GruCell16,
// lstm2_bwd_chain_remat.cu's LstmRematCell16, which also stages its gate
// inputs x, x1, h0p and h1p in bf16 and reads them into float32) read the
// residuals stored in bf16 (res16, the GRU's prev16) into float32 and write
// the chain outputs in bf16 too (out16, the GRU's out_n16), each rounded
// from the float32 value the float32 form writes.  Their exchange stays
// float32, in scratch the caller allocates: layer 1's row (the hop into
// layer 0, which runs behind) a whole series, layer 0's own in two (B, .)
// slots used in turn (rows t & 1 of out[0] / out_n[0], which only the
// follow set reads, a step behind its writes); so the chain is the float32
// form's over the same inputs.
//
// Any B >= 1; H % 4 == 0 (the remat cell's bf16 form H % 8 == 0) with
// 2 H / UPC <= the SM count.  Built with
// -DRNN_CHAIN_TIMERS=1 each warp splits its steps into the buckets of
// rnn_timers.cuh.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

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
  float* out[2];          // GRU: layer l's dih (T, B, 3H); LSTM: its dg (T, B, 4H;
                          // legacy: rows 8H apart)
  float* out_n[2];        // GRU: layer l's dhn (T, B, H); LSTM unused
  float* carry;           // (2, B, H): layer l's at l B H (GRU: layer 1's starts as
                          // dh_final; LSTM: dc, zeros)
  unsigned* flags;        // 2 x kPairSetFlags (zero): the lead set's, then the follow set's
  int batch, t_len, hidden, upc, ncl, rgroups, kc;
  // LstmRematCell: layer l's gate inputs xin[l] (T, B, din) = x (din =
  // d_in, a multiple of 4) / x1 (din = H) and hin[l] (T, B, H) = h0p /
  // h1p, its gate columns [w_ih; w_hh] packed a CTA's unit block at a time
  // wg[l] (H / U, din + H, 4U: column q U + u is gate q of unit u), its
  // bias bg[l] (4H); rk steps a gate block; ld rows a step apart in its
  // series, residuals and outputs (the whole batch, of which a launch takes
  // the batch rows its pointers start at; carry and dh_final are the
  // launch's own)
  const float* xin[2];
  const float* hin[2];
  const float* wg[2];
  const float* bg[2];
  int d_in, rk, ld;
  // GruLegacyCell, LstmLegacyCell: the sequence output's cotangent (T, B,
  // H), or null
  const float* dys;
  // the bf16 forms': the residuals in place of res and prev, and the chain
  // outputs beside the float32 exchange out / out_n
  const bf16* res16;
  const bf16* prev16[2];
  bf16* out16[2];
  bf16* out_n16[2];
  // LstmRematCell16: the gate inputs in bf16, in place of xin and hin (din
  // a multiple of 8)
  const bf16* xin16[2];
  const bf16* hin16[2];
};

// the row of layer l's exchanged series that holds step t's: the series'
// own, or in the bf16 forms layer 0's in one of two slots
template <class S>
__device__ __forceinline__ size_t ex_row(int layer, int t) {
  return kHalfStore<S> && layer == 0 ? (size_t)(t & 1) : (size_t)t;
}

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

// The remat cell's gate blocks, in floats: a CTA's U = upc x rgroups
// units, 4U gate columns, over the rows of its row group padded to whole
// passes (bgp) for rk steps, M = rk bgp rows, twice (the block in use and
// the one being formed); a piece of kin = din + H deep products (kp deep,
// a whole number of 16-byte pieces of its inputs: a multiple of 4, in the
// bf16 form (half) of 8): its M input rows (stride ldi floats = 4 mod 8,
// so the four rows of a thread's tile fall in distinct banks; the bf16
// form's rows take kp / 2 of them, so its blocks never need more than the
// float32 form's where kp is the same) and kp weight rows; and the copies'
// transaction barrier (4 floats, 8-byte aligned).
struct GateGeom {
  int n, bgp, m, kin, kp, ldi, pieces;
  __host__ __device__ GateGeom(int hidden, int upc, int rgroups, int batch, int din,
                               int rk, bool half = false) {
    const int vec = half ? 8 : 4;
    n = 4 * upc * rgroups;
    const int bg = (batch + rgroups - 1) / rgroups;
    bgp = (bg + PH - 1) / PH * PH;
    m = rk * bgp;
    kin = din + hidden;
    kp = ((kin + rk - 1) / rk + vec - 1) / vec * vec;
    ldi = ((half ? kp / 2 : kp) + 7) / 8 * 8 + 4;
    pieces = (kin + kp - 1) / kp;
  }
  __host__ __device__ int floats() const { return 2 * m * n + m * ldi + kp * n + 4; }
};

// Shared memory of the remat cell's plan, in floats: each set's own
// buffers (the lead set's weights over its own share, half the follow
// set's) and its layer's gate blocks (layer 0 din = d_in, layer 1 H), the
// larger of the two sets.
__host__ __device__ inline int remat_smem_floats(int hidden, int upc, int ncl,
                                                 int rgroups, int kc, int batch,
                                                 int d_in, int rk, bool half) {
  const int nu = upc * ncl * rgroups;
  const int own4 = 4 * hidden / 4;
  const int follow = smem_floats(4, hidden, upc, ncl, rgroups, kc);
  const int lead = follow - nu * (round32(4 * ((2 * own4 + ncl - 1) / ncl)) -
                                  round32(4 * ((own4 + ncl - 1) / ncl)));
  const int g0 = GateGeom(hidden, upc, rgroups, batch, d_in, rk, half).floats();
  const int g1 = GateGeom(hidden, upc, rgroups, batch, hidden, rk, half).floats();
  return max(follow + g0, lead + g1);
}

// The remat cell's gate pre-activations g = [x | h_prev] [w_ih; w_hh] for
// the CTA's cells, formed ahead of the chain that needs them.  The gates
// depend only on the forward's series, so step s's come from a block of
// rk steps (block s / rk) formed before it: the prologue forms block 0,
// and in step s of block b the CTA adds piece s % rk (kp rows of the
// product's depth) of block b + 1 into the other buffer while the step's
// exchange is on its way (piece_products' hook).  The copies of the next
// step's piece start at the end of the step, issued by warps 1-7 while
// warp 0 polls the flag barrier, and land behind the barrier and the next
// exchange's issue.  They travel by bulk copies (TMA, one a row of the
// piece, the weights as one block) on a transaction barrier of their own:
// many 16-byte cp.async copies stalled the threads that issued them for
// ~2,000 cycles a step, and the chain's exchange waits on cp.async
// groups; the issue of bulk copies grows with the copies a warp starts,
// so they are spread over warps, and copies landing during the products
// slowed them.  Each
// weight row is read once a block, not once a step, and the block never
// grows with T.  A thread forms 4 rows x 4 gate columns a tile, the
// warp's lanes on neighbouring columns; the bias starts each block's
// sums.
// The bf16 form (S = bf16, LstmRematCell16) stages the bf16 input rows
// as they are stored, 8 values a 16-byte piece, and reads them into
// float32 where it forms the products: the same float32 FMAs over the
// float32 weights in the same order, so where both forms cut the depth
// into the same pieces (kp a multiple of 8) its gates are the float32
// form's over the same inputs upcast, bit for bit.
template <class S>
struct GateBlocksT {
  static constexpr bool kHalf = kHalfStore<S>;
  static constexpr int kVec = 16 / (int)sizeof(S);  // input values a 16-byte piece
  GateGeom geo;
  float* buf;         // 2 x m x n: block b at (b & 1)
  S* in;              // m rows of ldi floats: a piece's input rows
  float* w;           // kp x n: a piece's weight rows
  unsigned long long* bar;  // the copies' transaction barrier
  const S* x;         // (T, ld, din)
  const S* h;         // (T, ld, H)
  const float* wg;    // this CTA's unit block: kin x n
  const float* bias;  // (4H)
  int din, hidden, ld, t_len, rk, gb0, gb1, units, j0, ldin;

  __device__ GateBlocksT(const Args& a, int layer, float* base, int j0, int gb0_,
                         int gb1_)
      : geo(a.hidden, a.upc, a.rgroups, a.batch, layer == 0 ? a.d_in : a.hidden, a.rk,
            kHalf) {
    const int U = a.upc * a.rgroups;
    buf = base;
    in = reinterpret_cast<S*>(buf + 2 * geo.m * geo.n);
    w = buf + 2 * geo.m * geo.n + geo.m * geo.ldi;
    bar = reinterpret_cast<unsigned long long*>(
        (reinterpret_cast<size_t>(w + geo.kp * geo.n) + 7) & ~(size_t)7);
    x = res_of<S>(of_layer(a.xin, layer), of_layer(a.xin16, layer));
    h = res_of<S>(of_layer(a.hin, layer), of_layer(a.hin16, layer));
    wg = of_layer(a.wg, layer) + (size_t)(j0 / U) * geo.kin * geo.n;
    bias = of_layer(a.bg, layer);
    din = geo.kin - a.hidden;
    hidden = a.hidden;
    ld = a.ld;
    t_len = a.t_len;
    rk = a.rk;
    gb0 = gb0_;
    gb1 = gb1_;
    units = U;
    this->j0 = j0;
    ldin = geo.ldi * (4 / (int)sizeof(S));  // a staged row's stride in values
  }
  // whether block blk holds a step
  __device__ bool live(int blk) const { return blk * rk < t_len; }
  // start copying piece p of block blk's inputs and weights (p <
  // pieces, so not empty) on the barrier's next phase: copy 0 the weights
  // (its thread arms the phase), copy 1 + i row i of inputs (its x and h
  // segments), copy c by warp first_warp + c % nw, lane c / nw.  Called
  // after a CTA barrier that ends the slot's reads.
  __device__ void stage(int p, int blk, int first_warp) const {
    constexpr unsigned es = sizeof(S);
    const int k0 = p * geo.kp, kn = min(geo.kp, geo.kin - k0);
    const int rows = gb1 - gb0, steps = min(rk, t_len - blk * rk);
    const int nw = NT / 32 - first_warp, wi = (int)threadIdx.x / 32 - first_warp;
    if (wi < 0) return;
    const int lane = threadIdx.x % 32;
    if (wi == 0 && lane == 0) {
      mbar_expect(bar, 4u * kn * geo.n + es * kn * steps * rows);
      bulk_copy(w, wg + (size_t)k0 * geo.n, 4u * kn * geo.n, bar);
    }
    for (int c = wi + nw * lane; c < 1 + steps * rows; c += nw * 32) {
      if (c == 0) continue;
      const int si = (c - 1) / rows, r = (c - 1) % rows;
      const size_t row = (size_t)(t_len - 1 - blk * rk - si) * ld + gb0 + r;
      S* dst = in + (si * geo.bgp + r) * ldin;
      const int kx = min(k0 + kn, din) - k0;  // the x segment's values
      if (kx > 0) bulk_copy(dst, x + row * din + k0, es * kx, bar);
      if (kx < kn) {
        const int kh = max(0, kx);
        bulk_copy(dst + kh, h + row * hidden + (k0 + kh - din), es * (kn - kh), bar);
      }
    }
  }
  // input values k .. k + kVec - 1 of staged row xr, as float32
  __device__ static void inputs(const S* xr, int k, float (&v)[kVec]) {
    if constexpr (kHalf) {
      const uint4 u = *reinterpret_cast<const uint4*>(xr + k);
      const unsigned q[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        v[2 * i] = __uint_as_float(q[i] << 16);
        v[2 * i + 1] = __uint_as_float(q[i] & 0xffff0000u);
      }
    } else {
      const float4 f = *reinterpret_cast<const float4*>(xr + k);
      v[0] = f.x;
      v[1] = f.y;
      v[2] = f.z;
      v[3] = f.w;
    }
  }
  // add piece p (staged, visible to the CTA) into block blk's gates; piece
  // 0 writes them, from the bias
  __device__ void form(int p, int blk) const {
    const int k0 = p * geo.kp, kn = min(geo.kp, geo.kin - k0);
    if (kn <= 0) return;
    float* g = buf + (blk & 1) * geo.m * geo.n;
    const int nct = geo.n / 4, tiles = geo.m / 4 * nct;
    for (int i = threadIdx.x; i < tiles; i += NT) {
      const int rt = i / nct, ct = i % nct;
      // a tile's rows share a step; rows past the group's are skipped
      if (blk * rk + 4 * rt / geo.bgp >= t_len || gb0 + 4 * rt % geo.bgp >= gb1) continue;
      float acc[4][4] = {};
      if (p == 0) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int col = 4 * ct + c;
          const float b = __ldg(bias + col / units * hidden + j0 + col % units);
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[r][c] = b;
        }
      }
      const S* xr = in + 4 * rt * ldin;
      const float* wc = w + 4 * ct;
      for (int k = 0; k < kn; k += kVec) {
        float xv[4][kVec];
#pragma unroll
        for (int r = 0; r < 4; ++r) inputs(xr + r * ldin, k, xv[r]);
#pragma unroll
        for (int kk = 0; kk < kVec; ++kk) {
          const float4 wv = *reinterpret_cast<const float4*>(wc + (k + kk) * geo.n);
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float xs = xv[r][kk];
            acc[r][0] = fmaf(xs, wv.x, acc[r][0]);
            acc[r][1] = fmaf(xs, wv.y, acc[r][1]);
            acc[r][2] = fmaf(xs, wv.z, acc[r][2]);
            acc[r][3] = fmaf(xs, wv.w, acc[r][3]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float4* d = reinterpret_cast<float4*>(g + (4 * rt + r) * geo.n + 4 * ct);
        float4 v = make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
        if (p > 0) {
          const float4 o = *d;
          v = make_float4(o.x + v.x, o.y + v.y, o.z + v.z, o.w + v.w);
        }
        *d = v;
      }
    }
  }
  // the gate pre-activations of cell unit cu of row b at step s
  __device__ void gates(int s, int b, int cu, float (&g)[4]) const {
    const float* p = buf + ((s / rk) & 1) * geo.m * geo.n +
                     ((s % rk) * geo.bgp + b - gb0) * geo.n + cu;
#pragma unroll
    for (int q = 0; q < 4; ++q) g[q] = p[q * units];
  }
};

// what the other cells keep of the gate blocks: nothing
struct NoGates {
  static constexpr bool kHalf = false;
  __device__ NoGates(const Args&, int, float*, int, int, int) {}
};

// Two GRU layers: residuals [r | z | n | hn] and h_prev, stored in S; the
// exchanged row is [dr_pre | dz_pre | dhn] = [dih[:, :2H] | dhn] (3H) and
// the feed layer 1's dih; the carry is the direct part dh_t z.
template <class S>
struct GruCellT {
  using Gates = NoGates;
  static constexpr int kWidth = 3;
  static constexpr bool kRemat = false;
  struct Res {
    float act[4], hp, keep, carry;
  };
  __device__ static void load(const Args& a, int layer, int t, int b, int j, Res& r) {
    const int H = a.hidden;
    const size_t BH = (size_t)a.batch * H, o = (size_t)b * H + j;
    const S* p = res_of<S>(a.res, a.res16) + ((size_t)t * a.batch + b) * 8 * H +
                 4 * H * layer + j;
#pragma unroll
    for (int i = 0; i < 4; ++i) r.act[i] = ld_res(p + i * H);
    r.hp = ld_res(res_of<S>(of_layer(a.prev, layer), of_layer(a.prev16, layer)) + t * BH + o);
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
    const float d[4] = {dn_pre * hn * r * (1.0f - r), dh * (res.hp - n) * z * (1.0f - z),
                        dn_pre, dn_pre * r};
    const size_t row = (size_t)t * a.batch + b, ex = ex_row<S>(layer, t) * a.batch + b;
    float* out = of_layer(a.out, layer) + ex * 3 * H + j;
#pragma unroll
    for (int i = 0; i < 3; ++i) out[i * H] = d[i];
    of_layer(a.out_n, layer)[ex * H + j] = d[3];
    if constexpr (kHalfStore<S>) {
      bf16* out16 = of_layer(a.out16, layer) + row * 3 * H + j;
#pragma unroll
      for (int i = 0; i < 3; ++i) st_res(out16 + i * H, d[i]);
      st_res(of_layer(a.out_n16, layer) + t * BH + o, d[3]);
    }
    a.carry[layer * BH + o] = dh * z;
  }
  // float4 column c of row b of segment seg at step t: the layer's own
  // exchanged row, or (seg 1) layer 1's dih
  __device__ static const float* src(const Args& a, int layer, int seg, int t, int b,
                                     int c) {
    const int H = a.hidden;
    if (seg == 1) return a.out[1] + ((size_t)t * a.batch + b) * 3 * H + 4 * c;
    const size_t row = ex_row<S>(layer, t) * a.batch + b;
    return c < H / 2 ? of_layer(a.out, layer) + row * 3 * H + 4 * c
                     : of_layer(a.out_n, layer) + row * H + 4 * (c - H / 2);
  }
};

using GruCell = GruCellT<float>;
using GruCell16 = GruCellT<bf16>;

// Two LSTM layers: residuals from the packed row [g0 | g1 | c0_prev |
// c1_prev] (layer l's gates at 4H l, its c_prev at 8H + H l), stored in S;
// the exchanged row is dg (4H) and the feed layer 1's dg; the carry is dc.
// dh_final enters at layer 1's first step, loaded there, so no register
// holds it across the products.
template <class S>
struct LstmCellT {
  using Gates = NoGates;
  static constexpr int kWidth = 4;
  static constexpr bool kRemat = false;
  struct Res {
    float g[4], cp, keep, carry;
  };
  __device__ static void load(const Args& a, int layer, int t, int b, int j, Res& r) {
    const int H = a.hidden;
    const size_t BH = (size_t)a.batch * H, o = (size_t)b * H + j;
    const S* p = res_of<S>(a.res, a.res16) + ((size_t)t * a.batch + b) * 10 * H + j;
#pragma unroll
    for (int i = 0; i < 4; ++i) r.g[i] = ld_res(p + 4 * H * layer + i * H);
    r.cp = ld_res(p + 8 * H + H * layer);
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
    float d[4];
    a.carry[layer * BH + o] = rnn_bwd::lstm_cell_bwd(r.g, r.cp, dh, r.carry, d);
    float* out = of_layer(a.out, layer) + (ex_row<S>(layer, t) * a.batch + b) * 4 * H + j;
#pragma unroll
    for (int i = 0; i < 4; ++i) out[i * H] = d[i];
    if constexpr (kHalfStore<S>) {
      bf16* out16 = of_layer(a.out16, layer) + ((size_t)t * a.batch + b) * 4 * H + j;
#pragma unroll
      for (int i = 0; i < 4; ++i) st_res(out16 + i * H, d[i]);
    }
  }
  // float4 column c of row b of segment seg at step t: the layer's own dg,
  // or (seg 1) layer 1's
  __device__ static const float* src(const Args& a, int layer, int seg, int t, int b,
                                     int c) {
    const int l = seg == 1 ? 1 : layer;
    return of_layer(a.out, l) + (ex_row<S>(l, t) * a.batch + b) * 4 * a.hidden + 4 * c;
  }
};

using LstmCell = LstmCellT<float>;
using LstmCell16 = LstmCellT<bf16>;

// LstmCell over the no-gates residuals: packed (T, B, 2H) = [c0_prev |
// c1_prev]; the gates are not read but recomputed (GateBlocksT, which the
// core fills into Res::g after load).  Rows of the series are ld apart, so
// a launch may take a slice of the batch (the wrapper's, where the gate
// blocks of the whole batch do not fit).  The bf16 form (S = bf16,
// LstmRematCell16) reads packed and the gate inputs in bf16 and writes dg
// in bf16 (out16) beside the float32 exchange, layer 0's in two slots as
// LstmCell16's, each slot and the outputs ld rows a step.
template <class S>
struct LstmRematCellT : LstmCellT<S> {
  using Res = typename LstmCellT<S>::Res;
  using Gates = GateBlocksT<S>;
  static constexpr bool kRemat = true;
  __device__ static void load(const Args& a, int layer, int t, int b, int j, Res& r) {
    const int H = a.hidden;
    const size_t row = (size_t)t * a.ld + b;
    r.cp = ld_res(res_of<S>(a.res, a.res16) + row * 2 * H + H * layer + j);
    r.keep = layer == 0 ? __ldg(a.keep + row * H + j) : 0.0f;
    r.carry = a.carry[((size_t)layer * a.batch + b) * H + j];
  }
  __device__ static void step(const Args& a, int layer, int t, int b, int j,
                              const Res& r, float own, float feed) {
    const int H = a.hidden;
    const size_t o = ((size_t)layer * a.batch + b) * H + j;
    float dh = own + r.keep * feed;
    if (layer == 1 && t == a.t_len - 1) dh += __ldg(a.dh_final + (size_t)b * H + j);
    float d[4];
    a.carry[o] = rnn_bwd::lstm_cell_bwd(r.g, r.cp, dh, r.carry, d);
    float* out = of_layer(a.out, layer) + (ex_row<S>(layer, t) * a.ld + b) * 4 * H + j;
#pragma unroll
    for (int i = 0; i < 4; ++i) out[i * H] = d[i];
    if constexpr (kHalfStore<S>) {
      bf16* out16 = of_layer(a.out16, layer) + ((size_t)t * a.ld + b) * 4 * H + j;
#pragma unroll
      for (int i = 0; i < 4; ++i) st_res(out16 + i * H, d[i]);
    }
  }
  __device__ static const float* src(const Args& a, int layer, int seg, int t, int b,
                                     int c) {
    const int l = seg == 1 ? 1 : layer;
    return of_layer(a.out, l) + (ex_row<S>(l, t) * a.ld + b) * 4 * a.hidden + 4 * c;
  }
};

using LstmRematCell = LstmRematCellT<float>;
using LstmRematCell16 = LstmRematCellT<bf16>;

// LstmCell over the legacy layout: the wrapper packs the legacy series
// [g0 | g1 | c0_prev | c1_prev] into row 12's (T, B, 10H) rows, which the
// cell reads as LstmCell does; out[l] points at layer l's lanes of the
// (T, B, 8H) rows [dg0 | dg1]; the exchanged row is the layer's dg (4H),
// the feed layer 1's; dys, where given, adds to layer 1's dh.
struct LstmLegacyCell : LstmCell {
  struct Res : LstmCell::Res {
    float dys;
  };
  __device__ static void load(const Args& a, int layer, int t, int b, int j, Res& r) {
    LstmCell::load(a, layer, t, b, j, r);
    r.dys = layer == 1 && a.dys != nullptr
                ? __ldg(a.dys + ((size_t)t * a.batch + b) * a.hidden + j)
                : 0.0f;
  }
  __device__ static void step(const Args& a, int layer, int t, int b, int j,
                              const Res& r, float own, float feed) {
    const int H = a.hidden;
    const size_t o = (size_t)b * H + j;
    float dh = own + r.keep * feed + r.dys;
    if (layer == 1 && t == a.t_len - 1) dh += __ldg(a.dh_final + o);
    a.carry[layer * (size_t)a.batch * H + o] = rnn_bwd::lstm_cell_bwd(
        r.g, r.cp, dh, r.carry,
        of_layer(a.out, layer) + ((size_t)t * a.batch + b) * 8 * H + j, H);
  }
  // float4 column c of row b of segment seg at step t: the layer's own dg,
  // or (seg 1) layer 1's, in the 8H rows
  __device__ static const float* src(const Args& a, int layer, int seg, int t, int b,
                                     int c) {
    const size_t row = (size_t)t * a.batch + b;
    return (seg == 1 ? a.out[1] : of_layer(a.out, layer)) + row * 8 * a.hidden + 4 * c;
  }
};

// GruCell over the legacy layout: the wrapper packs layer l's [r | z | n |
// hn] series into res as GruCell reads them, h_prev is prev[l]; out[l]
// points at layer l's lanes of the (T, B, 12H) rows [dih0 | dhh0 | dih1 |
// dhh1], each cell writing dih and the full dhh = [dr_pre | dz_pre | dhn];
// the exchanged row is the layer's dhh (3H), the feed layer 1's dih; dys,
// where given, adds to layer 1's dh.
struct GruLegacyCell : GruCell {
  struct Res : GruCell::Res {
    float dys;
  };
  __device__ static void load(const Args& a, int layer, int t, int b, int j, Res& r) {
    GruCell::load(a, layer, t, b, j, r);
    r.dys = layer == 1 && a.dys != nullptr
                ? __ldg(a.dys + ((size_t)t * a.batch + b) * a.hidden + j)
                : 0.0f;
  }
  __device__ static void step(const Args& a, int layer, int t, int b, int j,
                              const Res& res, float own, float feed) {
    const int H = a.hidden;
    const float dh = res.carry + own + res.keep * feed + res.dys;
    const float r = res.act[0], z = res.act[1], n = res.act[2], hn = res.act[3];
    const float dn_pre = dh * (1.0f - z) * (1.0f - n * n);
    const float dr = dn_pre * hn * r * (1.0f - r);
    const float dz = dh * (res.hp - n) * z * (1.0f - z);
    float* out = of_layer(a.out, layer) + ((size_t)t * a.batch + b) * 12 * H + j;
    out[0] = out[3 * H] = dr;
    out[H] = out[4 * H] = dz;
    out[2 * H] = dn_pre;
    out[5 * H] = dn_pre * r;
    a.carry[layer * (size_t)a.batch * H + (size_t)b * H + j] = dh * z;
  }
  // float4 column c of row b of segment seg at step t: the layer's dhh, or
  // (seg 1) layer 1's dih
  __device__ static const float* src(const Args& a, int layer, int seg, int t, int b,
                                     int c) {
    const size_t row = (size_t)t * a.batch + b;
    return (seg == 1 ? a.out[1] : of_layer(a.out, layer) + 3 * a.hidden) +
           row * 12 * a.hidden + 4 * c;
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
  // the buffers are the follow set's, whose share is the wider (the
  // remat cell's lead set keeps its weights over its own share, leaving
  // room for its deeper gate blocks)
  const int cs4max = (2 * own4 + ncl - 1) / ncl;
  const int chunks_max = (cs4max + kc - 1) / kc;
  const int slots = chunks_max <= 8 ? chunks_max : 2;
  const int ldw =
      round32(4 * (Cell::kRemat && !follow ? (own4 + ncl - 1) / ncl : cs4max)) + 4;
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

  // the remat cell's gate blocks, after the set's own buffers: block 0
  // whole before the first step, and block 1's first piece on its way
  const typename Cell::Gates gates(
      a, layer, xpart + 4 * PH * NU, u0 + rank * upc, gb0, gb1);
  [[maybe_unused]] unsigned gphase = 0;  // the transaction barrier's phases done
  if constexpr (Cell::kRemat) {
    if (tid == 0) mbar_init(gates.bar);
    __syncthreads();
    for (int p = 0; p < gates.geo.pieces; ++p) {
      gates.stage(p, 0, 0);
      mbar_wait(gates.bar, gphase++ & 1);
      gates.form(p, 0);
      __syncthreads();
    }
    if (gates.live(1)) gates.stage(0, 1, 0);
  }
  const auto load = [&](int t, int b) {
    Cell::load(a, layer, t, b, j, res);
    if constexpr (Cell::kRemat) gates.gates(T - 1 - t, b, cu, res.g);
  };

  if (has_cell && gb0 + cr < gb1) load(T - 1, gb0 + cr);
  __syncthreads();

  for (int s = 0; s < T; ++s) {
    const int t = T - 1 - s;
    // the remat cell's piece s % rk of block s / rk + 1, once a step: while
    // the step's first exchange is on its way, or on its own where the CTA
    // forms no products this step
    [[maybe_unused]] bool formed = false;
    const auto form = [&]() {
      if constexpr (Cell::kRemat) {
        const int p = s % a.rk, blk = s / a.rk + 1;
        if (!formed && p < gates.geo.pieces && gates.live(blk)) {
          mbar_wait(gates.bar, gphase++ & 1);
          gates.form(p, blk);
        }
        formed = true;
      }
    };
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
      if (p > 0 && cell) load(t, bt0 + cr);
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
              mine + seg * PH * NU, tm, form);
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
    form();
    // arrive: this step's stores are made; load the next step's residuals
    // and start the next step's gate piece (warps 1-7, while warp 0 polls)
    // before waiting for the others
    __syncthreads();
    if (tid == 0) st_release(my_flag, (unsigned)s + 1);
    if (s + 1 < T && has_cell && gb0 + cr < gb1) load(t - 1, gb0 + cr);
    if constexpr (Cell::kRemat) {
      const int p = (s + 1) % a.rk, blk = (s + 1) / a.rk + 1;
      if (s + 1 < T && p < gates.geo.pieces && gates.live(blk)) gates.stage(p, blk, 1);
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
// With a launch's Args, the remat cell's shared memory includes its gate
// blocks (remat_smem_floats).
template <class Cell>
int configure(int hidden, int upc, int ncl, int rgroups, int kc,
              const void** fn, cudaLaunchConfig_t* cfg,
              cudaLaunchAttribute* attr, const Args* a = nullptr) {
  if (!pair_plan_ok(hidden, upc, ncl, rgroups, kc)) return kPlanMismatch;
  *fn = kernel_for<Cell>(upc * ncl * rgroups);
  const int need =
      (int)sizeof(float) *
      (Cell::kRemat && a != nullptr
           ? remat_smem_floats(hidden, upc, ncl, rgroups, kc, a->batch, a->d_in, a->rk,
                               Cell::Gates::kHalf)
           : smem_floats(Cell::kWidth, hidden, upc, ncl, rgroups, kc));
  return rnn_chain::configure(*fn, 2 * hidden / upc, ncl, need, cfg, attr);
}

// Re-check the plan against the shape and the card, then launch
// cooperatively with the cluster dimension.
template <class Cell>
int launch(const Args& a, cudaStream_t stream) {
  if (a.batch < 1 || a.t_len < 1 || a.hidden < 4 || a.hidden % 4 != 0) {
    return kUnsupported;
  }
  // the remat cell's bulk copies move 16-byte pieces of the input rows: 4
  // float32 values, 8 bf16 ones (so the bf16 form also needs H % 8 == 0)
  constexpr int vec = Cell::Gates::kHalf ? 8 : 4;
  if (Cell::kRemat && (a.rk < 1 || a.d_in < vec || a.d_in % vec != 0 ||
                       a.hidden % vec != 0 || a.ld < a.batch)) {
    return kUnsupported;
  }
  const void* fn = nullptr;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[2];
  const int err =
      configure<Cell>(a.hidden, a.upc, a.ncl, a.rgroups, a.kc, &fn, &cfg, attr, &a);
  if (err != cudaSuccess) return err;
  void* args[] = {(void*)&a};
  return launch_resident(fn, &cfg, attr, a.ncl, args, stream);
}

// How many clusters of a plan's kernel the card holds at once, into
// *count; 0 where the plan does not fit.  For the remat cell this is the
// count at the chain's own buffers: any plan past half an SM's shared
// memory holds one CTA an SM, and whether its gate blocks fit is
// remat_smem_floats', which the launch checks.
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
