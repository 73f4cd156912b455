// The one-layer reverse chain core for Hopper (sm_90a), shared by
// lstm_bwd_chain.cu (LstmCell) and gru_bwd_chain.cu (GruCell).
//
// One layer's reverse chain walks t = T-1 .. 0.  Every step needs
//
//   dh[b][j] = sum_m x[b][m] w_hh[j][m],   m over the exchanged row,
//
// where x is the row block the previous step wrote (LSTM: dg, G = 4H
// columns; GRU: [dih[:, :2H] | dhn], G = 3H), and then the cell backward of
// each (batch row b, unit j), which writes this step's row block.  Every
// unit needs every column of its batch row, and every CTA writes only its
// units' columns, so each step is one device-wide exchange.
//
// What bounded the first design (csrc/*_bwd_chain.cu before this core; the
// in-kernel timers of scripts/chain_ab.py --timers, PERF.md): every CTA read
// the whole row block from L2 (B x G floats, 256 KiB at B=32, H=512 for the
// LSTM: ~44% of a step waiting on it) and re-read its weight slice from
// shared memory once per batch row (~40%); one grid.sync() a step (~8%).
// L2 gives an SM ~20-50 GB/s when every SM reads at once (chain_ab.py
// --probe), and a 16-byte shared load costs four wavefronts whatever its
// addresses.
//
// Design.  The launch plan (ops/lstm_kernel.py::chain_plan, re-checked
// here) keeps the first design's grid, H / UPC CTAs, one per SM (shared
// memory is padded past half an SM's), and splits it three ways:
//
// * Row groups.  Row b of dh needs only row b of x, so R row groups
//   (the fewest passes of 8 rows a group, 2 first up to 16 rows, where
//   the weights fit) each take B / R of the batch: a CTA owns
//   R x UPC units for the rows of its group, in passes of 8 rows.
// * Clusters split the columns.  NCL CTAs of one row group and unit block
//   form a cluster; CTA `rank` loads from L2 only its share of the row
//   block's columns (float4 columns [rank n4 / NCL, (rank + 1) n4 / NCL))
//   for the pass's rows, by cp.async into shared memory in KC-column chunks
//   (the whole share in one where it fits, else a ring of two), and forms
//   the partial products of all NU = NCL x R x UPC units of the cluster
//   over that share, with those units' weights for the share resident in
//   shared memory.  An element of x crosses L2 once per cluster, and a CTA
//   reads 1 / (R NCL) of what it read before.  The partials (8 rows x NU)
//   meet through distributed shared memory: after a cluster barrier
//   (barrier.cluster arrive.release / wait.acquire) each cell thread adds
//   its unit's partials from the NCL CTAs.  They are double-buffered by
//   pass parity, so no CTA overwrites a buffer a peer still reads.
// * Register-blocked products.  A thread keeps 8 rows x UB units (UB = 8
//   where NU allows) of accumulators over every KS-th float4 column, the
//   32 lanes of a warp on consecutive columns: each float4 of x feeds UB
//   units and each float4 of the weights 8 rows, 64 FMA per pair of 16-byte
//   loads, so the products are as much FFMA as shared-memory bound.  The
//   lanes' partial sums meet by a shuffle reduce-scatter, the warps' in
//   shared memory.
// * A split barrier per row group (the groups are independent chains, so a
//   CTA waits only for the gridDim / R CTAs of its own).  After a step's
//   stores and a block barrier, thread 0 stores (st.release, cumulative
//   over the block's stores the barrier ordered before it, as CUTLASS's
//   GenericBarrier does) the count of steps done into its flag (words the
//   wrapper zeroes; monotonic, so nothing is reset within a launch), the
//   cell threads load the next step's residuals and carries, and only then
//   does warp 0 wait (ld.acquire, a lane per flag) for the group's flags.
//   Plain stores, no atomics on one word.  The launch is cooperative with
//   the cluster dimension, so the CUDA runtime refuses a grid that cannot
//   be resident at once.
// * The carries (LSTM dc; GRU the direct part dh_t z) live in a (B, H)
//   buffer the wrapper allocates (zeros; dh_final for the GRU), read with
//   the residuals, so shared memory does not grow with B.
//
// Exactly T steps run; any B >= 1; H % 4 == 0 with H / UPC <= the SM
// count.  Built with -DRNN_CHAIN_TIMERS=1 each warp splits its step into
// the buckets of rnn_timers.cuh.  The primitives this core shares with
// the forward core (rnn_fwd_chain.cuh) are in rnn_chain_common.cuh; its
// products (piece_products) are the 2-layer core's (rnn2_bwd_chain.cuh)
// too.
//
// The LSTM chain's bf16 form (LstmCell16, lstm_bwd_chain.cu's
// lstm_bwd_chain_bf16_launch) reads g and c_prev stored in bf16
// (res16, prev16: rnn_chain_common.cuh's storage) into float32 and writes
// float32 dgates, which are also its exchange.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include "rnn_chain_common.cuh"
#include "rnn_timers.cuh"

namespace rnn_bwd {

namespace cg = cooperative_groups;
using namespace rnn_chain;

struct Args {
  const float* res;        // LSTM g / GRU gates, (T, B, 4H)
  const float* prev;       // LSTM c_prev / GRU h_prev, (T, B, H)
  const float* dh_series;  // (T, B, H) or nullptr (zeros)
  const float* dh_final;   // (B, H)
  const float* w_hh;       // (H, G)
  float* out;              // LSTM dg (T, B, 4H) / GRU dih (T, B, 3H)
  float* out_n;            // GRU dhn (T, B, H); LSTM unused
  float* carry;            // (B, H): LSTM dc (zeros), GRU dh_t z (dh_final)
  unsigned* flags;         // the barriers' flags, kFlagsPerGroup a row group (zero)
  int batch, t_len, hidden, upc, ncl, rgroups, kc;
  // the bf16 form's residuals, in place of res and prev
  const bf16* res16;
  const bf16* prev16;
};

// units per thread of the products, for NU units in a cluster
__host__ __device__ constexpr int unit_block(int nu) { return nu < 8 ? nu : 8; }

// shared memory of a plan, in floats: the weights NU x ldw, the chunk
// slots x PH x ldx, the warps' partials 64 x UB, the cluster partials
// 2 x PH x NU
__host__ __device__ inline int smem_floats(int width, int hidden, int upc,
                                           int ncl, int rgroups, int kc) {
  const int nu = upc * ncl * rgroups;
  const int n4 = width * hidden / 4;
  const int cs4 = (n4 + ncl - 1) / ncl;
  const int chunks = (cs4 + kc - 1) / kc;
  const int slots = chunks <= 8 ? chunks : 2;
  const int ldw = round32(4 * cs4) + 4;
  const int ldx = round32(4 * kc) + 4;
  return nu * ldw + slots * PH * ldx + 64 * unit_block(nu) + 2 * PH * nu;
}

// One LSTM step backward for one (row, unit): gate pre-activations g (i,
// f, g, o), c_prev, dh, dc -> the 4 dgates d; returns dc_prev
__device__ __forceinline__ float lstm_cell_bwd(const float (&g)[4], float cp, float dh,
                                               float dc, float (&d)[4]) {
  const float si = sigmoidf_(g[0]), sf = sigmoidf_(g[1]);
  const float so = sigmoidf_(g[3]), tg = tanhf(g[2]);
  const float tc = tanhf(sf * cp + si * tg);
  const float dcs = dc + dh * so * (1.0f - tc * tc);
  d[0] = dcs * tg * si * (1.0f - si);
  d[1] = dcs * cp * sf * (1.0f - sf);
  d[2] = dcs * si * (1.0f - tg * tg);
  d[3] = dh * tc * so * (1.0f - so);
  return dcs * sf;
}

// the same, the 4 dgates to out[q H]
__device__ __forceinline__ float lstm_cell_bwd(const float (&g)[4], float cp, float dh,
                                               float dc, float* out, int H) {
  float d[4];
  const float dc_prev = lstm_cell_bwd(g, cp, dh, dc, d);
#pragma unroll
  for (int i = 0; i < 4; ++i) out[i * H] = d[i];
  return dc_prev;
}

// One LSTM layer: residuals g (4 gate pre-activations) and c_prev, stored
// in S; the exchanged row is dg (4H); the carry dc.
template <class S>
struct LstmCellT {
  static constexpr int kWidth = 4;
  struct Res {
    float g[4], cp, dhs, dhf, carry;
  };
  __device__ static void load(const Args& a, int t, int b, int j, bool first,
                              Res& r) {
    const int H = a.hidden;
    const size_t o = (size_t)b * H + j, BH = (size_t)a.batch * H;
    const S* p = res_of<S>(a.res, a.res16) + ((size_t)t * a.batch + b) * 4 * H + j;
#pragma unroll
    for (int i = 0; i < 4; ++i) r.g[i] = ld_res(p + i * H);
    r.cp = ld_res(res_of<S>(a.prev, a.prev16) + t * BH + o);
    r.dhs = a.dh_series != nullptr ? __ldg(a.dh_series + t * BH + o) : 0.0f;
    r.dhf = first ? __ldg(a.dh_final + o) : 0.0f;
    r.carry = a.carry[o];
  }
  // rec: the products' dh (unused at the first step, where dh_final is)
  __device__ static void step(const Args& a, int t, int b, int j, bool first,
                              const Res& r, float rec) {
    const int H = a.hidden;
    const float dh = (first ? r.dhf : rec) + r.dhs;
    a.carry[(size_t)b * H + j] = lstm_cell_bwd(
        r.g, r.cp, dh, r.carry, a.out + ((size_t)t * a.batch + b) * 4 * H + j, H);
  }
  // float4 column c of row b of step t's exchanged row
  __device__ static const float* src(const Args& a, int t, int b, int c) {
    return a.out + ((size_t)t * a.batch + b) * 4 * a.hidden + 4 * c;
  }
};
using LstmCell = LstmCellT<float>;
using LstmCell16 = LstmCellT<bf16>;

// One GRU layer: residuals [r | z | n | hn] and h_prev; the exchanged row
// is [dr_pre | dz_pre | dhn] = [dih[:, :2H] | dhn] (3H); the carry is the
// direct part dh_t z (dh_final at the start, when the products are zero).
struct GruCell {
  static constexpr int kWidth = 3;
  struct Res {
    float act[4], hp, dhs, carry;
  };
  __device__ static void load(const Args& a, int t, int b, int j, bool,
                              Res& r) {
    const int H = a.hidden;
    const size_t o = (size_t)b * H + j, BH = (size_t)a.batch * H;
    const float* p = a.res + ((size_t)t * a.batch + b) * 4 * H + j;
#pragma unroll
    for (int i = 0; i < 4; ++i) r.act[i] = __ldg(p + i * H);
    r.hp = __ldg(a.prev + t * BH + o);
    r.dhs = a.dh_series != nullptr ? __ldg(a.dh_series + t * BH + o) : 0.0f;
    r.carry = a.carry[o];
  }
  __device__ static void step(const Args& a, int t, int b, int j, bool,
                              const Res& res, float rec) {
    const int H = a.hidden;
    const float dh = res.carry + rec + res.dhs;
    const float r = res.act[0], z = res.act[1], n = res.act[2], hn = res.act[3];
    const float dn_pre = dh * (1.0f - z) * (1.0f - n * n);
    float* out = a.out + ((size_t)t * a.batch + b) * 3 * H + j;
    out[0] = dn_pre * hn * r * (1.0f - r);
    out[H] = dh * (res.hp - n) * z * (1.0f - z);
    out[2 * H] = dn_pre;
    const size_t o = (size_t)b * H + j;
    a.out_n[(size_t)t * a.batch * H + o] = dn_pre * r;
    a.carry[o] = dh * z;
  }
  __device__ static const float* src(const Args& a, int t, int b, int c) {
    const int h2 = a.hidden / 2;  // float4 columns of dih's first 2H
    const size_t row = (size_t)t * a.batch + b;
    return c < h2 ? a.out + row * 3 * a.hidden + 4 * c
                  : a.out_n + row * a.hidden + 4 * (c - h2);
  }
};

// The CTA's partial sums of its cluster's NU units over one piece of a
// row, len float4 columns: column c of row r < nb of the pass at src(r, c),
// staged by cp.async in chunks of kc columns through `slots` slots of xs
// (PH x ldx floats each), times the units' weights over the piece (NU rows
// of ldw floats from wb).  A thread keeps 8 rows x UB units of accumulators
// over every KS-th float4 column, the 32 lanes of a warp on consecutive
// columns; the lanes' sums meet by the shuffle reduce-scatter, the warps'
// through part (KW x PH x NU), into dst (PH x NU).  Every thread of the
// CTA calls it; it ends with dst written and xs and part still in use by
// other warps.  hook() runs once the piece's first chunks are on their
// way: work that fills the exchange's latency (the 2-layer core's gate
// recompute).
struct NoHook {
  __device__ __forceinline__ void operator()() const {}
};

template <int NU, class Src, class Hook = NoHook>
__device__ __forceinline__ void piece_products(const Src& src, int nb, int len, int kc,
                                               int slots, const float* wb, int ldw,
                                               float* xs, int ldx, float* part, float* dst,
                                               rnn_timer::Timer& tm,
                                               const Hook& hook = Hook()) {
  constexpr int UB = unit_block(NU);  // units per thread
  constexpr int UG = NU / UB;         // unit groups: one per warp ...
  constexpr int KW = 8 / UG;          // ... times KW warps of columns
  constexpr int KS = 32 * KW;         // column slices
  constexpr int NV = PH * UB;         // a thread's accumulators
  constexpr int VPL = NV >= 32 ? NV / 32 : 1;
  static_assert(UG * KW == 8 && NT == 256, "thread tiling");
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  // units ug UB + k, all PH rows, float4 columns ks + KS s
  const int ug = warp % UG, ks = lane + 32 * (warp / UG);
  const int chunks = (len + kc - 1) / kc;
  const auto stage = [&](int ch) {
    const int c0 = ch * kc;
    copy_rows([&](int r, int c) { return src(r, c0 + c); }, nb, min(kc, len - c0),
              xs + (ch % slots) * PH * ldx, ldx, tid);
  };
  // the piece's first chunks at once
  for (int ch = 0; ch < slots && ch < chunks; ++ch) stage(ch);
  hook();
  float acc[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) acc[i] = 0.0f;
  for (int ch = 0; ch < chunks; ++ch) {
    cp_async_wait(min(chunks, ch + slots) - ch - 1);
    tm.mark(rnn_timer::kExchange);
    __syncthreads();
    tm.mark(rnn_timer::kSync);
    const int kn = min(kc, len - ch * kc);
    const float* xb = xs + (ch % slots) * PH * ldx;
    const float* w0 = wb + ug * UB * ldw + 4 * ch * kc;
    for (int c = ks; c < kn; c += KS) {
      float4 w[UB];
#pragma unroll
      for (int k = 0; k < UB; ++k) {
        w[k] = *reinterpret_cast<const float4*>(w0 + k * ldw + 4 * c);
      }
#pragma unroll
      for (int i = 0; i < PH; ++i) {
        const float4 x = *reinterpret_cast<const float4*>(xb + i * ldx + 4 * c);
#pragma unroll
        for (int k = 0; k < UB; ++k) {
          float s = acc[i * UB + k];
          s = fmaf(x.x, w[k].x, s);
          s = fmaf(x.y, w[k].y, s);
          s = fmaf(x.z, w[k].z, s);
          acc[i * UB + k] = fmaf(x.w, w[k].w, s);
        }
      }
    }
    tm.mark(rnn_timer::kProducts);
    if (ch + slots < chunks) {
      __syncthreads();  // every warp is done with this slot
      tm.mark(rnn_timer::kSync);
      stage(ch + slots);
    }
  }
  // the lanes' sums meet by shuffles, the warps' in shared memory
  warp_reduce_scatter<NV>(acc, lane);
  float* pw = part + (warp / UG) * PH * NU;
  if (NV >= 32) {
#pragma unroll
    for (int v = 0; v < VPL; ++v) {
      const int idx = lane * VPL + v;  // row idx / UB, unit idx % UB
      pw[(idx / UB) * NU + ug * UB + idx % UB] = acc[v];
    }
  } else if ((lane & (32 / NV - 1)) == 0) {
    const int idx = lane / (32 / NV);
    pw[(idx / UB) * NU + ug * UB + idx % UB] = acc[0];
  }
  __syncthreads();
  for (int o = tid; o < PH * NU; o += NT) {
    float s = 0.0f;
#pragma unroll
    for (int k = 0; k < KW; ++k) s += part[k * PH * NU + o];
    dst[o] = s;
  }
  tm.mark(rnn_timer::kReduce);
}

template <class Cell, int NU>
__global__ void __launch_bounds__(NT, 1) chain_kernel(const Args a) {
  constexpr int KW = 8 / (NU / unit_block(NU));  // warps of columns
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();

  const int H = a.hidden, n4 = Cell::kWidth * H / 4;
  const int ncl = a.ncl, R = a.rgroups, kc = a.kc;
  const int upc = a.upc * R;  // units per CTA (the cell's)
  const int rank = (int)cluster.block_rank();
  const int cid = blockIdx.x / ncl;  // cluster: row group g, unit block
  const int g = cid % R;
  const int u0 = (cid / R) * NU;     // the cluster's first unit
  // this CTA's share: float4 columns [c_lo, c_lo + cs4) of the row
  const int c_lo = (int)((long long)rank * n4 / ncl);
  const int cs4 = (int)((long long)(rank + 1) * n4 / ncl) - c_lo;
  const int cs4max = (n4 + ncl - 1) / ncl;
  const int chunks_max = (cs4max + kc - 1) / kc;
  const int slots = chunks_max <= 8 ? chunks_max : 2;
  const int ldw = round32(4 * cs4max) + 4;
  const int ldx = round32(4 * kc) + 4;
  float* wl = smem;                      // NU x ldw
  float* xs = wl + NU * ldw;             // slots x PH x ldx
  float* part = xs + slots * PH * ldx;   // KW x PH x NU
  float* xpart = part + KW * PH * NU;    // 2 x PH x NU
  // the row group: rows [gb0, gb1) in passes of PH
  const int bg = (a.batch + R - 1) / R;
  const int gb0 = min(a.batch, g * bg), gb1 = min(a.batch, gb0 + bg);
  const int npass = (bg + PH - 1) / PH;
  // the row groups are independent chains, each with its own barrier: a
  // word per CTA of the group, the steps it has stored
  const int per_group = gridDim.x / R;
  unsigned* flags = a.flags + kFlagsPerGroup * g;
  unsigned* my_flag = flags + (cid / R) * ncl + rank;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  // the cluster's units' weights over this CTA's share of the columns
  for (int i = tid; i < NU * cs4; i += NT) {
    const int u = i / cs4, c = i % cs4;
    const float4 v = __ldg(reinterpret_cast<const float4*>(
        a.w_hh + (size_t)(u0 + u) * 4 * n4) + c_lo + c);
    *reinterpret_cast<float4*>(wl + u * ldw + 4 * c) = v;
  }

  // the cell: unit cu of the CTA, row cr of the pass (neighbouring
  // threads store neighbouring units)
  const bool has_cell = tid < upc * PH;
  const int cu = tid % upc, cr = tid / upc;
  const int j = u0 + rank * upc + cu;
  const int T = a.t_len;
  typename Cell::Res res;
  int xpar = 0;
  rnn_timer::Timer tm;

  if (has_cell && gb0 + cr < gb1) Cell::load(a, T - 1, gb0 + cr, j, true, res);
  __syncthreads();

  for (int q = 0; q < T; ++q) {
    const int t = T - 1 - q;
    const bool first = q == 0;
    if (!first) {
      // every CTA of the row group has stored step t + 1: warp 0 polls
      // their flags, a lane each
      if (warp == 0) wait_flags(flags, per_group, (unsigned)q, lane);
      __syncthreads();
      tm.mark(rnn_timer::kBarrier);
    }
    for (int p = 0; p < npass; ++p) {
      const int bt0 = gb0 + p * PH, nb = max(0, min(PH, gb1 - bt0));
      const bool cell = has_cell && cr < nb;
      if (p > 0 && cell) Cell::load(a, t, bt0 + cr, j, first, res);
      float rec = 0.0f;
      if (!first) {
        // this CTA's partials over its share of step t + 1's row block; the
        // cluster's CTAs' meet through distributed shared memory
        float* mine = xpart + xpar * PH * NU;
        piece_products<NU>(
            [&](int r, int c) { return Cell::src(a, t + 1, bt0 + r, c_lo + c); }, nb, cs4,
            kc, slots, wl, ldw, xs, ldx, part, mine, tm);
        cluster_sync_();  // also a CTA barrier: xs and part are free again
        if (cell) {
          const int o = cr * NU + rank * upc + cu;
          for (int r = 0; r < ncl; ++r) rec += cluster.map_shared_rank(mine, r)[o];
        }
        xpar ^= 1;
        tm.mark(rnn_timer::kCluster);
      }
      if (cell) Cell::step(a, t, bt0 + cr, j, first, res, rec);
      tm.mark(rnn_timer::kCell);
    }
    // arrive: this step's stores are made; load the next step's residuals
    // before waiting for the others
    __syncthreads();
    if (tid == 0) st_release(my_flag, (unsigned)q + 1);
    if (q + 1 < T && has_cell && gb0 + cr < gb1) {
      Cell::load(a, t - 1, gb0 + cr, j, false, res);
    }
    tm.mark(rnn_timer::kCell);
  }
  cluster_sync_();  // no CTA leaves while a peer may read its partials
  tm.flush();
}

template <class Cell>
const void* kernel_for(int nu) {
  switch (nu) {
    case 1: return (const void*)&chain_kernel<Cell, 1>;
    case 2: return (const void*)&chain_kernel<Cell, 2>;
    case 4: return (const void*)&chain_kernel<Cell, 4>;
    case 8: return (const void*)&chain_kernel<Cell, 8>;
    case 16: return (const void*)&chain_kernel<Cell, 16>;
    case 32: return (const void*)&chain_kernel<Cell, 32>;
    case 64: return (const void*)&chain_kernel<Cell, 64>;
    default: return nullptr;
  }
}

// The launch configuration of a plan: kernel, grid, cluster, shared memory;
// kPlanMismatch where the plan does not fit the shape or the card.
template <class Cell>
int configure(int hidden, int upc, int ncl, int rgroups, int kc,
              const void** fn, cudaLaunchConfig_t* cfg,
              cudaLaunchAttribute* attr) {
  if (!plan_shape_ok(hidden, upc, ncl, rgroups, kc)) return kPlanMismatch;
  *fn = kernel_for<Cell>(upc * ncl * rgroups);
  const int need = (int)sizeof(float) *
                   smem_floats(Cell::kWidth, hidden, upc, ncl, rgroups, kc);
  return rnn_chain::configure(*fn, hidden / upc, ncl, need, cfg, attr);
}

// Re-check the plan against the shape and the card, then launch
// cooperatively with the cluster dimension.
template <class Cell>
int launch(const Args& a, cudaStream_t stream) {
  if (a.batch < 1 || a.t_len < 1 || a.hidden < 1 || a.hidden % 4 != 0) {
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

// How many clusters of a plan's kernel the card holds at once (the launch
// plan's residency test), into *count; 0 where the plan does not fit.
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

inline const char* error_string(int err) {
  return rnn_chain::error_string(err, "shape not supported by the reverse chain");
}

}  // namespace rnn_bwd
