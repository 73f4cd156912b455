// The one-layer forward core for Hopper (sm_90a), shared by lstm1_fwd.cu
// (LstmCell) and gru1_fwd.cu (GruCell); the twin of rnn_bwd_chain.cuh.
//
// One layer's forward walks t = 0 .. T-1 from zero state.  Every step
// needs, for each batch row b and each of the layer's W H gate columns,
//
//   rec[b][q H + j] = sum_k h[b][k] w_hh[k][q H + j],   k over H,
//
// where h is the row block the previous step wrote (LSTM: W = 4 gates
// i, f, g, o; GRU: W = 3, r, z, n), and then the cell of each (row b, unit
// j), which adds the hoisted input projection ih[t] and writes this step's
// h.  Every unit needs every column of its row of h and every CTA writes
// only its units' columns, so each step is one device-wide exchange.
//
// What bounded the first design (csrc/lstm1_fwd.cu and gru1_fwd.cu before
// this core; the in-kernel timers of scripts/chain_ab.py --timers,
// PERF.md): every CTA read all B rows of the previous h from L2 (64 KiB a
// step at B=32, H=512: 57% of a step waiting on it), re-read its weight
// slice from shared memory once per batch row (a lane held one row; 27%),
// and one grid.sync() a step (13%).
//
// Design: rnn_bwd_chain.cuh's, transposed.  The launch plan
// (ops/lstm_kernel.py::chain_plan with forward=True, re-checked here)
// keeps H / UPC CTAs, one per SM, and splits them the same three ways:
//
// * Row groups.  Row b of h at step t needs only row b at step t-1, so R
//   row groups (the fewest passes of 8 rows a group) each take
//   B / R of the batch: a CTA runs the cells of R x UPC units for the
//   rows of its group, in passes of 8 rows.
// * Clusters split the columns of h.  NCL CTAs of one row group and unit
//   block form a cluster; CTA `rank` loads from L2 only its share of the
//   previous h row (float4 columns [rank n4 / NCL, (rank + 1) n4 / NCL) of
//   n4 = H / 4) for the pass's rows, by cp.async, and forms the partial
//   products of all W NU gate columns of the cluster's NU = NCL R UPC
//   units over that share, with those columns of w_hh over the share
//   resident in shared memory (transposed: a gate column's k run is
//   contiguous).  The partials (8 rows x W NU) meet through distributed
//   shared memory after a cluster barrier, double-buffered by pass parity.
// * Register-blocked products.  A thread keeps 8 rows x OB gate columns
//   (2 units' W gates: 64 accumulators for the LSTM, 48 for the GRU) over
//   every TPG-th float4 column of the share, lanes on consecutive columns:
//   each float4 of h feeds OB columns and each float4 of the weights 8
//   rows.  The lanes of a column group meet by a shuffle reduce-scatter
//   unrolled at compile time (rnn_chain_common.cuh); where a group spans
//   several warps, their sums meet in shared memory.
// * A flag barrier per row group.  After a step's stores and a block
//   barrier, thread 0 stores (st.release) the count of steps done into its
//   flag; the cell threads prefetch the next step's ih and carry; then
//   warp 0 waits (ld.acquire, a lane per flag) for the group's flags.  No
//   grid.sync().  The launch is cooperative with the cluster dimension, so
//   the CUDA runtime refuses a grid that cannot be resident at once.
// * The h the cells write is the next step's exchange: training, h_prev
//   (T, B, H), the state before each step; eval, the h series or two
//   (B, H) slots used in turn, of which slot (T-1) % 2 holds the final h.
//   A CTA releases step t only after its cp.async reads of step t's source
//   have completed, so step t+1 may overwrite the slot step t-1 wrote.
// * The carry (LSTM c; GRU h, the direct term z h_prev of the unit's own
//   column, which the staged share need not hold) stays in the cell
//   thread's register where one pass covers the row group (B <= 8 R),
//   else lives in a (B, H) buffer of zeros the wrapper allocates, read
//   and written by the cell thread of that (row, unit) alone.
//
// Exactly T steps run; any B >= 1; H % 4 == 0 with H / UPC <= the SM
// count.  Built with -DRNN_CHAIN_TIMERS=1 each warp splits its step into
// the buckets of rnn_timers.cuh.  Its products (piece_products) are the
// 2-layer forward core's (rnn2_fwd_chain.cuh) too.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include "rnn_chain_common.cuh"
#include "rnn_timers.cuh"

namespace rnn_fwd {

namespace cg = cooperative_groups;
using namespace rnn_chain;

struct Args {
  const float* ih;    // (T, B, W H): the hoisted input projection
  const float* w_hh;  // (H, W H)
  const float* b_hh;  // GRU (3H); LSTM unused
  float* gates;       // training: LSTM g / GRU [r | z | n | hn], (T, B, 4H)
  float* h_x;         // training: h_prev (T, B, H); eval: the h series
                      // (T, B, H) or two (B, H) slots
  float* c_prev;      // LSTM training: (T, B, H)
  float* finals;      // training: LSTM [h | c] (B, 2H), GRU h (B, H)
  float* carry;       // (B, H) zeros: LSTM c, GRU h
  unsigned* flags;    // the barriers' flags, kFlagsPerGroup a row group (zero)
  int batch, t_len, hidden, series, upc, ncl, rgroups, kc;
  // the LSTM training form's bf16 form: g and c_prev in place of gates and
  // c_prev
  bf16* gates16;
  bf16* c_prev16;
};

// units per thread of the products, for NU units in a cluster
__host__ __device__ constexpr int unit_block(int nu) { return nu < 2 ? nu : 2; }

// warps of one column group: NT / (NU / UB) threads, 32 to a warp
__host__ __device__ constexpr int group_warps(int nu) {
  return NT / (nu / unit_block(nu)) >= 32 ? NT / (nu / unit_block(nu)) / 32 : 1;
}

// shared memory of a plan, in floats: the weights W NU x ldw, the chunk
// slots x PH x ldx, the warps' partials where a column group spans
// several warps, the cluster partials 2 x PH x W NU
__host__ __device__ inline int smem_floats(int width, int hidden, int upc,
                                           int ncl, int rgroups, int kc) {
  const int nu = upc * ncl * rgroups, no = width * nu;
  const int cs4 = (hidden / 4 + ncl - 1) / ncl;
  const int chunks = (cs4 + kc - 1) / kc;
  const int slots = chunks <= 8 ? chunks : 2;
  const int ldw = round32(4 * cs4) + 4;
  const int ldx = round32(4 * kc) + 4;
  const int kw = group_warps(nu);
  return no * ldw + slots * PH * ldx + (kw > 1 ? kw * PH * no : 0) + 2 * PH * no;
}

// float4 column c of row b of the h that step t >= 1 reads
template <bool TRAIN>
__device__ __forceinline__ const float* h_src(const Args& a, int t, int b, int c) {
  const int row = TRAIN ? t : (a.series ? t - 1 : (t - 1) & 1);
  return a.h_x + ((size_t)row * a.batch + b) * a.hidden + 4 * c;
}

// One LSTM layer: gates i, f, g, o; the carry c.  The training form stores
// g and c_prev in S (h_prev, the exchange, and the finals stay float32).
template <class S>
struct LstmCellT {
  static constexpr int kWidth = 4;
  struct In {
    float ih[4];
  };
  __device__ static void load(const Args& a, int t, int b, int j, In& in) {
    const int H = a.hidden;
    const float* p = a.ih + ((size_t)t * a.batch + b) * 4 * H + j;
#pragma unroll
    for (int i = 0; i < 4; ++i) in.ih[i] = __ldg(p + i * H);
  }
  // rec: the products of the previous h with the unit's 4 gate columns;
  // cp: the carry c before the step; returns c after it
  template <bool TRAIN>
  __device__ static float step(const Args& a, int t, int b, int j, const In& in,
                               const float (&rec)[4], float cp) {
    const int H = a.hidden;
    float g[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) g[i] = in.ih[i] + rec[i];
    const float c = sigmoidf_(g[1]) * cp + sigmoidf_(g[0]) * tanhf(g[2]);
    const float h = sigmoidf_(g[3]) * tanhf(c);
    const size_t BH = (size_t)a.batch * H, o = (size_t)b * H + j;
    if constexpr (TRAIN) {
      S* gp = res_of<S>(a.gates, a.gates16) + ((size_t)t * a.batch + b) * 4 * H + j;
#pragma unroll
      for (int i = 0; i < 4; ++i) st_res(gp + i * H, g[i]);
      st_res(res_of<S>(a.c_prev, a.c_prev16) + t * BH + o, cp);
      if (t == 0) a.h_x[o] = 0.0f;
      if (t + 1 < a.t_len) {
        a.h_x[(t + 1) * BH + o] = h;
      } else {
        a.finals[(size_t)b * 2 * H + j] = h;
        a.finals[(size_t)b * 2 * H + H + j] = c;
      }
    } else {
      a.h_x[(a.series ? t : t & 1) * BH + o] = h;
    }
    return c;
  }
};
using LstmCell = LstmCellT<float>;
using LstmCell16 = LstmCellT<bf16>;

// One GRU layer: gates r, z, n with b_hh beside the product (its n third
// inside the reset product: hn = h w_hn + b_hn); the carry h.
struct GruCell {
  static constexpr int kWidth = 3;
  struct In {
    float ih[3], bh[3];
  };
  __device__ static void load(const Args& a, int t, int b, int j, In& in) {
    const int H = a.hidden;
    const float* p = a.ih + ((size_t)t * a.batch + b) * 3 * H + j;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      in.ih[i] = __ldg(p + i * H);
      in.bh[i] = __ldg(a.b_hh + i * H + j);
    }
  }
  // hp: the carry h before the step (the direct term's own column);
  // returns h after it
  template <bool TRAIN>
  __device__ static float step(const Args& a, int t, int b, int j, const In& in,
                               const float (&rec)[3], float hp) {
    const int H = a.hidden;
    const float hr = rec[0] + in.bh[0], hz = rec[1] + in.bh[1], hn = rec[2] + in.bh[2];
    const float r = sigmoidf_(in.ih[0] + hr);
    const float z = sigmoidf_(in.ih[1] + hz);
    const float n = tanhf(in.ih[2] + r * hn);
    const float h = (1.0f - z) * n + z * hp;
    const size_t BH = (size_t)a.batch * H, o = (size_t)b * H + j;
    if constexpr (TRAIN) {
      float* gp = a.gates + ((size_t)t * a.batch + b) * 4 * H + j;
      gp[0] = r;
      gp[H] = z;
      gp[2 * H] = n;
      gp[3 * H] = hn;
      if (t == 0) a.h_x[o] = 0.0f;
      if (t + 1 < a.t_len) {
        a.h_x[(t + 1) * BH + o] = h;
      } else {
        a.finals[o] = h;
      }
    } else {
      a.h_x[(a.series ? t : t & 1) * BH + o] = h;
    }
    return h;
  }
};

// The CTA's partial sums of its cluster's W NU gate columns over one
// piece of a row of h, len float4 columns: column c of row r < nb of the
// pass at src(r, c), staged by cp.async in chunks of kc columns through
// `slots` slots of xs (PH x ldx floats each), times the gate columns'
// weights over the piece (W NU rows of ldw floats from wb).  A thread keeps
// 8 rows x OB gate columns (UB units' W each) of accumulators over every
// TPG-th float4 column, lanes on consecutive columns; the lanes of a
// column group meet by the shuffle reduce-scatter, a group's warps (where
// it spans several) through part (KW x PH x W NU), into dst (PH x W NU).
// Every thread of the CTA calls it; it ends with dst written and xs and
// part still in use by other warps.
template <int W, int NU, class Src>
__device__ __forceinline__ void piece_products(const Src& src, int nb, int len, int kc,
                                               int slots, const float* wb, int ldw,
                                               float* xs, int ldx, float* part, float* dst,
                                               rnn_timer::Timer& tm) {
  constexpr int NO = W * NU;              // the cluster's gate columns
  constexpr int UB = unit_block(NU);      // units per thread ...
  constexpr int OB = W * UB;              // ... and their gate columns
  constexpr int OG = NU / UB;             // column groups
  constexpr int TPG = NT / OG;            // threads of a group: its column slices
  constexpr int L = TPG < 32 ? TPG : 32;  // lanes whose sums meet by shuffles
  constexpr int KW = group_warps(NU);     // warps whose sums meet in shared memory
  constexpr int NV = PH * OB;             // a thread's accumulators
  constexpr int S = scatter_levels(NV, L);
  constexpr int NF = NV >> S;             // values a lane holds after the reduce
  constexpr int LS = L >> S;              // lanes that hold the same ones
  static_assert(OG * TPG == NT && L * KW == TPG, "thread tiling");
  const int tid = threadIdx.x;
  // gate columns og OB + [0, OB) of the cluster (units og UB + [0, UB), W
  // each), all PH rows, float4 columns ks + TPG s
  const int og = tid / TPG, ks = tid % TPG;
  const int kw = ks / L, li = ks % L;
  const int chunks = (len + kc - 1) / kc;
  const auto stage = [&](int ch) {
    const int c0 = ch * kc;
    copy_rows([&](int r, int c) { return src(r, c0 + c); }, nb, min(kc, len - c0),
              xs + (ch % slots) * PH * ldx, ldx, tid);
  };
  // the piece's first chunks at once
  for (int ch = 0; ch < slots && ch < chunks; ++ch) stage(ch);
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
    const float* w0 = wb + og * OB * ldw + 4 * ch * kc;
    for (int c = ks; c < kn; c += TPG) {
      float4 w[OB];
#pragma unroll
      for (int k = 0; k < OB; ++k) {
        w[k] = *reinterpret_cast<const float4*>(w0 + k * ldw + 4 * c);
      }
#pragma unroll
      for (int i = 0; i < PH; ++i) {
        const float4 x = *reinterpret_cast<const float4*>(xb + i * ldx + 4 * c);
#pragma unroll
        for (int k = 0; k < OB; ++k) {
          float s = acc[i * OB + k];
          s = fmaf(x.x, w[k].x, s);
          s = fmaf(x.y, w[k].y, s);
          s = fmaf(x.z, w[k].z, s);
          acc[i * OB + k] = fmaf(x.w, w[k].w, s);
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
  // the lanes' sums meet by shuffles, a group's warps' in shared memory
  warp_reduce_scatter<NV, L>(acc, li);
  float* pw = KW > 1 ? part + kw * PH * NO : dst;
  if (li % LS == 0) {
#pragma unroll
    for (int v = 0; v < NF; ++v) {
      const int idx = NF * (li / LS) + v;  // row idx / OB, column idx % OB
      pw[(idx / OB) * NO + og * OB + idx % OB] = acc[v];
    }
  }
  if constexpr (KW > 1) {
    __syncthreads();
    for (int o = tid; o < PH * NO; o += NT) {
      float s = 0.0f;
#pragma unroll
      for (int k = 0; k < KW; ++k) s += part[k * PH * NO + o];
      dst[o] = s;
    }
  }
  tm.mark(rnn_timer::kReduce);
}

template <class Cell, int NU, bool TRAIN>
__global__ void __launch_bounds__(NT, 1) fwd_kernel(const Args a) {
  constexpr int W = Cell::kWidth;
  constexpr int NO = W * NU;              // the cluster's gate columns
  constexpr int KW = group_warps(NU);     // warps whose sums meet in shared memory
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();

  const int H = a.hidden, n4 = H / 4;
  const int ncl = a.ncl, R = a.rgroups, kc = a.kc;
  const int upc = a.upc * R;  // units per CTA (the cells')
  const int rank = (int)cluster.block_rank();
  const int cid = blockIdx.x / ncl;  // cluster: row group g, unit block
  const int g = cid % R;
  const int u0 = (cid / R) * NU;     // the cluster's first unit
  // this CTA's share: float4 columns [c_lo, c_lo + cs4) of the h row
  const int c_lo = (int)((long long)rank * n4 / ncl);
  const int cs4 = (int)((long long)(rank + 1) * n4 / ncl) - c_lo;
  const int cs4max = (n4 + ncl - 1) / ncl;
  const int chunks_max = (cs4max + kc - 1) / kc;
  const int slots = chunks_max <= 8 ? chunks_max : 2;
  const int ldw = round32(4 * cs4max) + 4;
  const int ldx = round32(4 * kc) + 4;
  float* wl = smem;                      // NO x ldw
  float* xs = wl + NO * ldw;             // slots x PH x ldx
  float* part = xs + slots * PH * ldx;   // KW x PH x NO where KW > 1
  float* xpart = part + (KW > 1 ? KW * PH * NO : 0);  // 2 x PH x NO
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
  // row u W + q of wl: gate column q H + u0 + u of w_hh over this CTA's
  // share of k; neighbouring threads read neighbouring units
  for (int i = tid; i < NO * 4 * cs4; i += NT) {
    const int u = i % NU, rest = i / NU;
    const int q = rest % W, k = rest / W;
    wl[(u * W + q) * ldw + k] =
        __ldg(a.w_hh + (size_t)(4 * c_lo + k) * W * H + q * H + u0 + u);
  }

  // the cell: unit cu of the CTA, row cr of the pass (neighbouring
  // threads store neighbouring units)
  const bool has_cell = tid < upc * PH;
  const int cu = tid % upc, cr = tid / upc;
  const int j = u0 + rank * upc + cu;
  const int oc = (rank * upc + cu) * W;  // its first gate column in the partials
  const int T = a.t_len;
  typename Cell::In in;
  // the cell's carry: kept in a register where one pass covers the row
  // group (the cell thread then has one row), else read with the ih
  // prefetch and stored back
  float carry = 0.0f;
  const auto prefetch = [&](int t, int b) {
    Cell::load(a, t, b, j, in);
    if (npass > 1) carry = a.carry[(size_t)b * H + j];
  };
  int xpar = 0;
  rnn_timer::Timer tm;

  if (has_cell && gb0 + cr < gb1) prefetch(0, gb0 + cr);
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    if (t > 0) {
      // every CTA of the row group has stored step t - 1
      if (warp == 0) wait_flags(flags, per_group, (unsigned)t, lane);
      __syncthreads();
      tm.mark(rnn_timer::kBarrier);
    }
    for (int p = 0; p < npass; ++p) {
      const int bt0 = gb0 + p * PH, nb = max(0, min(PH, gb1 - bt0));
      const bool cell = has_cell && cr < nb;
      if (p > 0 && cell) prefetch(t, bt0 + cr);
      float rec[W];
#pragma unroll
      for (int i = 0; i < W; ++i) rec[i] = 0.0f;
      if (t > 0) {
        // this CTA's partials over its share of the previous h; the
        // cluster's CTAs' meet through distributed shared memory
        float* mine = xpart + xpar * PH * NO;
        piece_products<W, NU>(
            [&](int r, int c) { return h_src<TRAIN>(a, t, bt0 + r, c_lo + c); }, nb, cs4,
            kc, slots, wl, ldw, xs, ldx, part, mine, tm);
        cluster_sync_();  // also a CTA barrier: xs and part are free again
        if (cell) {
          for (int r = 0; r < ncl; ++r) {
            const float* pr =
                (r == rank ? mine : cluster.map_shared_rank(mine, r)) + cr * NO + oc;
            if constexpr (W == 4) {
              const float4 v = *reinterpret_cast<const float4*>(pr);
              rec[0] += v.x;
              rec[1] += v.y;
              rec[2] += v.z;
              rec[3] += v.w;
            } else {
#pragma unroll
              for (int i = 0; i < W; ++i) rec[i] += pr[i];
            }
          }
        }
        xpar ^= 1;
        tm.mark(rnn_timer::kCluster);
      }
      if (cell) {
        carry = Cell::template step<TRAIN>(a, t, bt0 + cr, j, in, rec, carry);
        if (npass > 1) a.carry[(size_t)(bt0 + cr) * H + j] = carry;
      }
      tm.mark(rnn_timer::kCell);
    }
    // arrive: this step's stores are made and its reads of the previous h
    // are complete; prefetch the next step's ih before waiting for the
    // others
    __syncthreads();
    if (tid == 0) st_release(my_flag, (unsigned)t + 1);
    if (t + 1 < T && has_cell && gb0 + cr < gb1) prefetch(t + 1, gb0 + cr);
    tm.mark(rnn_timer::kCell);
  }
  cluster_sync_();  // no CTA leaves while a peer may read its partials
  tm.flush();
}

template <class Cell, bool TRAIN>
const void* kernel_for(int nu) {
  switch (nu) {
    case 1: return (const void*)&fwd_kernel<Cell, 1, TRAIN>;
    case 2: return (const void*)&fwd_kernel<Cell, 2, TRAIN>;
    case 4: return (const void*)&fwd_kernel<Cell, 4, TRAIN>;
    case 8: return (const void*)&fwd_kernel<Cell, 8, TRAIN>;
    case 16: return (const void*)&fwd_kernel<Cell, 16, TRAIN>;
    case 32: return (const void*)&fwd_kernel<Cell, 32, TRAIN>;
    case 64: return (const void*)&fwd_kernel<Cell, 64, TRAIN>;
    default: return nullptr;
  }
}

// The launch configuration of a plan: kernel, grid, cluster, shared memory;
// kPlanMismatch where the plan does not fit the shape or the card.
template <class Cell, bool TRAIN>
int configure(int hidden, int upc, int ncl, int rgroups, int kc,
              const void** fn, cudaLaunchConfig_t* cfg,
              cudaLaunchAttribute* attr) {
  if (!plan_shape_ok(hidden, upc, ncl, rgroups, kc)) return kPlanMismatch;
  *fn = kernel_for<Cell, TRAIN>(upc * ncl * rgroups);
  const int need = (int)sizeof(float) *
                   smem_floats(Cell::kWidth, hidden, upc, ncl, rgroups, kc);
  return rnn_chain::configure(*fn, hidden / upc, ncl, need, cfg, attr);
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

// How many clusters of a plan's kernels (the training and, with kEval, the
// eval form; the fewer) the card holds at once, into *count; 0 where the
// plan does not fit.
template <class Cell, bool kEval = true>
int max_clusters(int hidden, int upc, int ncl, int rgroups, int kc, int* count) {
  *count = 0;
  int least = -1;
  for (int form = 0; form < (kEval ? 2 : 1); ++form) {
    const void* fn = nullptr;
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr[1];
    int err = configure<Cell, true>(hidden, upc, ncl, rgroups, kc, &fn, &cfg, attr);
    if constexpr (kEval) {
      if (form == 1) err = configure<Cell, false>(hidden, upc, ncl, rgroups, kc, &fn, &cfg, attr);
    }
    if (err == kPlanMismatch) return cudaSuccess;
    if (err != cudaSuccess) return err;
    int n = 0;
    err = cudaOccupancyMaxActiveClusters(&n, fn, &cfg);
    if (err != cudaSuccess) return err;
    least = least < 0 || n < least ? n : least;
  }
  *count = least;
  return cudaSuccess;
}

}  // namespace rnn_fwd
