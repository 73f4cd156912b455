// 2-layer LSTM reverse dgates chain with the gates rematerialised, for
// Hopper (sm_90a).
//
// Replaces: multimodal_emotion_detection_tpu/ops/lstm_kernel.py::
// lstm2_bwd_chain_remat (kernel body _lstm2_bwd_remat_kernel, per-step math
// _lstm2_step_fn).  Same function as the plain PyTorch version
// ops/lstm_kernel.py::lstm2_bwd_chain_remat_reference: the reverse chain of
// lstm2_bwd_chain.cu over the residuals of lstm2_train_fwd.cu's no-gates form
// (packed (T, B, 2H) = [c0_prev | c1_prev], h0_prev, h1_prev, x1 (T, B, H)),
// the raw layer-0 input x (T, B, D) and the keep mask (T, B, H), with each
// step's gate pre-activations recomputed instead of read back:
//
//   g0[t] = x[t] @ w_ih0 + b0 + h0_prev[t] @ w_hh0
//   g1[t] = [x1[t] | h1_prev[t]] @ [w_ih1; w_hh1] + b1
//   (dg1, dc1) = cell_bwd(g1[t], c1_prev[t], dh1, dc1)
//   dh1 = dg1 @ w_hh1^T ;  dx1 = dg1 @ w_ih1^T
//   (dg0, dc0) = cell_bwd(g0[t], c0_prev[t], dh0 + dx1 * keep[t], dc0)
//   dh0 = dg0 @ w_hh0^T
//
// for t = T-1 .. 0 (dh1 = dh_final, the other carries zero at the start),
// writing dg0[t], dg1[t] (T, B, 4H each).
//
// What bounds it on the H100: the serial chain.  At the flagship shape
// (B=32, T=372, D=64, H=256) the chain's products are 18.7 GFLOP and the
// recompute 20.3 (39.0 in all, ~0.58 ms at 67 TFLOP/s) and the streams
// 174 MB (~0.05 ms), but each step needs the whole dgates row of the step
// before, so T+1 device-wide exchanges set the time.
//
// Design: the first 2-layer chain's (lstm2_bwd_chain_legacy.cu), plus the
// recompute.  One cooperative launch; CTA c owns hidden units [c*UPC,
// (c+1)*UPC), keeps ROWS j of w_hh1, w_ih1 and w_hh0 (for the chain's
// transposed products) in shared memory and reads
// the dg rows of the phase before as the exchange; the layers are
// wavefronted in reverse (phase q runs layer 1 at step T-1-q and layer 0 at
// step T-q), one grid barrier per phase, T+1 in all.  For the recompute the
// CTA also keeps its units' 4*UPC gate COLUMNS of [w_ih0; w_hh0] ((D + H) x
// 4UPC) and [w_ih1; w_hh1] (2H x 4UPC), and its slices of b0 and b1.  A
// step's gates depend only on the forward's streams, not on the chain, so
// each phase forms the NEXT phase's gates of its units for every batch row
// after its cell updates and before the grid barrier, into a shared buffer
// the next phase's cell threads read.  Their inputs, 32 rows of [x |
// h0_prev] and of [x1 | h1_prev], travel from L2 into two shared tiles by
// asynchronous copies (cp.async) that the phase starts right after the
// barrier, so they arrive while the chain runs: only the products (lane =
// row, warp = a slice of the inner dimension, partial sums meeting in
// shared memory) follow the cell updates.  A batch beyond 32 rows stages
// its further passes after the chain.  The tiles have odd row strides (one
// bank per row).  Exactly T steps run; any B >= 1 that fits shared memory.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 256;           // threads per CTA
constexpr int NW = NT / 32;       // warps
constexpr int ROWS = 32;          // batch rows per pass
constexpr int RPW = ROWS / NW;    // rows per warp and pass
constexpr int LOADS = 8;          // float4 loads in flight per array and thread
constexpr int kUnsupported = -1;  // shape the kernel does not take

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__device__ __forceinline__ float dot4(const float4 a, const float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

// one step of the cell backward for one (row, unit): gates g[4] (i, f, g,
// o pre-activations), c_prev, dh, dc -> dgates d[4]; returns dc_prev
__device__ __forceinline__ float cell_bwd(const float* g, float c_prev,
                                          float dh, float dc, float* d) {
  const float si = sigmoidf(g[0]), sf = sigmoidf(g[1]), so = sigmoidf(g[3]);
  const float tg = tanhf(g[2]);
  const float tc = tanhf(sf * c_prev + si * tg);
  const float dcs = dc + dh * so * (1.0f - tc * tc);
  d[0] = dcs * tg * si * (1.0f - si);
  d[1] = dcs * c_prev * sf * (1.0f - sf);
  d[2] = dcs * si * (1.0f - tg * tg);
  d[3] = dh * tc * so * (1.0f - so);
  return dcs * sf;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Start copying rows [bt0, bt0 + nb) of [a | h] (a (B, wa), h (B, H): one
// step's rows of two streamed series) into a tile of row stride kp: a warp
// per row, its lanes along it (coalesced), every copy in flight at once.
__device__ __forceinline__ void stage_rows(const float* a, int wa,
                                           const float* h, int H,
                                           float* tile, int kp, int bt0,
                                           int nb) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int r = warp; r < nb; r += NW) {
    const float* ra = a + (size_t)(bt0 + r) * wa;
    const float* rh = h + (size_t)(bt0 + r) * H;
    float* dst = tile + r * kp;
    for (int c = lane; c < wa; c += 32) cp_async4(dst + c, ra + c);
    for (int c = lane; c < H; c += 32) cp_async4(dst + wa + c, rh + c);
  }
}

// One layer's gate pre-activations at one step for every batch row:
// gates[b][col] = sum_k [a[b] | h[b]][k] * wc[k][col] + bias(col), with wc
// the CTA's (wa + H) x G gate columns and col = gate * UPC + unit.  Pass 0's
// rows are in the tile already when ``staged`` (their copies started
// earlier); the other passes stage their own.  Each thread passes the bias
// of column tid / ROWS (the column it sums in the last step).
template <int UPC>
__device__ __forceinline__ void gates_of_step(
    const float* a, int wa, const float* h, const float* wc, float bias,
    float* tile, int kp, float* gred, float* gates, int batch, int H,
    bool staged) {
  constexpr int G = 4 * UPC;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int K = wa + H;
  const int gr = tid % ROWS;  // the row and column this thread sums last
  const int gc = tid / ROWS;
  for (int bt0 = 0; bt0 < batch; bt0 += ROWS) {
    const int nb = min(ROWS, batch - bt0);
    if (!(staged && bt0 == 0)) stage_rows(a, wa, h, H, tile, kp, bt0, nb);
    cp_async_wait_all();
    __syncthreads();
    float acc[G];
#pragma unroll
    for (int col = 0; col < G; ++col) acc[col] = 0.0f;
    if (lane < nb) {
      const float* row = tile + lane * kp;
      for (int k = warp; k < K; k += NW) {
        const float v = row[k];
        const float4* w = reinterpret_cast<const float4*>(wc + k * G);
#pragma unroll
        for (int q = 0; q < G / 4; ++q) {
          const float4 e = w[q];
          acc[4 * q + 0] += v * e.x; acc[4 * q + 1] += v * e.y;
          acc[4 * q + 2] += v * e.z; acc[4 * q + 3] += v * e.w;
        }
      }
    }
    // gred[(w*G + col)*ROWS + row]: lanes write consecutive words
#pragma unroll
    for (int col = 0; col < G; ++col) gred[(warp * G + col) * ROWS + lane] = acc[col];
    __syncthreads();
    if (gc < G && gr < nb) {
      float s = 0.0f;
#pragma unroll
      for (int w = 0; w < NW; ++w) s += gred[(w * G + gc) * ROWS + gr];
      gates[(bt0 + gr) * G + gc] = s + bias;
    }
    __syncthreads();  // tile and gred are rewritten by the next pass
  }
}

template <int UPC>
__global__ void __launch_bounds__(NT) lstm2_bwd_chain_remat_kernel(
    const float* __restrict__ packed,    // (T, B, 2H)
    const float* __restrict__ keep,      // (T, B, H)
    const float* __restrict__ x,         // (T, B, D)
    const float* __restrict__ x1,        // (T, B, H)
    const float* __restrict__ h0p,       // (T, B, H)
    const float* __restrict__ h1p,       // (T, B, H)
    const float* __restrict__ dh_final,  // (B, H)
    const float* __restrict__ w_ih0,     // (D, 4H)
    const float* __restrict__ b0,        // (4H)
    const float* __restrict__ w_hh0,     // (H, 4H)
    const float* __restrict__ w_ih1,     // (H, 4H)
    const float* __restrict__ b1,        // (4H)
    const float* __restrict__ w_hh1,     // (H, 4H)
    float* dg0,                          // (T, B, 4H) out, also the exchange
    float* dg1,                          // (T, B, 4H) out, also the exchange
    int batch, int t_len, int hidden, int d_in) {
  constexpr int G = 4 * UPC;  // gate columns a CTA owns
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) float smem[];
  const int H = hidden;
  const int D = d_in;
  const int H4 = 4 * H;
  const int H2 = 2 * H;
  const int K0 = D + H;                // inner dimension of g0
  const int K1 = 2 * H;                // inner dimension of g1
  const int kp0 = K0 | 1;              // odd tile row strides
  const int kp1 = K1 | 1;
  // wr[(m*UPC + u)*4H + col] = W_m[j0 + u][col]; m: 0 w_hh1, 1 w_ih1, 2 w_hh0
  float* wr = smem;                    // 3 * UPC * 4H
  float* wc0 = wr + 3 * UPC * H4;      // K0 * G columns of [w_ih0; w_hh0]
  float* wc1 = wc0 + K0 * G;           // K1 * G columns of [w_ih1; w_hh1]
  float* tile0 = wc1 + K1 * G;         // ROWS * kp0 rows of [x | h0_prev]
  float* tile1 = tile0 + ROWS * kp0;   // ROWS * kp1 rows of [x1 | h1_prev]
  float* gred = tile1 + ROWS * kp1;    // NW * G * ROWS partial sums
  float* gb0 = gred + NW * G * ROWS;   // batch * G gates of layer 0
  float* gb1 = gb0 + batch * G;        // batch * G gates of layer 1
  float* red = gb1 + batch * G;        // ROWS * UPC * 3 reduced products
  float* dc0s = red + ROWS * UPC * 3;  // batch * UPC
  float* dc1s = dc0s + batch * UPC;    // batch * UPC

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int j0 = blockIdx.x * UPC;
  const size_t BH = (size_t)batch * H;
  const size_t BG = (size_t)batch * H4;

  for (int i = tid; i < UPC * H4; i += NT) {
    const int u = i / H4, col = i % H4;
    const size_t src = (size_t)(j0 + u) * H4 + col;
    wr[(0 * UPC + u) * H4 + col] = w_hh1[src];
    wr[(1 * UPC + u) * H4 + col] = w_ih1[src];
    wr[(2 * UPC + u) * H4 + col] = w_hh0[src];
  }
  // column col = g*UPC + u of the CTA <-> column g*H + j0 + u of W
  for (int i = tid; i < K0 * G; i += NT) {
    const int k = i / G, col = i % G;
    const size_t c = (size_t)(col / UPC) * H + j0 + col % UPC;
    wc0[i] = k < D ? w_ih0[(size_t)k * H4 + c] : w_hh0[(size_t)(k - D) * H4 + c];
  }
  for (int i = tid; i < K1 * G; i += NT) {
    const int k = i / G, col = i % G;
    const size_t c = (size_t)(col / UPC) * H + j0 + col % UPC;
    wc1[i] = k < H ? w_ih1[(size_t)k * H4 + c] : w_hh1[(size_t)(k - H) * H4 + c];
  }
  for (int i = tid; i < batch * UPC; i += NT) dc0s[i] = dc1s[i] = 0.0f;
  // the bias of the gate column this thread sums in the recompute
  const int gc = tid / ROWS;
  float bias0 = 0.0f, bias1 = 0.0f;
  if (gc < G) {
    const size_t c = (size_t)(gc / UPC) * H + j0 + gc % UPC;
    bias0 = b0[c];
    bias1 = b1[c];
  }

  // this thread's cell update, if any: row cr, unit cu, layer cl
  const bool has_cell = tid < 2 * UPC * ROWS;
  const int cr = tid % ROWS;
  const int cu = (tid / ROWS) % UPC;
  const int cl = tid / (ROWS * UPC);
  const int j = j0 + cu;
  const int h4 = H;  // float4 columns of a 4H row
  __syncthreads();

  // phase 0 runs layer 1 at step T-1 only
  gates_of_step<UPC>(x1 + (size_t)(t_len - 1) * BH, H, h1p + (size_t)(t_len - 1) * BH,
                     wc1, bias1, tile1, kp1, gred, gb1, batch, H, false);

  for (int q = 0; q <= t_len; ++q) {
    // the next phase's steps: layer 1 at T-2-q, layer 0 at T-1-q; their
    // first pass's rows start travelling now, behind the chain
    const int n1 = t_len - 2 - q;
    const int n0 = t_len - 1 - q;
    const int nb0 = min(ROWS, batch);
    if (n1 >= 0) {
      stage_rows(x1 + (size_t)n1 * BH, H, h1p + (size_t)n1 * BH, H, tile1, kp1,
                 0, nb0);
    }
    if (n0 >= 0) {
      stage_rows(x + (size_t)n0 * batch * D, D, h0p + (size_t)n0 * BH, H, tile0,
                 kp0, 0, nb0);
    }
    const bool do1 = q < t_len;   // layer 1 at step t1
    const bool do0 = q >= 1;      // layer 0 at step t0
    const int t1 = t_len - 1 - q;
    const int t0 = t_len - q;
    // dg1(t0) feeds dh1 of step t1 and dx1 of step t0; dg0(t0+1) feeds dh0
    const float* src1 = q >= 1 ? dg1 + (size_t)t0 * BG : nullptr;
    const float* src0 = q >= 2 ? dg0 + (size_t)(t0 + 1) * BG : nullptr;

    for (int bt0 = 0; bt0 < batch; bt0 += ROWS) {
      const int nb = min(ROWS, batch - bt0);
      const bool cell = has_cell && cr < nb;
      const int cb = bt0 + cr;
      const size_t o = (size_t)cb * H + j;
      // the cell's residuals come from device memory: start them first
      float c_prev = 0.0f, kv = 0.0f, dhf = 0.0f;
      if (cell && cl == 1 && do1) {
        c_prev = __ldg(packed + ((size_t)t1 * batch + cb) * H2 + H + j);
        if (q == 0) dhf = __ldg(dh_final + o);
      }
      if (cell && cl == 0 && do0) {
        c_prev = __ldg(packed + ((size_t)t0 * batch + cb) * H2 + j);
        kv = __ldg(keep + (size_t)t0 * BH + o);
      }

      // acc[r][u][m]: row warp + NW*r, unit u, product m
      float acc[RPW][UPC][3];
#pragma unroll
      for (int r = 0; r < RPW; ++r)
#pragma unroll
        for (int u = 0; u < UPC; ++u) acc[r][u][0] = acc[r][u][1] = acc[r][u][2] = 0.0f;
      if (src1 != nullptr) {
#pragma unroll
        for (int r = 0; r < RPW; ++r) {
          const int row = bt0 + warp + NW * r;
          if (row >= batch) continue;  // warp-uniform
          const float4* r1 = reinterpret_cast<const float4*>(src1 + (size_t)row * H4);
          const float4* r0 = src0 != nullptr
              ? reinterpret_cast<const float4*>(src0 + (size_t)row * H4) : nullptr;
          for (int c0 = lane; c0 < h4; c0 += 32 * LOADS) {
            float4 v1[LOADS], v0[LOADS];
#pragma unroll
            for (int l = 0; l < LOADS; ++l) {
              const int c = c0 + 32 * l;
              v1[l] = v0[l] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
              if (c < h4) {
                v1[l] = __ldcg(r1 + c);
                if (r0 != nullptr) v0[l] = __ldcg(r0 + c);
              }
            }
#pragma unroll
            for (int l = 0; l < LOADS; ++l) {
              const int c = c0 + 32 * l;
              if (c < h4) {
#pragma unroll
                for (int u = 0; u < UPC; ++u) {
                  const float4* w = reinterpret_cast<const float4*>(wr) + c;
                  acc[r][u][0] += dot4(v1[l], w[(0 * UPC + u) * h4]);
                  acc[r][u][1] += dot4(v1[l], w[(1 * UPC + u) * h4]);
                  acc[r][u][2] += dot4(v0[l], w[(2 * UPC + u) * h4]);
                }
              }
            }
          }
        }
      }
      // the lanes' partial sums meet by shuffles; lane 0 writes the totals
#pragma unroll
      for (int r = 0; r < RPW; ++r)
#pragma unroll
        for (int u = 0; u < UPC; ++u)
#pragma unroll
          for (int m = 0; m < 3; ++m) {
            float v = acc[r][u][m];
#pragma unroll
            for (int off = 16; off > 0; off /= 2) v += __shfl_xor_sync(0xffffffffu, v, off);
            acc[r][u][m] = v;
          }
      if (lane == 0) {
#pragma unroll
        for (int r = 0; r < RPW; ++r)
#pragma unroll
          for (int u = 0; u < UPC; ++u)
#pragma unroll
            for (int m = 0; m < 3; ++m)
              red[((warp + NW * r) * UPC + u) * 3 + m] = acc[r][u][m];
      }
      __syncthreads();

      const float* rd = red + (cr * UPC + cu) * 3;
      if (cell && cl == 1 && do1) {
        const float dh = q == 0 ? dhf : rd[0];
        float g[4], d[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) g[i] = gb1[cb * G + i * UPC + cu];
        dc1s[cb * UPC + cu] = cell_bwd(g, c_prev, dh, dc1s[cb * UPC + cu], d);
        float* out = dg1 + (size_t)t1 * BG + (size_t)cb * H4 + j;
#pragma unroll
        for (int i = 0; i < 4; ++i) out[i * H] = d[i];
      }
      if (cell && cl == 0 && do0) {
        const float dh = rd[2] + rd[1] * kv;
        float g[4], d[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) g[i] = gb0[cb * G + i * UPC + cu];
        dc0s[cb * UPC + cu] = cell_bwd(g, c_prev, dh, dc0s[cb * UPC + cu], d);
        float* out = dg0 + (size_t)t0 * BG + (size_t)cb * H4 + j;
#pragma unroll
        for (int i = 0; i < 4; ++i) out[i * H] = d[i];
      }
      __syncthreads();  // red and the gate buffers are rewritten next
    }

    // the next phase's gates
    if (n1 >= 0) {
      gates_of_step<UPC>(x1 + (size_t)n1 * BH, H, h1p + (size_t)n1 * BH, wc1,
                         bias1, tile1, kp1, gred, gb1, batch, H, true);
    }
    if (n0 >= 0) {
      gates_of_step<UPC>(x + (size_t)n0 * batch * D, D, h0p + (size_t)n0 * BH,
                         wc0, bias0, tile0, kp0, gred, gb0, batch, H, true);
    }
    grid.sync();
  }
}

template <int UPC>
int launch(const float* packed, const float* keep, const float* x,
           const float* x1, const float* h0p, const float* h1p,
           const float* dh_final, const float* w_ih0, const float* b0,
           const float* w_hh0, const float* w_ih1, const float* b1,
           const float* w_hh1, float* dg0, float* dg1, int batch, int t_len,
           int hidden, int d_in, int max_smem, cudaStream_t stream) {
  constexpr int G = 4 * UPC;
  const int k0 = d_in + hidden, k1 = 2 * hidden;
  const size_t smem =
      ((size_t)3 * UPC * 4 * hidden + (size_t)(k0 + k1) * G +
       (size_t)ROWS * ((k0 | 1) + (k1 | 1)) +
       NW * G * ROWS + 2 * (size_t)batch * G + ROWS * UPC * 3 +
       2 * (size_t)batch * UPC) * sizeof(float);
  if (smem > (size_t)max_smem) return kUnsupported;
  const void* fn = reinterpret_cast<const void*>(&lstm2_bwd_chain_remat_kernel<UPC>);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  void* args[] = {(void*)&packed, (void*)&keep,  (void*)&x,     (void*)&x1,
                  (void*)&h0p,    (void*)&h1p,   (void*)&dh_final,
                  (void*)&w_ih0,  (void*)&b0,    (void*)&w_hh0,
                  (void*)&w_ih1,  (void*)&b1,    (void*)&w_hh1,
                  (void*)&dg0,    (void*)&dg1,   (void*)&batch,
                  (void*)&t_len,  (void*)&hidden, (void*)&d_in};
  // refuses (cudaErrorCooperativeLaunchTooLarge) a grid that cannot be
  // resident all at once, so the grid barrier cannot deadlock
  err = cudaLaunchCooperativeKernel(fn, dim3(hidden / UPC), dim3(NT), args,
                                    smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// Units per CTA: the fewest that keep the grid within one CTA per SM, the
// forward's partition.  UPC 1 and 2 cover H up to twice the SM count (264
// on the H100); larger H, and a D or B whose buffers overflow shared
// memory, are refused as unsupported, as are dg outputs not 16-byte
// aligned (read back as float4).
extern "C" int lstm2_bwd_chain_remat_launch(
    const float* packed, const float* keep, const float* x, const float* x1,
    const float* h0p, const float* h1p, const float* dh_final,
    const float* w_ih0, const float* b0, const float* w_hh0,
    const float* w_ih1, const float* b1, const float* w_hh1, float* dg0,
    float* dg1, int batch, int t_len, int hidden, int d_in, void* stream) {
  if (batch < 1 || t_len < 1 || hidden < 1 || hidden % 4 != 0 || d_in < 1) {
    return kUnsupported;
  }
  if (((uintptr_t)dg0 | (uintptr_t)dg1) & 15) {
    return kUnsupported;
  }
  int dev = 0, sms = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&max_smem,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = (cudaStream_t)stream;
#define LSTM2_TRY(U)                                                         \
  if (hidden % (U) == 0 && hidden / (U) <= sms)                              \
    return launch<U>(packed, keep, x, x1, h0p, h1p, dh_final, w_ih0, b0,     \
                     w_hh0, w_ih1, b1, w_hh1, dg0, dg1, batch, t_len, hidden, \
                     d_in, max_smem, s);
  LSTM2_TRY(1)
  LSTM2_TRY(2)
#undef LSTM2_TRY
  return kUnsupported;
}

extern "C" const char* lstm2_bwd_chain_remat_error_string(int err) {
  if (err == kUnsupported) return "shape not supported by lstm2_bwd_chain_remat";
  return cudaGetErrorString((cudaError_t)err);
}
