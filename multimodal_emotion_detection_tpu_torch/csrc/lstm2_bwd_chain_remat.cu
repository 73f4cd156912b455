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
// writing dg0[t], dg1[t] (T, B, 4H each).  Its bf16 form
// (lstm2_bwd_chain_remat_bf16_launch: the JAX kernel over the streams of
// the no-gates forward with res_dtype bfloat16, x cast to bf16, whose
// dgates come out in bf16) reads packed, x, x1, h0p and h1p in bf16 into
// float32, recomputes the gates as float32 FMAs over the float32 weights
// (so a bf16 tensor-core product, which would round the weights, is not
// this function) and writes dg0 / dg1 in bf16, each rounded once from the
// float32 value; its CTAs exchange the float32 dg through scratch the
// wrapper allocates (layer 0's in two slots, layer 1's whole), so it is
// the float32 form over the same inputs upcast.
//
// What bounds it on the H100: the serial chain.  At the flagship shape
// (B=32, T=372, D=64, H=256) the chain's products are 18.7 GFLOP and the
// recompute 20.3 (39.0 in all, ~0.58 ms at 67 TFLOP/s) and the streams
// 174 MB (~0.05 ms), but each step needs the whole dgates row of the step
// before, so T+1 phases of device-wide exchanges set the time.
//
// Design: the 2-layer reverse core rnn2_bwd_chain.cuh with the remat cell
// (LstmRematCell, lstm2_bwd_chain.cu's LstmCell over the no-gates
// residuals): layer 1's chain on one CTA set, layer 0's on another over its
// own dg and layer 1's (the hop), in one launch, on row 12's launch plan
// (ops/lstm_kernel.py::chain_plan, layers=2, with the gate blocks' shared
// memory, re-checked here).  A CTA's gate columns of [w_ih; w_hh] do not
// fit beside the chain's weights (80 KiB for layer 0, 128 KiB for layer 1
// at the flagship plan), and streaming them every step would add 80-128
// KiB of L2 reads a CTA and step.  The gates depend only on the forward's
// series, so each CTA forms its cells' gates ahead of the chain, rk steps
// a block (GateBlocksT): one piece of the block's depth a step, staged by
// bulk copies (cp.async.bulk) on the blocks' transaction barrier at the end
// of the step before and formed while the step's exchange is on its way,
// so each weight row crosses L2 once a block.  The wrapper packs each
// CTA's gate columns contiguously; nothing grows with T beyond the
// outputs.  The bf16 form stages its inputs' bf16 rows (16-byte pieces of
// 8 values: the wrapper pads x to a multiple of 8 columns, H % 8 == 0),
// half the float32 form's bytes a row, so the plan of the float32 form
// serves both.  At the flagship shape its streams are ~96 MB; the bound
// stays the 39.0 GFLOP of float32 work.  The blocks grow with a row
// group's rows, so where the whole batch's do not fit beside row 12's plan (past 32 rows at the flagship's
// shape: on the H100 another launch costs less than a second pass or a
// ring of chunks) the wrapper launches on slices of the batch (chain_plan's
// batch_slice), each an independent chain over rows ld apart.

#include "rnn2_bwd_chain.cuh"

// The launch's batch rows of the series (T, ld, .): packed, keep, x, x1,
// h0p, h1p, dg0, dg1 point at its first row; x: d_in a multiple of 4 (the
// wrapper pads it); dh_final: (batch, H); wg0 / wg1: [w_ih0; w_hh0] /
// [w_ih1; w_hh1] packed per CTA unit block (rnn2_bwd::Args::wg); carry:
// (2, batch, H) zeros (dc); flags: 2,048 zeroed words (each set's row
// groups' barriers)
extern "C" int lstm2_bwd_chain_remat_launch(
    const float* packed, const float* keep, const float* dh_final, const float* w_hh0,
    const float* w_hh1, const float* w_ih1, const float* x, const float* x1,
    const float* h0p, const float* h1p, const float* wg0, const float* wg1,
    const float* b0, const float* b1, float* dg0, float* dg1, float* carry,
    unsigned* flags, int batch, int ld, int t_len, int hidden, int d_in, int upc,
    int ncl, int rgroups, int kc, int rk, void* stream) {
  const rnn2_bwd::Args a{packed, {nullptr, nullptr}, keep, dh_final, {w_hh0, w_hh1},
                         w_ih1, {dg0, dg1}, {nullptr, nullptr}, carry, flags, batch,
                         t_len, hidden, upc, ncl, rgroups, kc, {x, x1}, {h0p, h1p},
                         {wg0, wg1}, {b0, b1}, d_in, rk, ld, nullptr};
  return rnn2_bwd::launch<rnn2_bwd::LstmRematCell>(a, (cudaStream_t)stream);
}

// bf16 form: packed16 (T, ld, 2H), x16 (T, ld, d_in; d_in a multiple of
// 8), x116, h0p16, h1p16 (T, ld, H; H a multiple of 8) and dg0_16, dg1_16
// (T, ld, 4H) bf16; the float32 exchange (scratch): dg0 (2, ld, 4H), two
// slots, dg1 (T, ld, 4H), from the launch's first row as the series
extern "C" int lstm2_bwd_chain_remat_bf16_launch(
    const rnn_chain::bf16* packed16, const float* keep, const float* dh_final,
    const float* w_hh0, const float* w_hh1, const float* w_ih1, const rnn_chain::bf16* x16,
    const rnn_chain::bf16* x116, const rnn_chain::bf16* h0p16,
    const rnn_chain::bf16* h1p16, const float* wg0, const float* wg1, const float* b0,
    const float* b1, rnn_chain::bf16* dg0_16, rnn_chain::bf16* dg1_16, float* dg0,
    float* dg1, float* carry, unsigned* flags, int batch, int ld, int t_len, int hidden,
    int d_in, int upc, int ncl, int rgroups, int kc, int rk, void* stream) {
  rnn2_bwd::Args a{nullptr, {nullptr, nullptr}, keep, dh_final, {w_hh0, w_hh1},
                   w_ih1, {dg0, dg1}, {nullptr, nullptr}, carry, flags, batch,
                   t_len, hidden, upc, ncl, rgroups, kc, {nullptr, nullptr},
                   {nullptr, nullptr}, {wg0, wg1}, {b0, b1}, d_in, rk, ld, nullptr};
  a.res16 = packed16;
  a.out16[0] = dg0_16;
  a.out16[1] = dg1_16;
  a.xin16[0] = x16;
  a.xin16[1] = x116;
  a.hin16[0] = h0p16;
  a.hin16[1] = h1p16;
  return rnn2_bwd::launch<rnn2_bwd::LstmRematCell16>(a, (cudaStream_t)stream);
}

// the plan is cached per source, so it answers for both forms: the fewer
// clusters of the two
extern "C" int lstm2_bwd_chain_remat_max_clusters(int hidden, int upc, int ncl,
                                                  int rgroups, int kc, int* count) {
  int full = 0, half = 0;
  int err = rnn2_bwd::max_clusters<rnn2_bwd::LstmRematCell>(hidden, upc, ncl, rgroups, kc,
                                                            &full);
  if (err != cudaSuccess) return err;
  err = rnn2_bwd::max_clusters<rnn2_bwd::LstmRematCell16>(hidden, upc, ncl, rgroups, kc,
                                                          &half);
  *count = full < half ? full : half;
  return err;
}

extern "C" int lstm2_bwd_chain_remat_card(int* sms, int* max_smem) {
  return rnn_chain::card_limits(sms, max_smem);
}

RNN_TIMERS_EXPORT(lstm2_bwd_chain_remat)

extern "C" const char* lstm2_bwd_chain_remat_error_string(int err) {
  return rnn_chain::error_string(err, "shape not supported by lstm2_bwd_chain_remat");
}
