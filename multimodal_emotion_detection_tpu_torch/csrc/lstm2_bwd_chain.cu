// 2-layer LSTM reverse dgates chain for Hopper (sm_90a).
//
// Replaces: multimodal_emotion_detection_tpu/ops/lstm_kernel.py::
// lstm2_bwd_chain_padded (kernel body _lstm2_bwd_res_kernel, per-step math
// _lstm2_step_fn).  Same function as the plain PyTorch version
// ops/lstm_kernel.py::lstm2_bwd_chain_reference: over the residuals of
// lstm2_train_fwd (packed (T, B, 10H) = [g0 | g1 | c0_prev | c1_prev], the
// keep mask (T, B, H)) and the cotangent of layer 1's final hidden state
// dh_final (B, H), walk t = T-1 .. 0 with carries dh1, dc1, dh0, dc0 (dh1 =
// dh_final, the rest zero, at the start):
//
//   (dg1, dc1) = cell_bwd(g1[t], c1_prev[t], dh1, dc1)
//   dh1 = dg1 @ w_hh1^T ;  dx1 = dg1 @ w_ih1^T
//   (dg0, dc0) = cell_bwd(g0[t], c0_prev[t], dh0 + dx1 * keep[t], dc0)
//   dh0 = dg0 @ w_hh0^T
//
// and write dg0[t], dg1[t] (T, B, 4H each).  The hoisted weight gradients
// are plain matrix products outside (ops/lstm_vjp.py).  Its bf16 form
// (lstm2_bwd_chain_bf16_launch, the JAX kernel over bf16 residuals, whose
// dgates come out in the residuals' dtype) reads packed in bf16 and writes
// dg0 / dg1 in bf16, each rounded from the float32 value, its CTAs
// exchanging the float32 dg0 / dg1 through scratch the wrapper allocates.  The legacy
// layout's chain (row 9) is lstm2_bwd_chain_legacy.cu, the same core with
// the legacy cell.
//
// What bounds it on the H100: the serial chain.  At the flagship shape
// (B=32, T=372, H=256) the three products per step are 18.7 GFLOP and the
// streams 231 MB (~0.28 ms at 67 TFLOP/s), but each step needs the whole
// dgates row of the step before, so T+1 phases of device-wide exchanges
// set the time.
//
// Design: the 2-layer reverse core rnn2_bwd_chain.cuh with the LSTM cell:
// layer 1's chain on one CTA set, layer 0's on another over its own dg
// and layer 1's (the hop), in one launch.  The launch plan (UPC, cluster
// size, row groups, chunk) comes from ops/lstm_kernel.py::chain_plan
// (layers=2) and is re-checked here.

#include "rnn2_bwd_chain.cuh"

// carry: (2, B, H) zeros (dc); flags: 2,048 zeroed words (each set's row
// groups' barriers)
extern "C" int lstm2_bwd_chain_launch(const float* packed, const float* keep,
                                      const float* dh_final, const float* w_hh0,
                                      const float* w_hh1, const float* w_ih1,
                                      float* dg0, float* dg1, float* carry,
                                      unsigned* flags, int batch, int t_len, int hidden,
                                      int upc, int ncl, int rgroups, int kc,
                                      void* stream) {
  const rnn2_bwd::Args a{packed, {nullptr, nullptr}, keep, dh_final, {w_hh0, w_hh1},
                         w_ih1, {dg0, dg1}, {nullptr, nullptr}, carry, flags, batch,
                         t_len, hidden, upc, ncl, rgroups, kc};
  return rnn2_bwd::launch<rnn2_bwd::LstmCell>(a, (cudaStream_t)stream);
}

// bf16 form: packed16 (T, B, 10H) and dg0_16, dg1_16 (T, B, 4H) bf16; the
// float32 exchange (scratch): dg0 (2, B, 4H), two slots, dg1 (T, B, 4H)
extern "C" int lstm2_bwd_chain_bf16_launch(
    const rnn_chain::bf16* packed16, const float* keep, const float* dh_final,
    const float* w_hh0, const float* w_hh1, const float* w_ih1, rnn_chain::bf16* dg0_16,
    rnn_chain::bf16* dg1_16, float* dg0, float* dg1, float* carry, unsigned* flags,
    int batch, int t_len, int hidden, int upc, int ncl, int rgroups, int kc,
    void* stream) {
  rnn2_bwd::Args a{nullptr, {nullptr, nullptr}, keep, dh_final, {w_hh0, w_hh1},
                   w_ih1, {dg0, dg1}, {nullptr, nullptr}, carry, flags, batch,
                   t_len, hidden, upc, ncl, rgroups, kc};
  a.res16 = packed16;
  a.out16[0] = dg0_16;
  a.out16[1] = dg1_16;
  return rnn2_bwd::launch<rnn2_bwd::LstmCell16>(a, (cudaStream_t)stream);
}

// the plan is cached per source, so it answers for both forms: the fewer
// clusters of the two
extern "C" int lstm2_bwd_chain_max_clusters(int hidden, int upc, int ncl, int rgroups,
                                            int kc, int* count) {
  int full = 0, half = 0;
  int err = rnn2_bwd::max_clusters<rnn2_bwd::LstmCell>(hidden, upc, ncl, rgroups, kc,
                                                       &full);
  if (err != cudaSuccess) return err;
  err = rnn2_bwd::max_clusters<rnn2_bwd::LstmCell16>(hidden, upc, ncl, rgroups, kc, &half);
  *count = full < half ? full : half;
  return err;
}

extern "C" int lstm2_bwd_chain_card(int* sms, int* max_smem) {
  return rnn_chain::card_limits(sms, max_smem);
}

RNN_TIMERS_EXPORT(lstm2_bwd_chain)

extern "C" const char* lstm2_bwd_chain_error_string(int err) {
  return rnn_chain::error_string(err, "shape not supported by lstm2_bwd_chain");
}
