// 2-layer LSTM reverse dgates chain in the legacy layout for Hopper
// (sm_90a).
//
// Replaces: multimodal_emotion_detection_tpu/ops/lstm_kernel.py::
// lstm2_bwd_chain_pallas (kernel body _lstm2_bwd_kernel).  Same function
// as the plain PyTorch version ops/lstm_kernel.py::
// lstm2_bwd_chain_legacy_reference: over the older layout's separate
// series g0, g1 (T, B, 4H) and c0_prev, c1_prev (T, B, H), the keep mask
// (T, B, H), where one is given the sequence output's cotangent dys
// (T, B, H; without it the stream is not read) and the cotangent of layer
// 1's final hidden state dh_final (B, H), walk t = T-1 .. 0 with carries
// dh1, dc1, dh0, dc0 (dh1 = dh_final, the rest zero, at the start):
//
//   (dg1, dc1) = cell_bwd(g1[t], c1_prev[t], dh1 + dys[t], dc1)
//   dh1 = dg1 @ w_hh1^T ;  dx1 = dg1 @ w_ih1^T
//   (dg0, dc0) = cell_bwd(g0[t], c0_prev[t], dh0 + dx1 * keep[t], dc0)
//   dh0 = dg0 @ w_hh0^T
//
// and write dg (T, B, 8H) = [dg0 | dg1].  The hoisted weight gradients are
// plain matrix products outside (ops/lstm_vjp.py).  The residual-native
// chain (row 12) is lstm2_bwd_chain.cu.
//
// What bounds it on the H100: the serial chain.  At the flagship shape
// (B=32, T=372, H=256) the three products per step are 18.7 GFLOP and the
// streams 231 MB (~0.28 ms at 67 TFLOP/s), but each step needs the whole
// dgates row of the step before, so T+1 phases of device-wide exchanges
// set the time.
//
// Design: the 2-layer reverse core rnn2_bwd_chain.cuh with the legacy LSTM
// cell (LstmLegacyCell, lstm2_bwd_chain.cu's LstmCell writing and
// exchanging the 8H rows and adding dys to layer 1's dh): layer 1's chain
// on one CTA set, layer 0's on another over its own dg and layer 1's (the
// hop), in one launch, on row 12's launch plan (ops/lstm_kernel.py::
// chain_plan, layers=2, re-checked here).  The wrapper packs the gate and
// c_prev series into row 12's residual rows (T, B, 10H), which the cell
// reads as LstmCell does.

#include "rnn2_bwd_chain.cuh"

// packed: (T, B, 10H) = [g0 | g1 | c0_prev | c1_prev]; dys: (T, B, H) or
// null; dg: (T, B, 8H); carry: (2, B, H) zeros (dc); flags: 2,048 zeroed
// words (each set's row groups' barriers)
extern "C" int lstm2_bwd_chain_legacy_launch(const float* packed, const float* dys,
                                             const float* keep, const float* dh_final,
                                             const float* w_hh0, const float* w_hh1,
                                             const float* w_ih1, float* dg, float* carry,
                                             unsigned* flags, int batch, int t_len,
                                             int hidden, int upc, int ncl, int rgroups,
                                             int kc, void* stream) {
  rnn2_bwd::Args a{packed, {nullptr, nullptr}, keep, dh_final, {w_hh0, w_hh1},
                   w_ih1, {dg, dg + 4 * (size_t)hidden}, {nullptr, nullptr}, carry,
                   flags, batch, t_len, hidden, upc, ncl, rgroups, kc};
  a.dys = dys;
  return rnn2_bwd::launch<rnn2_bwd::LstmLegacyCell>(a, (cudaStream_t)stream);
}

extern "C" int lstm2_bwd_chain_legacy_max_clusters(int hidden, int upc, int ncl,
                                                   int rgroups, int kc, int* count) {
  return rnn2_bwd::max_clusters<rnn2_bwd::LstmLegacyCell>(hidden, upc, ncl, rgroups, kc,
                                                          count);
}

extern "C" int lstm2_bwd_chain_legacy_card(int* sms, int* max_smem) {
  return rnn_chain::card_limits(sms, max_smem);
}

RNN_TIMERS_EXPORT(lstm2_bwd_chain_legacy)

extern "C" const char* lstm2_bwd_chain_legacy_error_string(int err) {
  return rnn_chain::error_string(err, "shape not supported by lstm2_bwd_chain_legacy");
}
