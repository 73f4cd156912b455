// 2-layer LSTM training forward in the legacy layout for Hopper (sm_90a).
//
// Replaces: multimodal_emotion_detection_tpu/ops/lstm_kernel.py::
// lstm2_train_fwd_pallas (kernel body _lstm2_fwd_train_kernel).  Same
// function as the plain PyTorch version ops/lstm_kernel.py::
// lstm2_train_fwd_legacy_reference: given layer 0's hoisted input
// projection ih0 = x @ w_ih0 + b0 (T, B, 4H, time-major) and the
// layer-0 -> 1 keep mask (T, B, H), run from zero state for t = 0..T-1
//
//   g0 = ih0[t] + h0 @ w_hh0                 ; (h0, c0) = cell(g0, c0)
//   x1 = h0 * keep[t]
//   g1 = (x1 @ w_ih1 + b1) + h1 @ w_hh1      ; (h1, c1) = cell(g1, c1)
//
// and store the older layout of the TPU kernel _lstm2_fwd_train_kernel:
//   res[t] (B, 12H) = [g0 | g1 | h0 | h1 | c0 | c1], the states AFTER step t
//   h_final (B, H) = h1 after step T-1.
// The residual-native layout (rows 11 and 11n) is lstm2_train_fwd.cu.
//
// What bounds it on the H100: the serial chain, as for lstm2_infer.  At the
// flagship shape (B=32, T=372, H=256) the recurrent products are 18.7 GFLOP
// and the residual stores 146 MB (~0.28 ms at 67 TFLOP/s, ~0.04 ms at
// 3.35 TB/s), but every step needs the whole previous hidden state of all
// units, so T+1 phases of device-wide exchanges set the time.
//
// Design: the training form of the 2-layer forward core rnn2_fwd_chain.cuh
// with the legacy LSTM cell (LstmLegacyCell, lstm2_train_fwd.cu's LstmCell
// storing the 12H rows): layer 0's forward on one CTA set, layer 1's on
// another over [its own h | x1], in one launch, on row 11's launch plan
// (ops/lstm_kernel.py::chain_plan, forward=True, layers=2, re-checked
// here).  The layout stores no state before a step and no x1, so the sets
// exchange through h0p, h1p and x1 series (T, B, H each) the wrapper
// allocates as scratch, stored by the cells as row 11's are.

#include "rnn2_fwd_chain.cuh"

// res (T, B, 12H); h_final (B, H); h0p, h1p, x1 (T, B, H) scratch; carry:
// (2, B, H) zeros (c); flags: 2,048 zeroed words (each set's row groups'
// barriers)
extern "C" int lstm2_train_fwd_legacy_launch(const float* ih0, const float* keep,
                                             const float* w_hh0, const float* w_ih1,
                                             const float* b1, const float* w_hh1,
                                             float* res, float* h_final, float* h0p,
                                             float* h1p, float* x1, float* carry,
                                             unsigned* flags, int batch, int t_len,
                                             int hidden, int upc, int ncl, int rgroups,
                                             int kc, void* stream) {
  const rnn2_fwd::Args a{ih0,    {w_hh0, w_hh1}, w_ih1,  {nullptr, nullptr}, b1,
                         nullptr, nullptr,       carry,  flags,              batch,
                         t_len,  hidden,         upc,    ncl,                rgroups,
                         kc,     keep,           {h0p, h1p}, x1,             res,
                         h_final};
  return rnn2_fwd::launch<rnn2_fwd::LstmLegacyCell, true>(a, (cudaStream_t)stream);
}

extern "C" int lstm2_train_fwd_legacy_max_clusters(int hidden, int upc, int ncl,
                                                   int rgroups, int kc, int* count) {
  return rnn2_fwd::max_clusters<rnn2_fwd::LstmLegacyCell, true>(hidden, upc, ncl, rgroups,
                                                                kc, count);
}

extern "C" int lstm2_train_fwd_legacy_card(int* sms, int* max_smem) {
  return rnn_chain::card_limits(sms, max_smem);
}

RNN_TIMERS_EXPORT(lstm2_train_fwd_legacy)

extern "C" const char* lstm2_train_fwd_legacy_error_string(int err) {
  return rnn_chain::error_string(err, "shape not supported by lstm2_train_fwd_legacy");
}
