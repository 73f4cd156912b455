// 2-layer LSTM inference (final hidden state only) for Hopper (sm_90a).
//
// Replaces: multimodal_emotion_detection_tpu/ops/lstm_kernel.py::
// lstm2_infer_pallas (kernel body _lstm2_kernel).  Same function as the
// plain PyTorch version ops/lstm_kernel.py::lstm2_infer_reference: given
// layer 0's hoisted input projection ih0 = x @ w_ih0 + b0 (B, T, 4H), run
//
//   g0 = ih0[:, t] + h0 @ w_hh0              ; (h0, c0) = cell(g0, c0)
//   g1 = (h0 @ w_ih1 + b1) + h1 @ w_hh1      ; (h1, c1) = cell(g1, c1)
//
// for t = 0..T-1 from zero state; the final h1 (B, H) is slot (T-1) % 2 of
// h1.  Gate order i, f, g, o; cell: c = sig(f) c + sig(i) tanh(g),
// h = sig(o) tanh(c).
//
// What bounds it on the H100: the serial chain.  At the flagship shape
// (B=32, T=372, D=64, H=256) the input projection and the three recurrent
// products are 20.3 GFLOP (~0.30 ms at the 67 TFLOP/s float32 rate); but
// every step of each layer needs the whole previous hidden state of all
// units, so T+1 phases of device-wide exchanges set the time.
//
// Design: the 2-layer forward core rnn2_fwd_chain.cuh with the LSTM cell:
// layer 0's forward on one CTA set (storing the h0 series), layer 1's on
// another over its own h and h0, in one launch.  The launch plan (UPC,
// cluster size, row groups, chunk) comes from ops/lstm_kernel.py::
// chain_plan (forward=True, layers=2) and is re-checked here.

#include "rnn2_fwd_chain.cuh"

// h0: (T, B, H) for layer 0's series; h1: (2, B, H) slots; carry: (2, B,
// H) zeros (c); flags: 2,048 zeroed words (each set's row groups' barriers)
extern "C" int lstm2_infer_launch(const float* ih0, const float* w_hh0,
                                  const float* w_ih1, const float* b1,
                                  const float* w_hh1, float* h0, float* h1, float* carry,
                                  unsigned* flags, int batch, int t_len, int hidden,
                                  int upc, int ncl, int rgroups, int kc, void* stream) {
  const rnn2_fwd::Args a{ih0, {w_hh0, w_hh1}, w_ih1, {nullptr, nullptr}, b1, h0, h1,
                         carry, flags, batch, t_len, hidden, upc, ncl, rgroups, kc};
  return rnn2_fwd::launch<rnn2_fwd::LstmCell, false>(a, (cudaStream_t)stream);
}

extern "C" int lstm2_infer_max_clusters(int hidden, int upc, int ncl, int rgroups, int kc,
                                        int* count) {
  return rnn2_fwd::max_clusters<rnn2_fwd::LstmCell, false>(hidden, upc, ncl, rgroups, kc,
                                                          count);
}

extern "C" int lstm2_infer_card(int* sms, int* max_smem) {
  return rnn_chain::card_limits(sms, max_smem);
}

RNN_TIMERS_EXPORT(lstm2_infer)

extern "C" const char* lstm2_infer_error_string(int err) {
  return rnn_chain::error_string(err, "shape not supported by lstm2_infer");
}
