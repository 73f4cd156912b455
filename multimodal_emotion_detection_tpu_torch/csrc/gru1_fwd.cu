// One GRU layer's forward recurrence for Hopper (sm_90a): the training
// form with residuals, and the eval form.
//
// Replaces: the XLA scan the JAX package runs for GRU depths other than 2,
// in training and at eval (multimodal_emotion_detection_tpu/ops/
// lstm_vjp.py::_gru_fwd_scan); it produces the residuals that
// gru_bwd_chain_pallas (csrc/gru_bwd_chain.cu here) consumes.  Same
// function as the plain PyTorch versions ops/lstm_kernel.py::
// gru1_train_fwd_reference and gru1_infer_reference: given the layer's
// hoisted input projection ih = x @ w_ih + b_ih (T, B, 3H, time-major),
// run from zero state for t = 0..T-1
//
//   hh = h @ w_hh + b_hh ;  r = sig(ih_r + hh_r) ;  z = sig(ih_z + hh_z)
//   n = tanh(ih_n + r * hh_n) ;  h = (1 - z) n + z h
//
// b_hh stays beside the product: its n third sits inside the reset
// product.  Training form (gru1_fwd_train_launch) stores what the
// backward consumes, in the JAX package's order: gates[t] (B, 4H) =
// [r | z | n | hn] with hn = hh_n, h_prev[t] (B, H), the state BEFORE
// step t, and h_final (B, H) after step T-1.  Eval form
// (gru1_fwd_infer_launch) stores only h: every step's (T, B, H) when the
// next layer needs the series, else two (B, H) slots used in turn, of
// which slot (T-1) % 2 holds the final h.
//
// What bounds it on the H100: the serial chain.  At the big sweep
// config's shape (B=32, T=372, H=512) the recurrent products are 18.72
// GFLOP per layer (~0.28 ms at 67 TFLOP/s) and the training form's
// streams ~0.24 GB (~0.07 ms at 3.35 TB/s), but every step needs the whole
// previous hidden state of all units, so T device-wide exchanges set the
// time.
//
// Design: the shared forward core rnn_fwd_chain.cuh with the GRU cell
// (three gate columns a unit, b_hh beside the product, the carry h for
// the direct term).  The launch plan (UPC, cluster size, row groups,
// chunk) comes from ops/lstm_kernel.py::chain_plan (forward=True) and is
// re-checked here.

#include "rnn_fwd_chain.cuh"

// carry: (B, H) zeros (h); flags: 1,024 zeroed words (the row groups'
// barriers)
extern "C" int gru1_fwd_train_launch(const float* ih, const float* w_hh,
                                     const float* b_hh, float* gates, float* h_prev,
                                     float* h_final, float* carry, unsigned* flags,
                                     int batch, int t_len, int hidden, int upc, int ncl,
                                     int rgroups, int kc, void* stream) {
  const rnn_fwd::Args a{ih,    w_hh,  b_hh,  gates,  h_prev, nullptr, h_final, carry,
                        flags, batch, t_len, hidden, 0,      upc,     ncl,     rgroups,
                        kc};
  return rnn_fwd::launch<rnn_fwd::GruCell, true>(a, (cudaStream_t)stream);
}

extern "C" int gru1_fwd_infer_launch(const float* ih, const float* w_hh,
                                     const float* b_hh, float* h_out, float* carry,
                                     unsigned* flags, int batch, int t_len, int hidden,
                                     int series, int upc, int ncl, int rgroups, int kc,
                                     void* stream) {
  const rnn_fwd::Args a{ih,    w_hh,  b_hh,  nullptr, h_out,  nullptr, nullptr, carry,
                        flags, batch, t_len, hidden,  series, upc,     ncl,     rgroups,
                        kc};
  return rnn_fwd::launch<rnn_fwd::GruCell, false>(a, (cudaStream_t)stream);
}

extern "C" int gru1_fwd_max_clusters(int hidden, int upc, int ncl, int rgroups, int kc,
                                     int* count) {
  return rnn_fwd::max_clusters<rnn_fwd::GruCell>(hidden, upc, ncl, rgroups, kc, count);
}

extern "C" int gru1_fwd_card(int* sms, int* max_smem) {
  return rnn_chain::card_limits(sms, max_smem);
}

RNN_TIMERS_EXPORT(gru1_fwd)

extern "C" const char* gru1_fwd_error_string(int err) {
  return rnn_chain::error_string(err, "shape not supported by gru1_fwd");
}
