// One LSTM layer's forward recurrence for Hopper (sm_90a): the training
// form with residuals, and the eval form.
//
// Replaces: multimodal_emotion_detection_tpu/ops/lstm_kernel.py::
// lstm1_train_fwd_pallas (kernel body _lstm1_fwd_train_kernel), and the
// XLA scan the JAX package runs at eval for LSTM depths other than 2
// (ops/lstm_vjp.py::_fwd_scan).  Same function as the plain PyTorch
// versions ops/lstm_kernel.py::lstm1_train_fwd_reference and
// lstm1_infer_reference: given the layer's hoisted input projection
// ih = x @ w_ih + b (T, B, 4H, time-major), run from zero state for
// t = 0..T-1
//
//   g = ih[t] + h @ w_hh ;  (h, c) = cell(g, c)
//
// Training form (lstm1_fwd_train_launch) stores what the backward
// consumes, in the JAX package's layout: g[t] (B, 4H), h_prev[t] and
// c_prev[t] (B, H), the state BEFORE step t, and finals (B, 2H) = [h | c]
// after step T-1; its bf16 form (lstm1_fwd_train_bf16_launch, the JAX
// kernel's res_dtype bfloat16) stores g and c_prev in bf16, each rounded to
// nearest even from the float32 value, and h_prev and finals float32 (h_prev
// is also its exchange).  Eval form (lstm1_fwd_infer_launch) stores only h:
// every step's (T, B, H) when the next layer needs the series, else two
// (B, H) slots used in turn, of which slot (T-1) % 2 holds the final h.
//
// What bounds it on the H100: the serial chain.  At the big sweep config's
// shape (B=32, T=372, H=512) the recurrent products are 24.96 GFLOP per
// layer (~0.37 ms at 67 TFLOP/s) and the training form's streams ~0.24 GB
// (~0.07 ms at 3.35 TB/s), but every step needs the whole previous hidden
// state of all units, so T device-wide exchanges set the time.
//
// Design: the shared forward core rnn_fwd_chain.cuh with the LSTM cell
// (four gate columns a unit, the carry c).  The launch plan (UPC, cluster
// size, row groups, chunk) comes from ops/lstm_kernel.py::chain_plan
// (forward=True) and is re-checked here.

#include "rnn_fwd_chain.cuh"

// carry: (B, H) zeros (c); flags: 1,024 zeroed words (the row groups'
// barriers)
extern "C" int lstm1_fwd_train_launch(const float* ih, const float* w_hh, float* g,
                                      float* h_prev, float* c_prev, float* finals,
                                      float* carry, unsigned* flags, int batch,
                                      int t_len, int hidden, int upc, int ncl,
                                      int rgroups, int kc, void* stream) {
  const rnn_fwd::Args a{ih,     w_hh,  nullptr, g,     h_prev, c_prev, finals, carry,
                        flags,  batch, t_len,   hidden, 0,     upc,    ncl,    rgroups,
                        kc};
  return rnn_fwd::launch<rnn_fwd::LstmCell, true>(a, (cudaStream_t)stream);
}

extern "C" int lstm1_fwd_infer_launch(const float* ih, const float* w_hh, float* h_out,
                                      float* carry, unsigned* flags, int batch,
                                      int t_len, int hidden, int series, int upc,
                                      int ncl, int rgroups, int kc, void* stream) {
  const rnn_fwd::Args a{ih,    w_hh,  nullptr, nullptr, h_out, nullptr, nullptr, carry,
                        flags, batch, t_len,   hidden,  series, upc,    ncl,     rgroups,
                        kc};
  return rnn_fwd::launch<rnn_fwd::LstmCell, false>(a, (cudaStream_t)stream);
}

// bf16 form: g16 (T, B, 4H) and c_prev16 (T, B, H) bf16; h_prev, finals
// float32
extern "C" int lstm1_fwd_train_bf16_launch(const float* ih, const float* w_hh,
                                           rnn_chain::bf16* g16, float* h_prev,
                                           rnn_chain::bf16* c_prev16, float* finals,
                                           float* carry, unsigned* flags, int batch,
                                           int t_len, int hidden, int upc, int ncl,
                                           int rgroups, int kc, void* stream) {
  const rnn_fwd::Args a{ih,    w_hh,  nullptr, nullptr, h_prev, nullptr, finals, carry,
                        flags, batch, t_len,   hidden,  0,      upc,     ncl,    rgroups,
                        kc,    g16,   c_prev16};
  return rnn_fwd::launch<rnn_fwd::LstmCell16, true>(a, (cudaStream_t)stream);
}

// the plan is cached per source, so it answers for every form: the fewest
// clusters of the three
extern "C" int lstm1_fwd_max_clusters(int hidden, int upc, int ncl, int rgroups, int kc,
                                      int* count) {
  int full = 0, half = 0;
  int err = rnn_fwd::max_clusters<rnn_fwd::LstmCell>(hidden, upc, ncl, rgroups, kc, &full);
  if (err != cudaSuccess) return err;
  err = rnn_fwd::max_clusters<rnn_fwd::LstmCell16, false>(hidden, upc, ncl, rgroups, kc,
                                                          &half);
  *count = full < half ? full : half;
  return err;
}

extern "C" int lstm1_fwd_card(int* sms, int* max_smem) {
  return rnn_chain::card_limits(sms, max_smem);
}

RNN_TIMERS_EXPORT(lstm1_fwd)

extern "C" const char* lstm1_fwd_error_string(int err) {
  return rnn_chain::error_string(err, "shape not supported by lstm1_fwd");
}
