// One LSTM layer's reverse dgates chain for Hopper (sm_90a).
//
// Replaces: multimodal_emotion_detection_tpu/ops/lstm_kernel.py::
// lstm_bwd_chain_pallas (kernel body _lstm_bwd_kernel).  Same function as
// the plain PyTorch version ops/lstm_kernel.py::lstm_bwd_chain_reference:
// over one layer's residuals of lstm1_fwd (g (T, B, 4H) gate
// pre-activations, c_prev (T, B, H)), the per-step cotangent from the
// layer above dh_series (T, B, H; may be absent = zeros) and the final
// hidden state's dh_final (B, H), walk t = T-1 .. 0 with carries dh
// (dh_final at the start) and dc (zero):
//
//   (dg[t], dc) = cell_bwd(g[t], c_prev[t], dh + dh_series[t], dc)
//   dh = dg[t] @ w_hh^T
//
// and write dg (T, B, 4H).  The hop into the layer below and the hoisted
// weight gradients are plain matrix products outside (ops/lstm_vjp.py).
// Its bf16 form (lstm_bwd_chain_bf16_launch) reads g and c_prev stored in
// bf16 by lstm1_fwd.cu's bf16 form (the JAX kernel reads them in their
// stored dtype) and writes float32 dg, as JAX does.
//
// What bounds it on the H100: the serial chain.  At the big sweep config's
// shape (B=32, T=372, H=512) the products are 24.96 GFLOP per layer
// (~0.37 ms at 67 TFLOP/s) and the streams ~0.25 GB, but each step needs
// the whole dgates row of the step before, so T device-wide exchanges set
// the time.
//
// Design: the shared core rnn_bwd_chain.cuh with the LSTM cell (gate
// pre-activations and c_prev in, 4 dgates out, dc carried; the exchanged
// row is dg itself, 4H wide).  The launch plan (UPC, cluster size,
// row groups, chunk) comes from ops/lstm_kernel.py::chain_plan and is
// re-checked here.

#include "rnn_bwd_chain.cuh"

// carry: (B, H) zeros (dc); flags: 1,024 zeroed words
// (the row groups' barriers)
extern "C" int lstm_bwd_chain_launch(const float* g, const float* c_prev,
                                     const float* dh_series,
                                     const float* dh_final, const float* w_hh,
                                     float* dg, float* carry,
                                     unsigned* flags, int batch, int t_len,
                                     int hidden, int upc, int ncl, int rgroups,
                                     int kc, void* stream) {
  const rnn_bwd::Args a{g, c_prev, dh_series, dh_final, w_hh, dg, nullptr, carry,
                        flags, batch, t_len, hidden, upc, ncl, rgroups, kc};
  return rnn_bwd::launch<rnn_bwd::LstmCell>(a, (cudaStream_t)stream);
}

// bf16 form: g16 (T, B, 4H) and c_prev16 (T, B, H) stored in bf16; dg
// float32
extern "C" int lstm_bwd_chain_bf16_launch(const rnn_chain::bf16* g16,
                                          const rnn_chain::bf16* c_prev16,
                                          const float* dh_series, const float* dh_final,
                                          const float* w_hh, float* dg, float* carry,
                                          unsigned* flags, int batch, int t_len,
                                          int hidden, int upc, int ncl, int rgroups,
                                          int kc, void* stream) {
  const rnn_bwd::Args a{nullptr, nullptr, dh_series, dh_final, w_hh, dg, nullptr, carry,
                        flags,   batch,   t_len,     hidden,   upc,  ncl, rgroups, kc,
                        g16,     c_prev16};
  return rnn_bwd::launch<rnn_bwd::LstmCell16>(a, (cudaStream_t)stream);
}

// the plan is cached per source, so it answers for both forms: the fewer
// clusters of the two
extern "C" int lstm_bwd_chain_max_clusters(int hidden, int upc, int ncl, int rgroups,
                                           int kc, int* count) {
  int full = 0, half = 0;
  int err = rnn_bwd::max_clusters<rnn_bwd::LstmCell>(hidden, upc, ncl, rgroups, kc, &full);
  if (err != cudaSuccess) return err;
  err = rnn_bwd::max_clusters<rnn_bwd::LstmCell16>(hidden, upc, ncl, rgroups, kc, &half);
  *count = full < half ? full : half;
  return err;
}

extern "C" int lstm_bwd_chain_card(int* sms, int* max_smem) {
  return rnn_bwd::card_limits(sms, max_smem);
}

RNN_TIMERS_EXPORT(lstm_bwd_chain)

extern "C" const char* lstm_bwd_chain_error_string(int err) {
  return rnn_bwd::error_string(err);
}
