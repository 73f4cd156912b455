// 2-layer GRU training forward in the legacy layout for Hopper (sm_90a).
//
// Replaces: multimodal_emotion_detection_tpu/ops/lstm_kernel.py::
// gru2_train_fwd_pallas (kernel body _gru2_fwd_train_kernel).  Same
// function as the plain PyTorch version ops/lstm_kernel.py::
// gru2_train_fwd_legacy_reference: given layer 0's hoisted input
// projection ih0 = x @ w_ih0 + b_ih0 (T, B, 3H, time-major) and the
// layer-0 -> 1 keep mask (T, B, H), run from zero state for t = 0..T-1
//
//   h0 = gru(h0, ih0[t], w_hh0, b_hh0)
//   x1 = h0 * keep[t]
//   h1 = gru(h1, x1 @ w_ih1 + b_ih1, w_hh1, b_hh1)
//
// (gru as in gru2_infer.cu) and store the older layout of the TPU kernel
// _gru2_fwd_train_kernel:
//   res[t] (B, 10H) = [r0 | z0 | n0 | hn0 | h0 | r1 | z1 | n1 | hn1 | h1],
//                     activations, hn = h_prev @ W_hn + b_hn before r, and
//                     h the state AFTER step t
//   h_final (B, H) = h1 after step T-1.
// The residual-native layout (row 14) is gru2_train_fwd.cu.
//
// What bounds it on the H100: the serial chain, as for gru2_infer.  At the
// GRU config's shape (B=32, T=372, D=64, H=256) the input projection and
// the recurrent products are 15.2 GFLOP and the residual stores ~122 MB
// (~0.23 ms at 67 TFLOP/s, ~0.04 ms at 3.35 TB/s), but every step of each
// layer needs the whole previous hidden state of all units, so T+1 phases
// of device-wide exchanges set the time.
//
// Design: the training form of the 2-layer forward core rnn2_fwd_chain.cuh
// with the legacy GRU cell (GruLegacyCell, gru2_train_fwd.cu's GruCell
// storing the 10H rows): layer 0's forward on one CTA set, layer 1's on
// another over [its own h | x1], in one launch, on row 14's launch plan
// (ops/lstm_kernel.py::chain_plan, forward=True, layers=2, re-checked
// here).  The layout stores no state before a step and no x1, so the sets
// exchange through h0p, h1p and x1 series (T, B, H each) the wrapper
// allocates as scratch, stored by the cells as row 14's are.

#include "rnn2_fwd_chain.cuh"

// res (T, B, 10H); h_final (B, H); h0p, h1p, x1 (T, B, H) scratch; carry:
// (2, B, H) zeros (h); flags: 2,048 zeroed words (each set's row groups'
// barriers)
extern "C" int gru2_train_fwd_legacy_launch(const float* ih0, const float* keep,
                                            const float* w_hh0, const float* b_hh0,
                                            const float* w_ih1, const float* b_ih1,
                                            const float* w_hh1, const float* b_hh1,
                                            float* res, float* h_final, float* h0p,
                                            float* h1p, float* x1, float* carry,
                                            unsigned* flags, int batch, int t_len,
                                            int hidden, int upc, int ncl, int rgroups,
                                            int kc, void* stream) {
  const rnn2_fwd::Args a{ih0,     {w_hh0, w_hh1}, w_ih1, {b_hh0, b_hh1}, b_ih1,
                         nullptr, nullptr,        carry, flags,          batch,
                         t_len,   hidden,         upc,   ncl,            rgroups,
                         kc,      keep,           {h0p, h1p}, x1,        res,
                         h_final};
  return rnn2_fwd::launch<rnn2_fwd::GruLegacyCell, true>(a, (cudaStream_t)stream);
}

extern "C" int gru2_train_fwd_legacy_max_clusters(int hidden, int upc, int ncl,
                                                  int rgroups, int kc, int* count) {
  return rnn2_fwd::max_clusters<rnn2_fwd::GruLegacyCell, true>(hidden, upc, ncl, rgroups,
                                                               kc, count);
}

extern "C" int gru2_train_fwd_legacy_card(int* sms, int* max_smem) {
  return rnn_chain::card_limits(sms, max_smem);
}

RNN_TIMERS_EXPORT(gru2_train_fwd_legacy)

extern "C" const char* gru2_train_fwd_legacy_error_string(int err) {
  return rnn_chain::error_string(err, "shape not supported by gru2_train_fwd_legacy");
}
