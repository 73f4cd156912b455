// 2-layer GRU inference (final hidden state only) for Hopper (sm_90a).
//
// Replaces: multimodal_emotion_detection_tpu/ops/lstm_kernel.py::
// gru2_infer_pallas (kernel body _gru2_infer_kernel).  Same function as the
// plain PyTorch version ops/lstm_kernel.py::gru2_infer_reference: given
// layer 0's hoisted input projection ih0 = x @ w_ih0 + b_ih0 (B, T, 3H), run
//
//   h0 = gru(h0, ih0[:, t], w_hh0, b_hh0)
//   h1 = gru(h1, h0 @ w_ih1 + b_ih1, w_hh1, b_hh1)
//
// for t = 0..T-1 from zero state; the final h1 (B, H) is slot (T-1) % 2 of
// h1.  Gate order r, z, n; gru(h, ih, W, b): hh = h @ W + b,
// r = sig(ih_r + hh_r), z = sig(ih_z + hh_z), n = tanh(ih_n + r * hh_n),
// h' = (1 - z) n + z h.  b_hh stays beside h @ W: its n third sits inside
// the reset product.
//
// What bounds it on the H100: the serial chain.  At the GRU config's shape
// (B=32, T=372, D=64, H=256) the input projection and the three recurrent
// products are 15.2 GFLOP (~0.23 ms at the 67 TFLOP/s float32 rate); but
// every step of each layer needs the whole previous hidden state of all
// units, so T+1 phases of device-wide exchanges set the time.
//
// Design: the 2-layer forward core rnn2_fwd_chain.cuh with the GRU cell:
// layer 0's forward on one CTA set (storing the h0 series), layer 1's on
// another over its own h and h0, in one launch.  The launch plan (UPC,
// cluster size, row groups, chunk) comes from ops/lstm_kernel.py::
// chain_plan (forward=True, layers=2) and is re-checked here.

#include "rnn2_fwd_chain.cuh"

// h0: (T, B, H) for layer 0's series; h1: (2, B, H) slots; carry: (2, B,
// H) zeros; flags: 2,048 zeroed words (each set's row groups' barriers)
extern "C" int gru2_infer_launch(const float* ih0, const float* w_hh0,
                                 const float* b_hh0, const float* w_ih1,
                                 const float* b_ih1, const float* w_hh1,
                                 const float* b_hh1, float* h0, float* h1, float* carry,
                                 unsigned* flags, int batch, int t_len, int hidden,
                                 int upc, int ncl, int rgroups, int kc, void* stream) {
  const rnn2_fwd::Args a{ih0,  {w_hh0, w_hh1}, w_ih1, {b_hh0, b_hh1}, b_ih1,  h0,
                         h1,   carry,          flags, batch,          t_len,  hidden,
                         upc,  ncl,            rgroups, kc};
  return rnn2_fwd::launch<rnn2_fwd::GruCell, false>(a, (cudaStream_t)stream);
}

extern "C" int gru2_infer_max_clusters(int hidden, int upc, int ncl, int rgroups, int kc,
                                       int* count) {
  return rnn2_fwd::max_clusters<rnn2_fwd::GruCell, false>(hidden, upc, ncl, rgroups, kc,
                                                         count);
}

extern "C" int gru2_infer_card(int* sms, int* max_smem) {
  return rnn_chain::card_limits(sms, max_smem);
}

RNN_TIMERS_EXPORT(gru2_infer)

extern "C" const char* gru2_infer_error_string(int err) {
  return rnn_chain::error_string(err, "shape not supported by gru2_infer");
}
