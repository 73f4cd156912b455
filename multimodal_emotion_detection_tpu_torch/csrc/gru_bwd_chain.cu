// One GRU layer's reverse chain for Hopper (sm_90a).
//
// Replaces: multimodal_emotion_detection_tpu/ops/lstm_kernel.py::
// gru_bwd_chain_pallas (kernel body _gru_bwd_kernel, per-step math
// _gru_cell_bwd_k).  Same function as the plain PyTorch version
// ops/lstm_kernel.py::gru_bwd_chain_reference: over one layer's residuals
// of gru1_fwd (gates (T, B, 4H) = [r | z | n | hn], h_prev (T, B, H)), the
// per-step cotangent from the layer above dh_series (T, B, H; may be
// absent = zeros) and the final hidden state's dh_final (B, H), walk
// t = T-1 .. 0 with the carry dh (dh_final at the start):
//
//   dh_t = dh + dh_series[t]
//   dn_pre = dh_t (1 - z)(1 - n^2) ;  dr_pre = dn_pre hn r (1 - r)
//   dz_pre = dh_t (h_prev - n) z (1 - z) ;  dhn = dn_pre r
//   dih[t] = [dr_pre | dz_pre | dn_pre]
//   dh = dh_t z + [dr_pre | dz_pre | dhn] @ w_hh^T
//
// and write dih (T, B, 3H) and dhn (T, B, H).  The TPU kernel writes dhh
// = [dr_pre | dz_pre | dhn] whole; it shares its first 2H lanes with dih,
// so only its n lane is stored here (as csrc/gru2_bwd_chain.cu does).  The
// hop into the layer below and the hoisted weight gradients are plain
// matrix products outside (ops/lstm_vjp.py).
//
// What bounds it on the H100: the serial chain.  At the big sweep
// config's shape (B=32, T=372, H=512) the products are 18.72 GFLOP per
// layer (~0.28 ms at 67 TFLOP/s) and the streams ~0.25 GB, but each step
// needs the whole dhh row of the step before, so T device-wide exchanges
// set the time.
//
// Design: the shared core rnn_bwd_chain.cuh with the GRU cell (r, z, n,
// hn and h_prev in, 3 dih lanes + dhn out, the direct part dh_t z carried;
// the exchanged row is [dih[:, :2H] | dhn], 3H wide, read from the outputs
// themselves).  The launch plan (UPC, cluster size,
// row groups, chunk) comes from ops/lstm_kernel.py::chain_plan and is
// re-checked here.

#include "rnn_bwd_chain.cuh"

// carry: (B, H) holding dh_final (the direct part's start); flags: 1,024
// zeroed words (the row groups' barriers)
extern "C" int gru_bwd_chain_launch(const float* gates, const float* h_prev,
                                    const float* dh_series,
                                    const float* dh_final, const float* w_hh,
                                    float* dih, float* dhn, float* carry,
                                    unsigned* flags, int batch, int t_len,
                                    int hidden, int upc, int ncl, int rgroups,
                                    int kc, void* stream) {
  const rnn_bwd::Args a{gates, h_prev, dh_series, dh_final, w_hh, dih, dhn, carry,
                        flags, batch, t_len, hidden, upc, ncl, rgroups, kc};
  return rnn_bwd::launch<rnn_bwd::GruCell>(a, (cudaStream_t)stream);
}

extern "C" int gru_bwd_chain_max_clusters(int hidden, int upc, int ncl, int rgroups,
                                          int kc, int* count) {
  return rnn_bwd::max_clusters<rnn_bwd::GruCell>(hidden, upc, ncl, rgroups, kc, count);
}

extern "C" int gru_bwd_chain_card(int* sms, int* max_smem) {
  return rnn_bwd::card_limits(sms, max_smem);
}

RNN_TIMERS_EXPORT(gru_bwd_chain)

extern "C" const char* gru_bwd_chain_error_string(int err) {
  return rnn_bwd::error_string(err);
}
