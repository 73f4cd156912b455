// 2-layer GRU training forward with residuals, for Hopper (sm_90a).
//
// Replaces: multimodal_emotion_detection_tpu/ops/lstm_kernel.py::
// gru2_train_fwd_residuals (kernel body _gru2_fwd_res_kernel).  Same
// function as the plain PyTorch version ops/lstm_kernel.py::
// gru2_train_fwd_reference: given layer 0's hoisted input projection
// ih0 = x @ w_ih0 + b_ih0 (T, B, 3H, time-major) and the layer-0 -> 1 keep
// mask (T, B, H), run from zero state for t = 0..T-1
//
//   h0 = gru(h0, ih0[t], w_hh0, b_hh0)
//   x1 = h0 * keep[t]
//   h1 = gru(h1, x1 @ w_ih1 + b_ih1, w_hh1, b_hh1)
//
// (gru as in gru2_infer.cu) and store what the backward consumes, in the
// JAX package's layout:
//   packed[t]  (B, 8H) = [r0 | z0 | n0 | hn0 | r1 | z1 | n1 | hn1]
//                        (activations; hn = h_prev @ W_hn + b_hn, before r)
//   h0p[t], h1p[t] (B, H) = the state BEFORE step t;  x1[t] (B, H)
//   finals (2, B, H) = [h0, h1] after step T-1.
// Its bf16 form (gru2_train_fwd_bf16_launch, the JAX kernel's res_dtype
// bfloat16) stores packed, h0p, h1p and x1 in bf16, each rounded to nearest
// even from the float32 value above, and keeps finals float32; its CTAs
// exchange h through float32 h0p / h1p / x1 scratch the wrapper allocates
// beside them, so its finals are the float32 form's bit for bit.
// The older layout (the JAX package's gru2_train_fwd_pallas) is
// gru2_train_fwd_legacy.cu.
//
// What bounds it on the H100: the serial chain, as for gru2_infer.  At the
// GRU config's shape (B=32, T=372, D=64, H=256) the input projection and
// the recurrent products are 15.2 GFLOP and the residual stores ~140 MB
// (~0.23 ms at 67 TFLOP/s, ~0.05 ms at 3.35 TB/s), but every step of each
// layer needs the whole previous hidden state of all units, so T+1 phases
// of device-wide exchanges set the time.
//
// Design: the training form of the 2-layer forward core rnn2_fwd_chain.cuh
// with the GRU cell: layer 0's forward on one CTA set, layer 1's on another
// over [its own h | x1], in one launch, exchanging through the h0p, h1p
// and x1 series it stores.  The launch plan (UPC, cluster size, row
// groups, chunk) comes from ops/lstm_kernel.py::chain_plan (forward=True,
// layers=2) and is re-checked here.

#include "rnn2_fwd_chain.cuh"

// packed (T, B, 8H); h0p, h1p, x1 (T, B, H); finals (2, B, H); carry: (2,
// B, H) zeros; flags: 2,048 zeroed words (each set's row groups' barriers)
extern "C" int gru2_train_fwd_launch(const float* ih0, const float* keep,
                                     const float* w_hh0, const float* b_hh0,
                                     const float* w_ih1, const float* b_ih1,
                                     const float* w_hh1, const float* b_hh1, float* packed,
                                     float* h0p, float* h1p, float* x1, float* finals,
                                     float* carry, unsigned* flags, int batch, int t_len,
                                     int hidden, int upc, int ncl, int rgroups, int kc,
                                     void* stream) {
  const rnn2_fwd::Args a{ih0,     {w_hh0, w_hh1}, w_ih1, {b_hh0, b_hh1}, b_ih1,
                         nullptr, nullptr,        carry, flags,          batch,
                         t_len,   hidden,         upc,   ncl,            rgroups,
                         kc,      keep,           {h0p, h1p}, x1,        packed,
                         finals};
  return rnn2_fwd::launch<rnn2_fwd::GruCell, true>(a, (cudaStream_t)stream);
}

// bf16 form: packed16 (T, B, 8H), h0p16, h1p16, x116 (T, B, H) bf16; the
// float32 exchange (scratch): h0p, h1p (2, B, H), two slots, x1 (T, B, H)
extern "C" int gru2_train_fwd_bf16_launch(
    const float* ih0, const float* keep, const float* w_hh0, const float* b_hh0,
    const float* w_ih1, const float* b_ih1, const float* w_hh1, const float* b_hh1,
    rnn_chain::bf16* packed16, rnn_chain::bf16* h0p16, rnn_chain::bf16* h1p16,
    rnn_chain::bf16* x116, float* h0p, float* h1p, float* x1, float* finals,
    float* carry, unsigned* flags, int batch, int t_len, int hidden, int upc, int ncl,
    int rgroups, int kc, void* stream) {
  const rnn2_fwd::Args a{ih0,     {w_hh0, w_hh1}, w_ih1, {b_hh0, b_hh1}, b_ih1,
                         nullptr, nullptr,        carry, flags,          batch,
                         t_len,   hidden,         upc,   ncl,            rgroups,
                         kc,      keep,           {h0p, h1p}, x1,        nullptr,
                         finals,  packed16,       {h0p16, h1p16}, x116};
  return rnn2_fwd::launch<rnn2_fwd::GruCell16, true>(a, (cudaStream_t)stream);
}

// the plan is cached per source, so it answers for both forms: the fewer
// clusters of the two
extern "C" int gru2_train_fwd_max_clusters(int hidden, int upc, int ncl, int rgroups,
                                           int kc, int* count) {
  int full = 0, half = 0;
  int err = rnn2_fwd::max_clusters<rnn2_fwd::GruCell, true>(hidden, upc, ncl, rgroups,
                                                            kc, &full);
  if (err != cudaSuccess) return err;
  err = rnn2_fwd::max_clusters<rnn2_fwd::GruCell16, true>(hidden, upc, ncl, rgroups, kc,
                                                          &half);
  *count = full < half ? full : half;
  return err;
}

extern "C" int gru2_train_fwd_card(int* sms, int* max_smem) {
  return rnn_chain::card_limits(sms, max_smem);
}

RNN_TIMERS_EXPORT(gru2_train_fwd)

extern "C" const char* gru2_train_fwd_error_string(int err) {
  return rnn_chain::error_string(err, "shape not supported by gru2_train_fwd");
}
