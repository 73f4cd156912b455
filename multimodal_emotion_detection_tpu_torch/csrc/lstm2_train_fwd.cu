// 2-layer LSTM training forward with residuals, for Hopper (sm_90a).
//
// Replaces: multimodal_emotion_detection_tpu/ops/lstm_kernel.py::
// lstm2_train_fwd_residuals (kernel body _lstm2_fwd_res_kernel), with the
// gates and, as its store_gates=False form, without them.  Same function as
// the plain PyTorch version ops/lstm_kernel.py::lstm2_train_fwd_reference:
// given layer 0's hoisted input projection ih0 = x @ w_ih0 + b0 (T, B, 4H,
// time-major) and the layer-0 -> 1 keep mask (T, B, H), run from zero
// state for t = 0..T-1
//
//   g0 = ih0[t] + h0 @ w_hh0                 ; (h0, c0) = cell(g0, c0)
//   x1 = h0 * keep[t]
//   g1 = (x1 @ w_ih1 + b1) + h1 @ w_hh1      ; (h1, c1) = cell(g1, c1)
//
// and store what the backward consumes, in the JAX package's layout:
//   packed[t]  (B, 10H) = [g0 | g1 | c0_prev | c1_prev], or in the no-gates
//              form (lstm2_train_fwd_nogates_launch; for the reverse chain
//              that recomputes the gates, lstm2_bwd_chain_remat.cu)
//              (B, 2H) = [c0_prev | c1_prev]
//   h0p[t], h1p[t] (B, H) = the state BEFORE step t;  x1[t] (B, H)
//   finals (4, B, H) = [h0, c0, h1, c1] after step T-1.
// Its bf16 forms (lstm2_train_fwd_bf16_launch and, without the gates,
// lstm2_train_fwd_nogates_bf16_launch: the JAX kernel's res_dtype
// bfloat16, ops/lstm_kernel.py::lstm2_train_fwd_residuals with res_dtype
// torch.bfloat16) store packed, h0p, h1p and x1 in bf16, each rounded to
// nearest even from the float32 value above, and keep finals float32;
// their CTAs exchange h through float32 h0p / h1p / x1 scratch the wrapper
// allocates beside them, so their finals are the float32 forms' bit for
// bit (the no-gates bf16 form, for the remat chain's bf16 form, stores ~49
// MB at the flagship shape; its bound stays the float32 products').
// The older layout (the JAX package's lstm2_train_fwd_pallas) is
// lstm2_train_fwd_legacy.cu, the same core with the legacy cell.
//
// What bounds it on the H100: the serial chain, as for lstm2_infer.  At the
// flagship shape (B=32, T=372, H=256) the recurrent products are 18.7 GFLOP
// and the residual stores 158 MB (~0.33 ms at 67 TFLOP/s, ~0.05 ms at
// 3.35 TB/s), but every step of each layer needs the whole previous hidden
// state of all units, so T+1 phases of device-wide exchanges set the time.
//
// Design: the training form of the 2-layer forward core rnn2_fwd_chain.cuh
// with the LSTM cell (LstmCell, or LstmNoGatesCell without the gates):
// layer 0's forward on one CTA set, layer 1's on another over [its own h |
// x1], in one launch, exchanging through the h0p, h1p and x1 series it
// stores.  The launch plan (UPC, cluster size, row groups, chunk) comes from
// ops/lstm_kernel.py::chain_plan (forward=True, layers=2) and is re-checked
// here.

#include "rnn2_fwd_chain.cuh"

namespace {

template <class Cell>
int launch_form(const float* ih0, const float* keep, const float* w_hh0,
                const float* w_ih1, const float* b1, const float* w_hh1, float* packed,
                float* h0p, float* h1p, float* x1, float* finals, float* carry,
                unsigned* flags, int batch, int t_len, int hidden, int upc, int ncl,
                int rgroups, int kc, void* stream, rnn_chain::bf16* packed16 = nullptr,
                rnn_chain::bf16* h0p16 = nullptr, rnn_chain::bf16* h1p16 = nullptr,
                rnn_chain::bf16* x116 = nullptr) {
  const rnn2_fwd::Args a{ih0,    {w_hh0, w_hh1}, w_ih1,  {nullptr, nullptr}, b1,
                         nullptr, nullptr,       carry,  flags,              batch,
                         t_len,  hidden,         upc,    ncl,                rgroups,
                         kc,     keep,           {h0p, h1p}, x1,             packed,
                         finals, packed16,       {h0p16, h1p16}, x116};
  return rnn2_fwd::launch<Cell, true>(a, (cudaStream_t)stream);
}

}  // namespace

// packed (T, B, 10H); h0p, h1p, x1 (T, B, H); finals (4, B, H); carry: (2,
// B, H) zeros (c); flags: 2,048 zeroed words (each set's row groups'
// barriers)
extern "C" int lstm2_train_fwd_launch(const float* ih0, const float* keep,
                                      const float* w_hh0, const float* w_ih1,
                                      const float* b1, const float* w_hh1, float* packed,
                                      float* h0p, float* h1p, float* x1, float* finals,
                                      float* carry, unsigned* flags, int batch,
                                      int t_len, int hidden, int upc, int ncl,
                                      int rgroups, int kc, void* stream) {
  return launch_form<rnn2_fwd::LstmCell>(ih0, keep, w_hh0, w_ih1, b1, w_hh1, packed, h0p,
                                         h1p, x1, finals, carry, flags, batch, t_len,
                                         hidden, upc, ncl, rgroups, kc, stream);
}

// packed (T, B, 2H) = [c0_prev | c1_prev]: no gates
extern "C" int lstm2_train_fwd_nogates_launch(const float* ih0, const float* keep,
                                              const float* w_hh0, const float* w_ih1,
                                              const float* b1, const float* w_hh1,
                                              float* packed, float* h0p, float* h1p,
                                              float* x1, float* finals, float* carry,
                                              unsigned* flags, int batch, int t_len,
                                              int hidden, int upc, int ncl, int rgroups,
                                              int kc, void* stream) {
  return launch_form<rnn2_fwd::LstmNoGatesCell>(ih0, keep, w_hh0, w_ih1, b1, w_hh1,
                                                packed, h0p, h1p, x1, finals, carry,
                                                flags, batch, t_len, hidden, upc, ncl,
                                                rgroups, kc, stream);
}

// bf16 form: packed16 (T, B, 10H), h0p16, h1p16, x116 (T, B, H) bf16; the
// float32 exchange (scratch): h0p, h1p (2, B, H), two slots, x1 (T, B, H)
extern "C" int lstm2_train_fwd_bf16_launch(
    const float* ih0, const float* keep, const float* w_hh0, const float* w_ih1,
    const float* b1, const float* w_hh1, rnn_chain::bf16* packed16,
    rnn_chain::bf16* h0p16, rnn_chain::bf16* h1p16, rnn_chain::bf16* x116, float* h0p,
    float* h1p, float* x1, float* finals, float* carry, unsigned* flags, int batch,
    int t_len, int hidden, int upc, int ncl, int rgroups, int kc, void* stream) {
  return launch_form<rnn2_fwd::LstmCell16>(ih0, keep, w_hh0, w_ih1, b1, w_hh1, nullptr,
                                           h0p, h1p, x1, finals, carry, flags, batch,
                                           t_len, hidden, upc, ncl, rgroups, kc, stream,
                                           packed16, h0p16, h1p16, x116);
}

// bf16 form without the gates: packed16 (T, B, 2H) = [c0_prev | c1_prev],
// h0p16, h1p16, x116 (T, B, H) bf16; the float32 exchange (scratch) as the
// bf16 form's
extern "C" int lstm2_train_fwd_nogates_bf16_launch(
    const float* ih0, const float* keep, const float* w_hh0, const float* w_ih1,
    const float* b1, const float* w_hh1, rnn_chain::bf16* packed16,
    rnn_chain::bf16* h0p16, rnn_chain::bf16* h1p16, rnn_chain::bf16* x116, float* h0p,
    float* h1p, float* x1, float* finals, float* carry, unsigned* flags, int batch,
    int t_len, int hidden, int upc, int ncl, int rgroups, int kc, void* stream) {
  return launch_form<rnn2_fwd::LstmNoGatesCell16>(
      ih0, keep, w_hh0, w_ih1, b1, w_hh1, nullptr, h0p, h1p, x1, finals, carry, flags,
      batch, t_len, hidden, upc, ncl, rgroups, kc, stream, packed16, h0p16, h1p16, x116);
}

// the plan is cached per source, so it answers for every form: the fewest
// clusters of the four
extern "C" int lstm2_train_fwd_max_clusters(int hidden, int upc, int ncl, int rgroups,
                                            int kc, int* count) {
  int forms[4] = {0, 0, 0, 0};
  int err = rnn2_fwd::max_clusters<rnn2_fwd::LstmCell, true>(hidden, upc, ncl, rgroups,
                                                             kc, &forms[0]);
  if (err != cudaSuccess) return err;
  err = rnn2_fwd::max_clusters<rnn2_fwd::LstmNoGatesCell, true>(hidden, upc, ncl,
                                                                rgroups, kc, &forms[1]);
  if (err != cudaSuccess) return err;
  err = rnn2_fwd::max_clusters<rnn2_fwd::LstmCell16, true>(hidden, upc, ncl, rgroups,
                                                           kc, &forms[2]);
  if (err != cudaSuccess) return err;
  err = rnn2_fwd::max_clusters<rnn2_fwd::LstmNoGatesCell16, true>(hidden, upc, ncl,
                                                                  rgroups, kc, &forms[3]);
  *count = forms[0];
  for (int i = 1; i < 4; ++i) *count = forms[i] < *count ? forms[i] : *count;
  return err;
}

extern "C" int lstm2_train_fwd_card(int* sms, int* max_smem) {
  return rnn_chain::card_limits(sms, max_smem);
}

RNN_TIMERS_EXPORT(lstm2_train_fwd)

extern "C" const char* lstm2_train_fwd_error_string(int err) {
  return rnn_chain::error_string(err, "shape not supported by lstm2_train_fwd");
}
