// 2-layer GRU reverse chain for Hopper (sm_90a).
//
// Replaces: multimodal_emotion_detection_tpu/ops/lstm_kernel.py::
// gru2_bwd_chain_res_padded (kernel body _gru2_bwd_res_kernel, per-step
// math _gru_cell_bwd_k).  Same function as the plain PyTorch version
// ops/lstm_kernel.py::gru2_bwd_chain_reference: over the residuals of
// gru2_train_fwd (packed (T, B, 8H) = [r0|z0|n0|hn0|r1|z1|n1|hn1], the
// states before each step h0p, h1p (T, B, H), the keep mask (T, B, H)) and
// the cotangent of layer 1's final hidden state dh_final (B, H), walk
// t = T-1 .. 0 with carries dh1 (dh_final at the start) and dh0 (zero):
//
//   (dih1, dhn1, dd1) = cell_bwd(dh1, h1p[t], r1, z1, n1, hn1)
//   dh1 = dd1 + [dih1[:, :2H] | dhn1] @ w_hh1^T ;  dx1 = dih1 @ w_ih1^T
//   (dih0, dhn0, dd0) = cell_bwd(dh0 + dx1 * keep[t], h0p[t], r0, ..)
//   dh0 = dd0 + [dih0[:, :2H] | dhn0] @ w_hh0^T
//
// cell_bwd(dh, h_prev, r, z, n, hn): dn_pre = dh (1 - z)(1 - n^2),
// dr_pre = dn_pre hn r (1 - r), dz_pre = dh (h_prev - n) z (1 - z),
// dih = [dr_pre | dz_pre | dn_pre], dhn = dn_pre r, dd = dh z.  It writes
// dih0, dih1 (T, B, 3H) and dhn0, dhn1 (T, B, H): dhh = [dih[:, :2H] | dhn]
// shares its first 2H lanes with dih, so only its n lane is stored.  The
// hoisted weight gradients are plain matrix products outside
// (ops/lstm_vjp.py).  The legacy layout's chain (row 10) is
// gru2_bwd_chain_legacy.cu.  Its bf16 form (gru2_bwd_chain_bf16_launch,
// the JAX kernel over bf16 residuals) reads packed, h0p and h1p in bf16 and
// writes dih0, dhn0, dih1 and dhn1 in bf16, each rounded from the float32
// value, its CTAs exchanging the float32 series through scratch the
// wrapper allocates.
//
// What bounds it on the H100: the serial chain.  At the GRU config's shape
// (B=32, T=372, H=256) the three products per step are 14.0 GFLOP and the
// streams 234 MB (~0.21 ms at 67 TFLOP/s), but each layer's step needs
// the whole exchanged row of its step before, so T+1 phases of device-wide
// exchanges set the time.
//
// Design: the 2-layer reverse core rnn2_bwd_chain.cuh with the GRU cell:
// layer 1's chain on one CTA set, layer 0's on another over its own row and
// layer 1's dih (the hop), in one launch.  The launch plan (UPC, cluster
// size, row groups, chunk) comes from ops/lstm_kernel.py::chain_plan
// (layers=2) and is re-checked here.

#include "rnn2_bwd_chain.cuh"

// carry: (2, B, H) = [zeros | dh_final]; flags: 2,048 zeroed words (each
// set's row groups' barriers)
extern "C" int gru2_bwd_chain_launch(const float* packed, const float* h0p,
                                     const float* h1p, const float* keep,
                                     const float* w_hh0, const float* w_hh1,
                                     const float* w_ih1, float* dih0, float* dhn0,
                                     float* dih1, float* dhn1, float* carry,
                                     unsigned* flags, int batch, int t_len, int hidden,
                                     int upc, int ncl, int rgroups, int kc, void* stream) {
  const rnn2_bwd::Args a{packed, {h0p, h1p}, keep, nullptr, {w_hh0, w_hh1},
                         w_ih1, {dih0, dih1}, {dhn0, dhn1}, carry, flags, batch,
                         t_len, hidden, upc, ncl, rgroups, kc};
  return rnn2_bwd::launch<rnn2_bwd::GruCell>(a, (cudaStream_t)stream);
}

// bf16 form: packed16 (T, B, 8H), h0p16, h1p16 (T, B, H) and dih0_16, dhn0_16,
// dih1_16, dhn1_16 bf16; the float32 exchange (scratch): dih0 (2, B, 3H) and
// dhn0 (2, B, H), two slots, dih1 (T, B, 3H) and dhn1 (T, B, H)
extern "C" int gru2_bwd_chain_bf16_launch(
    const rnn_chain::bf16* packed16, const rnn_chain::bf16* h0p16,
    const rnn_chain::bf16* h1p16, const float* keep, const float* w_hh0,
    const float* w_hh1, const float* w_ih1, rnn_chain::bf16* dih0_16,
    rnn_chain::bf16* dhn0_16, rnn_chain::bf16* dih1_16, rnn_chain::bf16* dhn1_16,
    float* dih0, float* dhn0, float* dih1, float* dhn1, float* carry, unsigned* flags,
    int batch, int t_len, int hidden, int upc, int ncl, int rgroups, int kc,
    void* stream) {
  rnn2_bwd::Args a{nullptr, {nullptr, nullptr}, keep, nullptr, {w_hh0, w_hh1},
                   w_ih1, {dih0, dih1}, {dhn0, dhn1}, carry, flags, batch,
                   t_len, hidden, upc, ncl, rgroups, kc};
  a.res16 = packed16;
  a.prev16[0] = h0p16;
  a.prev16[1] = h1p16;
  a.out16[0] = dih0_16;
  a.out16[1] = dih1_16;
  a.out_n16[0] = dhn0_16;
  a.out_n16[1] = dhn1_16;
  return rnn2_bwd::launch<rnn2_bwd::GruCell16>(a, (cudaStream_t)stream);
}

// the plan is cached per source, so it answers for both forms: the fewer
// clusters of the two
extern "C" int gru2_bwd_chain_max_clusters(int hidden, int upc, int ncl, int rgroups,
                                           int kc, int* count) {
  int full = 0, half = 0;
  int err = rnn2_bwd::max_clusters<rnn2_bwd::GruCell>(hidden, upc, ncl, rgroups, kc,
                                                      &full);
  if (err != cudaSuccess) return err;
  err = rnn2_bwd::max_clusters<rnn2_bwd::GruCell16>(hidden, upc, ncl, rgroups, kc, &half);
  *count = full < half ? full : half;
  return err;
}

extern "C" int gru2_bwd_chain_card(int* sms, int* max_smem) {
  return rnn_chain::card_limits(sms, max_smem);
}

RNN_TIMERS_EXPORT(gru2_bwd_chain)

extern "C" const char* gru2_bwd_chain_error_string(int err) {
  return rnn_chain::error_string(err, "shape not supported by gru2_bwd_chain");
}
