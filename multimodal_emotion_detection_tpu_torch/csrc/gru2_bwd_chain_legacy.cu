// 2-layer GRU reverse chain in the legacy layout for Hopper (sm_90a).
//
// Replaces: multimodal_emotion_detection_tpu/ops/lstm_kernel.py::
// gru2_bwd_chain_pallas (kernel body _gru2_bwd_kernel, per-step math
// _gru_cell_bwd_k).  Same function as the plain PyTorch version
// ops/lstm_kernel.py::gru2_bwd_chain_legacy_reference: over the older
// layout's residuals res0, res1 (T, B, 5H) = [h_prev | r | z | n | hn], the
// keep mask (T, B, H), where one is given the sequence output's cotangent
// dys (T, B, H; without it the stream is not read) and the cotangent of
// layer 1's final hidden state dh_final (B, H), walk t = T-1 .. 0 with
// carries dh1 (dh_final at the start) and dh0 (zero):
//
//   (dih1, dhn1, dd1) = cell_bwd(dh1 + dys[t], h1p[t], r1, z1, n1, hn1)
//   dh1 = dd1 + [dih1[:, :2H] | dhn1] @ w_hh1^T ;  dx1 = dih1 @ w_ih1^T
//   (dih0, dhn0, dd0) = cell_bwd(dh0 + dx1 * keep[t], h0p[t], r0, ..)
//   dh0 = dd0 + [dih0[:, :2H] | dhn0] @ w_hh0^T
//
// cell_bwd(dh, h_prev, r, z, n, hn): dn_pre = dh (1 - z)(1 - n^2),
// dr_pre = dn_pre hn r (1 - r), dz_pre = dh (h_prev - n) z (1 - z),
// dih = [dr_pre | dz_pre | dn_pre], dhn = dn_pre r, dd = dh z.  It writes,
// as the TPU kernel does, the full dhh: out (T, B, 12H) = [dih0 | dhh0 |
// dih1 | dhh1], whose r and z lanes of dhh are copies of dih's.  The
// hoisted weight gradients are plain matrix products outside
// (ops/lstm_vjp.py).
//
// What bounds it on the H100: the serial chain.  At the GRU config's shape
// (B=32, T=372, H=256) the three products per step are 14.0 GFLOP and the
// streams 283 MB (~0.21 ms at 67 TFLOP/s), but each step needs the whole
// dhh / dih row of the step before, so T+1 phases of device-wide exchanges
// set the time.
//
// Design: the 2-layer reverse core rnn2_bwd_chain.cuh with the legacy GRU
// cell (GruLegacyCell, gru2_bwd_chain.cu's GruCell over the legacy
// series, exchanging the contiguous dhh lanes of the 12H rows and adding
// dys to layer 1's dh): layer 1's chain on one CTA set, layer 0's on
// another over its own dhh and layer 1's dih (the hop), in one launch, on
// row 15's launch plan (ops/lstm_kernel.py::chain_plan, layers=2,
// re-checked here).  The wrapper packs the r, z, n, hn series of both
// layers into row 15's residual rows (T, B, 8H), which the cell reads as
// GruCell does.

#include "rnn2_bwd_chain.cuh"

// h0p / h1p: (T, B, H); res: (T, B, 8H), layer l's [r | z | n | hn] at 4H
// l; dys: (T, B, H) or null; out: (T, B, 12H); carry: (2, B, H) = [zeros |
// dh_final]; flags: 2,048 zeroed words (each set's row groups' barriers)
extern "C" int gru2_bwd_chain_legacy_launch(const float* h0p, const float* h1p,
                                            const float* res, const float* dys,
                                            const float* keep, const float* w_hh0,
                                            const float* w_hh1, const float* w_ih1,
                                            float* out, float* carry, unsigned* flags,
                                            int batch, int t_len, int hidden, int upc,
                                            int ncl, int rgroups, int kc, void* stream) {
  rnn2_bwd::Args a{res, {h0p, h1p}, keep, nullptr, {w_hh0, w_hh1},
                   w_ih1, {out, out + 6 * (size_t)hidden}, {nullptr, nullptr},
                   carry, flags, batch, t_len, hidden, upc, ncl, rgroups, kc};
  a.dys = dys;
  return rnn2_bwd::launch<rnn2_bwd::GruLegacyCell>(a, (cudaStream_t)stream);
}

extern "C" int gru2_bwd_chain_legacy_max_clusters(int hidden, int upc, int ncl,
                                                  int rgroups, int kc, int* count) {
  return rnn2_bwd::max_clusters<rnn2_bwd::GruLegacyCell>(hidden, upc, ncl, rgroups, kc,
                                                         count);
}

extern "C" int gru2_bwd_chain_legacy_card(int* sms, int* max_smem) {
  return rnn_chain::card_limits(sms, max_smem);
}

RNN_TIMERS_EXPORT(gru2_bwd_chain_legacy)

extern "C" const char* gru2_bwd_chain_legacy_error_string(int err) {
  return rnn_chain::error_string(err, "shape not supported by gru2_bwd_chain_legacy");
}
