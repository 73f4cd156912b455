"""PyTorch port, CUDA kernels against their plain versions on the card.

Marked ``gpu``; each test skips when torch sees no CUDA card (decided in
the test body, so every worker collects the same tests).  Imports only
torch, numpy and the port, so it runs where JAX is not installed:

    python -m pytest --noconftest -m gpu tests/test_torch_port_gpu.py
"""

import contextlib
import copy
import signal

import numpy as np
import pytest
import torch

from multimodal_emotion_detection_tpu_torch.ops import logmel, lstm_kernel

pytestmark = pytest.mark.gpu


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("b,t,params", [
    (3, 5000, logmel.LogMelParams()),                       # ragged frame tile
    (2, 16000, logmel.LogMelParams(hop_length=160)),        # non-128 hop
    (2, 3000, logmel.LogMelParams(n_fft=256, win_length=200, hop_length=80,
                                  n_mels=40)),              # masked bands
    (2, 4000, logmel.LogMelParams(win_length=512)),         # every tap
    (1, 48000, logmel.LogMelParams()),                      # B=1, the b1 grid
    (2, 9000, logmel.LogMelParams(n_fft=1024, win_length=1024,
                                  hop_length=256)),         # radix-2 last stage
    (1, 12000, logmel.LogMelParams(n_fft=2048, win_length=1600,
                                   hop_length=333)),        # 2048, odd hop
    (2, 3000, logmel.LogMelParams(n_fft=64, win_length=64, hop_length=32,
                                  n_mels=16)),              # the smallest size
    (1, 20000, logmel.LogMelParams(n_fft=4096, win_length=4096,
                                   hop_length=1024)),       # the largest size
])
def test_logmel_kernel_matches_plain(b, t, params):
    dev = _card()
    wave = torch.from_numpy(
        np.random.RandomState(t).randn(b, t).astype(np.float32)).to(dev)
    before = logmel.LOGMEL.launches
    out = logmel.logmel_cuda(wave, params)
    torch.cuda.synchronize()
    assert logmel.LOGMEL.launches == before + 1
    ref = logmel.logmel_frames(wave, params)
    assert out.shape == ref.shape == (b, params.num_frames(t), params.n_mels)
    # float32 sums in another order than cuBLAS: ~1e-6 relative on the
    # spectrum, through the log
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)


def test_logmel_kernel_matches_plain_at_low_amplitude():
    # a quiet clip (amplitude 1e-3): the power is ~1e-6 of a loud one's,
    # near eps, where the log magnifies relative error
    dev = _card()
    params = logmel.LogMelParams()
    wave = torch.from_numpy(
        (1e-3 * np.random.RandomState(5).randn(2, 16000)).astype(np.float32)).to(dev)
    out = logmel.logmel_cuda(wave, params)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, logmel.logmel_frames(wave, params),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("n_fft", [400, 96, 8192])
def test_logmel_kernel_refuses_other_fft_sizes(n_fft):
    # the FFT takes powers of two from 64 to 4096; other sizes raise on the
    # card and launch nothing (no fallback to the plain version)
    dev = _card()
    params = logmel.LogMelParams(n_fft=n_fft, win_length=min(400, n_fft))
    wave = torch.zeros(1, 3 * n_fft, device=dev)
    before = logmel.LOGMEL.launches
    with pytest.raises(ValueError, match="power of two"):
        logmel.logmel_cuda(wave, params)
    assert logmel.LOGMEL.launches == before


@pytest.mark.parametrize("b,t,d,h", [
    (1, 7, 5, 64),       # one row, one block per unit
    (37, 20, 12, 128),   # more rows than one pass of the block (32)
    (4, 30, 8, 256),     # two units per block
])
def test_lstm2_infer_kernel_matches_plain(b, t, d, h):
    dev = _card()
    rng = np.random.RandomState(b * 100 + t)
    k = 1.0 / np.sqrt(h)

    def layer(d_in):
        return {name: torch.from_numpy(
            rng.uniform(-k, k, shape).astype(np.float32)).to(dev)
            for name, shape in (("w_ih", (d_in, 4 * h)),
                                ("w_hh", (h, 4 * h)), ("b", (4 * h,)))}

    l0, l1 = layer(d), layer(h)
    x = torch.from_numpy(rng.randn(b, t, d).astype(np.float32)).to(dev)
    before = lstm_kernel.LSTM2_INFER.launches
    out = lstm_kernel.lstm2_infer(x, l0, l1)
    torch.cuda.synchronize()
    assert lstm_kernel.LSTM2_INFER.launches == before + 1
    ref = lstm_kernel.lstm2_infer_reference(x, l0, l1)
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)


def _lstm_case(dev, b, t, d, h, seed):
    rng = np.random.RandomState(seed)
    k = 1.0 / np.sqrt(h)

    def layer(d_in):
        return {name: torch.from_numpy(
            rng.uniform(-k, k, shape).astype(np.float32)).to(dev)
            for name, shape in (("w_ih", (d_in, 4 * h)),
                                ("w_hh", (h, 4 * h)), ("b", (4 * h,)))}

    l0, l1 = layer(d), layer(h)
    x_tm = torch.from_numpy(rng.randn(t, b, d).astype(np.float32)).to(dev)
    keep = torch.from_numpy(
        ((rng.rand(t, b, h) < 0.9) / 0.9).astype(np.float32)).to(dev)
    return x_tm, keep, l0, l1


TRAIN_SHAPES = [(1, 5, 6, 64), (37, 5, 6, 128), (32, 5, 64, 256),
                (1, 372, 6, 64), (37, 372, 6, 128), (32, 372, 64, 256)]


@pytest.mark.parametrize("b,t,d,h", TRAIN_SHAPES)
def test_lstm2_train_kernels_match_plain(b, t, d, h):
    dev = _card()
    x_tm, keep, l0, l1 = _lstm_case(dev, b, t, d, h, seed=b * 1000 + t)
    before = lstm_kernel.LSTM2_TRAIN_FWD.launches
    outs = lstm_kernel.lstm2_train_fwd_residuals(x_tm, keep, l0, l1)
    torch.cuda.synchronize()
    assert lstm_kernel.LSTM2_TRAIN_FWD.launches == before + 1
    refs = lstm_kernel.lstm2_train_fwd_reference(x_tm, keep, l0, l1)
    # float32 sums in another order than cuBLAS, carried through T steps
    for name, out, ref in zip(("packed", "h0_prev", "h1_prev", "x1", "finals"),
                              outs, refs):
        torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4, msg=name)

    dh = torch.from_numpy(
        np.random.RandomState(t).randn(b, h).astype(np.float32)).to(dev)
    args = (refs[0], keep, dh, l0["w_hh"], l1["w_hh"], l1["w_ih"])
    before = lstm_kernel.LSTM2_BWD_CHAIN.launches
    dgs = lstm_kernel.lstm2_bwd_chain(*args)
    torch.cuda.synchronize()
    assert lstm_kernel.LSTM2_BWD_CHAIN.launches == before + 1
    for name, out, ref in zip(("dg0", "dg1"), dgs,
                              lstm_kernel.lstm2_bwd_chain_reference(*args)):
        torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4, msg=name)


@pytest.mark.parametrize("b,t,d,h", [(3, 40, 6, 64), (32, 372, 64, 256)])
def test_fused_lstm_final_grads_match_plain_autograd(b, t, d, h):
    from multimodal_emotion_detection_tpu_torch.ops.lstm_vjp import (
        fused_lstm_final,
    )

    dev = _card()
    x_tm, keep, l0, l1 = _lstm_case(dev, b, t, d, h, seed=7 + b)
    weight = torch.from_numpy(
        np.random.RandomState(b).randn(b, h).astype(np.float32)).to(dev)

    def grads(fn):
        x = x_tm.transpose(0, 1).contiguous().requires_grad_()
        p0 = {k: v.clone().requires_grad_() for k, v in l0.items()}
        p1 = {k: v.clone().requires_grad_() for k, v in l1.items()}
        (fn(x, p0, p1) * weight).sum().backward()
        return [x.grad] + [p.grad for p in (*p0.values(), *p1.values())]

    ours = grads(lambda x, p0, p1: fused_lstm_final(x, keep[:, None], (p0, p1)))
    plain = grads(lambda x, p0, p1: lstm_kernel.lstm2_train_fwd_reference(
        x.transpose(0, 1), keep, p0, p1)[4][2])
    for i, (g, r) in enumerate(zip(ours, plain)):
        # weight gradients sum T*B terms: relative 1e-4 of the largest
        scale = float(r.abs().max())
        torch.testing.assert_close(g, r, rtol=1e-4, atol=1e-4 * max(scale, 1.0),
                                   msg=f"gradient {i}")


RES_NAMES = ("packed", "h0_prev", "h1_prev", "x1", "finals")
REMAT_SHAPES = [(32, 372, 64, 256),                  # the flagship
                (32, 1, 64, 256), (32, 2, 64, 256),  # the wavefront's ends
                (1, 5, 64, 256), (33, 5, 64, 256),   # one row; two slices of the batch
                (33, 7, 5, 128),                     # one unit per block, odd D
                (3, 9, 64, 264),                     # the widest pair, 2 x 132 SMs
                (32, 11, 64, 256), (17, 13, 7, 260)]  # T not a multiple of a gate block


@pytest.mark.parametrize("b,t,d,h", REMAT_SHAPES)
def test_lstm2_remat_kernels_match_plain(b, t, d, h):
    dev = _card()
    x_tm, keep, l0, l1 = _lstm_case(dev, b, t, d, h, seed=b * 1000 + t + 5)
    before = lstm_kernel.LSTM2_TRAIN_FWD_NOGATES.launches
    outs = lstm_kernel.lstm2_train_fwd_residuals(x_tm, keep, l0, l1, store_gates=False)
    torch.cuda.synchronize()
    assert lstm_kernel.LSTM2_TRAIN_FWD_NOGATES.launches == before + 1
    assert outs[0].shape == (t, b, 2 * h)
    refs = lstm_kernel.lstm2_train_fwd_reference(x_tm, keep, l0, l1, store_gates=False)
    for name, out, ref in zip(RES_NAMES, outs, refs):
        torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4, msg=name)
    # the stored-gates form runs the same arithmetic: its series and cell
    # states are these bit for bit
    stored = lstm_kernel.lstm2_train_fwd_residuals(x_tm, keep, l0, l1)
    for name, out, ref in zip(RES_NAMES, outs, (stored[0][..., 8 * h:], *stored[1:])):
        assert torch.equal(out, ref), name

    dh = torch.from_numpy(
        np.random.RandomState(t).randn(b, h).astype(np.float32)).to(dev)
    args = (outs[0], keep, x_tm, outs[3], outs[1], outs[2], dh, l0, l1)
    # one launch a slice of the batch where the gate blocks of the whole
    # batch do not fit beside the plan
    plan = lstm_kernel.chain_plan_on("lstm2_bwd_chain_remat", 4, h, b, dev, layers=2,
                                     remat_d=-(-d // 4) * 4)
    before = lstm_kernel.LSTM2_BWD_CHAIN_REMAT.launches
    dgs = lstm_kernel.lstm2_bwd_chain_remat(*args)
    torch.cuda.synchronize()
    assert (lstm_kernel.LSTM2_BWD_CHAIN_REMAT.launches
            == before + -(-b // (plan.batch_slice or b)))
    for name, out, ref in zip(("dg0", "dg1"), dgs,
                              lstm_kernel.lstm2_bwd_chain_remat_reference(*args)):
        torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4, msg=name)


@pytest.mark.parametrize("b,t", [(113, 5), (128, 7), (512, 3)])
def test_lstm2_remat_chain_takes_batches_past_its_gate_blocks(b, t):
    """Past the rows whose gate blocks fit beside the plan (32 at D=64,
    H=256 on an H100) the remat chain launches on slices of the batch
    (``ChainPlan.batch_slice``), one counted launch each, against the plain
    version at 1e-4 over the no-gates forward's residuals; the parent took
    these batches in one launch of its first design."""
    dev = _card()
    d, h = 64, 256
    x_tm, keep, l0, l1 = _lstm_case(dev, b, t, d, h, seed=b + t)
    outs = lstm_kernel.lstm2_train_fwd_residuals(x_tm, keep, l0, l1, store_gates=False)
    dh = torch.from_numpy(
        np.random.RandomState(b).randn(b, h).astype(np.float32)).to(dev)
    args = (outs[0], keep, x_tm, outs[3], outs[1], outs[2], dh, l0, l1)
    plan = lstm_kernel.chain_plan_on("lstm2_bwd_chain_remat", 4, h, b, dev, layers=2,
                                     remat_d=d)
    assert 0 < plan.batch_slice < b, plan
    before = lstm_kernel.LSTM2_BWD_CHAIN_REMAT.launches
    dgs = lstm_kernel.lstm2_bwd_chain_remat(*args)
    torch.cuda.synchronize()
    assert (lstm_kernel.LSTM2_BWD_CHAIN_REMAT.launches
            == before + -(-b // plan.batch_slice))
    for name, out, ref in zip(("dg0", "dg1"), dgs,
                              lstm_kernel.lstm2_bwd_chain_remat_reference(*args)):
        torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4, msg=name)


def test_redesigned_chains_raise_on_a_plan_that_does_not_fit():
    """No fallback in the remat chain, the legacy GRU pair and the legacy
    LSTM pair either: a plan their launchers do not accept (a cluster of 3,
    3 units a CTA, 3 row groups, an empty chunk; for the remat chain a gate
    block of no steps, an input width that is not a multiple of 4 or
    series rows fewer than the launch's batch) raises with its error
    string, and the launch is not counted."""
    dev = _card()
    b, t, d, h = 2, 3, 8, 128
    new = dict(dtype=torch.float32, device=dev)
    big = torch.zeros((t, b, 12 * h), **new)
    ser = torch.zeros((t, b, h), **new)
    w = torch.zeros((2 * h, 4 * h), **new)
    carry = torch.zeros((2, b, h), **new)
    flags = torch.zeros(2 * lstm_kernel.CHAIN_FLAGS, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    remat = lstm_kernel.chain_plan_on("lstm2_bwd_chain_remat", 4, h, b, dev, layers=2,
                                      remat_d=d)
    legacy = lstm_kernel.chain_plan_on("gru2_bwd_chain_legacy", 3, h, b, dev, layers=2)
    lstm_fwd = lstm_kernel.chain_plan_on("lstm2_train_fwd_legacy", 4, h, b, dev, True,
                                         layers=2)
    lstm_bwd = lstm_kernel.chain_plan_on("lstm2_bwd_chain_legacy", 4, h, b, dev, layers=2)
    gru_fwd = lstm_kernel.chain_plan_on("gru2_train_fwd_legacy", 3, h, b, dev, True,
                                        layers=2)
    assert remat.rk in lstm_kernel.REMAT_KS

    def remat_args(upc, ncl, rgroups, kc, d_in, rk, ld=b):
        return (big.data_ptr(), ser.data_ptr(), carry.data_ptr(), *(w.data_ptr(),) * 3,
                big.data_ptr(), *(ser.data_ptr(),) * 3, *(w.data_ptr(),) * 4,
                big.data_ptr(), big.data_ptr(), carry.data_ptr(), flags.data_ptr(), b, ld,
                t, h, d_in, upc, ncl, rgroups, kc, rk, stream)

    def legacy_args(upc, ncl, rgroups, kc):
        return (ser.data_ptr(), ser.data_ptr(), big.data_ptr(), None, ser.data_ptr(),
                *(w.data_ptr(),) * 3, big.data_ptr(), carry.data_ptr(), flags.data_ptr(),
                b, t, h, upc, ncl, rgroups, kc, stream)

    def lstm_fwd_args(upc, ncl, rgroups, kc):
        return (big.data_ptr(), ser.data_ptr(), *(w.data_ptr(),) * 4, big.data_ptr(),
                ser.data_ptr(), *(ser.data_ptr(),) * 3, carry.data_ptr(), flags.data_ptr(),
                b, t, h, upc, ncl, rgroups, kc, stream)

    def gru_fwd_args(upc, ncl, rgroups, kc):
        return (big.data_ptr(), ser.data_ptr(), *(w.data_ptr(),) * 6, big.data_ptr(),
                ser.data_ptr(), *(ser.data_ptr(),) * 3, carry.data_ptr(), flags.data_ptr(),
                b, t, h, upc, ncl, rgroups, kc, stream)

    def lstm_bwd_args(upc, ncl, rgroups, kc):
        return (big.data_ptr(), None, ser.data_ptr(), ser.data_ptr(),
                *(w.data_ptr(),) * 3, big.data_ptr(), carry.data_ptr(), flags.data_ptr(),
                b, t, h, upc, ncl, rgroups, kc, stream)

    for plan, kern, args_of in (
            (remat, lstm_kernel.LSTM2_BWD_CHAIN_REMAT,
             lambda *p: remat_args(*p, d, remat.rk)),
            (legacy, lstm_kernel.GRU2_BWD_CHAIN_LEGACY, legacy_args),
            (lstm_fwd, lstm_kernel.LSTM2_TRAIN_FWD_LEGACY, lstm_fwd_args),
            (lstm_bwd, lstm_kernel.LSTM2_BWD_CHAIN_LEGACY, lstm_bwd_args),
            (gru_fwd, lstm_kernel.GRU2_TRAIN_FWD_LEGACY, gru_fwd_args)):
        bad = [(plan.upc, 3, plan.rgroups, plan.kc), (3, plan.ncl, plan.rgroups, plan.kc),
               (plan.upc, plan.ncl, 3, plan.kc), (plan.upc, plan.ncl, plan.rgroups, 0)]
        for upc, ncl, rgroups, kc in bad:
            args = args_of(upc, ncl, rgroups, kc)
            before = kern.launches
            with pytest.raises(RuntimeError, match="launch plan"):
                kern(*args)
            assert kern.launches == before
    for d_in, rk, ld in ((d, 0, b), (d - 2, remat.rk, b), (d, remat.rk, b - 1)):
        before = lstm_kernel.LSTM2_BWD_CHAIN_REMAT.launches
        with pytest.raises(RuntimeError, match="not supported"):
            lstm_kernel.LSTM2_BWD_CHAIN_REMAT(*remat_args(
                remat.upc, remat.ncl, remat.rgroups, remat.kc, d_in, rk, ld))
        assert lstm_kernel.LSTM2_BWD_CHAIN_REMAT.launches == before


@pytest.mark.parametrize("b", [32, 17, 1])
@pytest.mark.parametrize("h", [256, 260, 264])
def test_gru2_legacy_chain_matches_plain_at_odd_shapes(b, h):
    """The legacy GRU chain (row 10, the reverse core's legacy cell) at B 32
    / 17 / 1 and H 256 / 260 / 264, T 1-3, with and without dys, over
    residuals drawn directly (r, z in (0, 1), n in (-1, 1); the gate series
    views of one tensor, as the legacy forward's are, or at T=2 separate
    ones; the wrapper packs either), against the plain version at 1e-4;
    dhh's r and z lanes equal dih's."""
    dev = _card()
    rng = np.random.RandomState(b * 1000 + h)
    k = 1.0 / np.sqrt(h)

    def t_(a):
        return torch.from_numpy(np.asarray(a, dtype=np.float32)).to(dev)

    w = [t_(rng.uniform(-k, k, (h, 3 * h))) for _ in range(3)]
    for t in (1, 2, 3):
        def layer():
            return (t_(rng.randn(t, b, h)), t_(rng.uniform(0.05, 0.95, (t, b, h))),
                    t_(rng.uniform(0.05, 0.95, (t, b, h))),
                    t_(rng.uniform(-0.95, 0.95, (t, b, h))), t_(rng.randn(t, b, h)))

        res0, res1 = layer(), layer()
        if t != 2:  # the gate series as views of one tensor
            res0, res1 = ((r[0], *torch.cat(r[1:], dim=-1).split(h, dim=-1))
                          for r in (res0, res1))
        keep = t_((rng.rand(t, b, h) < 0.9) / 0.9)
        dh = t_(rng.randn(b, h))
        for dys in (None, t_(rng.randn(t, b, h))):
            args = (res0, res1, dys, keep, dh, *w)
            before = lstm_kernel.GRU2_BWD_CHAIN_LEGACY.launches
            outs = lstm_kernel.gru2_bwd_chain_legacy(*args)
            torch.cuda.synchronize()
            assert lstm_kernel.GRU2_BWD_CHAIN_LEGACY.launches == before + 1
            refs = lstm_kernel.gru2_bwd_chain_legacy_reference(*args)
            for i in range(2):
                for j, name in enumerate(("dih", "dhh")):
                    torch.testing.assert_close(
                        outs[i][j], refs[i][j], rtol=1e-4, atol=1e-4,
                        msg=f"{name}{i}, T={t}, dys {dys is not None}")
                assert torch.equal(outs[i][1][..., :2 * h], outs[i][0][..., :2 * h])


@pytest.mark.parametrize("b,t,d,h", [(3, 40, 6, 64), (32, 372, 64, 256)])
def test_remat_lstm_final_grads_match_plain_autograd(b, t, d, h):
    from multimodal_emotion_detection_tpu_torch.ops.lstm_vjp import (
        fused_lstm_final,
    )

    dev = _card()
    x_tm, keep, l0, l1 = _lstm_case(dev, b, t, d, h, seed=17 + b)
    weight = torch.from_numpy(
        np.random.RandomState(b).randn(b, h).astype(np.float32)).to(dev)

    def grads(fn):
        x = x_tm.transpose(0, 1).contiguous().requires_grad_()
        p0 = {k: v.clone().requires_grad_() for k, v in l0.items()}
        p1 = {k: v.clone().requires_grad_() for k, v in l1.items()}
        (fn(x, p0, p1) * weight).sum().backward()
        return [x.grad] + [p.grad for p in (*p0.values(), *p1.values())]

    before = lstm_kernel.LSTM2_BWD_CHAIN_REMAT.launches
    ours = grads(lambda x, p0, p1: fused_lstm_final(x, keep[:, None], (p0, p1),
                                                    remat_gates=True))
    assert lstm_kernel.LSTM2_BWD_CHAIN_REMAT.launches == before + 1
    plain = grads(lambda x, p0, p1: lstm_kernel.lstm2_train_fwd_reference(
        x.transpose(0, 1), keep, p0, p1)[4][2])
    for i, (g, r) in enumerate(zip(ours, plain)):
        # weight gradients sum T*B terms: relative 1e-4 of the largest
        scale = float(r.abs().max())
        torch.testing.assert_close(g, r, rtol=1e-4, atol=1e-4 * max(scale, 1.0),
                                   msg=f"gradient {i}")


LAYER_SHAPES = [(1, 5, 64), (37, 5, 128), (32, 5, 512),
                (1, 372, 64), (37, 372, 128), (32, 372, 512)]
# the reverse chains' launch plans beyond LAYER_SHAPES: two 32-row passes
# (33, 64), T = 1, an odd grid (H 260: 130 CTAs), UPC 8 at the most CTAs
# (H 1056), clusters of 4 (H 100) and of 1 (H 524: 131 CTAs)
CHAIN_SHAPES = LAYER_SHAPES + [(33, 7, 256), (5, 3, 260), (2, 5, 1056), (32, 1, 512),
                               (64, 9, 512), (3, 4, 100), (2, 3, 524)]
# the forwards' eval form with two slots used in turn: a slot written at
# step t is overwritten at t + 2, so T = 2 and 3 at the big shape, at
# one row and at a ragged pass; and the b1 serving plan over many steps
FWD_SHAPES = CHAIN_SHAPES + [(32, 2, 512), (32, 3, 512), (1, 2, 512), (1, 3, 512),
                             (33, 3, 256), (9, 2, 64), (1, 40, 512)]


def _layer_case(dev, b, t, h, seed):
    """A layer's hoisted input projection (T, B, 4H) and its w_hh."""
    rng = np.random.RandomState(seed)
    k = 1.0 / np.sqrt(h)
    ih = rng.uniform(-1.0, 1.0, (t, b, 4 * h)).astype(np.float32)
    w_hh = rng.uniform(-k, k, (h, 4 * h)).astype(np.float32)
    return torch.from_numpy(ih).to(dev), torch.from_numpy(w_hh).to(dev)


@pytest.mark.parametrize("b,t,h", FWD_SHAPES)
def test_lstm1_fwd_kernels_match_plain(b, t, h):
    dev = _card()
    ih, w_hh = _layer_case(dev, b, t, h, seed=b * 1000 + t + h)
    before = lstm_kernel.LSTM1_TRAIN_FWD.launches
    outs = lstm_kernel.lstm1_train_fwd(ih, w_hh)
    torch.cuda.synchronize()
    assert lstm_kernel.LSTM1_TRAIN_FWD.launches == before + 1
    refs = lstm_kernel.lstm1_train_fwd_reference(ih, w_hh)
    # float32 sums in another order than cuBLAS, carried through T steps
    for name, out, ref in zip(("g", "h_prev", "c_prev", "finals"), outs, refs):
        torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4, msg=name)
    for series in (True, False):
        before = lstm_kernel.LSTM1_INFER.launches
        out = lstm_kernel.lstm1_infer(ih, w_hh, series)
        torch.cuda.synchronize()
        assert lstm_kernel.LSTM1_INFER.launches == before + 1
        ref = lstm_kernel.lstm1_infer_reference(ih, w_hh, series)
        torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4,
                                   msg=f"eval form, series={series}")


@pytest.mark.parametrize("b,t,h", CHAIN_SHAPES)
def test_lstm_bwd_chain_kernel_matches_plain(b, t, h):
    dev = _card()
    ih, w_hh = _layer_case(dev, b, t, h, seed=b * 1000 + t + h + 1)
    g, _, c_prev, _ = lstm_kernel.lstm1_train_fwd_reference(ih, w_hh)
    rng = np.random.RandomState(t + h)
    dhf = torch.from_numpy(rng.randn(b, h).astype(np.float32)).to(dev)
    dhs = torch.from_numpy(rng.randn(t, b, h).astype(np.float32)).to(dev)
    for series in (dhs, None):
        before = lstm_kernel.LSTM_BWD_CHAIN.launches
        out = lstm_kernel.lstm_bwd_chain(g, c_prev, series, dhf, w_hh)
        torch.cuda.synchronize()
        assert lstm_kernel.LSTM_BWD_CHAIN.launches == before + 1
        ref = lstm_kernel.lstm_bwd_chain_reference(g, c_prev, series, dhf, w_hh)
        torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4,
                                   msg=f"dh_series given: {series is not None}")


@pytest.mark.parametrize("b,t,d,h", [(3, 40, 6, 64), (32, 372, 64, 512)])
def test_layered_grads_match_plain_autograd(b, t, d, h):
    from multimodal_emotion_detection_tpu_torch.ops.lstm_vjp import (
        fused_lstm_final,
    )

    dev = _card()
    rng = np.random.RandomState(b + h)
    k = 1.0 / np.sqrt(h)
    layers = [{name: torch.from_numpy(
        rng.uniform(-k, k, shape).astype(np.float32)).to(dev)
        for name, shape in (("w_ih", (d if i == 0 else h, 4 * h)),
                            ("w_hh", (h, 4 * h)), ("b", (4 * h,)))}
        for i in range(3)]
    x = torch.from_numpy(rng.randn(b, t, d).astype(np.float32)).to(dev)
    keep = torch.from_numpy(
        ((rng.rand(t, 2, b, h) < 0.9) / 0.9).astype(np.float32)).to(dev)
    weight = torch.from_numpy(rng.randn(b, h).astype(np.float32)).to(dev)

    def grads(fn):
        xg = x.clone().requires_grad_()
        ps = [{n: v.clone().requires_grad_() for n, v in p.items()} for p in layers]
        (fn(xg, ps) * weight).sum().backward()
        return [xg.grad] + [p[n].grad for p in ps for n in ("w_ih", "w_hh", "b")]

    def plain(xg, ps):
        x_l = xg.transpose(0, 1)
        for i, p in enumerate(ps):
            _, hp, _, finals = lstm_kernel.lstm1_train_fwd_reference(
                x_l @ p["w_ih"] + p["b"], p["w_hh"])
            x_l = torch.cat([hp[1:], finals[None, :, :h]])
            if i < 2:
                x_l = x_l * keep[:, i]
        return finals[:, :h]

    launches = (lstm_kernel.LSTM1_TRAIN_FWD.launches,
                lstm_kernel.LSTM_BWD_CHAIN.launches)
    ours = grads(lambda xg, ps: fused_lstm_final(xg, keep, ps))
    assert (lstm_kernel.LSTM1_TRAIN_FWD.launches,
            lstm_kernel.LSTM_BWD_CHAIN.launches) == (launches[0] + 3, launches[1] + 3)
    for i, (g, r) in enumerate(zip(ours, grads(plain))):
        # weight gradients sum T*B terms: relative 1e-4 of the largest
        scale = float(r.abs().max())
        torch.testing.assert_close(g, r, rtol=1e-4, atol=1e-4 * max(scale, 1.0),
                                   msg=f"gradient {i}")


def test_two_layer_h512_trains_and_serves_on_the_layered_kernels():
    from multimodal_emotion_detection_tpu_torch.models.noise import Noise
    from multimodal_emotion_detection_tpu_torch.models.recurrent import (
        FusedStackedRNN,
    )

    dev = _card()
    b, t, d, h = 32, 372, 64, 512
    rnn = FusedStackedRNN(d, h, num_layers=2, dropout=0.1)
    for layer in (rnn.layer_0, rnn.layer_1):
        layer.reset_parameters(torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.RandomState(5).randn(b, t, d).astype(np.float32))
    counters = (lstm_kernel.LSTM1_TRAIN_FWD, lstm_kernel.LSTM_BWD_CHAIN,
                lstm_kernel.LSTM1_INFER, lstm_kernel.LSTM2_TRAIN_FWD,
                lstm_kernel.LSTM2_INFER)
    before = [c.launches for c in counters]
    card = rnn.to(dev).train()
    noise = Noise(torch.Generator(device=dev).manual_seed(0))
    card(x.to(dev), noise).sum().backward()
    grads = {n: p.grad.cpu() for n, p in card.named_parameters()}
    card.eval()
    with torch.no_grad():
        served = card(x.to(dev)).cpu()
    torch.cuda.synchronize()
    assert [c.launches - n for c, n in zip(counters, before)] == [2, 2, 2, 0, 0]

    cpu = rnn.cpu().train()
    for p in cpu.parameters():
        p.grad = None
    cpu(x, Noise(replay=noise.drawn)).sum().backward()
    for n, p in cpu.named_parameters():
        scale = float(p.grad.abs().max())
        torch.testing.assert_close(grads[n], p.grad, rtol=1e-4,
                                   atol=1e-4 * max(scale, 1.0), msg=n)
    with torch.no_grad():
        torch.testing.assert_close(served, cpu.eval()(x), rtol=1e-4, atol=1e-4)


def _gru_case(dev, b, t, d, h, seed):
    """Time-major x, keep mask at dropout 0.1, both GRU layers (the r third
    of b_ih in [-1.5, -0.5], so r sits away from 1)."""
    rng = np.random.RandomState(seed)
    k = 1.0 / np.sqrt(h)

    def layer(d_in):
        p = {name: rng.uniform(-k, k, shape).astype(np.float32)
             for name, shape in (("w_ih", (d_in, 3 * h)), ("w_hh", (h, 3 * h)),
                                 ("b_ih", (3 * h,)), ("b_hh", (3 * h,)))}
        p["b_ih"][:h] = rng.uniform(-1.5, -0.5, h)
        return {name: torch.from_numpy(v).to(dev) for name, v in p.items()}

    l0, l1 = layer(d), layer(h)
    x_tm = torch.from_numpy(rng.randn(t, b, d).astype(np.float32)).to(dev)
    keep = torch.from_numpy(
        ((rng.rand(t, b, h) < 0.9) / 0.9).astype(np.float32)).to(dev)
    return x_tm, keep, l0, l1


GRU_SHAPES = [(1, 5, 6, 128), (37, 5, 6, 256), (32, 5, 64, 256),
              (1, 372, 6, 128), (37, 372, 6, 256), (32, 372, 64, 256)]


@pytest.mark.parametrize("b,t,d,h", GRU_SHAPES)
def test_gru2_kernels_match_plain(b, t, d, h):
    dev = _card()
    x_tm, keep, l0, l1 = _gru_case(dev, b, t, d, h, seed=b * 1000 + t + h)
    x = x_tm.transpose(0, 1).contiguous()
    before = lstm_kernel.GRU2_INFER.launches
    out = lstm_kernel.gru2_infer(x, l0, l1)
    torch.cuda.synchronize()
    assert lstm_kernel.GRU2_INFER.launches == before + 1
    # float32 sums in another order than cuBLAS, carried through T steps
    torch.testing.assert_close(out, lstm_kernel.gru2_infer_reference(x, l0, l1),
                               rtol=1e-4, atol=1e-4, msg="gru2_infer")

    before = lstm_kernel.GRU2_TRAIN_FWD.launches
    outs = lstm_kernel.gru2_train_fwd_residuals(x_tm, keep, l0, l1)
    torch.cuda.synchronize()
    assert lstm_kernel.GRU2_TRAIN_FWD.launches == before + 1
    refs = lstm_kernel.gru2_train_fwd_reference(x_tm, keep, l0, l1)
    for name, o, r in zip(("packed", "h0_prev", "h1_prev", "x1", "finals"), outs, refs):
        torch.testing.assert_close(o, r, rtol=1e-4, atol=1e-4, msg=name)

    dh = torch.from_numpy(
        np.random.RandomState(t).randn(b, h).astype(np.float32)).to(dev)
    args = (*refs[:3], keep, dh, l0["w_hh"], l1["w_hh"], l1["w_ih"])
    before = lstm_kernel.GRU2_BWD_CHAIN.launches
    outs = lstm_kernel.gru2_bwd_chain(*args)
    torch.cuda.synchronize()
    assert lstm_kernel.GRU2_BWD_CHAIN.launches == before + 1
    for name, o, r in zip(("dih0", "dhn0", "dih1", "dhn1"), outs,
                          lstm_kernel.gru2_bwd_chain_reference(*args)):
        torch.testing.assert_close(o, r, rtol=1e-4, atol=1e-4, msg=name)


# the 2-layer cores (csrc/rnn2_bwd_chain.cuh, csrc/rnn2_fwd_chain.cuh): the
# GRU config's shape; one row (two row groups, one empty); 17 rows (a
# second pass of rows); T 1, 2, 3 (the first steps' skipped products, the
# eval form's two slots); H 260 (an odd grid: clusters of 1, each CTA of
# the follow set forming both halves of its row) and 264 (2 x 132 SMs)
PAIR_SHAPES = [(3, 40, 6, 64), (32, 372, 64, 256), (1, 372, 64, 256),
               (17, 372, 64, 256), (32, 1, 64, 256), (32, 2, 64, 256),
               (32, 3, 64, 256), (1, 2, 6, 64), (5, 9, 6, 260), (33, 9, 6, 264)]


@pytest.mark.parametrize("b,t,d,h", PAIR_SHAPES)
def test_gru2_pair_kernels_match_plain(b, t, d, h):
    dev = _card()
    x_tm, keep, l0, l1 = _gru_case(dev, b, t, d, h, seed=b * 100 + t + h)
    x = x_tm.transpose(0, 1).contiguous()
    before = lstm_kernel.GRU2_INFER.launches
    out = lstm_kernel.gru2_infer(x, l0, l1)
    torch.cuda.synchronize()
    assert lstm_kernel.GRU2_INFER.launches == before + 1
    # float32 sums in another order than cuBLAS, carried through T steps
    torch.testing.assert_close(out, lstm_kernel.gru2_infer_reference(x, l0, l1),
                               rtol=1e-4, atol=1e-4, msg="gru2_infer")
    refs = lstm_kernel.gru2_train_fwd_reference(x_tm, keep, l0, l1)
    dh = torch.from_numpy(
        np.random.RandomState(t + b).randn(b, h).astype(np.float32)).to(dev)
    args = (*refs[:3], keep, dh, l0["w_hh"], l1["w_hh"], l1["w_ih"])
    before = lstm_kernel.GRU2_BWD_CHAIN.launches
    outs = lstm_kernel.gru2_bwd_chain(*args)
    torch.cuda.synchronize()
    assert lstm_kernel.GRU2_BWD_CHAIN.launches == before + 1
    for name, o, r in zip(("dih0", "dhn0", "dih1", "dhn1"), outs,
                          lstm_kernel.gru2_bwd_chain_reference(*args)):
        torch.testing.assert_close(o, r, rtol=1e-4, atol=1e-4, msg=name)


# the LSTM pair on the same cores: PAIR_SHAPES, and H 260 (clusters of 1)
# at B 32, 17 and 1 as the flagship's shape takes them at H 256
LSTM_PAIR_SHAPES = PAIR_SHAPES + [(32, 40, 6, 260), (17, 40, 6, 260), (1, 40, 6, 260)]


@pytest.mark.parametrize("b,t,d,h", LSTM_PAIR_SHAPES)
def test_lstm2_pair_kernels_match_plain(b, t, d, h):
    dev = _card()
    x_tm, keep, l0, l1 = _lstm_case(dev, b, t, d, h, seed=b * 100 + t + h + 1)
    x = x_tm.transpose(0, 1).contiguous()
    before = lstm_kernel.LSTM2_INFER.launches
    out = lstm_kernel.lstm2_infer(x, l0, l1)
    torch.cuda.synchronize()
    assert lstm_kernel.LSTM2_INFER.launches == before + 1
    # float32 sums in another order than cuBLAS, carried through T steps
    torch.testing.assert_close(out, lstm_kernel.lstm2_infer_reference(x, l0, l1),
                               rtol=1e-4, atol=1e-4, msg="lstm2_infer")
    packed = lstm_kernel.lstm2_train_fwd_reference(x_tm, keep, l0, l1)[0]
    dh = torch.from_numpy(
        np.random.RandomState(t + b).randn(b, h).astype(np.float32)).to(dev)
    args = (packed, keep, dh, l0["w_hh"], l1["w_hh"], l1["w_ih"])
    before = lstm_kernel.LSTM2_BWD_CHAIN.launches
    outs = lstm_kernel.lstm2_bwd_chain(*args)
    torch.cuda.synchronize()
    assert lstm_kernel.LSTM2_BWD_CHAIN.launches == before + 1
    for name, o, r in zip(("dg0", "dg1"), outs,
                          lstm_kernel.lstm2_bwd_chain_reference(*args)):
        torch.testing.assert_close(o, r, rtol=1e-4, atol=1e-4, msg=name)


@pytest.mark.parametrize("b,t,d,h", PAIR_SHAPES)
def test_gru2_train_fwd_pair_matches_plain(b, t, d, h):
    """Row 14, the forward core's training form, on the 2-layer shapes: its
    residuals and finals against the plain version, keep at p = 0.1."""
    dev = _card()
    x_tm, keep, l0, l1 = _gru_case(dev, b, t, d, h, seed=b * 100 + t + h + 2)
    before = lstm_kernel.GRU2_TRAIN_FWD.launches
    outs = lstm_kernel.gru2_train_fwd_residuals(x_tm, keep, l0, l1)
    torch.cuda.synchronize()
    assert lstm_kernel.GRU2_TRAIN_FWD.launches == before + 1
    refs = lstm_kernel.gru2_train_fwd_reference(x_tm, keep, l0, l1)
    # float32 sums in another order than cuBLAS, carried through T steps
    for name, o, r in zip(("packed", "h0_prev", "h1_prev", "x1", "finals"), outs, refs):
        torch.testing.assert_close(o, r, rtol=1e-4, atol=1e-4, msg=name)


@pytest.mark.parametrize("b,t,d,h", LSTM_PAIR_SHAPES)
def test_lstm2_train_fwd_pair_forms_match_plain(b, t, d, h):
    """Rows 11 and 11n, the forward core's training form with and without
    the gates: each against the plain version, and the no-gates form's
    residuals equal to the stored form's c_prev lanes and series bit for
    bit."""
    dev = _card()
    x_tm, keep, l0, l1 = _lstm_case(dev, b, t, d, h, seed=b * 100 + t + h + 3)
    runs = {}
    for store_gates, kern in ((True, lstm_kernel.LSTM2_TRAIN_FWD),
                              (False, lstm_kernel.LSTM2_TRAIN_FWD_NOGATES)):
        before = kern.launches
        outs = lstm_kernel.lstm2_train_fwd_residuals(x_tm, keep, l0, l1,
                                                     store_gates=store_gates)
        torch.cuda.synchronize()
        assert kern.launches == before + 1
        refs = lstm_kernel.lstm2_train_fwd_reference(x_tm, keep, l0, l1,
                                                     store_gates=store_gates)
        # float32 sums in another order than cuBLAS, carried through T steps
        for name, o, r in zip(("packed", "h0_prev", "h1_prev", "x1", "finals"), outs,
                              refs):
            torch.testing.assert_close(o, r, rtol=1e-4, atol=1e-4,
                                       msg=f"{name}, store_gates {store_gates}")
        runs[store_gates] = outs
    stored, bare = runs[True], runs[False]
    assert torch.equal(bare[0], stored[0][..., 8 * h:])
    for o, s in zip(bare[1:], stored[1:]):
        assert torch.equal(o, s)


def test_pair_kernels_raise_on_a_plan_that_does_not_fit():
    """No fallback: a 2-layer plan the launchers of either cell do not
    accept (a cluster of 3, 3 units a CTA, 3 row groups, an empty chunk, or
    a grid of two sets past the card) raises with its error string, and the
    launch is not counted: the eval forms, the reverse chains and the
    training forwards (the LSTM's with and without the gates)."""
    dev = _card()
    b, t, d, h = 2, 3, 6, 128
    x_tm, keep, l0, l1 = _gru_case(dev, b, t, d, h, seed=5)
    ih0 = (x_tm.transpose(0, 1) @ l0["w_ih"] + l0["b_ih"]).contiguous()
    stream = torch.cuda.current_stream().cuda_stream
    new = dict(dtype=torch.float32, device=dev)
    h0, big = torch.empty((t, b, h), **new), torch.empty((t, b, 10 * h), **new)
    h1, carry = torch.empty((2, b, h), **new), torch.zeros((2, b, h), **new)
    dih, dhn = torch.empty((t, b, 3 * h), **new), torch.empty((t, b, h), **new)
    flags = torch.zeros(2 * lstm_kernel.CHAIN_FLAGS, dtype=torch.int32, device=dev)
    w = [p.data_ptr() for p in (l0["w_hh"], l0["b_hh"], l1["w_ih"], l1["b_ih"],
                                l1["w_hh"], l1["b_hh"])]
    lw = [p.data_ptr() for p in _lstm_case(dev, b, t, d, h, seed=6)[2:]
          for p in (p["w_hh"], p["w_ih"], p["b"])]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    series = [torch.empty((t, b, h), **new) for _ in range(3)]
    finals = torch.empty((4, b, h), **new)
    for source, forward in (("gru2_infer", True), ("gru2_bwd_chain", False),
                            ("lstm2_infer", True), ("lstm2_bwd_chain", False),
                            ("gru2_train_fwd", True), ("lstm2_train_fwd", True),
                            ("lstm2_train_fwd_nogates", True)):
        width = 4 if source.startswith("lstm") else 3
        plan = lstm_kernel.chain_plan_on(source.replace("_nogates", ""), width, h, b, dev,
                                         forward, layers=2)
        bad = [(plan.upc, 3, plan.rgroups, plan.kc), (3, plan.ncl, plan.rgroups, plan.kc),
               (plan.upc, plan.ncl, 3, plan.kc), (plan.upc, plan.ncl, plan.rgroups, 0)]
        if h <= sms < 2 * h:
            bad.append((1, 1, 1, plan.kc))  # one set fits the card, two do not
        for upc, ncl, rgroups, kc in bad:
            if source == "gru2_infer":
                kern, args = lstm_kernel.GRU2_INFER, (
                    ih0.data_ptr(), *w, h0.data_ptr(), h1.data_ptr(), carry.data_ptr(),
                    flags.data_ptr(), b, t, h)
            elif source == "gru2_bwd_chain":
                kern, args = lstm_kernel.GRU2_BWD_CHAIN, (
                    big.data_ptr(), h0.data_ptr(), h0.data_ptr(), keep.data_ptr(),
                    w[0], w[4], w[2], dih.data_ptr(), dhn.data_ptr(), dih.data_ptr(),
                    dhn.data_ptr(), carry.data_ptr(), flags.data_ptr(), b, t, h)
            elif source == "lstm2_infer":
                # (w_hh0, w_ih1, b1, w_hh1): ih0 is wide enough for 4H rows
                kern, args = lstm_kernel.LSTM2_INFER, (
                    big.data_ptr(), lw[0], lw[4], lw[5], lw[3], h0.data_ptr(),
                    h1.data_ptr(), carry.data_ptr(), flags.data_ptr(), b, t, h)
            elif source == "lstm2_bwd_chain":
                kern, args = lstm_kernel.LSTM2_BWD_CHAIN, (
                    big.data_ptr(), keep.data_ptr(), h1.data_ptr(), lw[0], lw[3], lw[4],
                    big.data_ptr(), big.data_ptr(), carry.data_ptr(), flags.data_ptr(),
                    b, t, h)
            elif source == "gru2_train_fwd":
                kern, args = lstm_kernel.GRU2_TRAIN_FWD, (
                    ih0.data_ptr(), keep.data_ptr(), *w, big.data_ptr(),
                    *(a.data_ptr() for a in series), finals.data_ptr(), carry.data_ptr(),
                    flags.data_ptr(), b, t, h)
            else:
                # ih0 from big: wide enough for 4H rows
                kern = (lstm_kernel.LSTM2_TRAIN_FWD if source == "lstm2_train_fwd"
                        else lstm_kernel.LSTM2_TRAIN_FWD_NOGATES)
                args = (big.data_ptr(), keep.data_ptr(), lw[0], lw[4], lw[5], lw[3],
                        big.data_ptr(), *(a.data_ptr() for a in series),
                        finals.data_ptr(), carry.data_ptr(), flags.data_ptr(), b, t, h)
            before = kern.launches
            with pytest.raises(RuntimeError, match="launch plan"):
                kern(*args, upc, ncl, rgroups, kc, stream)
            assert kern.launches == before


@pytest.mark.parametrize("b,t,d,h", [(3, 40, 6, 128), (32, 372, 64, 256)])
def test_fused_gru_final_grads_match_plain_autograd(b, t, d, h):
    from multimodal_emotion_detection_tpu_torch.ops.lstm_vjp import (
        fused_gru_final,
    )

    dev = _card()
    x_tm, keep, l0, l1 = _gru_case(dev, b, t, d, h, seed=17 + b)
    weight = torch.from_numpy(
        np.random.RandomState(b).randn(b, h).astype(np.float32)).to(dev)

    def grads(fn):
        x = x_tm.transpose(0, 1).contiguous().requires_grad_()
        p0 = {k: v.clone().requires_grad_() for k, v in l0.items()}
        p1 = {k: v.clone().requires_grad_() for k, v in l1.items()}
        (fn(x, p0, p1) * weight).sum().backward()
        return [x.grad] + [p.grad for p in (*p0.values(), *p1.values())]

    launches = (lstm_kernel.GRU2_TRAIN_FWD.launches, lstm_kernel.GRU2_BWD_CHAIN.launches)
    ours = grads(lambda x, p0, p1: fused_gru_final(x, keep[:, None], (p0, p1)))
    assert (lstm_kernel.GRU2_TRAIN_FWD.launches,
            lstm_kernel.GRU2_BWD_CHAIN.launches) == (launches[0] + 1, launches[1] + 1)
    plain = grads(lambda x, p0, p1: lstm_kernel.gru2_train_fwd_reference(
        x.transpose(0, 1), keep, p0, p1)[4][1])
    for i, (g, r) in enumerate(zip(ours, plain)):
        # weight gradients sum T*B terms: relative 1e-4 of the largest
        scale = float(r.abs().max())
        torch.testing.assert_close(g, r, rtol=1e-4, atol=1e-4 * max(scale, 1.0),
                                   msg=f"gradient {i}")


def test_gru_rnn_trains_one_step_and_serves_on_the_card():
    from multimodal_emotion_detection_tpu_torch.models.noise import Noise
    from multimodal_emotion_detection_tpu_torch.models.recurrent import (
        FusedStackedRNN,
    )

    dev = _card()
    b, t, d, h = 32, 372, 64, 256
    rnn = FusedStackedRNN(d, h, num_layers=2, dropout=0.1, cell_type="gru")
    for layer in (rnn.layer_0, rnn.layer_1):
        layer.reset_parameters(torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.RandomState(6).randn(b, t, d).astype(np.float32))
    counters = (lstm_kernel.GRU2_TRAIN_FWD, lstm_kernel.GRU2_BWD_CHAIN,
                lstm_kernel.GRU2_INFER, lstm_kernel.LSTM2_TRAIN_FWD,
                lstm_kernel.LSTM2_INFER, lstm_kernel.LSTM1_TRAIN_FWD)
    before = [c.launches for c in counters]
    card = rnn.to(dev).train()
    noise = Noise(torch.Generator(device=dev).manual_seed(0))
    card(x.to(dev), noise).sum().backward()
    grads = {n: p.grad.cpu() for n, p in card.named_parameters()}
    card.eval()
    with torch.no_grad():
        served = card(x.to(dev)).cpu()
    torch.cuda.synchronize()
    assert [c.launches - n for c, n in zip(counters, before)] == [1, 1, 1, 0, 0, 0]

    cpu = rnn.cpu().train()
    for p in cpu.parameters():
        p.grad = None
    cpu(x, Noise(replay=noise.drawn)).sum().backward()
    for n, p in cpu.named_parameters():
        scale = float(p.grad.abs().max())
        torch.testing.assert_close(grads[n], p.grad, rtol=1e-4,
                                   atol=1e-4 * max(scale, 1.0), msg=n)
    with torch.no_grad():
        torch.testing.assert_close(served, cpu.eval()(x), rtol=1e-4, atol=1e-4)


def _gru_layer_case(dev, b, t, h, seed):
    """A GRU layer's hoisted input projection (T, B, 3H), w_hh and b_hh;
    the r third of ih shifted down, so r sits away from 1."""
    rng = np.random.RandomState(seed)
    k = 1.0 / np.sqrt(h)
    ih = rng.uniform(-1.0, 1.0, (t, b, 3 * h)).astype(np.float32)
    ih[..., :h] -= 1.0
    w_hh = rng.uniform(-k, k, (h, 3 * h)).astype(np.float32)
    b_hh = rng.uniform(-k, k, (3 * h,)).astype(np.float32)
    return tuple(torch.from_numpy(a).to(dev) for a in (ih, w_hh, b_hh))


@pytest.mark.parametrize("b,t,h", FWD_SHAPES)
def test_gru1_fwd_kernels_match_plain(b, t, h):
    dev = _card()
    ih, w_hh, b_hh = _gru_layer_case(dev, b, t, h, seed=b * 1000 + t + h + 2)
    before = lstm_kernel.GRU1_TRAIN_FWD.launches
    outs = lstm_kernel.gru1_train_fwd(ih, w_hh, b_hh)
    torch.cuda.synchronize()
    assert lstm_kernel.GRU1_TRAIN_FWD.launches == before + 1
    refs = lstm_kernel.gru1_train_fwd_reference(ih, w_hh, b_hh)
    # float32 sums in another order than cuBLAS, carried through T steps
    for name, out, ref in zip(("gates", "h_prev", "h"), outs, refs):
        torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4, msg=name)
    for series in (True, False):
        before = lstm_kernel.GRU1_INFER.launches
        out = lstm_kernel.gru1_infer(ih, w_hh, b_hh, series)
        torch.cuda.synchronize()
        assert lstm_kernel.GRU1_INFER.launches == before + 1
        ref = lstm_kernel.gru1_infer_reference(ih, w_hh, b_hh, series)
        torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4,
                                   msg=f"eval form, series={series}")


@pytest.mark.parametrize("b,t,h", CHAIN_SHAPES)
def test_gru_bwd_chain_kernel_matches_plain(b, t, h):
    dev = _card()
    ih, w_hh, b_hh = _gru_layer_case(dev, b, t, h, seed=b * 1000 + t + h + 3)
    gates, h_prev, _ = lstm_kernel.gru1_train_fwd_reference(ih, w_hh, b_hh)
    rng = np.random.RandomState(t + h + 1)
    dhf = torch.from_numpy(rng.randn(b, h).astype(np.float32)).to(dev)
    dhs = torch.from_numpy(rng.randn(t, b, h).astype(np.float32)).to(dev)
    for series in (dhs, None):
        before = lstm_kernel.GRU_BWD_CHAIN.launches
        outs = lstm_kernel.gru_bwd_chain(gates, h_prev, series, dhf, w_hh)
        torch.cuda.synchronize()
        assert lstm_kernel.GRU_BWD_CHAIN.launches == before + 1
        refs = lstm_kernel.gru_bwd_chain_reference(gates, h_prev, series, dhf, w_hh)
        for name, out, ref in zip(("dih", "dhn"), outs, refs):
            torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4,
                                       msg=f"{name}, dh_series given: {series is not None}")


def test_reverse_chains_raise_on_a_plan_that_does_not_fit():
    """No fallback: a plan the launcher does not accept raises with its
    error string, and the launch is not counted."""
    dev = _card()
    b, t, h = 2, 3, 64
    ih, w_hh = _layer_case(dev, b, t, h, seed=7)
    g, _, c_prev, _ = lstm_kernel.lstm1_train_fwd_reference(ih, w_hh)
    dhf = torch.ones((b, h), device=dev)
    plan = lstm_kernel.chain_plan_on("lstm_bwd_chain", 4, h, b, dev)
    dg = torch.empty((t, b, 4 * h), device=dev)
    carry = torch.zeros((b, h), device=dev)
    flags = torch.zeros(lstm_kernel.CHAIN_FLAGS, dtype=torch.int32, device=dev)
    for upc, ncl, rgroups, kc in ((plan.upc, 3, plan.rgroups, plan.kc),
                                  (3, plan.ncl, plan.rgroups, plan.kc),
                                  (plan.upc, plan.ncl, 3, plan.kc),
                                  (plan.upc, plan.ncl, plan.rgroups, 0)):
        before = lstm_kernel.LSTM_BWD_CHAIN.launches
        with pytest.raises(RuntimeError, match="launch plan"):
            lstm_kernel.LSTM_BWD_CHAIN(
                g.data_ptr(), c_prev.data_ptr(), None, dhf.data_ptr(),
                w_hh.data_ptr(), dg.data_ptr(), carry.data_ptr(), flags.data_ptr(),
                b, t, h, upc, ncl, rgroups, kc, torch.cuda.current_stream().cuda_stream)
        assert lstm_kernel.LSTM_BWD_CHAIN.launches == before


def test_forwards_raise_on_a_plan_that_does_not_fit():
    """No fallback: a forward plan the launcher does not accept raises with
    its error string, and the launch is not counted (both sources, both
    forms)."""
    dev = _card()
    b, t, h = 2, 3, 64
    ih, w_hh = _layer_case(dev, b, t, h, seed=8)
    gih, gw_hh, gb_hh = _gru_layer_case(dev, b, t, h, seed=9)
    stream = torch.cuda.current_stream().cuda_stream
    carry_t = torch.zeros((b, h), device=dev)
    flags_t = torch.zeros(lstm_kernel.CHAIN_FLAGS, dtype=torch.int32, device=dev)
    carry, flags = carry_t.data_ptr(), flags_t.data_ptr()
    big = torch.empty((t, b, 4 * h), device=dev)
    series = torch.empty((t, b, h), device=dev)
    finals = torch.empty((b, 2 * h), device=dev)
    for source, width in (("lstm1_fwd", 4), ("gru1_fwd", 3)):
        plan = lstm_kernel.chain_plan_on(source, width, h, b, dev, forward=True)
        for upc, ncl, rgroups, kc in ((plan.upc, 3, plan.rgroups, plan.kc),
                                      (3, plan.ncl, plan.rgroups, plan.kc),
                                      (plan.upc, plan.ncl, 3, plan.kc),
                                      (plan.upc, plan.ncl, plan.rgroups, 0)):
            if source == "lstm1_fwd":
                calls = (
                    (lstm_kernel.LSTM1_TRAIN_FWD,
                     (ih.data_ptr(), w_hh.data_ptr(), big.data_ptr(), series.data_ptr(),
                      series.data_ptr(), finals.data_ptr(), carry, flags, b, t, h)),
                    (lstm_kernel.LSTM1_INFER,
                     (ih.data_ptr(), w_hh.data_ptr(), series.data_ptr(), carry, flags,
                      b, t, h, 1)))
            else:
                calls = (
                    (lstm_kernel.GRU1_TRAIN_FWD,
                     (gih.data_ptr(), gw_hh.data_ptr(), gb_hh.data_ptr(), big.data_ptr(),
                      series.data_ptr(), finals.data_ptr(), carry, flags, b, t, h)),
                    (lstm_kernel.GRU1_INFER,
                     (gih.data_ptr(), gw_hh.data_ptr(), gb_hh.data_ptr(),
                      series.data_ptr(), carry, flags, b, t, h, 1)))
            for kern, args in calls:
                before = kern.launches
                with pytest.raises(RuntimeError, match="launch plan"):
                    kern(*args, upc, ncl, rgroups, kc, stream)
                assert kern.launches == before


@pytest.mark.parametrize("b,t,d,h", [(3, 40, 6, 64), (32, 372, 64, 512)])
def test_layered_gru_grads_match_plain_autograd(b, t, d, h):
    from multimodal_emotion_detection_tpu_torch.ops.lstm_vjp import (
        fused_gru_final,
    )

    dev = _card()
    rng = np.random.RandomState(b + h + 1)
    k = 1.0 / np.sqrt(h)
    names = ("w_ih", "w_hh", "b_ih", "b_hh")
    layers = [{name: torch.from_numpy(
        rng.uniform(-k, k, shape).astype(np.float32)).to(dev)
        for name, shape in (("w_ih", (d if i == 0 else h, 3 * h)),
                            ("w_hh", (h, 3 * h)), ("b_ih", (3 * h,)),
                            ("b_hh", (3 * h,)))}
        for i in range(3)]
    x = torch.from_numpy(rng.randn(b, t, d).astype(np.float32)).to(dev)
    keep = torch.from_numpy(
        ((rng.rand(t, 2, b, h) < 0.9) / 0.9).astype(np.float32)).to(dev)
    weight = torch.from_numpy(rng.randn(b, h).astype(np.float32)).to(dev)

    def grads(fn):
        xg = x.clone().requires_grad_()
        ps = [{n: v.clone().requires_grad_() for n, v in p.items()} for p in layers]
        (fn(xg, ps) * weight).sum().backward()
        return [xg.grad] + [p[n].grad for p in ps for n in names]

    def plain(xg, ps):
        x_l = xg.transpose(0, 1)
        for i, p in enumerate(ps):
            _, hp, hf = lstm_kernel.gru1_train_fwd_reference(
                x_l @ p["w_ih"] + p["b_ih"], p["w_hh"], p["b_hh"])
            x_l = torch.cat([hp[1:], hf[None]])
            if i < 2:
                x_l = x_l * keep[:, i]
        return hf

    launches = (lstm_kernel.GRU1_TRAIN_FWD.launches, lstm_kernel.GRU_BWD_CHAIN.launches)
    ours = grads(lambda xg, ps: fused_gru_final(xg, keep, ps))
    assert (lstm_kernel.GRU1_TRAIN_FWD.launches,
            lstm_kernel.GRU_BWD_CHAIN.launches) == (launches[0] + 3, launches[1] + 3)
    for i, (g, r) in enumerate(zip(ours, grads(plain))):
        # weight gradients sum T*B terms: relative 1e-4 of the largest
        scale = float(r.abs().max())
        torch.testing.assert_close(g, r, rtol=1e-4, atol=1e-4 * max(scale, 1.0),
                                   msg=f"gradient {i}")


@pytest.mark.parametrize("num_layers", [1, 3])
def test_layered_gru_trains_one_step_and_serves_on_the_card(num_layers):
    from multimodal_emotion_detection_tpu_torch.models.noise import Noise
    from multimodal_emotion_detection_tpu_torch.models.recurrent import (
        FusedStackedRNN,
    )

    dev = _card()
    b, t, d, h = 32, 372, 64, 512
    rnn = FusedStackedRNN(d, h, num_layers=num_layers, dropout=0.1, cell_type="gru")
    for i in range(num_layers):
        getattr(rnn, f"layer_{i}").reset_parameters(torch.Generator().manual_seed(i))
    x = torch.from_numpy(np.random.RandomState(7).randn(b, t, d).astype(np.float32))
    counters = (lstm_kernel.GRU1_TRAIN_FWD, lstm_kernel.GRU_BWD_CHAIN,
                lstm_kernel.GRU1_INFER, lstm_kernel.GRU2_TRAIN_FWD,
                lstm_kernel.GRU2_INFER, lstm_kernel.LSTM1_TRAIN_FWD)
    before = [c.launches for c in counters]
    card = rnn.to(dev).train()
    noise = Noise(torch.Generator(device=dev).manual_seed(0))
    card(x.to(dev), noise).sum().backward()
    grads = {n: p.grad.cpu() for n, p in card.named_parameters()}
    card.eval()
    with torch.no_grad():
        served = card(x.to(dev)).cpu()
    torch.cuda.synchronize()
    n = num_layers
    assert [c.launches - k for c, k in zip(counters, before)] == [n, n, n, 0, 0, 0]

    cpu = rnn.cpu().train()
    for p in cpu.parameters():
        p.grad = None
    cpu(x, Noise(replay=noise.drawn)).sum().backward()
    for name, p in cpu.named_parameters():
        scale = float(p.grad.abs().max())
        torch.testing.assert_close(grads[name], p.grad, rtol=1e-4,
                                   atol=1e-4 * max(scale, 1.0), msg=name)
    with torch.no_grad():
        torch.testing.assert_close(served, cpu.eval()(x), rtol=1e-4, atol=1e-4)



LEGACY_SHAPES = [(32, 372, 64, 256),                  # the flagship and GRU config
                 (32, 1, 64, 256), (32, 2, 64, 256),  # the wavefront's ends
                 (1, 5, 6, 64), (33, 5, 5, 128),      # one row; a ragged second pass
                 (3, 9, 64, 264)]                     # the widest pair, 2 x 132 SMs


def _close_to_largest(out, ref, msg):
    scale = float(ref.abs().max())
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-6 * max(scale, 1e-30), msg=msg)


# and the LSTM pair's at B 17 and an odd H / 4 (an odd grid: clusters of 1)
LSTM_LEGACY_SHAPES = LEGACY_SHAPES + [(17, 3, 64, 256), (32, 3, 64, 260),
                                      (17, 4, 5, 260), (1, 3, 64, 260)]


@pytest.mark.parametrize("b,t,d,h", LSTM_LEGACY_SHAPES)
def test_lstm2_legacy_kernels_match_plain(b, t, d, h):
    """Rows 5 and 9 (the 2-layer cores' legacy LSTM cells) against their
    plain versions at 1e-4, the chain with and without dys, each one
    counted launch; and against the residual-native pair (rows 11 and 12)
    on the same inputs to 1e-6 of the largest."""
    dev = _card()
    x_tm, keep, l0, l1 = _lstm_case(dev, b, t, d, h, seed=b * 1000 + t + 11)
    before = lstm_kernel.LSTM2_TRAIN_FWD_LEGACY.launches
    outs = lstm_kernel.lstm2_train_fwd_legacy(x_tm, keep, l0, l1)
    torch.cuda.synchronize()
    assert lstm_kernel.LSTM2_TRAIN_FWD_LEGACY.launches == before + 1
    refs = lstm_kernel.lstm2_train_fwd_legacy_reference(x_tm, keep, l0, l1)
    names = ("ys", "h_final", "g0", "g1", "h0_new", "c0_new", "c1_new")
    # float32 sums in another order than cuBLAS, carried through T steps
    for name, out, ref in zip(names, outs, refs):
        torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4, msg=name)
    # the residual-native form on the same inputs: the same arithmetic
    packed, h0p, h1p, _, finals = lstm_kernel.lstm2_train_fwd_residuals(x_tm, keep, l0, l1)
    ys, h_final, g0, g1, h0, c0, c1 = outs
    zero = torch.zeros_like(h0[:1])
    for name, out, ref in (("g0", g0, packed[..., :4 * h]), ("g1", g1, packed[..., 4 * h:8 * h]),
                           ("c0_prev", torch.cat([zero, c0[:-1]]), packed[..., 8 * h:9 * h]),
                           ("c1_prev", torch.cat([zero, c1[:-1]]), packed[..., 9 * h:]),
                           ("h0_prev", torch.cat([zero, h0[:-1]]), h0p),
                           ("h1_prev", torch.cat([zero, ys[:-1]]), h1p),
                           ("h_final", h_final, finals[2])):
        _close_to_largest(out, ref, f"legacy vs residual {name}")

    rng = np.random.RandomState(t)
    dh = torch.from_numpy(rng.randn(b, h).astype(np.float32)).to(dev)
    dys = torch.from_numpy(rng.randn(t, b, h).astype(np.float32)).to(dev)
    cp0, cp1 = (torch.cat([zero, c[:-1]]) for c in refs[5:7])
    for stream in (None, dys):
        args = (refs[2], refs[3], cp0, cp1, stream, keep, dh, l0["w_hh"], l1["w_hh"],
                l1["w_ih"])
        before = lstm_kernel.LSTM2_BWD_CHAIN_LEGACY.launches
        dgs = lstm_kernel.lstm2_bwd_chain_legacy(*args)
        torch.cuda.synchronize()
        assert lstm_kernel.LSTM2_BWD_CHAIN_LEGACY.launches == before + 1
        for name, out, ref in zip(("dg0", "dg1"), dgs,
                                  lstm_kernel.lstm2_bwd_chain_legacy_reference(*args)):
            torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4,
                                       msg=f"{name}, dys {stream is not None}")
    dgs_res = lstm_kernel.lstm2_bwd_chain(
        torch.cat([refs[2], refs[3], cp0, cp1], dim=-1), keep, dh, l0["w_hh"],
        l1["w_hh"], l1["w_ih"])
    dgs = lstm_kernel.lstm2_bwd_chain_legacy(refs[2], refs[3], cp0, cp1, None, keep, dh,
                                             l0["w_hh"], l1["w_hh"], l1["w_ih"])
    for name, out, ref in zip(("dg0", "dg1"), dgs, dgs_res):
        _close_to_largest(out, ref, f"legacy vs residual chain {name}")


def test_lstm2_legacy_pair_takes_every_shape_the_route_sends():
    """Every (B, H) that ``lstm_route`` sends to the pair, which
    ``set_res2_mode("off")`` runs on rows 5 and 9 (2 layers, H % 4 == 0, H
    <= 2 x SMs; any B, as the first designs took them), launches both: H 4
    .. 2 x SMs at B 1, 33 and 300, T 2, against the plain versions at 1e-4
    (the chain with dys).  A wider H has no plan: the wrappers raise and
    launch nothing."""
    from multimodal_emotion_detection_tpu_torch.ops.lstm_vjp import lstm_route

    dev = _card()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    fwd_k, bwd_k = lstm_kernel.LSTM2_TRAIN_FWD_LEGACY, lstm_kernel.LSTM2_BWD_CHAIN_LEGACY
    for h in range(4, 2 * sms + 1, 4):
        assert lstm_route(2, h, sms) == "pair"
        for b in (1, 33, 300):
            x_tm, keep, l0, l1 = _lstm_case(dev, b, 2, 3, h, seed=h * 10 + b)
            before = fwd_k.launches
            outs = lstm_kernel.lstm2_train_fwd_legacy(x_tm, keep, l0, l1)
            torch.cuda.synchronize()
            assert fwd_k.launches == before + 1, (b, h)
            refs = lstm_kernel.lstm2_train_fwd_legacy_reference(x_tm, keep, l0, l1)
            for i, (out, ref) in enumerate(zip(outs, refs)):
                torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4,
                                           msg=f"B={b} H={h} forward output {i}")
            zero = torch.zeros_like(refs[5][:1])
            dys = torch.ones_like(refs[0])
            args = (refs[2], refs[3], torch.cat([zero, refs[5][:-1]]),
                    torch.cat([zero, refs[6][:-1]]), dys, keep, dys[0], l0["w_hh"],
                    l1["w_hh"], l1["w_ih"])
            before = bwd_k.launches
            dgs = lstm_kernel.lstm2_bwd_chain_legacy(*args)
            torch.cuda.synchronize()
            assert bwd_k.launches == before + 1, (b, h)
            for name, out, ref in zip(("dg0", "dg1"), dgs,
                                      lstm_kernel.lstm2_bwd_chain_legacy_reference(*args)):
                torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4,
                                           msg=f"B={b} H={h} {name}")
    h = 2 * sms + 4
    assert lstm_route(2, h, sms) == "layered"
    x_tm, keep, l0, l1 = _lstm_case(dev, 2, 2, 3, h, seed=1)
    w = torch.zeros((h, 4 * h), device=dev)
    g, c = torch.zeros((2, 2, 4 * h), device=dev), torch.zeros((2, 2, h), device=dev)
    before = (fwd_k.launches, bwd_k.launches)
    with pytest.raises(ValueError, match="chain_plan"):
        lstm_kernel.lstm2_train_fwd_legacy(x_tm, keep, l0, l1)
    with pytest.raises(ValueError, match="chain_plan"):
        lstm_kernel.lstm2_bwd_chain_legacy(g, g, c, c, None, keep, c[0], w, w, w)
    assert (fwd_k.launches, bwd_k.launches) == before


# and the GRU pair's at B 17 and an odd H / 4, as the LSTM's
GRU_LEGACY_SHAPES = LEGACY_SHAPES + [(17, 3, 64, 256), (32, 3, 64, 260),
                                    (17, 4, 5, 260), (1, 3, 64, 260)]


@pytest.mark.parametrize("b,t,d,h", GRU_LEGACY_SHAPES)
def test_gru2_legacy_kernels_match_plain(b, t, d, h):
    """Rows 8 and 10 (the 2-layer cores' legacy GRU cells) against their
    plain versions at 1e-4, the chain with and without dys, each one
    counted launch; row 8 against the residual-native forward (row 14) on
    the same inputs bit for bit on r, z, n, hn and h (one cell arithmetic,
    one plan), row 10 against row 15 to 1e-6 of the largest."""
    dev = _card()
    x_tm, keep, l0, l1 = _gru_case(dev, b, t, d, h, seed=b * 1000 + t + 13)
    before = lstm_kernel.GRU2_TRAIN_FWD_LEGACY.launches
    ys, h_final, layers = lstm_kernel.gru2_train_fwd_legacy(x_tm, keep, l0, l1)
    torch.cuda.synchronize()
    assert lstm_kernel.GRU2_TRAIN_FWD_LEGACY.launches == before + 1
    r_ys, r_hf, r_layers = lstm_kernel.gru2_train_fwd_legacy_reference(x_tm, keep, l0, l1)
    torch.testing.assert_close(ys, r_ys, rtol=1e-4, atol=1e-4, msg="ys")
    torch.testing.assert_close(h_final, r_hf, rtol=1e-4, atol=1e-4, msg="h_final")
    for i in range(2):
        for j, name in enumerate(("r", "z", "n", "hn", "h_new")):
            torch.testing.assert_close(layers[i][j], r_layers[i][j], rtol=1e-4,
                                       atol=1e-4, msg=f"layer_{i}.{name}")
    # the residual-native form on the same inputs: the same cell arithmetic
    # and plan, so the same bits
    packed, h0p, h1p, _, finals = lstm_kernel.gru2_train_fwd_residuals(x_tm, keep, l0, l1)
    zero = torch.zeros_like(ys[:1])
    for i, hp in enumerate((h0p, h1p)):
        assert torch.equal(torch.cat(layers[i][:4], dim=-1),
                           packed[..., 4 * h * i:4 * h * (i + 1)]), f"layer_{i} gates"
        assert torch.equal(torch.cat([zero, layers[i][4][:-1]]), hp), f"layer_{i} h_prev"
    assert torch.equal(h_final, finals[1]), "h_final"

    rng = np.random.RandomState(t)
    dh = torch.from_numpy(rng.randn(b, h).astype(np.float32)).to(dev)
    dys = torch.from_numpy(rng.randn(t, b, h).astype(np.float32)).to(dev)
    res0, res1 = ((torch.cat([zero, lay[4][:-1]]),) + tuple(lay[:4]) for lay in r_layers)
    w = (l0["w_hh"], l1["w_hh"], l1["w_ih"])
    for stream in (None, dys):
        args = (res0, res1, stream, keep, dh, *w)
        before = lstm_kernel.GRU2_BWD_CHAIN_LEGACY.launches
        outs = lstm_kernel.gru2_bwd_chain_legacy(*args)
        torch.cuda.synchronize()
        assert lstm_kernel.GRU2_BWD_CHAIN_LEGACY.launches == before + 1
        refs = lstm_kernel.gru2_bwd_chain_legacy_reference(*args)
        for i in range(2):
            for j, name in enumerate(("dih", "dhh")):
                torch.testing.assert_close(outs[i][j], refs[i][j], rtol=1e-4, atol=1e-4,
                                           msg=f"{name}{i}, dys {stream is not None}")
            # dhh's r and z lanes are copies of dih's
            assert torch.equal(outs[i][1][..., :2 * h], outs[i][0][..., :2 * h])
    dih0, dhn0, dih1, dhn1 = lstm_kernel.gru2_bwd_chain(
        torch.cat([*res0[1:], *res1[1:]], dim=-1), res0[0], res1[0], keep, dh, *w)
    outs = lstm_kernel.gru2_bwd_chain_legacy(res0, res1, None, keep, dh, *w)
    for i, (dih, dhn) in enumerate(((dih0, dhn0), (dih1, dhn1))):
        _close_to_largest(outs[i][0], dih, f"legacy vs residual chain dih{i}")
        _close_to_largest(outs[i][1][..., 2 * h:], dhn, f"legacy vs residual chain dhn{i}")


def test_gru2_legacy_train_fwd_takes_every_shape_the_route_sends():
    """Every (B, H) that ``gru_route`` sends to the pair, which
    ``set_res2_mode("off")`` runs on row 8 (2 layers, H % 4 == 0, H <= 2 x
    SMs; any B, as the first design took them), launches it: H 4 .. 2 x
    SMs at B 1, 33 and 300, T 2, against the plain version at 1e-4.  A
    wider H has no plan: the wrapper raises and launches nothing."""
    from multimodal_emotion_detection_tpu_torch.ops.lstm_vjp import gru_route

    dev = _card()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    kern = lstm_kernel.GRU2_TRAIN_FWD_LEGACY
    for h in range(4, 2 * sms + 1, 4):
        assert gru_route(2, h, sms) == "pair"
        for b in (1, 33, 300):
            x_tm, keep, l0, l1 = _gru_case(dev, b, 2, 3, h, seed=h * 10 + b)
            before = kern.launches
            ys, h_final, layers = lstm_kernel.gru2_train_fwd_legacy(x_tm, keep, l0, l1)
            torch.cuda.synchronize()
            assert kern.launches == before + 1, (b, h)
            r_ys, r_hf, r_layers = lstm_kernel.gru2_train_fwd_legacy_reference(
                x_tm, keep, l0, l1)
            outs = (ys, h_final, *layers[0], *layers[1])
            refs = (r_ys, r_hf, *r_layers[0], *r_layers[1])
            for i, (out, ref) in enumerate(zip(outs, refs)):
                torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4,
                                           msg=f"B={b} H={h} output {i}")
    h = 2 * sms + 4
    assert gru_route(2, h, sms) == "layered"
    x_tm, keep, l0, l1 = _gru_case(dev, 2, 2, 3, h, seed=1)
    before = kern.launches
    with pytest.raises(ValueError, match="chain_plan"):
        lstm_kernel.gru2_train_fwd_legacy(x_tm, keep, l0, l1)
    assert kern.launches == before


@pytest.mark.parametrize("route", ["lstm", "gru_fused", "gru_layered"])
@pytest.mark.parametrize("b,t,d,h", [(3, 40, 6, 128), (32, 372, 64, 256)])
def test_legacy_routes_launch_their_kernels_and_match_plain_autograd(route, b, t, d, h):
    from multimodal_emotion_detection_tpu_torch.ops import lstm_vjp

    dev = _card()
    cell = route[:3] if route != "lstm" else "lstm"
    case = _lstm_case if cell == "lstm" else _gru_case
    x_tm, keep, l0, l1 = case(dev, b, t, d, h, seed=23 + b)
    weight = torch.from_numpy(
        np.random.RandomState(b).randn(b, h).astype(np.float32)).to(dev)

    def grads(fn):
        x = x_tm.transpose(0, 1).contiguous().requires_grad_()
        p0 = {k: v.clone().requires_grad_() for k, v in l0.items()}
        p1 = {k: v.clone().requires_grad_() for k, v in l1.items()}
        (fn(x, p0, p1) * weight).sum().backward()
        return [x.grad] + [p.grad for p in (*p0.values(), *p1.values())]

    k = lstm_kernel
    counters = {"lstm": (k.LSTM2_TRAIN_FWD_LEGACY, k.LSTM2_BWD_CHAIN_LEGACY,
                         k.LSTM2_TRAIN_FWD, k.LSTM2_BWD_CHAIN),
                "gru_fused": (k.GRU2_TRAIN_FWD_LEGACY, k.GRU2_BWD_CHAIN_LEGACY,
                              k.GRU2_TRAIN_FWD, k.GRU2_BWD_CHAIN, k.GRU_BWD_CHAIN),
                "gru_layered": (k.GRU2_TRAIN_FWD_LEGACY, k.GRU_BWD_CHAIN,
                                k.GRU2_BWD_CHAIN_LEGACY, k.GRU2_TRAIN_FWD,
                                k.GRU2_BWD_CHAIN)}[route]
    expected = {"lstm": [1, 1, 0, 0], "gru_fused": [1, 1, 0, 0, 0],
                "gru_layered": [1, 2, 0, 0, 0]}[route]
    fused = lstm_vjp.fused_lstm_final if cell == "lstm" else lstm_vjp.fused_gru_final
    before = [c.launches for c in counters]
    prev_mode, prev_bwd2 = lstm_vjp.set_res2_mode("off"), lstm_vjp.GRU_BWD2_ENABLED
    lstm_vjp.GRU_BWD2_ENABLED = route == "gru_fused"
    try:
        ours = grads(lambda x, p0, p1: fused(x, keep[:, None], (p0, p1)))
    finally:
        lstm_vjp.set_res2_mode(prev_mode)
        lstm_vjp.GRU_BWD2_ENABLED = prev_bwd2
    torch.cuda.synchronize()
    assert [c.launches - n for c, n in zip(counters, before)] == expected
    if cell == "lstm":
        plain = grads(lambda x, p0, p1: k.lstm2_train_fwd_legacy_reference(
            x.transpose(0, 1), keep, p0, p1)[1])
    else:
        plain = grads(lambda x, p0, p1: k.gru2_train_fwd_legacy_reference(
            x.transpose(0, 1), keep, p0, p1)[1])
    for i, (g, r) in enumerate(zip(ours, plain)):
        # weight gradients sum T*B terms: relative 1e-4 of the largest
        scale = float(r.abs().max())
        torch.testing.assert_close(g, r, rtol=1e-4, atol=1e-4 * max(scale, 1.0),
                                   msg=f"gradient {i}")

def _flash_case(dev, b, h, tq, tk, d, masked, seed):
    rng = np.random.RandomState(seed)
    q = torch.from_numpy(rng.randn(b, h, tq, d).astype(np.float32)).to(dev)
    k, v = (torch.from_numpy(rng.randn(b, h, tk, d).astype(np.float32)).to(dev)
            for _ in range(2))
    bias = None
    if masked:
        keep = rng.rand(b, tk) > 0.25
        keep[:, 0] = True
        bias = torch.from_numpy(np.where(keep, 0.0, -1e9).astype(np.float32)).to(dev)
    do = torch.from_numpy(rng.randn(b, h, tq, d).astype(np.float32)).to(dev)
    return q, k, v, bias, do


FLASH_SHAPES = [
    # b, h, tq, tk, d, masked, rate
    (1, 1, 1, 1, 64, False, 0.0),        # one query, one key
    (2, 4, 77, 77, 40, True, 0.0),       # ragged tiles, padded head dim
    (2, 2, 130, 130, 64, False, 0.1),    # dropout, three key tiles
    (1, 2, 50, 300, 128, True, 0.2),     # cross attention, head dim 128
    (32, 4, 372, 372, 64, False, 0.1),   # the encoder's shape
    (3, 4, 512, 512, 64, True, 0.1),     # blockwise-fold blocks
    (1, 2, 70, 1100, 32, True, 0.1),     # several key tiles per span
    (2, 2, 65, 65, 64, False, 0.1),      # one row past a 64-row query tile
    (2, 2, 100, 100, 96, True, 0.1),     # head dim 96, padded to 128
    (2, 2, 70, 130, 8, False, 0.1),      # head dim 8, padded to 64
    (1, 2, 64, 5000, 64, True, 0.1),     # dq's ragged last key tile (8 keys)
    (2, 3, 45, 150, 13, True, 0.1),      # head dim 13: the 4-byte copies
    (3, 2, 33, 700, 128, True, 0.0),     # head dim 128, two key tiles a span
    (2, 2, 90, 90, 72, True, 0.1),       # head dim 72, padded to 128
    (3, 65535, 2, 2, 4, False, 0.1),     # the most heads a launch takes
    (65535, 2, 2, 2, 4, True, 0.1),      # the most batch rows
]


def _check_flash_kernels(b, h, tq, tk, d, masked, rate, q_scale=1.0):
    from multimodal_emotion_detection_tpu_torch.ops import flash_attention as fa

    dev = _card()
    q, k, v, bias, do = _flash_case(dev, b, h, tq, tk, d, masked, seed=tq + tk + d)
    q = q * q_scale
    seed = torch.tensor([tq * 1000 + tk], dtype=torch.int64, device=dev)
    before = fa.FLASH_FWD.launches
    o, lse = fa.flash_fwd(q, k, v, bias, seed, rate)
    torch.cuda.synchronize()
    assert fa.FLASH_FWD.launches == before + 1
    o_ref, lse_ref = fa.flash_fwd_reference(q, k, v, bias, seed, rate)
    # float32 sums in another order than cuBLAS (3xTF32 on the tensor cores)
    torch.testing.assert_close(o, o_ref, rtol=1e-4, atol=1e-4, msg="O")
    torch.testing.assert_close(lse, lse_ref, rtol=1e-5, atol=1e-5, msg="LSE")

    delta = (do * o_ref).sum(-1)
    args = (q, k, v, bias, seed, rate, do, lse_ref, delta)
    refs = fa.flash_bwd_reference(*args)
    counters = (fa.FLASH_BWD_FUSED, fa.FLASH_BWD_DKV, fa.FLASH_BWD_DQ)
    before = [c.launches for c in counters]
    fused = fa.flash_bwd_fused(*args)
    two_pass = (fa.flash_bwd_dq(*args), *fa.flash_bwd_dkv(*args))
    torch.cuda.synchronize()
    assert [c.launches - n for c, n in zip(counters, before)] == [1, 1, 1]
    for form, outs in (("fused", fused), ("two-pass", two_pass)):
        for name, g, r in zip(("dQ", "dK", "dV"), outs, refs):
            # sums over up to Tq or Tk terms: relative 1e-4 of the largest
            scale = float(r.abs().max())
            torch.testing.assert_close(g, r, rtol=1e-4, atol=1e-4 * max(scale, 1.0),
                                       msg=f"{form} {name}")


@pytest.mark.parametrize("b,h,tq,tk,d,masked,rate", FLASH_SHAPES)
def test_flash_kernels_match_plain(b, h, tq, tk, d, masked, rate):
    _check_flash_kernels(b, h, tq, tk, d, masked, rate)


def test_flash_kernels_match_plain_at_large_logits():
    # q scaled by 6: scores up to ~30, where an error in the TF32 split of
    # the operands would show in LSE and through exp in O and dQ
    _check_flash_kernels(2, 4, 200, 200, 64, True, 0.1, q_scale=6.0)


def test_flash_attention_on_the_card_matches_the_cpu_with_one_seed():
    from multimodal_emotion_detection_tpu_torch.ops import flash_attention as fa

    dev = _card()
    cpu = _flash_case(torch.device("cpu"), 2, 4, 200, 200, 64, True, seed=3)
    seed = torch.tensor([2**45 + 3], dtype=torch.int64)

    def run(tensors, s):
        q, k, v = (t.clone().requires_grad_() for t in tensors[:3])
        out = fa.flash_attention(q, k, v, tensors[3], dropout_rate=0.1, dropout_seed=s)
        (out * tensors[4]).sum().backward()
        return [out.detach().cpu()] + [t.grad.cpu() for t in (q, k, v)]

    card = run([t.to(dev) if t is not None else None for t in cpu], seed.to(dev))
    # the same Philox mask on both sides: the results agree to round-off
    for name, g, r in zip(("O", "dQ", "dK", "dV"), card, run(cpu, seed)):
        torch.testing.assert_close(g, r, rtol=1e-4, atol=1e-4, msg=name)


@pytest.mark.parametrize("b,h,tq,tk,d,masked,rate", [
    (2, 4, 77, 130, 40, True, 0.1),      # head dim 40, ragged key tile
    (2, 2, 300, 1000, 64, False, 0.0),   # rate 0, no bias
    (2, 2, 300, 1000, 64, True, 0.1),    # key bias, dropout
    (1, 2, 100, 260, 128, True, 0.1),    # head dim 128: one ring stage
    (1, 2, 100, 4096, 64, True, 0.1),    # the fused form's 8 tiles a span
    (1, 2, 65, 4000, 128, False, 0.0),   # head dim 128, Tk off the tiles
])
def test_flash_bwd_dkv_form_matches_plain_and_the_fused_form(b, h, tq, tk, d, masked, rate):
    # the dK / dV form is flash_bwd_fused.cu without its dQ phase: the same
    # products in the same order, so its dK and dV are the fused form's bit
    # for bit (at Tk <= 4,096, where the fused form runs), and within 1e-4
    # of the largest entry of the plain version's
    from multimodal_emotion_detection_tpu_torch.ops import flash_attention as fa

    dev = _card()
    q, k, v, bias, do = _flash_case(dev, b, h, tq, tk, d, masked, seed=tq + tk + d)
    seed = torch.tensor([tq * 1000 + tk], dtype=torch.int64, device=dev)
    o, lse = fa.flash_fwd_reference(q, k, v, bias, seed, rate)
    args = (q, k, v, bias, seed, rate, do, lse, (do * o).sum(-1))
    before = (fa.FLASH_BWD_DKV.launches, fa.FLASH_BWD_FUSED.launches)
    dk, dv = fa.flash_bwd_dkv(*args)
    _, dk_fused, dv_fused = fa.flash_bwd_fused(*args)
    torch.cuda.synchronize()
    assert (fa.FLASH_BWD_DKV.launches - before[0],
            fa.FLASH_BWD_FUSED.launches - before[1]) == (1, 1)
    assert torch.equal(dk, dk_fused) and torch.equal(dv, dv_fused)
    for name, g, r in zip(("dK", "dV"), (dk, dv), fa.flash_bwd_reference(*args)[1:]):
        scale = float(r.abs().max())
        torch.testing.assert_close(g, r, rtol=1e-4, atol=1e-4 * max(scale, 1.0),
                                   msg=name)


def _half_close(out, ref, msg, ulps=4):
    """A bf16 kernel output against its plain version on the same inputs:
    within ``ulps`` bf16 ulps of the largest entry (one ulp = 2^-8 of it)
    plus 1e-6.  The two round at the same points from float32 values that
    differ by sums in another order (and, in O, by P taken after the
    running max), so an element may land an ulp or two away; where the
    exact result is 0 (dQ with one key) only that round-off is left."""
    assert out.dtype == ref.dtype == torch.bfloat16, msg
    err = float((out.float() - ref.float()).abs().max())
    bound = ulps * 2.0 ** -8 * float(ref.float().abs().max()) + 1e-6
    assert err <= bound, f"{msg}: {err:.3e} > {bound:.3e}"


def _check_flash_bf16_kernels(b, h, tq, tk, d, masked, rate):
    from multimodal_emotion_detection_tpu_torch.ops import flash_attention as fa

    dev = _card()
    q, k, v, bias, do = _flash_case(dev, b, h, tq, tk, d, masked, seed=tq + tk + d)
    q, k, v, do = (t.to(torch.bfloat16) for t in (q, k, v, do))
    seed = torch.tensor([tq * 1000 + tk], dtype=torch.int64, device=dev)
    f32 = (fa.FLASH_FWD, fa.FLASH_BWD_FUSED, fa.FLASH_BWD_DKV, fa.FLASH_BWD_DQ)
    f32_before = [c.launches for c in f32]
    before = fa.FLASH_FWD_BF16.launches
    o, lse = fa.flash_fwd(q, k, v, bias, seed, rate)
    torch.cuda.synchronize()
    assert fa.FLASH_FWD_BF16.launches == before + 1
    o_ref, lse_ref = fa.flash_fwd_reference(q, k, v, bias, seed, rate)
    _half_close(o, o_ref, "O")
    # float32 statistics from bf16 products summed in another order
    torch.testing.assert_close(lse, lse_ref, rtol=1e-5, atol=1e-5, msg="LSE")

    delta = (do.float() * o_ref.float()).sum(-1)
    args = (q, k, v, bias, seed, rate, do, lse_ref, delta)
    refs = fa.flash_bwd_reference(*args)
    counters = (fa.FLASH_BWD_FUSED_BF16, fa.FLASH_BWD_DKV_BF16, fa.FLASH_BWD_DQ_BF16)
    before = [c.launches for c in counters]
    fused = fa.flash_bwd_fused(*args)
    two_pass = (fa.flash_bwd_dq(*args), *fa.flash_bwd_dkv(*args))
    torch.cuda.synchronize()
    assert [c.launches - n for c, n in zip(counters, before)] == [1, 1, 1]
    assert [c.launches for c in f32] == f32_before  # no float32 form ran
    for form, outs in (("fused", fused), ("two-pass", two_pass)):
        for name, g, r in zip(("dQ", "dK", "dV"), outs, refs):
            _half_close(g, r, f"{form} {name}")
    # dK and dV of the dK / dV form are the fused form's bit for bit, and so
    # is dQ of the dQ form (the q role's values in the q role's key order)
    assert torch.equal(two_pass[1], fused[1]) and torch.equal(two_pass[2], fused[2])
    assert torch.equal(two_pass[0], fused[0])
    # no atomics, no partial slots: a second run of the dQ form, the same bits
    assert torch.equal(fa.flash_bwd_dq(*args), two_pass[0])


@pytest.mark.parametrize("b,h,tq,tk,d,masked,rate", FLASH_SHAPES)
def test_flash_bf16_kernels_match_plain(b, h, tq, tk, d, masked, rate):
    _check_flash_bf16_kernels(b, h, tq, tk, d, masked, rate)


def test_flash_bf16_fused_backward_at_the_fused_routes_last_size():
    # Tk 4,096, the most keys the fused route takes: the q role sums dQ over
    # 64 key tiles on chip, every query row against its plain version
    _check_flash_bf16_kernels(1, 2, 4096, 4096, 64, True, 0.1)


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_flash_bf16_dq_form_at_5000_keys(rate):
    # the two-pass route's dQ pass at (2, 4, 5000, 64) with a key bias: 79
    # key tiles walked a query tile, against the plain version within 4 bf16
    # ulps, two runs bit for bit, and no other flash form launched
    from multimodal_emotion_detection_tpu_torch.ops import flash_attention as fa

    dev = _card()
    q, k, v, bias, do = _flash_case(dev, 2, 4, 5000, 5000, 64, True, seed=5064)
    q, k, v, do = (t.to(torch.bfloat16) for t in (q, k, v, do))
    seed = torch.tensor([0xA77E5710], dtype=torch.int64, device=dev)
    o, lse = fa.flash_fwd_reference(q, k, v, bias, seed, rate)
    args = (q, k, v, bias, seed, rate, do, lse, (do.float() * o.float()).sum(-1))
    others = (fa.FLASH_FWD, fa.FLASH_BWD_FUSED, fa.FLASH_BWD_DKV, fa.FLASH_BWD_DQ,
              fa.FLASH_FWD_BF16, fa.FLASH_BWD_FUSED_BF16, fa.FLASH_BWD_DKV_BF16)
    others_before = [c.launches for c in others]
    before = fa.FLASH_BWD_DQ_BF16.launches
    first, second = fa.flash_bwd_dq(*args), fa.flash_bwd_dq(*args)
    torch.cuda.synchronize()
    assert fa.FLASH_BWD_DQ_BF16.launches == before + 2
    assert [c.launches for c in others] == others_before
    assert torch.equal(first, second)
    _half_close(first, fa.flash_bwd_reference(*args)[0], f"dQ at rate {rate}")


@pytest.mark.parametrize("b,h,tq,tk,d,masked,rate", [
    (32, 4, 372, 372, 64, False, 0.1),   # the encoder's shape
    (2, 2, 300, 1000, 64, True, 0.0),    # many key tiles, no dropout
    (1, 2, 50, 300, 128, True, 0.2),     # head dim 128
    (2, 3, 45, 150, 13, True, 0.1),      # head dim 13: padded to 16
])
def test_flash_bf16_kernels_are_deterministic(b, h, tq, tk, d, masked, rate):
    # no atomics and no partial sums: two runs on the same inputs give the
    # same bits for O, LSE, dQ, dK and dV
    from multimodal_emotion_detection_tpu_torch.ops import flash_attention as fa

    dev = _card()
    q, k, v, bias, do = _flash_case(dev, b, h, tq, tk, d, masked, seed=tq + tk + d)
    q, k, v, do = (t.to(torch.bfloat16) for t in (q, k, v, do))
    seed = torch.tensor([tq * 1000 + tk], dtype=torch.int64, device=dev)

    def run():
        o, lse = fa.flash_fwd(q, k, v, bias, seed, rate)
        delta = (do.float() * o.float()).sum(-1)
        return (o, lse, *fa.flash_bwd_fused(q, k, v, bias, seed, rate, do, lse, delta))

    first, second = run(), run()
    torch.cuda.synchronize()
    for name, x, y in zip(("O", "LSE", "dQ", "dK", "dV"), first, second):
        assert torch.equal(x, y), name


def test_flash_attention_bf16_on_the_card_takes_the_bf16_forms():
    # through the autograd Function on both backward routes: the bf16
    # forms launch, the float32 forms never, and O and the gradients are
    # bf16 within the kernels' bound of the CPU's plain versions
    from multimodal_emotion_detection_tpu_torch.ops import flash_attention as fa

    dev = _card()
    for t in (300, 4200):
        q, k, v, bias, do = _flash_case(torch.device("cpu"), 1, 2, t, t, 64, True, seed=t)
        cpu = [q.bfloat16(), k.bfloat16(), v.bfloat16(), bias, do.bfloat16()]
        seed = torch.tensor([2**40 + t], dtype=torch.int64)

        def run(tensors, s):
            q, k, v = (x.clone().requires_grad_() for x in tensors[:3])
            out = fa.flash_attention(q, k, v, tensors[3], dropout_rate=0.1, dropout_seed=s)
            out.backward(tensors[4])
            return [out.detach().cpu()] + [x.grad.cpu() for x in (q, k, v)]

        counters = (fa.FLASH_FWD, fa.FLASH_BWD_FUSED, fa.FLASH_BWD_DKV, fa.FLASH_BWD_DQ,
                    fa.FLASH_FWD_BF16, fa.FLASH_BWD_FUSED_BF16, fa.FLASH_BWD_DKV_BF16,
                    fa.FLASH_BWD_DQ_BF16)
        before = [c.launches for c in counters]
        card = run([x.to(dev) if x is not None else None for x in cpu], seed.to(dev))
        torch.cuda.synchronize()
        fused = fa.bwd_route(t) == "fused"
        assert [c.launches - n for c, n in zip(counters, before)] == [
            0, 0, 0, 0, 1, int(fused), int(not fused), int(not fused)]
        for name, g, r in zip(("O", "dQ", "dK", "dV"), card, run(cpu, seed)):
            _half_close(g, r, f"T {t} {name}")


def test_bf16_transformer_encoder_trains_one_step_and_serves_on_the_card():
    # the transformer config's encoder at full width in bf16: a training
    # forward + backward launches the bf16 forward twice (two blocks) and
    # the bf16 fused backward twice, an eval forward the bf16 forward
    # twice, and no float32 form; the card against the CPU (plain
    # versions) on the same weights and Philox seeds, bf16 on both sides:
    # outputs within 4 bf16 ulps of the largest, gradients (float32
    # parameters) within 2e-2 of the largest, as the bf16 step rule
    from multimodal_emotion_detection_tpu_torch.models.classifier import init_weights
    from multimodal_emotion_detection_tpu_torch.models.encoders import SequenceEncoder
    from multimodal_emotion_detection_tpu_torch.models.noise import Noise
    from multimodal_emotion_detection_tpu_torch.ops import flash_attention as fa

    dev = _card()
    enc = init_weights(SequenceEncoder(64, 256, 128, num_layers=2, dropout=0.1,
                                       encoder_type="transformer", dtype=torch.bfloat16),
                       torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.RandomState(7).randn(32, 372, 64).astype(np.float32))
    w = torch.from_numpy(np.random.RandomState(8).randn(32, 128).astype(np.float32))
    counters = (fa.FLASH_FWD, fa.FLASH_BWD_FUSED, fa.FLASH_FWD_BF16, fa.FLASH_BWD_FUSED_BF16)
    before = [c.launches for c in counters]
    card = copy.deepcopy(enc).to(dev).train()
    noise = Noise(torch.Generator(device=dev).manual_seed(0))
    out = card(x.to(dev), noise)
    assert out.dtype == torch.bfloat16
    (out.float() * w.to(dev)).sum().backward()
    grads = {n: p.grad.cpu() for n, p in card.named_parameters()}
    card.eval()
    with torch.no_grad():
        served = card(x.to(dev)).cpu()
    torch.cuda.synchronize()
    assert [c.launches - n for c, n in zip(counters, before)] == [0, 0, 4, 2]

    cpu = enc.train()
    want = cpu(x, Noise(replay=noise.drawn))
    (want.float() * w).sum().backward()
    _half_close(out.detach().cpu(), want.detach(), "training output")
    g_max = max(float(p.grad.abs().max()) for p in cpu.parameters())
    for n, p in cpu.named_parameters():
        err = float((grads[n] - p.grad).abs().max())
        assert err <= 2e-2 * g_max, f"{n}: {err:.3e} of {g_max:.3e}"
    with torch.no_grad():
        _half_close(served, cpu.eval()(x), "served output")


# configs/base.yaml as written: the raw waveform, 48,000 steps at b32.  The
# LSTM pair's packed rows (10H) pass 2^31 elements from step 26,214, the
# GRU pair's (8H) and one H=512 layer's gates (4H) from step 32,768: any
# 32-bit offset left in a core shows past there
RAW_T = 48000


def _close_in_chunks(out, ref, msg, chunk=2048):
    """``out`` within 1e-4 of ``ref``'s largest entry, compared a few
    thousand steps at a time (a whole raw-length series is ~16 GB)."""
    assert out.shape == ref.shape, msg
    largest = max(float(ref[t:t + chunk].abs().max()) for t in range(0, ref.shape[0], chunk))
    for t in range(0, ref.shape[0], chunk):
        err = float((out[t:t + chunk] - ref[t:t + chunk]).abs().max())
        assert err <= 1e-4 * largest, f"{msg}: steps from {t}: {err:.3e} of {largest:.3e}"


def test_lstm2_pair_matches_plain_at_raw_length():
    dev = _card()
    x_tm, keep, l0, l1 = _lstm_case(dev, 32, RAW_T, 1, 256, seed=48)
    refs = lstm_kernel.lstm2_train_fwd_reference(x_tm, keep, l0, l1)
    outs = lstm_kernel.lstm2_train_fwd_residuals(x_tm, keep, l0, l1)
    torch.cuda.synchronize()
    for name, o, r in zip(("packed", "h0p", "h1p", "x1", "finals"), outs, refs):
        _close_in_chunks(o, r, name)
    packed = outs[0]
    del refs, outs
    dh = torch.from_numpy(np.random.RandomState(48).randn(32, 256).astype(np.float32)).to(dev)
    args = (packed, keep, dh, l0["w_hh"], l1["w_hh"], l1["w_ih"])
    refs = lstm_kernel.lstm2_bwd_chain_reference(*args)
    outs = lstm_kernel.lstm2_bwd_chain(*args)
    torch.cuda.synchronize()
    for name, o, r in zip(("dg0", "dg1"), outs, refs):
        _close_in_chunks(o, r, name)


def test_gru2_pair_matches_plain_at_raw_length():
    dev = _card()
    x_tm, keep, l0, l1 = _gru_case(dev, 32, RAW_T, 1, 256, seed=49)
    refs = lstm_kernel.gru2_train_fwd_reference(x_tm, keep, l0, l1)
    outs = lstm_kernel.gru2_train_fwd_residuals(x_tm, keep, l0, l1)
    torch.cuda.synchronize()
    for name, o, r in zip(("packed", "h0p", "h1p", "x1", "finals"), outs, refs):
        _close_in_chunks(o, r, name)
    series = outs[:3]
    del refs, outs
    dh = torch.from_numpy(np.random.RandomState(49).randn(32, 256).astype(np.float32)).to(dev)
    args = (*series, keep, dh, l0["w_hh"], l1["w_hh"], l1["w_ih"])
    del series
    refs = lstm_kernel.gru2_bwd_chain_reference(*args)
    outs = lstm_kernel.gru2_bwd_chain(*args)
    torch.cuda.synchronize()
    for name, o, r in zip(("dih0", "dhn0", "dih1", "dhn1"), outs, refs):
        _close_in_chunks(o, r, name)


def test_lstm1_layer_matches_plain_at_raw_length():
    dev = _card()
    b, h = 32, 512
    rng = np.random.RandomState(50)
    k = 1.0 / np.sqrt(h)
    x = torch.from_numpy(rng.randn(RAW_T, b, 1).astype(np.float32)).to(dev)
    w_ih, w_hh, bias = (torch.from_numpy(rng.uniform(-k, k, s).astype(np.float32)).to(dev)
                        for s in ((1, 4 * h), (h, 4 * h), (4 * h,)))
    ih = torch.matmul(x, w_ih) + bias
    refs = lstm_kernel.lstm1_train_fwd_reference(ih, w_hh)
    outs = lstm_kernel.lstm1_train_fwd(ih, w_hh)
    torch.cuda.synchronize()
    for name, o, r in zip(("g", "h_prev", "c_prev", "finals"), outs, refs):
        _close_in_chunks(o, r, name)
    g, c_prev = outs[0], outs[2]
    del refs, outs, ih
    dhs = torch.from_numpy(rng.randn(RAW_T, b, h).astype(np.float32)).to(dev)
    dhf = torch.from_numpy(rng.randn(b, h).astype(np.float32)).to(dev)
    ref = lstm_kernel.lstm_bwd_chain_reference(g, c_prev, dhs, dhf, w_hh)
    out = lstm_kernel.lstm_bwd_chain(g, c_prev, dhs, dhf, w_hh)
    torch.cuda.synchronize()
    _close_in_chunks(out, ref, "dg")


def _bn_encoder(kind):
    from multimodal_emotion_detection_tpu_torch.models.classifier import init_weights
    from multimodal_emotion_detection_tpu_torch.models.encoders import (
        SequenceEncoder,
        SimpleMLPEncoder,
    )

    enc = (SequenceEncoder(64, 256, 128, encoder_type="cnn", dropout=0.1)
           if kind == "cnn" else SimpleMLPEncoder(64, 128, 128, dropout=0.1))
    return init_weights(enc, torch.Generator().manual_seed(0))


@pytest.mark.parametrize("kind", ["cnn", "mlp"])
def test_batch_norm_encoders_train_one_step_and_serve_on_the_card(kind):
    # audio_only.yaml's encoder (and its MLP form) at full width: one
    # training forward + backward on the card against the CPU with the same
    # masks, the running statistics it moved, then the eval forward on them
    from multimodal_emotion_detection_tpu_torch.models.noise import Noise

    dev = _card()
    torch.backends.cudnn.allow_tf32 = False
    enc = _bn_encoder(kind)
    x = torch.from_numpy(np.random.RandomState(7).randn(32, 372, 64).astype(np.float32))
    card = enc.to(dev).train()
    noise = Noise(torch.Generator(device=dev).manual_seed(0))
    card(x.to(dev), noise).square().sum().backward()
    grads = {n: p.grad.cpu() for n, p in card.named_parameters()}
    stats = {n: b.cpu() for n, b in card.named_buffers()}
    card.eval()
    with torch.no_grad():
        served = card(x.to(dev)).cpu()
        mc = card.train()(x.to(dev), Noise(torch.Generator(device=dev).manual_seed(1)),
                          bn_eval=True)
    torch.cuda.synchronize()
    assert all(torch.equal(b.cpu(), stats[n]) for n, b in card.named_buffers())

    cpu = _bn_encoder(kind).train()
    cpu(x, Noise(replay=noise.drawn)).square().sum().backward()
    g_max = max(float(p.grad.abs().max()) for p in cpu.parameters())
    for n, p in cpu.named_parameters():
        torch.testing.assert_close(grads[n], p.grad, rtol=0, atol=1e-4 * g_max, msg=n)
    for n, b in cpu.named_buffers():
        torch.testing.assert_close(stats[n], b, rtol=0,
                                   atol=1e-5 * float(b.abs().max()), msg=n)
    with torch.no_grad():
        torch.testing.assert_close(served, cpu.eval()(x), rtol=1e-4, atol=1e-4)
    assert mc.shape == served.shape and bool(torch.isfinite(mc).all())


def test_audio_only_train_step_on_the_card_matches_the_cpu():
    # configs/audio_only.yaml as written: log-mel (its kernel, once) -> CNN
    # with BatchNorm -> head, one train_step against the CPU's
    from multimodal_emotion_detection_tpu_torch.config import load_config
    from multimodal_emotion_detection_tpu_torch.models.classifier import (
        classifier_from_config,
        init_weights,
    )
    from multimodal_emotion_detection_tpu_torch.models.noise import Noise
    from multimodal_emotion_detection_tpu_torch.training.optim import build_optimizer
    from multimodal_emotion_detection_tpu_torch.training.steps import train_step

    dev = _card()
    torch.backends.cudnn.allow_tf32 = False
    from pathlib import Path

    cfg = load_config(str(Path(__file__).resolve().parents[1] / "configs" / "audio_only.yaml"), [])
    rng = np.random.RandomState(8)
    feats = {"audio": torch.from_numpy(rng.randn(32, 48000, 1).astype(np.float32))}
    labels = torch.from_numpy(rng.randint(0, 8, 32).astype(np.int64))
    idx, valid = torch.arange(32), torch.ones(32)
    valid[28:] = 0.0  # wrap padding: still in the batch statistics
    out = {}
    for side, device in (("card", dev), ("cpu", torch.device("cpu"))):
        model = init_weights(classifier_from_config(cfg),
                             torch.Generator().manual_seed(0)).to(device)
        opt, _ = build_optimizer(cfg.training, model.parameters(), 3)
        noise = (Noise(torch.Generator(device=dev).manual_seed(0)) if side == "card"
                 else Noise(replay=out["card"][2].drawn))
        before = logmel.LOGMEL.launches
        metrics = train_step(model, opt, {k: v.to(device) for k, v in feats.items()},
                             labels.to(device), idx.to(device), valid.to(device),
                             lr=1e-3, clip_norm=1.0, modality_dropout=0.0, noise=noise)
        if side == "card":
            torch.cuda.synchronize()
            assert logmel.LOGMEL.launches == before + 1
        out[side] = (float(metrics["loss"]),
                     {n: b.cpu() for n, b in model.named_buffers()}, noise)
    assert abs(out["card"][0] - out["cpu"][0]) < 1e-4
    for n, b in out["cpu"][1].items():
        torch.testing.assert_close(out["card"][1][n], b, rtol=0,
                                   atol=1e-5 * float(b.abs().max()), msg=n)


# --------------------------------------------- bf16 residual streams (fast.yaml)


def _bf16_ulps(a, b):
    """Elementwise distance in bf16 ulps of two bf16 tensors."""
    def ordinal(t):
        u = t.contiguous().view(torch.int16).to(torch.int32) & 0xFFFF
        return torch.where(u >= 0x8000, 0x8000 - u, u)

    return (ordinal(a) - ordinal(b)).abs()


def _within_one_ulp(out, ref, msg):
    """A bf16 output against its plain version: one bf16 ulp of ref plus
    1e-6 of its largest entry (the float32 values it rounds differ by
    ~1e-7, which can straddle a rounding boundary)."""
    assert out.dtype == ref.dtype == torch.bfloat16, msg
    o, r = out.float(), ref.float()
    _, e = torch.frexp(r)
    ulp = torch.ldexp(torch.ones_like(r), e - 8)
    assert float(((o - r).abs() / (ulp + 1e-6 * r.abs().max())).max()) <= 1.0, msg


@pytest.mark.parametrize("cell", ["lstm", "gru"])
@pytest.mark.parametrize("b,t,d,h", [(1, 40, 6, 64), (17, 40, 6, 128), (32, 372, 64, 256)])
def test_pair_bf16_forms_match_the_float32_forms_and_plain(cell, b, t, d, h):
    """Rows 11 / 12 and 14 / 15 in bf16: finals bit for bit the float32
    form's, the stored series the float32 form's rounded (<= 1 ulp), the
    chain over bf16 residuals the float32 chain over them upcast, rounded
    (<= 1 ulp), each within one ulp of its plain version."""
    dev = _card()
    case = _lstm_case if cell == "lstm" else _gru_case
    x_tm, keep, l0, l1 = case(dev, b, t, d, h, seed=b + t + h)
    fwd = getattr(lstm_kernel, f"{cell}2_train_fwd_residuals")
    fwd_ref = getattr(lstm_kernel, f"{cell}2_train_fwd_reference")
    chain = getattr(lstm_kernel, f"{cell}2_bwd_chain")
    chain_ref = getattr(lstm_kernel, f"{cell}2_bwd_chain_reference")
    fwd16 = getattr(lstm_kernel, f"{cell.upper()}2_TRAIN_FWD_BF16")
    chain16 = getattr(lstm_kernel, f"{cell.upper()}2_BWD_CHAIN_BF16")
    before = fwd16.launches
    o16 = fwd(x_tm, keep, l0, l1, res_dtype=torch.bfloat16)
    o32 = fwd(x_tm, keep, l0, l1)
    torch.cuda.synchronize()
    assert fwd16.launches == before + 1
    assert torch.equal(o16[4], o32[4])
    refs = fwd_ref(x_tm, keep, l0, l1, res_dtype=torch.bfloat16)
    for i, name in enumerate(("packed", "h0_prev", "h1_prev", "x1")):
        assert int(_bf16_ulps(o16[i], o32[i].to(torch.bfloat16)).max()) <= 1, name
        _within_one_ulp(o16[i], refs[i], name)
    dh = torch.from_numpy(np.random.RandomState(t).randn(b, h).astype(np.float32)).to(dev)
    w = (l0["w_hh"], l1["w_hh"], l1["w_ih"])
    args = ((o16[0], keep, dh, *w) if cell == "lstm"
            else (o16[0], o16[1], o16[2], keep, dh, *w))
    before = chain16.launches
    d16 = chain(*args)
    d32 = chain(*(a.float() for a in args))
    torch.cuda.synchronize()
    assert chain16.launches == before + 1
    for i, (a, r, p) in enumerate(zip(d16, d32, chain_ref(*args))):
        assert int(_bf16_ulps(a, r.to(torch.bfloat16)).max()) <= 1, i
        _within_one_ulp(a, p, f"chain output {i}")


@pytest.mark.parametrize("b,t,h", [(1, 40, 64), (32, 372, 512)])
def test_lstm1_bf16_forms_match_the_float32_forms_and_plain(b, t, h):
    """Rows 6 and 4 in bf16: h_prev and finals bit for bit the float32
    form's, g and c_prev the float32 form's rounded (<= 1 ulp); the chain
    over them the float32 chain over them upcast."""
    dev = _card()
    ih, w_hh = _layer_case(dev, b, t, h, seed=t + h)
    before = lstm_kernel.LSTM1_TRAIN_FWD_BF16.launches
    o16 = lstm_kernel.lstm1_train_fwd(ih, w_hh, torch.bfloat16)
    o32 = lstm_kernel.lstm1_train_fwd(ih, w_hh)
    torch.cuda.synchronize()
    assert lstm_kernel.LSTM1_TRAIN_FWD_BF16.launches == before + 1
    assert torch.equal(o16[1], o32[1]) and torch.equal(o16[3], o32[3])
    refs = lstm_kernel.lstm1_train_fwd_reference(ih, w_hh, torch.bfloat16)
    for i in (0, 2):
        assert int(_bf16_ulps(o16[i], o32[i].to(torch.bfloat16)).max()) <= 1, i
        _within_one_ulp(o16[i], refs[i], f"output {i}")
    rng = np.random.RandomState(t)
    dhs = torch.from_numpy(rng.randn(t, b, h).astype(np.float32)).to(dev)
    dhf = torch.from_numpy(rng.randn(b, h).astype(np.float32)).to(dev)
    before = lstm_kernel.LSTM_BWD_CHAIN_BF16.launches
    d16 = lstm_kernel.lstm_bwd_chain(o16[0], o16[2], dhs, dhf, w_hh)
    d32 = lstm_kernel.lstm_bwd_chain(o16[0].float(), o16[2].float(), dhs, dhf, w_hh)
    torch.cuda.synchronize()
    assert lstm_kernel.LSTM_BWD_CHAIN_BF16.launches == before + 1
    assert d16.dtype == torch.float32
    assert int(_bf16_ulps(d16.to(torch.bfloat16), d32.to(torch.bfloat16)).max()) <= 1
    ref = lstm_kernel.lstm_bwd_chain_reference(o16[0], o16[2], dhs, dhf, w_hh)
    torch.testing.assert_close(d16, ref, rtol=0, atol=1e-4 * float(ref.abs().max()))


@pytest.mark.parametrize("b,t", [(32, 372), (17, 40), (1, 40), (128, 7)])
def test_lstm2_remat_bf16_forms_match_the_float32_forms_and_plain(b, t):
    """Rows 11n and 13 in bf16 (the remat pair with bf16 streams) at D 64, H
    256: the no-gates forward's finals bit for bit the float32 no-gates
    form's and its series that form's rounded, bit for bit; the remat chain
    over those bf16 streams (x cast to bf16) the float32 chain over them
    upcast, rounded, bit for bit (at B 128 in slices of the batch, one
    counted launch each); each within one bf16 ulp of its plain version;
    neither float32 form counted."""
    dev = _card()
    d, h = 64, 256
    x_tm, keep, l0, l1 = _lstm_case(dev, b, t, d, h, seed=b + t + 3)
    fwd16 = lstm_kernel.LSTM2_TRAIN_FWD_NOGATES_BF16
    chain16 = lstm_kernel.LSTM2_BWD_CHAIN_REMAT_BF16
    f32_counts = (lstm_kernel.LSTM2_TRAIN_FWD_NOGATES.launches,
                  lstm_kernel.LSTM2_BWD_CHAIN_REMAT.launches)
    before = fwd16.launches
    o16 = lstm_kernel.lstm2_train_fwd_residuals(x_tm, keep, l0, l1, store_gates=False,
                                                res_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert fwd16.launches == before + 1
    o32 = lstm_kernel.lstm2_train_fwd_residuals(x_tm, keep, l0, l1, store_gates=False)
    assert o16[0].shape == (t, b, 2 * h) and torch.equal(o16[4], o32[4])
    refs = lstm_kernel.lstm2_train_fwd_reference(x_tm, keep, l0, l1, store_gates=False,
                                                 res_dtype=torch.bfloat16)
    for i, name in enumerate(RES_NAMES[:4]):
        assert torch.equal(o16[i], o32[i].to(torch.bfloat16)), name
        _within_one_ulp(o16[i], refs[i], name)
    dh = torch.from_numpy(np.random.RandomState(t).randn(b, h).astype(np.float32)).to(dev)
    args = (o16[0], keep, x_tm.to(torch.bfloat16), o16[3], o16[1], o16[2], dh, l0, l1)
    plan = lstm_kernel.chain_plan_on("lstm2_bwd_chain_remat", 4, h, b, dev, layers=2,
                                     remat_d=d)
    before = chain16.launches
    d16 = lstm_kernel.lstm2_bwd_chain_remat(*args)
    torch.cuda.synchronize()
    assert chain16.launches == before + -(-b // (plan.batch_slice or b))
    assert (b <= 32) == (plan.batch_slice == 0)
    d32 = lstm_kernel.lstm2_bwd_chain_remat(
        *(a.float() if torch.is_tensor(a) else a for a in args))
    f32_counts = (f32_counts[0] + 1, f32_counts[1] + -(-b // (plan.batch_slice or b)))
    assert (lstm_kernel.LSTM2_TRAIN_FWD_NOGATES.launches,
            lstm_kernel.LSTM2_BWD_CHAIN_REMAT.launches) == f32_counts
    for name, a, r, p in zip(("dg0", "dg1"), d16, d32,
                             lstm_kernel.lstm2_bwd_chain_remat_reference(*args)):
        assert a.dtype == torch.bfloat16 and torch.equal(a, r.to(torch.bfloat16)), name
        _within_one_ulp(a, p, name)


@pytest.mark.parametrize("b,t,d,h", [(3, 40, 6, 64), (32, 372, 64, 256)])
def test_remat_bf16_lstm_final_grads_match_the_cpu(b, t, d, h):
    """``fused_lstm_final(remat_gates=True, res_dtype="bfloat16")`` on the
    card: both bf16 forms once, no float32 or stored-gates form; the
    forward's value the float32 one bit for bit; its gradients within 2e-3
    of each largest entry of the same route's on the CPU, where the
    wrappers run the plain versions and round at the same points (the bf16
    rule of the CPU tests)."""
    from multimodal_emotion_detection_tpu_torch.ops.lstm_vjp import fused_lstm_final

    dev = _card()
    x_tm, keep, l0, l1 = _lstm_case(dev, b, t, d, h, seed=11 + b)
    weight = torch.from_numpy(np.random.RandomState(b).randn(b, h).astype(np.float32))
    names = ("LSTM2_TRAIN_FWD_NOGATES_BF16", "LSTM2_BWD_CHAIN_REMAT_BF16",
             "LSTM2_TRAIN_FWD_NOGATES", "LSTM2_BWD_CHAIN_REMAT", "LSTM2_TRAIN_FWD",
             "LSTM2_TRAIN_FWD_BF16", "LSTM2_BWD_CHAIN", "LSTM2_BWD_CHAIN_BF16")

    def grads(device, res_dtype="bfloat16"):
        x = x_tm.transpose(0, 1).contiguous().to(device).requires_grad_()
        p0, p1 = ({k: v.detach().clone().to(device).requires_grad_() for k, v in p.items()}
                  for p in (l0, l1))
        out = fused_lstm_final(x, keep[:, None].to(device), (p0, p1), remat_gates=True,
                               res_dtype=res_dtype)
        (out * weight.to(device)).sum().backward()
        return out.detach().cpu(), [g.grad.cpu() for g in (x, *p0.values(), *p1.values())]

    before = [getattr(lstm_kernel, n).launches for n in names]
    h16, ours = grads(dev)
    torch.cuda.synchronize()
    assert [getattr(lstm_kernel, n).launches - c for n, c in zip(names, before)] == (
        [1, 1] + [0] * 6)
    h32, _ = grads(dev, "float32")
    assert torch.equal(h16, h32)
    _, cpu = grads(torch.device("cpu"))
    for i, (g, r) in enumerate(zip(ours, cpu)):
        torch.testing.assert_close(g, r, rtol=0, atol=2e-3 * float(r.abs().max()),
                                   msg=f"gradient {i}")


def test_remat_bf16_refuses_h_not_a_multiple_of_8_on_the_card():
    """The bf16 remat chain copies 16-byte pieces of the bf16 h rows: at H
    260 the route raises before its forward runs, and the chain's wrapper
    raises too, launching nothing (the float32 remat route takes H 260)."""
    from multimodal_emotion_detection_tpu_torch.ops.lstm_vjp import fused_lstm_final

    dev = _card()
    b, t, d, h = 3, 5, 8, 260
    x_tm, keep, l0, l1 = _lstm_case(dev, b, t, d, h, seed=5)
    counts = (lstm_kernel.LSTM2_TRAIN_FWD_NOGATES_BF16.launches,
              lstm_kernel.LSTM2_BWD_CHAIN_REMAT_BF16.launches)
    with pytest.raises(NotImplementedError, match="H % 8"):
        fused_lstm_final(x_tm.transpose(0, 1), keep[:, None], (l0, l1), remat_gates=True,
                         res_dtype="bfloat16")
    res = lstm_kernel.lstm2_train_fwd_residuals(x_tm, keep, l0, l1, store_gates=False,
                                                res_dtype=torch.bfloat16)
    dh = torch.ones(b, h, device=dev)
    with pytest.raises(ValueError, match="H % 8"):
        lstm_kernel.lstm2_bwd_chain_remat(res[0], keep, x_tm.to(torch.bfloat16), res[3],
                                          res[1], res[2], dh, l0, l1)
    assert (lstm_kernel.LSTM2_TRAIN_FWD_NOGATES_BF16.launches,
            lstm_kernel.LSTM2_BWD_CHAIN_REMAT_BF16.launches) == (counts[0] + 1, counts[1])
    out = fused_lstm_final(x_tm.transpose(0, 1), keep[:, None], (l0, l1), remat_gates=True)
    assert torch.isfinite(out).all()


@pytest.mark.parametrize("s,b", [(3, 32), (2, 7), (4, 1)])
def test_batched_forward_equals_forward_on_the_card(s, b):
    """``make_batched_forward_fn`` on the synthetic fixture's model at the
    flagship's recurrent width (three sensors of D 32, T 100, each LSTM
    2x256): each microbatch bit for bit ``forward``, row 2 three times a
    microbatch, and the plain versions on the CPU within 1e-4."""
    from multimodal_emotion_detection_tpu_torch.config import load_config
    from multimodal_emotion_detection_tpu_torch.models.classifier import (
        classifier_from_config,
        init_weights,
    )
    from multimodal_emotion_detection_tpu_torch.training.steps import (
        forward,
        make_batched_forward_fn,
    )

    dev = _card()
    enc = ("{type: sequence, encoder_type: lstm, input_dim: 32, hidden_dim: 256, "
           "num_layers: 2, output_dim: 128}")
    cfg = load_config(None, [
        "dataset.name=synthetic", "dataset.modalities=[sensor1,sensor2,sensor3]",
        "dataset.num_classes=5",
        "model.encoders={" + ", ".join(f"sensor{i}: {enc}" for i in (1, 2, 3)) + "}"])
    model = init_weights(classifier_from_config(cfg), torch.Generator().manual_seed(3))
    rng = np.random.RandomState(s * b)
    feats = {f"sensor{i}": torch.from_numpy(
        rng.randn(s, b, 100, 32).astype(np.float32)) for i in (1, 2, 3)}
    on_card = {k: v.to(dev) for k, v in feats.items()}
    model = model.to(dev)
    before = lstm_kernel.LSTM2_INFER.launches
    got = make_batched_forward_fn(model)(on_card)
    torch.cuda.synchronize()
    assert lstm_kernel.LSTM2_INFER.launches == before + 3 * s
    assert got.shape == (s, b, 5)
    for i in range(s):
        assert torch.equal(got[i], forward(model, {k: v[i] for k, v in on_card.items()}))
    ref = make_batched_forward_fn(model.cpu())(feats)
    torch.testing.assert_close(got.cpu(), ref, rtol=0, atol=1e-4)


def _flagship(extra=(), config="base.yaml"):
    from pathlib import Path

    from multimodal_emotion_detection_tpu_torch.config import load_config
    from multimodal_emotion_detection_tpu_torch.models.classifier import (
        classifier_from_config,
        init_weights,
    )

    root = Path(__file__).resolve().parents[1]
    cfg = load_config(str(root / "configs" / config),
                      (["model.frontend.audio=logmel"] if config == "base.yaml" else [])
                      + list(extra))
    return cfg, init_weights(classifier_from_config(cfg), torch.Generator().manual_seed(4))


def _clips(b, seed=0):
    rng = np.random.RandomState(seed)
    return {"audio": torch.from_numpy(rng.randn(b, 48000, 1).astype(np.float32)),
            "video": torch.from_numpy(rng.rand(b, 24, 4096).astype(np.float32))}


@pytest.mark.parametrize("mode", ["int8", "int8-bf16", "bfloat16"])
def test_quantized_flagship_serves_on_the_card_as_on_the_cpu(mode, tmp_path):
    """The flagship's weights round-tripped through a serving mode: the
    card's forward (log-mel and row 2 once) against the CPU's plain
    versions on the same rounded weights; the int8 artifact serves the
    in-memory int8 weights bit for bit."""
    from multimodal_emotion_detection_tpu_torch.training.steps import forward
    from multimodal_emotion_detection_tpu_torch.utils import quantize as q

    dev = _card()
    _, model = _flagship()
    rounded = q.quantize_params_for_eval(q.model_params(model), mode)
    q.load_params(model, rounded)
    feats = _clips(32)
    ref = forward(model, feats)
    model = model.to(dev)
    before = (logmel.LOGMEL.launches, lstm_kernel.LSTM2_INFER.launches)
    got = forward(model, {k: v.to(dev) for k, v in feats.items()})
    torch.cuda.synchronize()
    assert (logmel.LOGMEL.launches, lstm_kernel.LSTM2_INFER.launches) == (
        before[0] + 1, before[1] + 1)
    torch.testing.assert_close(got.cpu(), ref, rtol=0, atol=1e-3)
    if mode == "int8":
        _, fresh = _flagship()
        q.save_quantized(tmp_path / "a.pt", q.model_params(fresh))
        params, _ = q.load_quantized(tmp_path / "a.pt")
        q.load_params(fresh, params)
        fresh = fresh.to(dev)
        again = forward(fresh, {k: v.to(dev) for k, v in feats.items()})
        assert torch.equal(again, got)


def test_sweep_step_of_two_members_runs_the_training_kernels():
    """One step-major sweep step of two flagship members at batch 32: rows
    1, 11 and 12 once per member; each member's loss against its CPU
    forward; member 1 bit for bit a standalone ``member_ids=[1]`` run."""
    from multimodal_emotion_detection_tpu_torch.parallel import vmap_sweep as vs
    from multimodal_emotion_detection_tpu_torch.training.steps import cross_entropy

    dev = _card()
    torch.backends.cudnn.allow_tf32 = False
    cfg, model = _flagship(["model.dropout=0.0", "model.encoders.audio.dropout=0.0",
                            "model.encoders.video.dropout=0.0"])
    feats = {k: v.to(dev) for k, v in _clips(40, 1).items()}
    labels = torch.from_numpy(np.random.RandomState(2).randint(0, 8, 40)).to(dev)
    idx = torch.arange(32, device=dev)
    valid = torch.ones(32, device=dev)
    state = vs.init_sweep_state(model, [5e-4, 1e-3], 3, mdrops=[0.0, 0.05], device=dev)
    cpu = copy.deepcopy(state.members[0]).cpu().train()
    with torch.no_grad():
        cpu_loss = float(cross_entropy(
            cpu({k: v[:32].cpu() for k, v in feats.items()}, torch.ones(32, 2)),
            labels[:32].cpu(), torch.ones(32)))
    step = vs.make_vmapped_train_step(2, 0.0, 1.0, 1e-4)
    counters = (logmel.LOGMEL, lstm_kernel.LSTM2_TRAIN_FWD, lstm_kernel.LSTM2_BWD_CHAIN)
    before = [c.launches for c in counters]
    metrics = step(state, feats, labels, idx, valid, 3)
    torch.cuda.synchronize()
    assert [c.launches - b for c, b in zip(counters, before)] == [2, 2, 2]
    # member 0 draws mDrop 0 (every modality kept): its loss is the CPU's
    np.testing.assert_allclose(float(metrics["loss"][0]), cpu_loss, rtol=1e-4)
    solo = vs.init_sweep_state(model, [1e-3], 3, mdrops=[0.05], member_ids=[1], device=dev)
    step(solo, feats, labels, idx, valid, 3)
    for k, v in vs.member_params(solo, 0).items():
        assert torch.equal(v, vs.member_params(state, 1)[k]), k


def test_visualize_matrix_on_the_card_matches_the_cpu():
    """av_hybrid.yaml at full width: the (M, M) cross-attention matrix
    from the card's forward (log-mel and row 2 once) against the CPU's."""
    from multimodal_emotion_detection_tpu_torch.tools.visualize import attention_matrix

    dev = _card()
    _, model = _flagship(config="av_hybrid.yaml")
    feats = _clips(32, 3)
    ref = attention_matrix(model, feats, torch.ones(32, 2), ["audio", "video"])
    model = model.to(dev)
    before = (logmel.LOGMEL.launches, lstm_kernel.LSTM2_INFER.launches)
    got = attention_matrix(model, {k: v.to(dev) for k, v in feats.items()},
                           torch.ones(32, 2, device=dev), ["audio", "video"])
    assert (logmel.LOGMEL.launches, lstm_kernel.LSTM2_INFER.launches) == (
        before[0] + 1, before[1] + 1)
    assert got.shape == (2, 2)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def _bf16_stack_step(device, rnn, x, keep, weight):
    """One training forward + backward and one eval forward of the bf16
    ``rnn`` copied to ``device``, the keep mask replayed: (train h,
    gradients, eval h), on the CPU."""
    from multimodal_emotion_detection_tpu_torch.models.noise import Noise

    m = copy.deepcopy(rnn).to(device).train()
    h = m(x.to(device), Noise(replay=[keep]))
    (h.float() * weight.to(device)).sum().backward()
    grads = [p.grad.cpu() for p in m.parameters()]
    m.eval()
    with torch.no_grad():
        h_eval = m(x.to(device))
    return h.detach().float().cpu(), grads, h_eval.float().cpu()


def _bf16_stack_check(dev, rnn, b, t, d, h, counters, seed):
    x = torch.from_numpy(np.random.RandomState(seed).randn(b, t, d).astype(np.float32))
    keep = torch.bernoulli(torch.full((t, 1, b, h), 0.9),
                           generator=torch.Generator().manual_seed(seed)) / 0.9
    weight = torch.from_numpy(np.random.RandomState(seed + 1).randn(b, h).astype(np.float32))
    weight = weight.to(torch.bfloat16).float()  # bf16-exact: h's rounding stays out
    before = [c.launches for c in counters]
    card = _bf16_stack_step(dev, rnn, x, keep, weight)
    torch.cuda.synchronize()
    launched = [c.launches - n for c, n in zip(counters, before)]
    cpu = _bf16_stack_step(torch.device("cpu"), rnn, x, keep, weight)
    for out, ref, what in ((card[0], cpu[0], "train h"), (card[2], cpu[2], "eval h")):
        # float32 kernels on the same rounded operands, rounded once: 1 ulp
        torch.testing.assert_close(out, ref, rtol=0, atol=2.0 ** -8 * float(ref.abs().max()),
                                   msg=what)
    g_max = max(float(g.abs().max()) for g in cpu[1])
    for i, (g, r) in enumerate(zip(card[1], cpu[1])):
        assert g.dtype == torch.float32
        torch.testing.assert_close(g, r, rtol=0, atol=1e-4 * g_max, msg=f"gradient {i}")
    return launched


@pytest.mark.parametrize("b", [32, 256])
@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_bf16_compute_pairs_match_the_cpu_on_the_card(cell, b):
    """``FusedStackedRNN(dtype=bfloat16)`` at the flagship's widths (log-mel
    64 -> 2 x 256, 372 steps) at batch 32 and the bench legs' 256: the
    float32 pair kernels (rows 11 / 12, 14 / 15) once each a training step
    and the eval kernel (row 2, the GRU's 3) once an eval forward, on
    bf16-rounded operands, no bf16-residual form; h within 1 bf16 ulp and
    the float32 gradients within 1e-4 of the largest of the CPU's plain
    versions on the same operands."""
    from multimodal_emotion_detection_tpu_torch.models.recurrent import FusedStackedRNN

    dev = _card()
    rnn = FusedStackedRNN(64, 256, 2, dropout=0.1, cell_type=cell, dtype=torch.bfloat16)
    for p in rnn.parameters():
        torch.nn.init.uniform_(p, -1 / 16, 1 / 16, generator=torch.Generator().manual_seed(b))
    up = cell.upper()
    counters = [getattr(lstm_kernel, f"{up}2_{n}") for n in
                ("TRAIN_FWD", "BWD_CHAIN", "INFER", "TRAIN_FWD_BF16", "BWD_CHAIN_BF16")]
    launched = _bf16_stack_check(dev, rnn, b, 372, 64, 256, counters, seed=b)
    assert launched == [1, 1, 1, 0, 0]


def test_bf16_compute_remat_pair_with_float32_streams_on_the_card():
    """The gate-rematerialising pair under the bf16 compute dtype with
    float32 residual streams: the float32 no-gates forward and remat chain
    (row 13), x read into float32 before the chain as the JAX package casts
    it to the streams' dtype, once each; no bf16 form, no stored-gates
    pair; h and the gradients as the CPU's plain versions on the same
    operands."""
    from multimodal_emotion_detection_tpu_torch.models.recurrent import FusedStackedRNN

    dev = _card()
    rnn = FusedStackedRNN(64, 256, 2, dropout=0.1, dtype=torch.bfloat16)
    rnn.remat_gates = True
    for p in rnn.parameters():
        torch.nn.init.uniform_(p, -1 / 16, 1 / 16, generator=torch.Generator().manual_seed(3))
    counters = [getattr(lstm_kernel, n) for n in (
        "LSTM2_TRAIN_FWD_NOGATES", "LSTM2_BWD_CHAIN_REMAT", "LSTM2_INFER",
        "LSTM2_TRAIN_FWD_NOGATES_BF16", "LSTM2_BWD_CHAIN_REMAT_BF16", "LSTM2_TRAIN_FWD",
        "LSTM2_BWD_CHAIN")]
    launched = _bf16_stack_check(dev, rnn, 32, 372, 64, 256, counters, seed=5)
    assert launched == [1, 1, 1, 0, 0, 0, 0]


# the serving kernels as custom ops (med_torch::*): opcheck on the card's
# tensors, each case launching its kernel
OP_CASES = ["logmel", "logmel_3d_hop160", "lstm2_infer", "gru2_infer",
            "lstm1_infer_series", "lstm1_infer_final", "gru1_infer_series",
            "gru1_infer_final", "flash_fwd", "flash_fwd_bias_dropout", "flash_fwd_bf16",
            "flash_fwd_bf16_d40_dropout"]


def _op_case(name: str, dev):
    """(op, its arguments on ``dev``, the kernel counter it ticks)."""
    from multimodal_emotion_detection_tpu_torch.ops import flash_attention as fa

    rng = np.random.RandomState(len(name))

    def rand(*shape, scale=1.0):
        return torch.from_numpy((scale * rng.randn(*shape)).astype(np.float32)).to(dev)

    if name.startswith("logmel"):
        params = logmel.LogMelParams(hop_length=160 if "hop160" in name else 128)
        wave = rand(3, 16000, 1) if "3d" in name else rand(2, 8000)
        return logmel.LOGMEL_OP, (wave, params.sample_rate, params.n_fft,
                                  params.hop_length, params.win_length, params.n_mels,
                                  params.fmin, params.fmax,
                                  params.log_epsilon), logmel.LOGMEL
    if name in ("lstm2_infer", "gru2_infer"):
        gates, h = (4, 256) if name == "lstm2_infer" else (3, 256)
        x = rand(4, 30, 8)
        if gates == 4:
            w = [rand(8, 4 * h, scale=0.06), rand(h, 4 * h, scale=0.06), rand(4 * h, scale=0.06),
                 rand(h, 4 * h, scale=0.06), rand(h, 4 * h, scale=0.06), rand(4 * h, scale=0.06)]
            return lstm_kernel.LSTM2_INFER_OP, (x, *w), lstm_kernel.LSTM2_INFER
        w = [rand(8, 3 * h, scale=0.06), rand(h, 3 * h, scale=0.06), rand(3 * h, scale=0.06),
             rand(3 * h, scale=0.06), rand(h, 3 * h, scale=0.06), rand(h, 3 * h, scale=0.06),
             rand(3 * h, scale=0.06), rand(3 * h, scale=0.06)]
        return lstm_kernel.GRU2_INFER_OP, (x, *w), lstm_kernel.GRU2_INFER
    if name.startswith(("lstm1", "gru1")):
        series, h = name.endswith("series"), 128
        if name.startswith("lstm1"):
            return lstm_kernel.LSTM1_INFER_OP, (rand(20, 3, 4 * h), rand(h, 4 * h, scale=0.08),
                                                series), lstm_kernel.LSTM1_INFER
        return lstm_kernel.GRU1_INFER_OP, (rand(20, 3, 3 * h), rand(h, 3 * h, scale=0.08),
                                           rand(3 * h, scale=0.08), series), lstm_kernel.GRU1_INFER
    half = "bf16" in name
    d = 40 if "d40" in name else 64
    dtype = torch.bfloat16 if half else torch.float32
    q, k, v = (rand(2, 4, 37, d).to(dtype) for _ in range(3))
    bias = None
    if "bias" in name:
        bias = torch.zeros(2, 37, device=dev)
        bias[1, 20:] = fa.MASKED
    rate = 0.1 if "dropout" in name else 0.0
    seed = torch.tensor([7], dtype=torch.int64, device=dev) if rate else None
    return fa.FLASH_FWD_OP, (q, k, v, bias, seed, rate), (
        fa.FLASH_FWD_BF16 if half else fa.FLASH_FWD)


@pytest.mark.parametrize("name", OP_CASES)
def test_op_passes_opcheck_on_the_card(name):
    dev = _card()
    op, args, counter = _op_case(name, dev)
    before = counter.launches
    result = torch.library.opcheck(op, args)
    torch.cuda.synchronize()
    assert set(result.values()) == {"SUCCESS"}, result
    assert counter.launches > before


# the six configurations of tests/test_torch_port_export.py, narrowed the
# same way, exported by the CLI on the card from seeded weights
EXPORT_NARROW = ["model.frontend.audio=logmel", "model.encoders.audio.hidden_dim=128",
                 "model.encoders.video.input_dim=16", "model.encoders.video.hidden_dim=32",
                 "model.output_dim=16", "model.hidden_dim=32", "dataset.batch_size=8"]
EXPORT_TF = ["model.encoders.audio.encoder_type=transformer",
             "model.encoders.audio.hidden_dim=64"]
EXPORT_CONFIGS = {
    "flagship": ([], {"logmel": 1, "lstm2_infer": 1}),
    "gru": (["model.encoders.audio.encoder_type=gru"], {"logmel": 1, "gru2_infer": 1}),
    "lstm3": (["model.encoders.audio.num_layers=3"], {"logmel": 1, "lstm1_infer": 3}),
    "gru3": (["model.encoders.audio.encoder_type=gru", "model.encoders.audio.num_layers=3"],
             {"logmel": 1, "gru1_infer": 3}),
    "transformer": (EXPORT_TF, {"logmel": 1, "flash_fwd": 2}),
    "transformer_bf16": (EXPORT_TF + ["runtime.compute_dtype=bfloat16"],
                         {"logmel": 1, "flash_fwd_bf16": 2}),
}


@pytest.mark.parametrize("name", list(EXPORT_CONFIGS))
def test_exported_program_on_the_card_is_the_eager_forward(name, tmp_path):
    """``tools.export`` on the card: the loaded program's logits bit for
    bit the eager forward's on the same 8 clips, each exported call
    launching exactly the eager forward's kernels."""
    from pathlib import Path

    from multimodal_emotion_detection_tpu_torch.config import load_config
    from multimodal_emotion_detection_tpu_torch.models.classifier import (
        classifier_from_config,
        init_weights,
    )
    from multimodal_emotion_detection_tpu_torch.ops import flash_attention as fa
    from multimodal_emotion_detection_tpu_torch.tools.export import load_exported
    from multimodal_emotion_detection_tpu_torch.tools.export import main as export
    from multimodal_emotion_detection_tpu_torch.training.checkpoints import save_checkpoint
    from multimodal_emotion_detection_tpu_torch.training.steps import forward

    dev = _card()
    test = tmp_path / "data" / "test"
    test.mkdir(parents=True)
    rng = np.random.RandomState(11)
    clips = {"audio": rng.randn(12, 40 * 128, 1).astype(np.float32),
             "video": rng.rand(12, 4, 16).astype(np.float32)}
    for m, a in clips.items():
        np.save(test / f"{m}.npy", a)
    np.save(test / "labels.npy", rng.randint(0, 8, 12).astype(np.int32))
    base = str(Path(__file__).resolve().parents[1] / "configs" / "base.yaml")
    overrides = EXPORT_NARROW + EXPORT_CONFIGS[name][0] + [
        f"dataset.data_dir={tmp_path / 'data'}"]
    cfg = load_config(base, overrides)
    model = init_weights(classifier_from_config(cfg), torch.Generator().manual_seed(4))
    save_checkpoint(tmp_path / "m.pt", model.state_dict(), {"seed": 4})
    out = export(["--checkpoint", str(tmp_path / "m.pt"), "--config", base,
                  "--out", str(tmp_path / "m.pt2"), "--batch", "8", *overrides])
    program = load_exported(out).module()
    batch = {m: torch.from_numpy(a[:8]).to(dev) for m, a in clips.items()}
    eager = forward(model.to(dev), batch)
    counters = {"logmel": logmel.LOGMEL, "lstm2_infer": lstm_kernel.LSTM2_INFER,
                "gru2_infer": lstm_kernel.GRU2_INFER, "lstm1_infer": lstm_kernel.LSTM1_INFER,
                "gru1_infer": lstm_kernel.GRU1_INFER, "flash_fwd": fa.FLASH_FWD,
                "flash_fwd_bf16": fa.FLASH_FWD_BF16}
    before = {k: c.launches for k, c in counters.items()}
    with torch.inference_mode():
        got = program(batch)
    torch.cuda.synchronize()
    launched = {k: c.launches - before[k] for k, c in counters.items()}
    assert {k: n for k, n in launched.items() if n} == EXPORT_CONFIGS[name][1]
    assert got.dtype == eager.dtype and got.device == eager.device
    torch.testing.assert_close(got, eager, rtol=0, atol=0)


@contextlib.contextmanager
def _time_limit(seconds: float):
    """Fail the test past ``seconds`` of wall time (SIGALRM, raised in the
    main thread once control is back in Python)."""
    def expire(signum, frame):
        raise TimeoutError(f"past its time limit of {seconds} s")

    prev = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, seconds)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, prev)


def test_video_resize_on_card_in_full_float32_with_tf32_on():
    # RAVDESS's 1280x720 BGR frames, 2 clips: the card's gray + area
    # resize against the CPU's, with TF32 allowed for the process: the
    # resize's products switch it off (a TF32 product would miss by ~0.05
    # on the 0-255 scale), and the setting is restored after
    from multimodal_emotion_detection_tpu_torch.ops.resize import area_resize, bgr_to_gray

    dev = _card()
    with _time_limit(120):
        frames = torch.from_numpy(np.random.RandomState(3).randint(
            0, 256, (2, 24, 720, 1280, 3)).astype(np.uint8))
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            card = area_resize(bgr_to_gray(frames.to(dev)), 64, 64).cpu()
            assert torch.backends.cuda.matmul.allow_tf32 is True
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev
        cpu = area_resize(bgr_to_gray(frames), 64, 64)
        assert card.shape == (2, 24, 64, 64) and card.dtype == torch.float32
        torch.testing.assert_close(card, cpu, rtol=0, atol=1e-3)


def test_resize_classifier_on_card_matches_cpu():
    # the flagship with model.frontend.video=resize on raw uint8 frames:
    # log-mel and row 2 once, the logits as [serve]'s against the CPU's
    from pathlib import Path

    from multimodal_emotion_detection_tpu_torch.config import load_config
    from multimodal_emotion_detection_tpu_torch.models.classifier import (
        classifier_from_config,
        init_weights,
    )
    from multimodal_emotion_detection_tpu_torch.training.steps import forward

    dev = _card()
    with _time_limit(300):
        base = str(Path(__file__).resolve().parents[1] / "configs" / "base.yaml")
        cfg = load_config(base, ["model.frontend.audio=logmel", "model.frontend.video=resize"])
        model = init_weights(classifier_from_config(cfg), torch.Generator().manual_seed(2))
        rng = np.random.RandomState(4)
        batch = {"audio": torch.from_numpy(rng.randn(2, 48000, 1).astype(np.float32)),
                 "video": torch.from_numpy(rng.randint(0, 256, (2, 24, 90, 160, 3))
                                           .astype(np.uint8))}
        want = forward(model, batch)
        before = (logmel.LOGMEL.launches, lstm_kernel.LSTM2_INFER.launches)
        got = forward(model.to(dev), {m: t.to(dev) for m, t in batch.items()}).cpu()
        torch.cuda.synchronize()
        assert (logmel.LOGMEL.launches - before[0],
                lstm_kernel.LSTM2_INFER.launches - before[1]) == (1, 1)
        torch.testing.assert_close(got, want, rtol=0, atol=1e-3)
