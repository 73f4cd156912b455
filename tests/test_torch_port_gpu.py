"""PyTorch port, CUDA kernels against their plain versions on the card.

Marked ``gpu``; each test skips when torch sees no CUDA card (decided in
the test body, so every worker collects the same tests).  Imports only
torch, numpy and the port, so it runs where JAX is not installed:

    python -m pytest --noconftest -m gpu tests/test_torch_port_gpu.py
"""

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
    (2, 4000, logmel.LogMelParams(win_length=512)),         # every tap chunk
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

    ours = grads(lambda x, p0, p1: fused_lstm_final(x, keep, p0, p1))
    plain = grads(lambda x, p0, p1: lstm_kernel.lstm2_train_fwd_reference(
        x.transpose(0, 1), keep, p0, p1)[4][2])
    for i, (g, r) in enumerate(zip(ours, plain)):
        # weight gradients sum T*B terms: relative 1e-4 of the largest
        scale = float(r.abs().max())
        torch.testing.assert_close(g, r, rtol=1e-4, atol=1e-4 * max(scale, 1.0),
                                   msg=f"gradient {i}")
