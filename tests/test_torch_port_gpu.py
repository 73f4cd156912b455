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
