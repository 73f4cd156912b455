"""PyTorch port, 2-layer LSTM inference: the plain version against both
JAX routes — the Pallas kernel (interpret mode) and FusedStackedRNN's
scan — with the same numpy-seeded weights and inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_emotion_detection_tpu.models.recurrent import FusedStackedRNN
from multimodal_emotion_detection_tpu.ops.lstm_kernel import lstm2_infer_pallas
from multimodal_emotion_detection_tpu_torch.ops.lstm_kernel import (
    lstm2_infer,
    lstm2_infer_reference,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the suite runs several test workers on the same cores; at these tiny
    # shapes a multi-threaded torch only spins idle threads that slow them all
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _params(rng, d, h):
    k = 1.0 / np.sqrt(h)

    def layer(d_in):
        return {
            "w_ih": rng.uniform(-k, k, (d_in, 4 * h)).astype(np.float32),
            "w_hh": rng.uniform(-k, k, (h, 4 * h)).astype(np.float32),
            "b": rng.uniform(-k, k, (4 * h,)).astype(np.float32),
        }

    return layer(d), layer(h)


def _torch(layer):
    return {k: torch.from_numpy(v) for k, v in layer.items()}


@pytest.mark.parametrize("b,t,d,h", [(8, 50, 12, 128), (8, 40, 6, 128),
                                     (1, 37, 6, 128)])
def test_plain_matches_jax_kernel_and_scan(b, t, d, h):
    rng = np.random.RandomState(b * 1000 + t)
    x = rng.randn(b, t, d).astype(np.float32)
    l0, l1 = _params(rng, d, h)
    with jax.default_matmul_precision("highest"):
        _, h_scan = FusedStackedRNN(hidden_dim=h, num_layers=2).apply(
            {"params": {"layer_0": l0, "layer_1": l1}}, jnp.asarray(x))
        h_pallas = lstm2_infer_pallas(jnp.asarray(x), l0, l1, chunk=16,
                                      interpret=True)
    ours = lstm2_infer_reference(torch.from_numpy(x), _torch(l0), _torch(l1))
    assert ours.shape == (b, h)
    np.testing.assert_allclose(ours.numpy(), np.asarray(h_scan),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ours.numpy(), np.asarray(h_pallas),
                               rtol=1e-5, atol=1e-5)


def test_wrapper_on_cpu_is_the_plain_version():
    rng = np.random.RandomState(7)
    x = torch.from_numpy(rng.randn(2, 9, 5).astype(np.float32))
    l0, l1 = (_torch(p) for p in _params(rng, 5, 16))
    torch.testing.assert_close(lstm2_infer(x, l0, l1),
                               lstm2_infer_reference(x, l0, l1),
                               rtol=0, atol=0)
