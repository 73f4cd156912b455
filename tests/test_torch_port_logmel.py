"""PyTorch port, log-mel frontend: the plain version against the JAX
package's XLA reference, its Pallas kernel (interpret mode) and the pinned
goldens.  Inputs come from a numpy seed and go to both frameworks."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_emotion_detection_tpu.ops import logmel as jax_logmel
from multimodal_emotion_detection_tpu_torch.ops import logmel as port_logmel

GOLDEN = Path(__file__).parent / "golden"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the suite runs several test workers on the same cores; at these tiny
    # shapes a multi-threaded torch only spins idle threads that slow them all
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _full_f32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with jax.default_matmul_precision("highest"):
        yield


def _wave(b, t, seed=0):
    return np.random.RandomState(seed).randn(b, t).astype(np.float32)


def _port(wave, params):
    return port_logmel.logmel_cuda(torch.from_numpy(wave), params).numpy()


def test_constants_bit_identical():
    for n_fft, win in ((512, 400), (256, 256)):
        for a, b in zip(jax_logmel._dft_basis_np(n_fft, win),
                        port_logmel._dft_basis_np(n_fft, win)):
            assert a.dtype == b.dtype == np.float32
            np.testing.assert_array_equal(a, b)
    for p in (port_logmel.LogMelParams(),
              port_logmel.LogMelParams(n_fft=256, n_mels=16, fmax=6000.0)):
        jp = jax_logmel.LogMelParams(**vars(p))
        np.testing.assert_array_equal(jax_logmel.mel_filterbank(jp),
                                      port_logmel.mel_filterbank(p))
    np.testing.assert_array_equal(jax_logmel._dct_matrix_np(64, 40),
                                  port_logmel._dct_matrix_np(64, 40))


@pytest.mark.parametrize("n_fft,win,taps,chunks", [
    (512, 400, (57, 456), (48, 464)),   # flagship: Hann tap 0 is zero too
    (256, 200, (29, 228), (16, 240)),
    (512, 512, (1, 512), (0, 512)),
])
def test_kernel_tap_range_skips_only_zero_rows(n_fft, win, taps, chunks):
    # the kernel walks only the taps in _kernel_taps: every basis row
    # outside it must be exactly zero in the JAX package's basis too
    p = port_logmel.LogMelParams(n_fft=n_fft, win_length=win)
    assert port_logmel.nonzero_taps(n_fft, win) == taps
    lo, hi = port_logmel._kernel_taps(p)
    assert (lo, hi) == chunks
    for basis in jax_logmel._dft_basis_np(n_fft, win):
        assert not basis[:lo].any() and not basis[hi:].any()
        assert basis[taps[0]].any() and basis[taps[1] - 1].any()


def test_plain_matches_jax_pallas_and_xla_hop128():
    wave = _wave(2, 48000, seed=1)
    p = port_logmel.LogMelParams()
    jp = jax_logmel.LogMelParams()
    ours = _port(wave, p)
    xla = np.asarray(jax_logmel.logmel_frames(jnp.asarray(wave), jp))
    pallas = np.asarray(
        jax_logmel.logmel_pallas(jnp.asarray(wave), jp, interpret=True))
    assert ours.shape == xla.shape == (2, 372, 64)
    np.testing.assert_allclose(ours, xla, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(ours, pallas, rtol=1e-4, atol=1e-4)


def test_plain_matches_jax_hop160_and_3d_input():
    wave = _wave(2, 16000, seed=2)
    p = port_logmel.LogMelParams(hop_length=160)
    xla = np.asarray(jax_logmel.logmel_frames(
        jnp.asarray(wave), jax_logmel.LogMelParams(hop_length=160)))
    ours = _port(wave[..., None], p)  # (B, T, 1) as the loader feeds it
    assert ours.shape == xla.shape
    np.testing.assert_allclose(ours, xla, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("hop", [128, 160])
def test_plain_matches_golden(hop):
    wave = np.load(GOLDEN / "logmel_input_16k.npy")
    golden = np.load(GOLDEN / f"logmel_hop{hop}.npy")
    out = _port(wave[None, :], port_logmel.LogMelParams(hop_length=hop))[0]
    assert out.shape == golden.shape
    np.testing.assert_allclose(out, golden.astype(np.float32),
                               atol=2e-4, rtol=2e-5)


def test_mfcc_matches_jax():
    wave = _wave(2, 4096, seed=3)
    p = port_logmel.LogMelParams(n_fft=256, hop_length=128, win_length=256,
                                 n_mels=16)
    jp = jax_logmel.LogMelParams(**vars(p))
    ref = np.asarray(jax_logmel.mfcc(jnp.asarray(wave), jp, n_mfcc=8,
                                     use_pallas=False))
    ours = port_logmel.mfcc(torch.from_numpy(wave), p, n_mfcc=8).numpy()
    np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-4)


def test_too_short_waveform_raises():
    with pytest.raises(ValueError, match="0 frames"):
        port_logmel.logmel_cuda(torch.zeros(1, 100),
                                port_logmel.LogMelParams())
