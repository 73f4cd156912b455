"""PyTorch port, log-mel frontend: the plain version against the JAX
package's XLA reference, its Pallas kernel (interpret mode) and the pinned
goldens; a numpy model of the CUDA kernel's FFT (``csrc/logmel.cu``: the
packed complex points, the Stockham radix-4 stages and the last radix-2
one, the twiddle table, the real split, the filterbank's non-zero runs)
against both and against a float64 FFT.  Inputs come from a numpy seed and
go to both frameworks."""

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
    (512, 400, (57, 456), (56, 456)),   # flagship: Hann tap 0 is zero too
    (256, 200, (29, 228), (28, 228)),
    (512, 512, (1, 512), (0, 512)),
])
def test_kernel_tap_range_skips_only_zero_rows(n_fft, win, taps, chunks):
    # the kernel reads only the taps in _kernel_taps (whole pairs of the
    # packed complex points): every basis row outside it must be exactly
    # zero in the JAX package's basis too
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


# ---------------------------------------------------------------------------
# A model of the kernel's FFT (csrc/logmel.cu)
# ---------------------------------------------------------------------------


def _cmul(ar, ai, wr, wi):
    return ar * wr - ai * wi, ar * wi + ai * wr


def fft_emulated(re, im, tw):
    """csrc/logmel.cu's FFT of (frames, M) complex points in float32:
    Stockham autosort stages, natural order in and out, radix 4 while 4 Ns
    <= M and a last radix-2 stage where log2(M) is odd; stage Ns reads
    points j + r M / R, multiplies point r by W_N^(r (j % Ns) N / (R Ns))
    from the twiddle table (none in the first stage) and writes the
    butterfly's output r to (j / Ns) R Ns + j % Ns + r Ns."""
    m = re.shape[1]
    n = 2 * m
    ns = 1
    while ns < m:
        radix = 4 if 4 * ns <= m else 2
        j = np.arange(m // radix)
        k = j % ns
        vr = [re[:, j + r * (m // radix)] for r in range(radix)]
        vi = [im[:, j + r * (m // radix)] for r in range(radix)]
        if ns > 1:
            for r in range(1, radix):
                t = r * k * (n // (radix * ns))
                vr[r], vi[r] = _cmul(vr[r], vi[r], tw[t, 0], tw[t, 1])
        if radix == 4:  # the 4-point DFT, W_4 = -i (dft4)
            s0r, s0i, d0r, d0i = vr[0] + vr[2], vi[0] + vi[2], vr[0] - vr[2], vi[0] - vi[2]
            s1r, s1i, d1r, d1i = vr[1] + vr[3], vi[1] + vi[3], vr[1] - vr[3], vi[1] - vi[3]
            outs = [(s0r + s1r, s0i + s1i), (d0r + d1i, d0i - d1r),
                    (s0r - s1r, s0i - s1i), (d0r - d1i, d0i + d1r)]
        else:
            outs = [(vr[0] + vr[1], vi[0] + vi[1]), (vr[0] - vr[1], vi[0] - vi[1])]
        re, im = np.empty_like(re), np.empty_like(im)
        d = (j // ns) * ns * radix + k
        for r, (xr, xi) in enumerate(outs):
            re[:, d + r * ns], im[:, d + r * ns] = xr, xi
        ns *= radix
    return re, im


def logmel_fft_emulated(wave, params):
    """The kernel's log-mel of a (B, T) float32 wave: each frame windowed
    over the kernel's taps and packed as z[n] = x[2n] + i x[2n + 1],
    ``fft_emulated``, the real split X[k] = E[k] + W_N^k O[k] for bins 0 ..
    M, the power, each band's non-zero run summed in bin order, the log."""
    n_fft, hop = params.n_fft, params.hop_length
    tw, win = port_logmel.fft_tables_np(n_fft, params.win_length)
    runs, weights = port_logmel.mel_runs_np(params)
    lo, hi = port_logmel._kernel_taps(params)
    b, t = wave.shape
    f = params.num_frames(t)
    m = n_fft // 2
    idx = np.arange(f)[:, None] * hop + np.arange(n_fft)[None]
    frames = wave[:, idx].reshape(b * f, n_fft).astype(np.float32)
    frames[:, :lo] = 0.0
    frames[:, hi:] = 0.0
    frames = frames * win
    re, im = fft_emulated(frames[:, 0::2].copy(), frames[:, 1::2].copy(), tw)
    k = np.arange(m + 1)
    ar, ai, cr, ci = re[:, k % m], im[:, k % m], re[:, (m - k) % m], im[:, (m - k) % m]
    half = np.float32(0.5)
    er, ei = half * (ar + cr), half * (ai - ci)
    tr, ti = _cmul(half * (ai + ci), half * (cr - ar), tw[k, 0], tw[k, 1])
    xr, xi = er + tr, ei + ti
    power = xr * xr + xi * xi
    out = np.empty((b * f, params.n_mels), np.float32)
    for band, (first, count, off, _) in enumerate(runs):
        acc = np.zeros(b * f, np.float32)
        for i in range(count):
            acc = acc + power[:, first + i] * weights[off + i]
        out[:, band] = acc
    return np.log(out + np.float32(params.log_epsilon)).reshape(b, f, params.n_mels)


def _float64_logmel(wave, params):
    """log(|rfft(frame * window)|^2 @ mel + eps) in float64 (numpy's FFT)."""
    n_fft = params.n_fft
    f = params.num_frames(wave.shape[1])
    idx = np.arange(f)[:, None] * params.hop_length + np.arange(n_fft)[None]
    window = port_logmel._window_np(n_fft, params.win_length)
    spec = np.abs(np.fft.rfft(wave.astype(np.float64)[:, idx] * window, axis=-1)) ** 2
    mel = port_logmel.mel_filterbank(params).astype(np.float64)
    return np.log(spec @ mel + params.log_epsilon)


@pytest.mark.parametrize("amplitude", [1.0, 1e-3])
def test_fft_model_matches_plain_and_jax_pallas_and_xla_hop128(amplitude):
    # the kernel's bound (chip_smoke.py [logmel]): 1e-4 abs + 1e-4 rel, on
    # randn clips and on quiet ones (power near eps, where the log
    # magnifies relative error)
    wave = (amplitude * _wave(2, 16000, seed=4)).astype(np.float32)
    p = port_logmel.LogMelParams()
    jp = jax_logmel.LogMelParams()
    ours = logmel_fft_emulated(wave, p)
    plain = _port(wave, p)
    xla = np.asarray(jax_logmel.logmel_frames(jnp.asarray(wave), jp))
    pallas = np.asarray(
        jax_logmel.logmel_pallas(jnp.asarray(wave), jp, interpret=True))
    assert ours.shape == plain.shape == xla.shape == pallas.shape == (2, 122, 64)
    for want in (plain, xla, pallas):
        np.testing.assert_allclose(ours, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("amplitude", [1.0, 1e-3])
@pytest.mark.parametrize("n_fft,win,hop,n_mels", [
    (512, 400, 160, 64),   # hop 160 (10 ms): the Pallas kernel takes only 128
    (256, 200, 128, 40),   # n_fft 256: radix-4 stages only (M 128 -> 2 x 4 x 4 x 4)
    (256, 256, 80, 16),
])
def test_fft_model_matches_plain_and_jax_xla(n_fft, win, hop, n_mels, amplitude):
    wave = (amplitude * _wave(2, 9000, seed=n_fft + hop)).astype(np.float32)
    p = port_logmel.LogMelParams(n_fft=n_fft, win_length=win, hop_length=hop,
                                 n_mels=n_mels)
    jp = jax_logmel.LogMelParams(**vars(p))
    ours = logmel_fft_emulated(wave, p)
    xla = np.asarray(jax_logmel.logmel_frames(jnp.asarray(wave), jp))
    for want in (_port(wave, p), xla):
        np.testing.assert_allclose(ours, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("n_fft", port_logmel.FFT_SIZES)
def test_fft_model_matches_float64_at_every_kernel_size(n_fft):
    # every size the kernel takes, 64 .. 4096: log2(M) odd ends in the
    # radix-2 stage; the model sits within the bound of a float64 FFT
    p = port_logmel.LogMelParams(n_fft=n_fft, win_length=min(400, n_fft),
                                 hop_length=n_fft // 2)
    wave = _wave(1, 4 * n_fft, seed=n_fft)
    ours = logmel_fft_emulated(wave, p)
    np.testing.assert_allclose(ours, _float64_logmel(wave, p), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("n_fft", [64, 512])
def test_fft_emulated_is_the_dft(n_fft):
    # the stages alone against numpy's complex FFT of the packed points
    rng = np.random.RandomState(n_fft)
    z = (rng.randn(3, n_fft // 2) + 1j * rng.randn(3, n_fft // 2))
    tw, _ = port_logmel.fft_tables_np(n_fft, n_fft)
    re, im = fft_emulated(z.real.astype(np.float32), z.imag.astype(np.float32), tw)
    want = np.fft.fft(z, axis=-1)
    np.testing.assert_allclose(re + 1j * im, want, rtol=0, atol=1e-4 * np.abs(want).max())


def test_fft_tables_are_float64_rounded_and_the_window_is_the_basis():
    for n_fft, win in ((512, 400), (256, 200), (4096, 4096)):
        tw, window = port_logmel.fft_tables_np(n_fft, win)
        assert tw.dtype == window.dtype == np.float32
        assert tw.shape == (n_fft, 2) and window.shape == (n_fft,)
        angle = 2.0 * np.pi * np.arange(n_fft) / n_fft
        np.testing.assert_array_equal(tw[:, 0], np.cos(angle).astype(np.float32))
        np.testing.assert_array_equal(tw[:, 1], (-np.sin(angle)).astype(np.float32))
        # column 0 of the JAX package's window-folded basis is the window
        cos_b, _ = jax_logmel._dft_basis_np(n_fft, win)
        np.testing.assert_array_equal(window, cos_b[:, 0])


@pytest.mark.parametrize("params", [
    port_logmel.LogMelParams(),
    port_logmel.LogMelParams(n_fft=256, n_mels=40, fmax=6000.0),
    port_logmel.LogMelParams(n_fft=64, win_length=64, n_mels=64),  # empty bands
])
def test_mel_runs_rebuild_the_dense_filterbank(params):
    runs, weights = port_logmel.mel_runs_np(params)
    fb = jax_logmel.mel_filterbank(jax_logmel.LogMelParams(**vars(params)))
    dense = np.zeros_like(fb)
    for band, (first, count, off, _) in enumerate(runs):
        dense[first:first + count, band] = weights[off:off + count]
    np.testing.assert_array_equal(dense, fb)
    assert runs.dtype == np.int32 and weights.dtype == np.float32
    assert int(runs[:, 1].sum()) == weights.size
