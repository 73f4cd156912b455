"""PyTorch port, ``utils/flops.py``'s counts against the JAX package's, on
the CPU:

* every copied function (``logmel_frames``, ``_frontend_flops``,
  ``_rnn_flops``, ``_transformer_flops``, ``_cnn_flops``,
  ``encoder_forward_flops``, ``classifier_flops_per_clip``, ``_enc_dims``,
  ``classifier_param_count``, ``mfu``) equal to JAX's, exactly, on every
  file in ``configs/`` (with each audio frontend) and on the JAX bench legs
  (``bench.py:39-71``: the flagship on each frontend, ``BIG``, GRU, big GRU,
  transformer, bf16 compute);
* JAX's hand counts (``tests/test_flops.py``);
* ``classifier_param_count`` equal to the port's own model's parameter
  count on the concat-head configurations whose ``model.encoders`` are
  their modalities' (the unimodal files keep the default's other encoder
  in ``model.encoders``, which the count includes, as JAX's does);
* in place of JAX's XLA cost-analysis cross-check,
  ``torch.utils.flop_counter.FlopCounterMode`` on the CPU forward of a
  narrowed flagship: the counter cannot see into the log-mel custom op, so
  the plain log-mel's products stand in for it (equal to the analytic
  frontend count); the analytic forward count lies within 1% below the
  counter's (the counter also sees the attention pool's weighted sum);
* ``device_peak_flops`` / ``device_hbm_bw``: the H100 SXM's datasheet
  figures, and a refusal for any other card, dtype or no card."""

from pathlib import Path

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from multimodal_emotion_detection_tpu.config import load_config as jax_load_config
from multimodal_emotion_detection_tpu.utils import flops as jax_flops
from multimodal_emotion_detection_tpu_torch.config import load_config
from multimodal_emotion_detection_tpu_torch.models.classifier import (
    classifier_from_config,
    init_weights,
)
from multimodal_emotion_detection_tpu_torch.ops import logmel
from multimodal_emotion_detection_tpu_torch.utils import flops

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = sorted(p.name for p in (ROOT / "configs").glob("*.yaml"))
H100 = "NVIDIA H100 80GB HBM3"

# bench.py:39-71's legs, as overrides of the default Config
_SMALL = ["model.encoders.audio.hidden_dim=256"]
_BIG = ["model.output_dim=256", "model.hidden_dim=512",
        "model.encoders.audio.hidden_dim=512", "model.encoders.audio.num_layers=3",
        "model.encoders.video.hidden_dim=512"]
BENCH_LEGS = {
    "flagship_raw": _SMALL,
    "flagship_logmel": _SMALL + ["model.frontend.audio=logmel"],
    "flagship_logmel_cached": _SMALL + ["model.frontend.audio=logmel",
                                        "model.frontend.cache=true"],
    "flagship_bf16_b256": _SMALL + ["model.frontend.audio=logmel",
                                    "runtime.compute_dtype=bfloat16",
                                    "dataset.batch_size=256"],
    "big": _BIG + ["model.frontend.audio=logmel"],
    "big_bf16_b256": _BIG + ["model.frontend.audio=logmel", "model.frontend.cache=true",
                             "runtime.compute_dtype=bfloat16", "dataset.batch_size=256"],
    "gru": _SMALL + ["model.frontend.audio=logmel",
                     "model.encoders.audio.encoder_type=gru"],
    "big_gru": _BIG + ["model.frontend.audio=logmel", "model.frontend.cache=true",
                       "model.encoders.audio.encoder_type=gru"],
    "transformer": _SMALL + ["model.frontend.audio=logmel", "model.frontend.cache=true",
                             "model.encoders.audio.encoder_type=transformer"],
    "mfcc": _SMALL + ["model.frontend.audio=mfcc"],
}
COMMON = ["model.encoders.video.input_dim=4096"]


def _cases():
    for name in CONFIGS:
        for audio in ("raw", "logmel", "mfcc"):
            yield pytest.param(str(ROOT / "configs" / name), [f"model.frontend.audio={audio}"],
                               id=f"{name}-{audio}")
    for leg, overrides in BENCH_LEGS.items():
        yield pytest.param(None, COMMON + overrides, id=f"bench-{leg}")


def _both(path, overrides):
    return load_config(path, overrides), jax_load_config(path, overrides)


@pytest.mark.parametrize("path,overrides", list(_cases()))
def test_counts_equal_jax_exactly(path, overrides):
    cfg, jcfg = _both(path, overrides)
    fe, jfe = cfg.model.frontend, jcfg.model.frontend
    for samples in (48000, 16000, 5000):
        assert flops.logmel_frames(samples, fe.n_fft, fe.hop_length) == \
            jax_flops.logmel_frames(samples, jfe.n_fft, jfe.hop_length)
        assert flops._frontend_flops(fe, samples) == jax_flops._frontend_flops(jfe, samples)
    for audio_samples, video_frames in ((48000, 24), (16000, 8)):
        assert flops.classifier_flops_per_clip(cfg, audio_samples, video_frames) == \
            jax_flops.classifier_flops_per_clip(jcfg, audio_samples, video_frames)
    for name, enc in cfg.model.encoders.items():
        jenc = jcfg.model.encoders[name]
        dims = flops._enc_dims(cfg, name, dict(enc), 48000, 24)
        assert dims == jax_flops._enc_dims(jcfg, name, dict(jenc), 48000, 24)
        assert flops.encoder_forward_flops(dict(enc), cfg.model.output_dim, *dims) == \
            jax_flops.encoder_forward_flops(dict(jenc), jcfg.model.output_dim, *dims)
    count = flops.classifier_param_count(cfg)
    assert count == jax_flops.classifier_param_count(jcfg)
    train = flops.classifier_flops_per_clip(cfg)["train"]
    assert flops.mfu(1234.5, train, peak_flops=66.9e12) == \
        jax_flops.mfu(1234.5, train, peak_flops=66.9e12)


@pytest.mark.parametrize("args", [(372, 64, 256, 2), (48000, 1, 256, 2), (10, 8, 16, 3)])
def test_encoder_parts_equal_jax(args):
    t, d, h, layers = args
    for cell in ("lstm", "gru"):
        assert flops._rnn_flops(t, d, h, layers, cell) == \
            jax_flops._rnn_flops(t, d, h, layers, cell)
    assert flops._transformer_flops(t, d, h, layers) == \
        jax_flops._transformer_flops(t, d, h, layers)
    assert flops._cnn_flops(t, d, h) == jax_flops._cnn_flops(t, d, h)
    for enc in ({"type": "mlp", "hidden_dim": h, "num_layers": layers},
                {"type": "mlp", "hidden_dim": h, "sequence_length": 1},
                {"type": "frame", "hidden_dim": h}):
        for tt in (1, t):
            assert flops.encoder_forward_flops(enc, 32, tt, d) == \
                jax_flops.encoder_forward_flops(enc, 32, tt, d)
    for mod in (flops, jax_flops):
        with pytest.raises(ValueError, match="pretrained_cnn"):
            mod.encoder_forward_flops({"type": "pretrained_cnn"}, 32, t, d)
        with pytest.raises(ValueError, match="Unknown encoder_type"):
            mod.encoder_forward_flops({"encoder_type": "tcn"}, 32, t, d)


def test_hand_counts():
    # one LSTM layer, T 10, in 8, hidden 16, out 4: 4 gates x 16 x (8 + 16)
    # MACs a step, 2 FLOPs a MAC, 10 steps; the projection 2 x 16 x 4
    lstm = {"type": "sequence", "encoder_type": "lstm", "num_layers": 1, "hidden_dim": 16}
    assert flops.encoder_forward_flops(lstm, output_dim=4, T=10, input_dim=8) == 30720 + 128
    gru = {**lstm, "encoder_type": "gru"}  # 3 gates
    assert flops.encoder_forward_flops(gru, output_dim=4, T=10, input_dim=8) == 23040 + 128
    # 24 frames of 4096 -> 256, the pool's scores, the projection to 128
    f = flops.encoder_forward_flops({"type": "frame", "hidden_dim": 256}, output_dim=128,
                                    T=24, input_dim=4096)
    assert f == 24 * 2 * 4096 * 256 + 24 * 2 * 256 + 2 * 256 * 128
    # the frontend has no parameters: train = frontend + 3 x the rest
    cfg = load_config(None, COMMON + BENCH_LEGS["flagship_logmel"])
    r = flops.classifier_flops_per_clip(cfg)
    assert r["train"] == r["breakdown"]["frontend"] + 3 * (r["forward"] - r["breakdown"]["frontend"])
    cfg.model.frontend.cache = True
    cached = flops.classifier_flops_per_clip(cfg)
    assert "frontend" not in cached["breakdown"] and cached["train"] == 3 * cached["forward"]
    assert 6.5e8 < cached["forward"] < 7.2e8  # JAX's pinned envelope
    m = flops.mfu(100.0, 1e12, peak_flops=1e15)
    assert m == {"achieved_tflops": 100.0, "mfu": 0.1, "peak_tflops": 1000.0}


def test_logmel_frames_is_the_frontends_frame_count():
    params = logmel.LogMelParams()
    for samples in (48000, 40 * 128, 16000):
        out = logmel.logmel_frames(torch.zeros(1, samples), params)
        assert out.shape[1] == flops.logmel_frames(samples, params.n_fft, params.hop_length)


@pytest.mark.parametrize("path,overrides", [
    pytest.param(str(ROOT / "configs" / "base.yaml"), [], id="base.yaml"),
    pytest.param(str(ROOT / "configs" / "base.yaml"), ["model.frontend.audio=logmel"],
                 id="base.yaml-logmel"),
    *[pytest.param(None, COMMON + BENCH_LEGS[leg], id=f"bench-{leg}")
      for leg in ("flagship_logmel", "big", "gru", "big_gru", "transformer")],
])
def test_param_count_is_the_port_models(path, overrides):
    cfg = load_config(path, overrides)
    model = classifier_from_config(cfg)
    assert flops.classifier_param_count(cfg) == sum(p.numel() for p in model.parameters())


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_analytic_forward_within_the_flop_counters(one_thread):
    narrow = ["model.frontend.audio=logmel", "model.encoders.audio.hidden_dim=32",
              "model.encoders.video.input_dim=256", "model.encoders.video.hidden_dim=16",
              "model.output_dim=16", "model.hidden_dim=16", "runtime.platform=cpu",
              "model.encoders.audio.dropout=0", "model.encoders.video.dropout=0"]
    cfg = load_config(str(ROOT / "configs" / "base.yaml"), narrow)
    model = init_weights(classifier_from_config(cfg), torch.Generator().manual_seed(0))
    b, samples, frames = 4, 8000, 24
    g = torch.Generator().manual_seed(1)
    feats = {"audio": torch.randn(b, samples, 1, generator=g),
             "video": torch.randn(b, frames, 256, generator=g)}
    # the training form (dropout 0): the recurrence's products run as aten
    # ops the counter sees; the eval form's pair is one custom op it does not
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        model.train()(feats)
    with torch.no_grad(), FlopCounterMode(display=False) as front:
        logmel.logmel_frames(feats["audio"], logmel.LogMelParams())
    analytic = flops.classifier_flops_per_clip(cfg, samples, frames)
    assert front.get_total_flops() == b * analytic["breakdown"]["frontend"]
    counted = counter.get_total_flops() + front.get_total_flops()
    assert 0.99 * counted <= b * analytic["forward"] <= counted, (b * analytic["forward"], counted)


def test_device_figures():
    assert flops.device_peak_flops("bfloat16", name=H100) == 989.4e12
    assert flops.device_peak_flops("tfloat32", name=H100) == 494.7e12
    assert flops.device_peak_flops(name=H100) == 66.9e12
    assert flops.device_peak_flops("float32", name="NVIDIA H100 SXM5 80GB") == 66.9e12
    assert flops.device_hbm_bw(name=H100) == 3.35e12
    for card in ("NVIDIA H100 PCIe", "NVIDIA A100-SXM4-80GB", "TPU v5 lite"):
        with pytest.raises(ValueError, match="no peak FLOP/s is known"):
            flops.device_peak_flops("bfloat16", name=card)
        with pytest.raises(ValueError, match="no HBM bandwidth is known"):
            flops.device_hbm_bw(name=card)
    with pytest.raises(ValueError, match="compute_dtype"):
        flops.device_peak_flops("float16", name=H100)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            flops.device_peak_flops()
        with pytest.raises(RuntimeError, match="no CUDA card"):
            flops.mfu(10.0, 1e9)
