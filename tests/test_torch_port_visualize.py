"""PyTorch port, the attention visualizer against the JAX package: the
(M, M) cross-attention matrix of a hybrid fusion (and the (1, M) fusion
weights of uncertainty-weighted late fusion) on JAX-initialised weights
against the numbers JAX ``tools/visualize.py``'s inline code gives (1e-5),
and both CLIs on the same checkpoint writing the PNG where matplotlib is
installed."""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_emotion_detection_tpu.config import load_config as jax_load_config
from multimodal_emotion_detection_tpu.models.classifier import (
    classifier_from_config as jax_classifier_from_config,
)
from multimodal_emotion_detection_tpu.models.fusion import HybridFusion as JaxHybrid
from multimodal_emotion_detection_tpu.tools.visualize import main as jax_visualize
from multimodal_emotion_detection_tpu.training.checkpoints import save_checkpoint
from multimodal_emotion_detection_tpu.training.optim import build_optimizer
from multimodal_emotion_detection_tpu.training.steps import create_train_state
from multimodal_emotion_detection_tpu_torch.config import load_config
from multimodal_emotion_detection_tpu_torch.models.attention import (
    visualize_attention,
)
from multimodal_emotion_detection_tpu_torch.models.classifier import (
    classifier_from_config,
)
from multimodal_emotion_detection_tpu_torch.tools.visualize import (
    attention_matrix,
)
from multimodal_emotion_detection_tpu_torch.tools.visualize import main as port_visualize
from multimodal_emotion_detection_tpu_torch.utils.weights import (
    state_dict_from_jax_params,
)

ROOT = Path(__file__).resolve().parents[1]
HYBRID = str(ROOT / "configs" / "av_hybrid.yaml")
UNCERTAINTY = str(ROOT / "configs" / "uncertainty.yaml")
NARROW = ["model.encoders.audio.hidden_dim=32", "model.encoders.video.input_dim=16",
          "model.encoders.video.hidden_dim=32", "model.output_dim=16",
          "model.hidden_dim=32", "dataset.batch_size=6"]
ROWS, SAMPLES, FRAMES = 6, 40 * 128, 4
try:
    import matplotlib  # noqa: F401
    HAVE_MPL = True
except ImportError:
    HAVE_MPL = False


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the suite runs several test workers on the same cores; at these tiny
    # shapes a multi-threaded torch only spins idle threads that slow them all
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _feats(seed):
    rng = np.random.RandomState(seed)
    return {"audio": rng.randn(ROWS, SAMPLES, 1).astype(np.float32),
            "video": rng.rand(ROWS, FRAMES, 16).astype(np.float32)}


def _jax_matrix(cfg, jmodel, variables, feats):
    """JAX tools/visualize.py's inline numbers on ``feats``."""
    modalities = list(cfg.dataset.modalities)
    batch = {k: jnp.asarray(v) for k, v in feats.items()}
    mask = jnp.ones((ROWS, len(modalities)), jnp.float32)
    _, aux = jmodel.apply(variables, batch, mask, deterministic=True, return_aux=True)
    if cfg.model.train_fusion == "library" and cfg.model.fusion_type == "hybrid":
        fusion = JaxHybrid(
            modality_dims={m: cfg.model.output_dim for m in modalities},
            hidden_dim=cfg.model.hidden_dim, num_classes=cfg.dataset.num_classes,
            num_heads=cfg.model.num_heads, dropout=cfg.model.dropout)
        _, info = fusion.apply({"params": variables["params"]["fusion"]},
                               aux["encoded"], mask, return_attention=True)
        return np.stack([np.asarray(info["per_modality_attention"][m]).mean(axis=(0, 1, 2))
                         for m in modalities])
    return np.asarray(aux["fusion_weights"]).mean(axis=0, keepdims=True)


@pytest.mark.parametrize("config,shape", [(HYBRID, (2, 2)), (UNCERTAINTY, (1, 2))],
                         ids=["av_hybrid", "uncertainty"])
def test_attention_matrix_matches_jax(config, shape):
    jcfg = jax_load_config(config, NARROW)
    jmodel = jax_classifier_from_config(jcfg)
    feats = _feats(0)
    with jax.default_matmul_precision("highest"):
        variables = jmodel.init(jax.random.PRNGKey(4),
                                {k: jnp.asarray(v) for k, v in feats.items()},
                                jnp.ones((ROWS, 2), jnp.float32))
        want = _jax_matrix(jcfg, jmodel, variables, feats)
    model = classifier_from_config(load_config(config, NARROW))
    model.load_state_dict(state_dict_from_jax_params(
        jax.tree_util.tree_map(np.asarray, variables["params"])))
    got = attention_matrix(model, {k: torch.from_numpy(v) for k, v in feats.items()},
                           torch.ones(ROWS, 2), ["audio", "video"])
    assert got.shape == want.shape == shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.sum(-1), 1.0, rtol=0, atol=1e-5)  # rows of softmaxes


def test_attention_matrix_is_none_without_fusion_weights():
    model = classifier_from_config(load_config(str(ROOT / "configs" / "base.yaml"),
                                               NARROW + ["model.frontend.audio=logmel"]))
    feats = {k: torch.from_numpy(v) for k, v in _feats(0).items()}
    assert attention_matrix(model, feats, torch.ones(ROWS, 2), ["audio", "video"]) is None


def _converter():
    spec = importlib.util.spec_from_file_location(
        "jax_ckpt_to_torch", ROOT / "scripts" / "jax_ckpt_to_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.main


def test_visualize_clis_write_the_heatmap(tmp_path, monkeypatch):
    data = tmp_path / "data"
    for seed, split in enumerate(("train", "val", "test")):
        d = data / split
        d.mkdir(parents=True)
        for name, arr in _feats(seed).items():
            np.save(d / f"{name}.npy", arr)
        np.save(d / "labels.npy", np.random.RandomState(seed).randint(0, 8, ROWS)
                .astype(np.int32))
    overrides = NARROW + [f"dataset.data_dir={data}", "runtime.platform=cpu"]
    jcfg = jax_load_config(HYBRID, overrides)
    jmodel = jax_classifier_from_config(jcfg)
    tx, _ = build_optimizer(jcfg.training, steps_per_epoch=1)
    sample = {k: jnp.asarray(v) for k, v in _feats(2).items()}
    state = create_train_state(jmodel, tx, sample, jnp.ones((ROWS, 2)),
                               jax.random.PRNGKey(6))
    jax_ckpt, port_ckpt = tmp_path / "best.ckpt", tmp_path / "best.pt"
    save_checkpoint(jax_ckpt, state, {"epoch": 0, "step": 1})
    _converter()([str(jax_ckpt), str(port_ckpt)])

    jout, pout = tmp_path / "jax.png", tmp_path / "port.png"
    assert jax_visualize(["--checkpoint", str(jax_ckpt), "--config", HYBRID,
                          "--out", str(jout), *overrides]) == str(jout)
    assert port_visualize(["--checkpoint", str(port_ckpt), "--config", HYBRID,
                           "--out", str(pout), *overrides]) == str(pout)
    assert pout.exists() == jout.exists() == HAVE_MPL
    if HAVE_MPL:
        assert pout.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    # without a card and without runtime.platform=cpu it raises
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="runtime.platform=cpu"):
        port_visualize(["--checkpoint", str(port_ckpt), "--config", HYBRID,
                        "--out", str(tmp_path / "never.png"), *overrides[:-1]])
    assert not (tmp_path / "never.png").exists()


@pytest.mark.skipif(not HAVE_MPL, reason="matplotlib is not installed")
def test_visualize_attention_averages_down_to_two_axes(tmp_path):
    out = tmp_path / "attn.png"
    visualize_attention(np.random.RandomState(0).rand(3, 4, 2, 2), ["audio", "video"],
                        save_path=str(out))
    assert out.exists() and out.stat().st_size > 0
