"""PyTorch port, predict CLI end to end on a tiny on-disk dataset: a JAX
checkpoint is served by the JAX predict CLI, converted by
``scripts/jax_ckpt_to_torch.py`` and served by the port's predict CLI; the
artifacts must agree."""

import importlib.util
import json
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
from multimodal_emotion_detection_tpu.tools.predict import main as jax_predict
from multimodal_emotion_detection_tpu.training.checkpoints import save_checkpoint
from multimodal_emotion_detection_tpu.training.optim import build_optimizer
from multimodal_emotion_detection_tpu.training.steps import create_train_state
from multimodal_emotion_detection_tpu_torch.tools.predict import (
    main as port_predict,
)

ROOT = Path(__file__).resolve().parents[1]
NARROW = [
    "model.frontend.audio=logmel",
    "model.encoders.audio.hidden_dim=128",
    "model.encoders.video.input_dim=16",
    "model.encoders.video.hidden_dim=32",
    "model.output_dim=16",
    "model.hidden_dim=32",
    "dataset.batch_size=8",
]
ROWS = 12  # 2 batches of 8: the second is wrap-padded


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the suite runs several test workers on the same cores; at these tiny
    # shapes a multi-threaded torch only spins idle threads that slow them all
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _write_split(root: Path, split: str, seed: int) -> None:
    rng = np.random.RandomState(seed)
    d = root / split
    d.mkdir(parents=True)
    np.save(d / "audio.npy", rng.randn(ROWS, 40 * 128, 1).astype(np.float32))
    np.save(d / "video.npy", rng.rand(ROWS, 4, 16).astype(np.float32))
    np.save(d / "labels.npy", rng.randint(0, 8, ROWS).astype(np.int32))


def _converter():
    spec = importlib.util.spec_from_file_location(
        "jax_ckpt_to_torch", ROOT / "scripts" / "jax_ckpt_to_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.main


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("port_predict")
    data = tmp / "data"
    # the JAX restore loads every split, so all three are written
    for seed, split in enumerate(("train", "val", "test")):
        _write_split(data, split, seed)
    overrides = NARROW + [f"dataset.data_dir={data}"]

    cfg = jax_load_config(str(ROOT / "configs/base.yaml"), overrides)
    model = jax_classifier_from_config(cfg)
    tx, _ = build_optimizer(cfg.training, steps_per_epoch=2)
    rng = np.random.RandomState(9)
    sample = {"audio": jnp.asarray(rng.randn(8, 40 * 128, 1), jnp.float32),
              "video": jnp.asarray(rng.rand(8, 4, 16), jnp.float32)}
    state = create_train_state(model, tx, sample, jnp.ones((8, 2)),
                               jax.random.PRNGKey(5))
    jax_ckpt = tmp / "best.ckpt"
    save_checkpoint(jax_ckpt, state, {"epoch": 1, "step": 2})
    port_ckpt = tmp / "best.pt"
    _converter()([str(jax_ckpt), str(port_ckpt)])

    def run(predict, ckpt, out, extra=()):
        return predict([
            "--checkpoint", str(ckpt), "--config",
            str(ROOT / "configs/base.yaml"), "--out", str(out), *extra,
            *overrides, "runtime.platform=cpu",
        ])

    return tmp, overrides, port_ckpt, {
        name: (run(jax_predict, jax_ckpt, tmp / f"jax{name}", extra),
               run(port_predict, port_ckpt, tmp / f"port{name}", extra))
        for name, extra in (("", ()), ("_missing0", ("--missing", "0")))
    }


@pytest.mark.parametrize("name", ["", "_missing0"], ids=["all", "missing0"])
def test_artifacts_match_jax(served, name):
    tmp, _, _, metrics = served
    jdir, pdir = tmp / f"jax{name}", tmp / f"port{name}"
    logits = np.load(pdir / "logits.npy")
    assert logits.shape == (ROWS, 8)
    np.testing.assert_allclose(logits, np.load(jdir / "logits.npy"),
                               rtol=1e-4, atol=1e-4)
    for f in ("predictions.npy", "labels.npy"):
        np.testing.assert_array_equal(np.load(pdir / f), np.load(jdir / f))
    jm = json.loads((jdir / "metrics.json").read_text())
    pm = json.loads((pdir / "metrics.json").read_text())
    assert pm == metrics[name][1]
    for key in ("ece", "mce", "nll", "accuracy"):
        assert pm[key] == pytest.approx(jm[key], abs=1e-5)
    for key in ("split", "missing_pattern", "mc_dropout_samples",
                "quantize_weights"):
        assert pm[key] == jm[key]


def test_predict_without_cpu_override_raises_on_a_host_without_a_card(
        served, monkeypatch):
    tmp, overrides, port_ckpt, _ = served
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="runtime.platform=cpu"):
        port_predict(["--checkpoint", str(port_ckpt), "--config",
                      str(ROOT / "configs/base.yaml"),
                      "--out", str(tmp / "never"), *overrides])
    assert not (tmp / "never").exists()


# the first case was --mc-dropout until MC dropout was ported, then the
# int8 serving artifact; both cases keep their ids (flag0, flag1) and now
# hold that the serving-quantization options, once refused, run
@pytest.mark.parametrize("flag", [["--quantized-artifact", "model_int8.pt"],
                                  ["--quantize-weights", "int8"]])
def test_unported_options_exit_with_their_roadmap_item(served, flag):
    from multimodal_emotion_detection_tpu_torch.tools.quantize import (
        main as port_quantize,
    )

    tmp, overrides, port_ckpt, _ = served
    config = ["--config", str(ROOT / "configs/base.yaml")]
    if flag[0] == "--quantized-artifact":
        flag = [flag[0], str(tmp / flag[1])]
        port_quantize(["--checkpoint", str(port_ckpt), *config, "--out", flag[1],
                       *overrides, "runtime.platform=cpu"])
    out = tmp / f"quantized{flag[0]}"
    metrics = port_predict(["--checkpoint", str(port_ckpt), *config, *flag,
                            "--out", str(out), *overrides, "runtime.platform=cpu"])
    assert metrics["quantize_weights"] == ("int8-artifact" if "artifact" in flag[0]
                                           else "int8")
    logits = np.load(out / "logits.npy")
    assert logits.shape == (ROWS, 8) and np.isfinite(logits).all()
    # int8 weights move the logits off the float32 ones, but not far
    f32 = np.load(tmp / "port" / "logits.npy")
    assert 0 < np.abs(logits - f32).max() < 0.05 * np.abs(f32).max()
