"""PyTorch port, the training CLI and the Trainer on a tiny on-disk split
(``runtime.platform=cpu``, where every kernel wrapper runs its plain
version): the artifact set and CSV cadence of the JAX ``train.main``,
2 epochs of ``val/loss`` against the JAX ``Trainer.fit`` from the same
weights (tolerance 1e-4, as the train-step test), resume, early stopping
by validation checks, the predict CLI on the trained ``best.ckpt``,
``frontend.cache``, and the image encoder's configurations: trained on
rank-5 frames, or refused with the JAX package's errors."""

import csv
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from multimodal_emotion_detection_tpu import train as jax_train
from multimodal_emotion_detection_tpu.config import load_config as jax_load_config
from multimodal_emotion_detection_tpu.data.loader import (
    create_dataloaders as jax_create_dataloaders,
)
from multimodal_emotion_detection_tpu.training.loop import Trainer as JaxTrainer
from multimodal_emotion_detection_tpu_torch import train as port_train
from multimodal_emotion_detection_tpu_torch.config import load_config
from multimodal_emotion_detection_tpu_torch.data.loader import create_dataloaders
from multimodal_emotion_detection_tpu_torch.models.classifier import (
    classifier_from_config,
)
from multimodal_emotion_detection_tpu_torch.tools.predict import (
    main as port_predict,
)
from multimodal_emotion_detection_tpu_torch.training.loop import Trainer
from multimodal_emotion_detection_tpu_torch.utils.weights import (
    state_dict_from_jax_params,
)

ROOT = Path(__file__).resolve().parents[1]
CONFIG = str(ROOT / "configs" / "base.yaml")
NARROW = [
    "model.frontend.audio=logmel",
    "model.encoders.audio.hidden_dim=128",
    "model.encoders.video.input_dim=16",
    "model.encoders.video.hidden_dim=32",
    "model.output_dim=16",
    "model.hidden_dim=32",
    "dataset.batch_size=8",
    "training.max_epochs=2",
    "experiment.log_every_n_steps=2",
    "runtime.platform=cpu",
    "runtime.lstm_kernels=off",
    "runtime.epoch_scan=off",
]
NO_DROPOUT = [
    "model.encoders.audio.dropout=0.0",
    "model.encoders.video.dropout=0.0",
    "training.augmentation.modality_dropout=0.0",
]
SIZES = {"train": 20, "val": 12, "test": 12}  # 3 / 2 / 2 batches of 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the suite runs several test workers on the same cores; at these tiny
    # shapes a multi-threaded torch only spins idle threads that slow them all
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("port_trainer_data")
    for seed, (split, n) in enumerate(SIZES.items()):
        rng = np.random.RandomState(seed)
        d = root / split
        d.mkdir()
        np.save(d / "audio.npy", rng.randn(n, 40 * 128, 1).astype(np.float32))
        np.save(d / "video.npy", rng.rand(n, 4, 16).astype(np.float32))
        np.save(d / "labels.npy", rng.randint(0, 8, n).astype(np.int32))
    return root


def _overrides(data_dir, save_dir, *extra):
    return NARROW + [f"dataset.data_dir={data_dir}",
                     f"experiment.save_dir={save_dir}",
                     "experiment.name=run", *extra]


def _csv_shape(path):
    """Header and, per row, (step, epoch, the non-empty metric columns)."""
    with open(path) as f:
        rows = list(csv.DictReader(f))
        header = rows[0].keys() if rows else []
    return sorted(header), [
        (r["step"], r["epoch"], sorted(k for k, v in r.items()
                                       if v != "" and k not in ("step", "epoch")))
        for r in rows]


@pytest.fixture(scope="module")
def port_run(data_dir, tmp_path_factory):
    save = tmp_path_factory.mktemp("port_run")
    results = port_train.main(["--config", CONFIG, *_overrides(data_dir, save)])
    return save / "run", results


def test_train_main_writes_the_jax_artifact_set(data_dir, tmp_path, port_run):
    port_dir, results = port_run
    jax_train.main(["--config", CONFIG, *_overrides(data_dir, tmp_path)])
    jax_dir = tmp_path / "run"
    for rel in ("results.json", "best.ckpt", "checkpoints/last.ckpt",
                "confusion_matrix.npy", "config_snapshot/config.yaml"):
        assert (jax_dir / rel).exists(), rel
        assert (port_dir / rel).exists(), rel
    port_results = json.loads((port_dir / "results.json").read_text())
    jax_results = json.loads((jax_dir / "results.json").read_text())
    assert sorted(port_results) == sorted(jax_results)
    assert sorted(port_results["config"]) == sorted(jax_results["config"])
    assert Path(port_results["best_model_path"]).exists()
    assert np.load(port_dir / "confusion_matrix.npy").sum() == SIZES["test"]
    assert _csv_shape(port_dir / "csv_logs/version_0/metrics.csv") == _csv_shape(
        jax_dir / "csv_logs/version_0/metrics.csv")
    assert set(results) >= {"test/loss", "test/acc", "test/acc_agg",
                            "test/macro_f1", "best_val_loss"}


def test_predict_loads_the_trained_best_ckpt(data_dir, tmp_path, port_run):
    port_dir, _ = port_run
    metrics = port_predict([
        "--checkpoint", str(port_dir / "best.ckpt"), "--config", CONFIG,
        "--out", str(tmp_path / "preds"),
        *_overrides(data_dir, tmp_path)])
    logits = np.load(tmp_path / "preds" / "logits.npy")
    assert logits.shape == (SIZES["test"], 8) and np.isfinite(logits).all()
    assert metrics["split"] == "test"


def _loaders(cfg, create):
    return create(cfg.dataset.name, cfg.dataset.data_dir, cfg.dataset.modalities,
                  batch_size=cfg.dataset.batch_size, seed=cfg.seed)


def _port_fit(data_dir, save_dir, *extra, model=None, resume=False):
    cfg = load_config(CONFIG, _overrides(data_dir, save_dir, *extra))
    trainer = Trainer(cfg, model=model, save_dir=Path(save_dir) / "run")
    train_loader, val_loader, _ = _loaders(cfg, create_dataloaders)
    trainer.fit(train_loader, val_loader, resume=resume)
    return trainer


def test_fit_val_loss_matches_jax_trainer(data_dir, tmp_path):
    extra = NO_DROPOUT
    jcfg = jax_load_config(CONFIG, _overrides(data_dir, tmp_path / "jax", *extra))
    jtrainer = JaxTrainer(jcfg, save_dir=tmp_path / "jax")
    jtrain, jval, _ = _loaders(jcfg, jax_create_dataloaders)
    with jax.default_matmul_precision("highest"):
        jtrainer._build(jtrain)
        params = jax.tree_util.tree_map(np.asarray, jtrainer.state.params)
        jtrainer.fit(jtrain, jval)

    cfg = load_config(CONFIG, _overrides(data_dir, tmp_path, *extra))
    model = classifier_from_config(cfg)
    model.load_state_dict(state_dict_from_jax_params(params))
    trainer = _port_fit(data_dir, tmp_path / "port", *extra, model=model)
    want = [row["val/loss"] for row in jtrainer.history]
    got = [row["val/loss"] for row in trainer.history]
    assert len(got) == len(want) == 2
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_resume_equals_uninterrupted(data_dir, tmp_path):
    straight = _port_fit(data_dir, tmp_path / "straight", "training.max_epochs=3")
    _port_fit(data_dir, tmp_path / "resumed", "training.max_epochs=2")
    resumed = _port_fit(data_dir, tmp_path / "resumed", "training.max_epochs=3",
                        resume=True)
    assert [r["epoch"] for r in resumed.history] == [2]
    np.testing.assert_allclose(resumed.history[0]["val/loss"],
                               straight.history[2]["val/loss"], rtol=1e-6)
    assert resumed.step == straight.step


def test_early_stopping_counts_validation_checks(data_dir, tmp_path):
    # lr 0: val/loss never improves after the first check; patience 2
    # validation checks at every 2nd epoch stops after epoch 5, not 3
    trainer = _port_fit(data_dir, tmp_path, "training.max_epochs=10",
                        "training.learning_rate=0.0",
                        "training.val_every_n_epochs=2",
                        "training.early_stopping_patience=2")
    assert [r["epoch"] for r in trainer.history] == list(range(6))
    assert [("val/loss" in r) for r in trainer.history] == [False, True] * 3


def test_frontend_cache_gives_the_same_trajectory(data_dir, tmp_path):
    plain = _port_fit(data_dir, tmp_path / "a")
    cached = _port_fit(data_dir, tmp_path / "b", "model.frontend.cache=true")
    for key in ("train/loss", "val/loss"):
        np.testing.assert_allclose([r[key] for r in cached.history],
                                   [r[key] for r in plain.history],
                                   rtol=0, atol=1e-6, err_msg=key)


@pytest.fixture(scope="module")
def frame_dir(data_dir, tmp_path_factory):
    """``data_dir`` with rank-5 video: (N, 2, 16, 16, 3) frames."""
    root = tmp_path_factory.mktemp("port_trainer_frames")
    for seed, split in enumerate(SIZES):
        d = root / split
        d.mkdir()
        for name in ("audio.npy", "labels.npy"):
            (d / name).write_bytes((data_dir / split / name).read_bytes())
        frames = np.random.RandomState(20 + seed).rand(SIZES[split], 2, 16, 16, 3)
        np.save(d / "video.npy", frames.astype(np.float32))
    return root


# the image encoder (type: pretrained_cnn) and its weights_path are ported
# since: each case keeps its id, and trains on rank-5 frames or refuses as
# the JAX package does, with its error (rank-3 features into the image
# encoder; weights_path on another encoder)
RANK, WEIGHTS = "Expected rank-4/5 frames", "requires type='pretrained_cnn'"


@pytest.mark.parametrize("override,item", [
    pytest.param(["model.frontend.video=resize", "model.encoders.video.type=pretrained_cnn"],
                 RANK, id="runtime.lstm_residual_dtype=bfloat16-item 13"),
    pytest.param(["runtime.compute_dtype=bfloat16",
                  "model.encoders.audio.type=pretrained_cnn"], RANK,
                 id="runtime.compute_dtype=bfloat16-item 13"),
    pytest.param(["model.encoders.audio.dtype=bfloat16", "model.frontend.video=resize",
                  "model.encoders.video.type=pretrained_cnn"],
                 RANK, id="runtime.profile_dir=prof-item 5"),
    pytest.param("model.encoders.video.weights_path=w.pth", WEIGHTS,
                 id="model.encoders.video.weights_path=w.pth-item 5"),
    pytest.param("model.encoders.video.type=pretrained_cnn", None,
                 id="dataset.name=synthetic-item 5"),
    pytest.param(["model.encoders.video.type=pretrained_cnn",
                  "model.encoders.video.dtype=bfloat16"],
                 None, id="dataset.device_resident=false-item 5"),
    pytest.param("model.encoders.audio.type=pretrained_cnn", RANK,
                 id="model.fusion_type=uncertainty-item 9"),
])
def test_training_configs_outside_the_slice_raise(data_dir, frame_dir, tmp_path,
                                                  override, item):
    extra = [override] if isinstance(override, str) else override
    if item is not None:
        with pytest.raises(ValueError, match=item):
            port_train.main(["--config", CONFIG, *_overrides(data_dir, tmp_path, *extra)])
        return
    results = port_train.main(["--config", CONFIG,
                               *_overrides(frame_dir, tmp_path, *extra)])
    assert all(np.isfinite(v) for v in results.values())
    assert (tmp_path / "run" / "best.ckpt").exists()
