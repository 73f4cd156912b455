"""PyTorch port, synthetic data and the host-streaming loader
(``runtime.platform=cpu``, where every kernel wrapper runs its plain
version): the synthetic arrays bit for bit the JAX package's, the loaders'
sizing, streamed batches equal to resident gathers, ``Trainer.fit``
streamed bit for bit resident and against the JAX ``Trainer.fit`` on its
host-streaming path (val loss / accuracy 1e-4), the train CLI's artifacts
against JAX's on ``dataset.name=synthetic``, predict on a converted JAX
``best.ckpt`` against JAX's predict, ``runtime.profile_dir``'s one-epoch
trace, and ``weights_path`` still refused."""

import csv
import importlib.util
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
from multimodal_emotion_detection_tpu.data.synthetic import (
    synthetic_arrays as jax_synthetic_arrays,
)
from multimodal_emotion_detection_tpu.tools.predict import main as jax_predict
from multimodal_emotion_detection_tpu.training.loop import Trainer as JaxTrainer
from multimodal_emotion_detection_tpu_torch import train as port_train
from multimodal_emotion_detection_tpu_torch.config import load_config
from multimodal_emotion_detection_tpu_torch.data.loader import (
    SYNTHETIC_KEYS,
    create_dataloaders,
)
from multimodal_emotion_detection_tpu_torch.data.synthetic import synthetic_arrays
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
ENC = ("{type: sequence, encoder_type: lstm, input_dim: 8, hidden_dim: 16, "
       "num_layers: 2, dropout: 0.0}")
# the reference's synthetic fixture (three sensors), narrow: LSTM 2x16 over
# T 12; 40 train rows in batches of 16 (the last ragged), 12 val / 12 test
SYNTH = [
    "runtime.platform=cpu",
    "runtime.lstm_kernels=off",
    "runtime.epoch_scan=off",
    "dataset.name=synthetic",
    "dataset.modalities=[sensor1,sensor2,sensor3]",
    "dataset.num_samples=40",
    "dataset.num_samples_eval=60",
    "dataset.num_classes=5",
    "dataset.batch_size=16",
    "dataset.sequence_length=12",
    "dataset.modality_dim=8",
    "model.encoders={" + ", ".join(f"sensor{i}: {ENC}" for i in (1, 2, 3)) + "}",
    "model.output_dim=8",
    "model.hidden_dim=16",
    "training.max_epochs=2",
    "training.augmentation.modality_dropout=0.0",
    "experiment.log_every_n_steps=2",
]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the suite runs several test workers on the same cores; at these tiny
    # shapes a multi-threaded torch only spins idle threads that slow them all
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _overrides(save_dir, *extra):
    return SYNTH + [f"experiment.save_dir={save_dir}", "experiment.name=run", *extra]


def _loaders(cfg, create, **kw):
    return create(cfg.dataset.name, cfg.dataset.data_dir, cfg.dataset.modalities,
                  batch_size=cfg.dataset.batch_size, seed=cfg.seed,
                  **{k: getattr(cfg.dataset, k) for k in SYNTHETIC_KEYS}, **kw)


@pytest.mark.parametrize("seed", [0, 42, 1234])
@pytest.mark.parametrize("split", ["train", "val", "test", "other"])
def test_synthetic_arrays_equal_jax_bit_for_bit(seed, split):
    dims = {"sensor1": 8, "sensor2": 3, "x": 5}
    for kwargs in ({}, dict(num_samples=17, num_classes=4, modality_dims=dims,
                            sequence_length=6)):
        if not kwargs:
            kwargs = dict(num_samples=9)  # the default three sensors of 32
        port = synthetic_arrays(split=split, seed=seed, **kwargs)
        ref = jax_synthetic_arrays(split=split, seed=seed, **kwargs)
        assert port.modalities == ref.modalities
        for m in ref.modalities:
            assert port.features[m].dtype == ref.features[m].dtype == np.float32
            np.testing.assert_array_equal(port.features[m], ref.features[m])
        assert port.labels.dtype == ref.labels.dtype == np.int32
        np.testing.assert_array_equal(port.labels, ref.labels)


def test_create_dataloaders_synthetic_sizing_equals_jax(capsys):
    kw = dict(batch_size=8, num_samples=32, num_samples_eval=40, num_classes=4,
              modality_dim=6, sequence_length=5)
    port = create_dataloaders("synthetic", "", ["a", "b"], **kw)
    ref = jax_create_dataloaders("synthetic", "", ["a", "b"], **kw)
    assert [p.num_samples for p in port] == [r.num_samples for r in ref] == [32, 8, 8]
    assert [len(p) for p in port] == [len(r) for r in ref]
    for p, r in zip(port, ref):
        for m in ("a", "b"):
            np.testing.assert_array_equal(p.arrays.features[m], r.arrays.features[m])
        np.testing.assert_array_equal(p.arrays.labels, r.arrays.labels)
        assert (p.shuffle, p.seed) == (r.shuffle, r.seed)
        np.testing.assert_array_equal(p.epoch_batch_indices(1), r.epoch_batch_indices(1))
    create_dataloaders("synthetic", "", ["a"], num_workers=2, **kw)
    assert "num_workers=2 accepted for config-schema parity" in capsys.readouterr().out


def test_streamed_batches_equal_resident_gathers():
    cfg = load_config(None, SYNTH)
    resident = _loaders(cfg, create_dataloaders)[0]
    streamed = _loaders(cfg, create_dataloaders, device_resident=False)[0]
    assert resident.device_resident and not streamed.device_resident
    feats, labels = resident.device_arrays()
    for epoch in (0, 1):
        batches = list(streamed.stream(epoch))
        idx = resident.epoch_batch_indices(epoch)
        assert len(batches) == len(idx) == 3
        for (f, lab), row in zip(batches, idx):
            row = torch.from_numpy(row.astype(np.int64))
            assert lab.dtype == torch.int64
            assert torch.equal(lab, labels.index_select(0, row))
            for m, a in feats.items():
                assert torch.equal(f[m], a.index_select(0, row))


def _port_fit(save_dir, *extra, model=None, device_resident=True):
    cfg = load_config(None, _overrides(save_dir, *extra))
    trainer = Trainer(cfg, model=model, save_dir=Path(save_dir) / "run")
    train, val, _ = _loaders(cfg, create_dataloaders, device_resident=device_resident)
    trainer.fit(train, val)
    return trainer


@pytest.fixture(scope="module")
def jax_fit(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("jax_synthetic_fit")
    jcfg = jax_load_config(None, _overrides(tmp / "jax"))
    jtrainer = JaxTrainer(jcfg, save_dir=tmp / "jax")
    jtrain, jval, _ = _loaders(jcfg, jax_create_dataloaders, device_resident=False)
    with jax.default_matmul_precision("highest"):
        jtrainer._build(jtrain)
        params = jax.tree_util.tree_map(np.asarray, jtrainer.state.params)
        jtrainer.fit(jtrain, jval)
    return params, jtrainer.history


def test_fit_streamed_is_resident_bit_for_bit_and_matches_jax(tmp_path, jax_fit):
    params, jax_history = jax_fit
    runs = {}
    for resident in (True, False):
        model = classifier_from_config(load_config(None, SYNTH))
        model.load_state_dict(state_dict_from_jax_params(params))
        runs[resident] = _port_fit(tmp_path / str(resident), model=model,
                                   device_resident=resident)
    keys = ("train/loss", "train/acc", "val/loss", "val/acc", "val/entropy")
    got = [[row[k] for k in keys] for row in runs[False].history]
    assert got == [[row[k] for k in keys] for row in runs[True].history]
    for name, p in runs[True].model.state_dict().items():
        assert torch.equal(p, runs[False].model.state_dict()[name]), name
    assert len(got) == len(jax_history) == 2
    for key in ("val/loss", "val/acc"):
        np.testing.assert_allclose([r[key] for r in runs[False].history],
                                   [r[key] for r in jax_history], rtol=0, atol=1e-4,
                                   err_msg=key)


def _csv_shape(path):
    with open(path) as f:
        rows = list(csv.DictReader(f))
    return sorted(rows[0].keys()), [
        (r["step"], r["epoch"], sorted(k for k, v in r.items()
                                       if v != "" and k not in ("step", "epoch")))
        for r in rows]


def _converter():
    spec = importlib.util.spec_from_file_location(
        "jax_ckpt_to_torch", ROOT / "scripts" / "jax_ckpt_to_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.main


def test_train_cli_artifacts_and_predict_match_jax(tmp_path):
    port_results = port_train.main(_overrides(tmp_path / "port"))
    with jax.default_matmul_precision("highest"):
        jax_train.main(_overrides(tmp_path / "jax"))
    port_dir, jax_dir = tmp_path / "port" / "run", tmp_path / "jax" / "run"
    for rel in ("results.json", "best.ckpt", "checkpoints/last.ckpt",
                "confusion_matrix.npy", "config_snapshot/config.yaml"):
        assert (jax_dir / rel).exists(), rel
        assert (port_dir / rel).exists(), rel
    assert sorted(json.loads((port_dir / "results.json").read_text())) == sorted(
        json.loads((jax_dir / "results.json").read_text()))
    assert np.load(port_dir / "confusion_matrix.npy").sum() == 12
    assert _csv_shape(port_dir / "csv_logs/version_0/metrics.csv") == _csv_shape(
        jax_dir / "csv_logs/version_0/metrics.csv")
    assert np.isfinite(list(port_results.values())).all()

    # the JAX run's best.ckpt, converted, served by both CLIs on the
    # synthetic test split
    converted = tmp_path / "best.pt"
    _converter()([str(jax_dir / "best.ckpt"), str(converted)])
    with jax.default_matmul_precision("highest"):
        jm = jax_predict(["--checkpoint", str(jax_dir / "best.ckpt"),
                          "--out", str(tmp_path / "jp"), *SYNTH])
    pm = port_predict(["--checkpoint", str(converted), "--out", str(tmp_path / "pp"),
                       *SYNTH])
    logits = np.load(tmp_path / "pp" / "logits.npy")
    assert logits.shape == (12, 5)
    np.testing.assert_allclose(logits, np.load(tmp_path / "jp" / "logits.npy"),
                               rtol=1e-4, atol=1e-4)
    for f in ("predictions.npy", "labels.npy"):
        np.testing.assert_array_equal(np.load(tmp_path / "pp" / f),
                                      np.load(tmp_path / "jp" / f))
    assert pm["accuracy"] == pytest.approx(jm["accuracy"], abs=1e-6)
    # and the port's own best.ckpt serves the same split
    port_predict(["--checkpoint", str(port_dir / "best.ckpt"),
                  "--out", str(tmp_path / "own"), *SYNTH])
    np.testing.assert_array_equal(np.load(tmp_path / "own" / "labels.npy"),
                                  np.load(tmp_path / "jp" / "labels.npy"))


def test_profile_dir_writes_one_trace_of_one_epoch(tmp_path):
    prof = tmp_path / "prof"
    trainer = _port_fit(tmp_path, "training.max_epochs=3", f"runtime.profile_dir={prof}",
                        device_resident=False)
    assert len(trainer.history) == 3
    assert [p.name for p in prof.iterdir()] == ["trace_epoch1.json"]
    events = json.loads((prof / "trace_epoch1.json").read_text())["traceEvents"]
    steps = [e for e in events if str(e.get("name", "")).startswith("Optimizer.step#")]
    assert len(steps) == 3  # the 3 steps of epoch 1, no validation, no other epoch


def test_weights_path_is_still_refused_naming_item_8(tmp_path):
    with pytest.raises(NotImplementedError, match="item 8"):
        port_train.main(_overrides(tmp_path, "model.encoders.sensor1.weights_path=w.pth"))
