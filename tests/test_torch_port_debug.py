"""PyTorch port, the debug harness (``tools/debug.py``) and the curve
plotter (``tools/plot_curves.py``) on synthetic data
(``runtime.platform=cpu``, where every kernel wrapper runs its plain
version): the label distribution, activation and gradient statistics
against the JAX ``tools.debug`` on the same initial weights (1e-4
relative), the overfit probe passing with the encoders frozen (they take no
gradient and do not move), the CLI end to end, and ``plot_curves`` on a
port ``metrics.csv``."""

import jax
import numpy as np
import pytest
import torch

from multimodal_emotion_detection_tpu.config import load_config as jax_load_config
from multimodal_emotion_detection_tpu.data.loader import (
    create_dataloaders as jax_create_dataloaders,
)
from multimodal_emotion_detection_tpu.models.classifier import (
    classifier_from_config as jax_classifier_from_config,
)
from multimodal_emotion_detection_tpu.tools import debug as jax_debug
from multimodal_emotion_detection_tpu_torch import train as port_train
from multimodal_emotion_detection_tpu_torch.config import load_config
from multimodal_emotion_detection_tpu_torch.data.loader import (
    SYNTHETIC_KEYS,
    create_dataloaders,
)
from multimodal_emotion_detection_tpu_torch.models.classifier import (
    classifier_from_config,
)
from multimodal_emotion_detection_tpu_torch.tools import debug as port_debug
from multimodal_emotion_detection_tpu_torch.tools.plot_curves import plot_curves
from multimodal_emotion_detection_tpu_torch.utils.weights import (
    state_dict_from_jax_params,
)

LSTM = ("{type: sequence, encoder_type: lstm, input_dim: 8, hidden_dim: 16, "
        "num_layers: 2, dropout: 0.0}")
MLP = "{type: mlp, input_dim: 8, hidden_dim: 16, num_layers: 1, dropout: 0.0}"
SYNTH = [
    "runtime.platform=cpu",
    "runtime.lstm_kernels=off",
    "dataset.name=synthetic",
    "dataset.modalities=[sensor1,sensor2]",
    "dataset.num_samples=40",
    "dataset.num_samples_eval=60",
    "dataset.num_classes=5",
    "dataset.batch_size=16",
    "dataset.sequence_length=12",
    "dataset.modality_dim=8",
    f"model.encoders={{sensor1: {LSTM}, sensor2: {MLP}}}",
    "model.output_dim=16",
    "model.hidden_dim=64",
    "model.dropout=0.0",
    "training.max_epochs=2",
]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the suite runs several test workers on the same cores; at these tiny
    # shapes a multi-threaded torch only spins idle threads that slow them all
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _loaders(cfg, create):
    return create(cfg.dataset.name, cfg.dataset.data_dir, cfg.dataset.modalities,
                  batch_size=cfg.dataset.batch_size, seed=cfg.seed,
                  **{k: getattr(cfg.dataset, k) for k in SYNTHETIC_KEYS})


@pytest.fixture(scope="module")
def both():
    """The JAX and port configs and loaders, and the port model holding the
    tree the JAX probes initialise (``model.init`` from ``seed`` on the
    first batch)."""
    jcfg, cfg = jax_load_config(None, SYNTH), load_config(None, SYNTH)
    jloaders, loaders = _loaders(jcfg, jax_create_dataloaders), _loaders(cfg, create_dataloaders)
    feats, _ = jloaders[0].device_arrays()
    batch = {m: a[:16] for m, a in feats.items()}
    variables = jax.jit(jax_classifier_from_config(jcfg).init)(
        jax.random.PRNGKey(jcfg.seed), batch)
    params, stats = (jax.tree_util.tree_map(np.asarray, variables[k])
                     for k in ("params", "batch_stats"))

    def model():
        m = classifier_from_config(cfg)
        m.load_state_dict(state_dict_from_jax_params(params, stats))
        return m

    return jcfg, cfg, jloaders, loaders, model


def test_label_distribution_matches_jax(both):
    _, _, jloaders, loaders, _ = both
    names = ("train", "val", "test")
    assert (port_debug.inspect_label_distribution(dict(zip(names, loaders)))
            == jax_debug.inspect_label_distribution(dict(zip(names, jloaders))))


def test_activation_stats_match_jax(both):
    jcfg, cfg, jloaders, loaders, model = both
    with jax.default_matmul_precision("highest"):
        want = jax_debug.activation_stats(jcfg, jloaders[0])
    got = port_debug.activation_stats(cfg, loaders[0], model=model())
    assert list(got) == list(want) == ["sensor1", "sensor2", "logits"]
    for name, stats in want.items():
        for key, value in stats.items():
            assert got[name][key] == pytest.approx(value, rel=1e-4, abs=1e-7), (name, key)


def test_gradient_stats_match_jax(both):
    jcfg, cfg, jloaders, loaders, model = both
    with jax.default_matmul_precision("highest"):
        want = jax_debug.gradient_stats(jcfg, jloaders[0])
    got = port_debug.gradient_stats(cfg, loaders[0], model=model())
    assert sorted(got) == sorted(want)
    for name, norm in want.items():
        assert norm > 0 and got[name] == pytest.approx(norm, rel=1e-4), name


def test_overfit_one_batch_passes_with_the_encoders_frozen(both, capsys):
    _, cfg, _, loaders, model = both
    m = model()
    # parameters only: the step's training-mode forward moves BatchNorm's
    # running statistics in the frozen encoders too, as JAX's does
    before = {k: v.detach().clone() for k, v in m.named_parameters()}
    assert port_debug.overfit_one_batch(cfg, loaders[0], model=m)
    assert "[overfit] PASS at step" in capsys.readouterr().out
    after = dict(m.named_parameters())
    for k, v in before.items():
        moved = not torch.equal(v, after[k])
        assert moved == (not k.startswith(("sensor1_encoder", "sensor2_encoder"))), k


def test_debug_cli_end_to_end(capsys):
    assert port_debug.main(SYNTH) is True
    out = capsys.readouterr().out
    for tag in ("[labels] train: n=40", "[overfit] PASS", "[activations] logits",
                "[grads] head_out", "overfit_one_batch PASS"):
        assert tag in out, tag


def test_plot_curves_from_a_port_metrics_csv(tmp_path):
    port_train.main(SYNTH + [f"experiment.save_dir={tmp_path}", "experiment.name=run"])
    csv_path = tmp_path / "run" / "csv_logs" / "version_0" / "metrics.csv"
    out = plot_curves(str(csv_path))
    png = csv_path.with_name("curves.png")
    assert out == str(png)
    assert png.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    other = tmp_path / "c.png"
    assert plot_curves(str(csv_path), str(other)) == str(other) and other.exists()
