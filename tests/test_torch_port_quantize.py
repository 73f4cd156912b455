"""PyTorch port, weight-only int8 serving quantization against the JAX
package: the JAX-layout tree a port ``state_dict`` maps to
(``utils/weights.py::jax_params_from_state_dict``), its int8 codes,
scales and byte stats bit for bit JAX ``quantize_tree``'s, the three
``quantize_params_for_eval`` modes JAX's values, the artifact format, the
quantize CLI and predict's ``--quantize-weights`` / ``--quantized-artifact``
against JAX predict's logits (1e-4 of the largest) after JAX ``train.run``
and JAX ``tools.quantize``, through ``scripts/jax_ckpt_to_torch.py``."""

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
from multimodal_emotion_detection_tpu.tools.quantize import main as jax_quantize
from multimodal_emotion_detection_tpu.train import run as jax_train_run
from multimodal_emotion_detection_tpu.utils import quantize as jq
from multimodal_emotion_detection_tpu_torch.config import load_config
from multimodal_emotion_detection_tpu_torch.models.classifier import (
    classifier_from_config,
)
from multimodal_emotion_detection_tpu_torch.tools.predict import main as port_predict
from multimodal_emotion_detection_tpu_torch.tools.quantize import main as port_quantize
from multimodal_emotion_detection_tpu_torch.utils import quantize as pq
from multimodal_emotion_detection_tpu_torch.utils.weights import (
    attention_heads,
    jax_params_from_state_dict,
    state_dict_from_jax_params,
)

ROOT = Path(__file__).resolve().parents[1]
NARROW = ["model.encoders.audio.hidden_dim=32", "model.encoders.video.input_dim=16",
          "model.encoders.video.hidden_dim=32", "model.output_dim=16",
          "model.hidden_dim=32"]
# the flagship, the GRU and transformer encoders, library hybrid fusion and
# the audio CNN with BatchNorm, each narrow
CONFIGS = {
    "flagship": ("base.yaml", ["model.frontend.audio=logmel"]),
    "gru": ("base.yaml", ["model.frontend.audio=logmel",
                          "model.encoders.audio.encoder_type=gru"]),
    "transformer": ("base.yaml", ["model.frontend.audio=logmel",
                                  "model.encoders.audio.encoder_type=transformer",
                                  "model.encoders.audio.hidden_dim=64"]),
    "av_hybrid": ("av_hybrid.yaml", []),
    "audio_only": ("audio_only.yaml", []),
}
SAMPLES, FRAMES = 40 * 128, 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the suite runs several test workers on the same cores; at these tiny
    # shapes a multi-threaded torch only spins idle threads that slow them all
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


_TREES = {}


def _jax_variables(name):
    """JAX-initialised variables of ``name``'s narrow classifier (its
    running statistics moved off 0 / 1 by one training-mode forward)."""
    if name not in _TREES:
        config, extra = CONFIGS[name]
        overrides = NARROW + extra
        jmodel = jax_classifier_from_config(
            jax_load_config(str(ROOT / "configs" / config), overrides))
        rng = np.random.RandomState(0)
        feats = {"audio": jnp.asarray(rng.randn(2, SAMPLES, 1), jnp.float32),
                 "video": jnp.asarray(rng.rand(2, FRAMES, 16), jnp.float32)}
        modalities = jax_load_config(str(ROOT / "configs" / config), overrides).dataset.modalities
        feats = {m: feats[m] for m in modalities}
        mask = jnp.ones((2, len(modalities)), jnp.float32)
        variables = jmodel.init(jax.random.PRNGKey(3), feats, mask)
        if "batch_stats" in variables:
            _, state = jmodel.apply(variables, feats, mask, deterministic=False,
                                    rngs={"dropout": jax.random.PRNGKey(1)},
                                    mutable=["batch_stats"])
            variables = {**variables, **state}
        port = classifier_from_config(load_config(str(ROOT / "configs" / config), overrides))
        _TREES[name] = (_np_tree(variables["params"]),
                        _np_tree(variables.get("batch_stats")) or None, port)
    return _TREES[name]


def _leaves(tree, prefix=""):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict) and not set(v) <= {"q", "scale", "::int8::"}:
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield prefix + k, v


@pytest.mark.parametrize("name", list(CONFIGS))
def test_jax_layout_is_the_inverse_of_the_state_dict_map(name):
    params, stats, model = _jax_variables(name)
    model.load_state_dict(state_dict_from_jax_params(params, stats))  # strict
    back = jax_params_from_state_dict(model.state_dict(), attention_heads(model))
    want, got = dict(_leaves(params)), dict(_leaves(back))
    assert got.keys() == want.keys()  # parameters only: no running statistics
    for path, arr in want.items():
        assert got[path].shape == arr.shape, path
        np.testing.assert_array_equal(got[path], arr, err_msg=path)
    if name == "transformer":
        assert attention_heads(model) == {"audio_encoder.block_0.self_attn": 4,
                                          "audio_encoder.block_1.self_attn": 4}
        with pytest.raises(ValueError, match="head count"):
            jax_params_from_state_dict(model.state_dict())


@pytest.mark.parametrize("min_size", [1024, 64])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_codes_scales_stats_and_modes_match_jax(name, min_size):
    params, stats, model = _jax_variables(name)
    model.load_state_dict(state_dict_from_jax_params(params, stats))
    tree = pq.model_params(model)
    jtree, jstats = jq.quantize_tree(params, min_size=min_size)
    ptree, pstats = pq.quantize_tree(tree, min_size=min_size)
    assert pstats == jstats
    want, got = dict(_leaves(jtree)), dict(_leaves(ptree))
    assert got.keys() == want.keys()
    quantized = 0
    for path, j in want.items():
        if isinstance(j, dict):
            quantized += 1
            for part in ("q", "scale"):
                assert got[path][part].dtype == np.asarray(j["::int8::"][part]).dtype
                np.testing.assert_array_equal(got[path][part], j["::int8::"][part],
                                              err_msg=f"{path} {part}")
        else:
            np.testing.assert_array_equal(got[path], j, err_msg=path)
    assert quantized > 0
    for mode in ("int8", "int8-bf16", "bfloat16"):
        jmode = dict(_leaves(jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float32),
            jq.quantize_params_for_eval(params, mode, min_size=min_size))))
        pmode = dict(_leaves(pq.quantize_params_for_eval(tree, mode, min_size=min_size)))
        for path, j in jmode.items():
            np.testing.assert_array_equal(pmode[path], j, err_msg=f"{mode} {path}")
        # mapped back into the model: its buffers stay as they were
        buffers = {k: v.clone() for k, v in model.state_dict().items() if "running" in k}
        pq.load_params(model, pq.quantize_params_for_eval(tree, mode, min_size=min_size))
        for k, v in buffers.items():
            torch.testing.assert_close(model.state_dict()[k], v, rtol=0, atol=0)
        model.load_state_dict(state_dict_from_jax_params(params, stats))


def test_artifact_round_trip_and_format_check(tmp_path):
    params, stats, model = _jax_variables("transformer")
    model.load_state_dict(state_dict_from_jax_params(params, stats))
    tree = pq.model_params(model)
    path = tmp_path / "model_int8.pt"
    out = pq.save_quantized(path, tree, meta={"epoch": 3}, min_size=64)
    assert out["bytes_file"] == path.stat().st_size
    loaded, meta = pq.load_quantized(path)
    assert meta == {"epoch": 3}
    want = dict(_leaves(pq.quantize_params_for_eval(tree, "int8", min_size=64)))
    for p, v in _leaves(loaded):
        np.testing.assert_array_equal(v, want[p], err_msg=p)
    torch.save({"format": "something-else", "quantized": {}}, tmp_path / "bad.pt")
    with pytest.raises(ValueError, match="not an int8 serving artifact"):
        pq.load_quantized(tmp_path / "bad.pt")


# ------------------------------------------------------------- the CLIs

TINY = [
    "dataset.name=synthetic", "dataset.modalities=[s1,s2]", "dataset.num_samples=48",
    "dataset.num_samples_eval=40", "dataset.num_classes=4", "dataset.batch_size=16",
    "dataset.sequence_length=6", "dataset.modality_dim=8",
    ("model.encoders={s1: {type: mlp, input_dim: 8, hidden_dim: 16, num_layers: 1, "
     "batch_norm: true}, s2: {type: mlp, input_dim: 8, hidden_dim: 16, num_layers: 1, "
     "batch_norm: false}}"),
    "model.output_dim=8", "model.hidden_dim=16", "training.max_epochs=1",
    "training.learning_rate=1e-2", "runtime.platform=cpu",
]
MODES = {
    "f32": [],
    "int8": ["--quantize-weights", "int8", "--quantize-min-size", "64"],
    "int8-bf16": ["--quantize-weights", "int8-bf16", "--quantize-min-size", "64"],
    "bfloat16": ["--quantize-weights", "bfloat16"],
}


def _converter():
    spec = importlib.util.spec_from_file_location(
        "jax_ckpt_to_torch", ROOT / "scripts" / "jax_ckpt_to_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.main


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """JAX train.run (a BatchNorm encoder among them) -> JAX tools.quantize
    -> the checkpoint and the artifact converted -> JAX and port predict in
    every mode, and the port's own artifact."""
    tmp = tmp_path_factory.mktemp("port_quantize")
    cfg = jax_load_config(None, TINY + [f"experiment.save_dir={tmp / 'out'}",
                                        "experiment.name=q"])
    jax_train_run(cfg)
    ckpt = tmp / "out" / "q" / "best.ckpt"
    jstats = jax_quantize(["--checkpoint", str(ckpt), "--out", str(tmp / "q.msgpack"),
                           "--min-size", "64", *TINY])
    convert = _converter()
    convert([str(ckpt), str(tmp / "q.pt")])
    convert(["--artifact", str(tmp / "q.msgpack"), str(tmp / "q_converted.pt")])
    pstats = port_quantize(["--checkpoint", str(tmp / "q.pt"),
                            "--out", str(tmp / "q_port.pt"), "--min-size", "64", *TINY])
    runs = {}
    for name, flags in {**MODES, "artifact": None}.items():
        jflags = flags if flags is not None else ["--quantized-artifact",
                                                  str(tmp / "q.msgpack")]
        pflags = flags if flags is not None else ["--quantized-artifact",
                                                  str(tmp / "q_converted.pt")]
        runs[name] = (
            jax_predict(["--checkpoint", str(ckpt), *jflags, "--out",
                         str(tmp / f"jax_{name}"), *TINY]),
            port_predict(["--checkpoint", str(tmp / "q.pt"), *pflags, "--out",
                          str(tmp / f"port_{name}"), *TINY]))
    runs["own_artifact"] = (None, port_predict([
        "--checkpoint", str(tmp / "q.pt"), "--quantized-artifact", str(tmp / "q_port.pt"),
        "--out", str(tmp / "port_own_artifact"), *TINY]))
    return tmp, jstats, pstats, runs


@pytest.mark.parametrize("name", [*MODES, "artifact"])
def test_quantized_predict_matches_jax_predict(served, name):
    tmp, _, _, runs = served
    want = np.load(tmp / f"jax_{name}" / "logits.npy")
    got = np.load(tmp / f"port_{name}" / "logits.npy")
    assert got.shape == want.shape and want.shape[1] == 4
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())
    jm, pm = runs[name]
    assert pm["quantize_weights"] == jm["quantize_weights"]
    assert json.loads((tmp / f"port_{name}" / "metrics.json").read_text()) == pm
    for key in ("ece", "nll", "accuracy"):
        assert pm[key] == pytest.approx(jm[key], abs=1e-5)


def test_quantize_cli_stats_and_own_artifact_equal_in_memory_int8(served):
    tmp, jstats, pstats, runs = served
    assert {k: pstats[k] for k in ("bytes_f32", "bytes_quantized", "compression")} == \
        {k: jstats[k] for k in ("bytes_f32", "bytes_quantized", "compression")}
    assert pstats["bytes_file"] == (tmp / "q_port.pt").stat().st_size
    assert pstats["compression"] > 1.5
    # the port's own artifact, JAX's converted one and the in-memory int8
    # round trip dequantize the same codes: the same logits, bit for bit
    own = np.load(tmp / "port_own_artifact" / "logits.npy")
    np.testing.assert_array_equal(own, np.load(tmp / "port_artifact" / "logits.npy"))
    np.testing.assert_array_equal(own, np.load(tmp / "port_int8" / "logits.npy"))
    assert runs["own_artifact"][1]["quantize_weights"] == "int8-artifact"
    # the converted artifact holds JAX's codes bit for bit
    jcodes, _ = pq.read_artifact(tmp / "q_converted.pt")
    pcodes, _ = pq.read_artifact(tmp / "q_port.pt")
    for (p1, a), (p2, b) in zip(_leaves(jcodes), _leaves(pcodes)):
        assert p1 == p2
        for x, y in ([(a["q"], b["q"]), (a["scale"], b["scale"])]
                     if isinstance(a, dict) else [(a, b)]):
            np.testing.assert_array_equal(x, y, err_msg=p1)


def test_quantize_cli_raises_without_a_card_or_cpu_override(served, monkeypatch):
    tmp = served[0]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="runtime.platform=cpu"):
        port_quantize(["--checkpoint", str(tmp / "q.pt"), "--out", str(tmp / "never.pt"),
                       *TINY[:-1]])
    assert not (tmp / "never.pt").exists()
