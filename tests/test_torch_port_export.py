"""PyTorch port, the export CLI (``tools/export.py``) on the CPU against the
JAX package's: one JAX checkpoint a configuration, exported by JAX
``tools.export.main`` (StableHLO), converted by
``scripts/jax_ckpt_to_torch.py`` and exported by the port's
``tools.export.main`` (``torch.export``), both at batch 8 on the test
split's first 8 clips.  Six configurations, narrowed as the other port
files narrow them: the flagship (LSTM 2 x 128), the GRU pair, a 3-layer
LSTM and a 3-layer GRU (the layered route), the transformer and the
transformer under ``runtime.compute_dtype=bfloat16``.

* The loaded ``.pt2`` and the deserialized StableHLO agree on the sample
  within 1e-4 in float32, and within 4 bf16 ulps of the largest logit
  (2^-8 of it each) under bf16 compute, the rule of
  ``test_torch_port_compute_bf16.py``; the loaded program is the eager
  forward bit for bit.
* The graph holds one node per kernel launch (one ``logmel``, then one
  ``lstm2_infer`` / ``gru2_infer``, three ``lstm1_infer`` / ``gru1_infer``
  or two ``flash_fwd``) and no per-step recurrence.
* The flagship's file loads in a fresh interpreter that imports only
  ``multimodal_emotion_detection_tpu_torch.ops`` and gives the eager
  logits bit for bit; without that import loading raises.
* Without ``runtime.platform=cpu`` on a host with no card the CLI raises."""

import importlib.util
import os
import subprocess
import sys
import textwrap
from collections import Counter
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
from multimodal_emotion_detection_tpu.tools.export import main as jax_export
from multimodal_emotion_detection_tpu.training.checkpoints import save_checkpoint
from multimodal_emotion_detection_tpu.training.optim import build_optimizer
from multimodal_emotion_detection_tpu.training.steps import create_train_state
from multimodal_emotion_detection_tpu_torch.config import load_config
from multimodal_emotion_detection_tpu_torch.tools._restore import restore_model
from multimodal_emotion_detection_tpu_torch.tools.export import (
    Serve,
    load_exported,
)
from multimodal_emotion_detection_tpu_torch.tools.export import main as port_export

ROOT = Path(__file__).resolve().parents[1]
BASE = str(ROOT / "configs" / "base.yaml")
NARROW = [
    "model.frontend.audio=logmel",
    "model.encoders.audio.hidden_dim=128",
    "model.encoders.video.input_dim=16",
    "model.encoders.video.hidden_dim=32",
    "model.output_dim=16",
    "model.hidden_dim=32",
    "dataset.batch_size=8",
]
GRU = ["model.encoders.audio.encoder_type=gru"]
DEEP = ["model.encoders.audio.num_layers=3"]
TRANSFORMER = ["model.encoders.audio.encoder_type=transformer",
               "model.encoders.audio.hidden_dim=64"]
HALF = ["runtime.compute_dtype=bfloat16"]
# configuration -> (overrides, the kernel ops of one forward)
CONFIGS = {
    "flagship": (NARROW, {"logmel": 1, "lstm2_infer": 1}),
    "gru": (NARROW + GRU, {"logmel": 1, "gru2_infer": 1}),
    "lstm3": (NARROW + DEEP, {"logmel": 1, "lstm1_infer": 3}),
    "gru3": (NARROW + GRU + DEEP, {"logmel": 1, "gru1_infer": 3}),
    "transformer": (NARROW + TRANSFORMER, {"logmel": 1, "flash_fwd": 2}),
    "transformer_bf16": (NARROW + TRANSFORMER + HALF, {"logmel": 1, "flash_fwd": 2}),
}
ROWS, BATCH = 12, 8
ULP = 2.0 ** -8


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
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("export_data")
    # the JAX export loads every split, so all three are written
    for seed, split in enumerate(("train", "val", "test")):
        _write_split(root, split, seed)
    return root


_EXPORTED = {}


def _export(name, data, tmp_path_factory):
    """``name`` exported by both CLIs from one JAX checkpoint (once a
    worker) -> (name, its folder, overrides, port checkpoint, the sample)."""
    if name in _EXPORTED:
        return _EXPORTED[name]
    tmp = tmp_path_factory.mktemp(f"export_{name}")
    overrides = CONFIGS[name][0] + [f"dataset.data_dir={data}", "runtime.platform=cpu"]
    cfg = jax_load_config(BASE, overrides)
    tx, _ = build_optimizer(cfg.training, steps_per_epoch=2)
    rng = np.random.RandomState(9)
    sample = {"audio": jnp.asarray(rng.randn(BATCH, 40 * 128, 1), jnp.float32),
              "video": jnp.asarray(rng.rand(BATCH, 4, 16), jnp.float32)}
    state = create_train_state(jax_classifier_from_config(cfg), tx, sample,
                               jnp.ones((BATCH, 2)), jax.random.PRNGKey(5))
    jax_ckpt, port_ckpt = tmp / "best.ckpt", tmp / "best.pt"
    save_checkpoint(jax_ckpt, state, {"epoch": 1, "step": 2})
    _converter()([str(jax_ckpt), str(port_ckpt)])
    cli = ["--config", BASE, "--batch", str(BATCH), *overrides]
    jax_export(["--checkpoint", str(jax_ckpt), "--out", str(tmp / "model.stablehlo"),
                *cli])
    out = port_export(["--checkpoint", str(port_ckpt), "--out", str(tmp / "model.pt2"),
                       *cli])
    assert out == tmp / "model.pt2" and out.stat().st_size > 0
    test = data / "test"
    clips = {m: np.load(test / f"{m}.npy")[:BATCH] for m in ("audio", "video")}
    _EXPORTED[name] = name, tmp, overrides, port_ckpt, clips
    return _EXPORTED[name]


@pytest.fixture(scope="module", params=list(CONFIGS))
def exported(request, data, tmp_path_factory):
    return _export(request.param, data, tmp_path_factory)


@pytest.fixture(scope="module")
def flagship(data, tmp_path_factory):
    return _export("flagship", data, tmp_path_factory)


def _port_eager(overrides, ckpt, clips):
    cfg = load_config(BASE, overrides)
    cfg.model.frontend.cache = False
    model, _ = restore_model(cfg, ckpt, torch.device("cpu"))
    with torch.inference_mode():
        return Serve(model)({m: torch.from_numpy(a) for m, a in clips.items()})


def test_exported_program_matches_the_jax_export(exported):
    name, tmp, _, _, clips = exported
    restored = jax.export.deserialize((tmp / "model.stablehlo").read_bytes())
    ref = np.asarray(restored.call({m: jnp.asarray(a) for m, a in clips.items()}),
                     np.float32)
    with torch.inference_mode():
        got = load_exported(tmp / "model.pt2").module()(
            {m: torch.from_numpy(a) for m, a in clips.items()}).float().numpy()
    assert got.shape == ref.shape == (BATCH, 8) and np.isfinite(got).all()
    if name.endswith("bf16"):
        bound = 4 * ULP * float(np.abs(ref).max())
        assert float(np.abs(got - ref).max()) <= bound
    else:
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def test_exported_program_is_the_eager_forward_bit_for_bit(exported):
    _, tmp, overrides, port_ckpt, clips = exported
    eager = _port_eager(overrides, port_ckpt, clips)
    with torch.inference_mode():
        got = load_exported(tmp / "model.pt2").module()(
            {m: torch.from_numpy(a) for m, a in clips.items()})
    assert got.dtype == eager.dtype
    torch.testing.assert_close(got, eager, rtol=0, atol=0)


def test_graph_holds_one_node_per_kernel_launch(exported):
    name, tmp, _, _, _ = exported
    program = load_exported(tmp / "model.pt2")
    calls = Counter(str(n.target) for n in program.graph.nodes if n.op == "call_function")
    ops = {t.split(".")[1]: n for t, n in calls.items() if t.startswith("med_torch.")}
    assert ops == CONFIGS[name][1]
    # no per-step recurrence, no attention in aten ops: the plain versions'
    # sigmoid / tanh steps, softmax statistics and frames stay inside the ops
    plain = ("sigmoid", "tanh", "unfold", "logsumexp", "aten.exp.")
    assert not [t for t in calls if any(s in t for s in plain)]


FRESH = textwrap.dedent("""
    import sys
    import torch
    if sys.argv[1] == "ops":
        import multimodal_emotion_detection_tpu_torch.ops  # noqa: F401
    program = torch.export.load(sys.argv[2])
    clips = torch.load(sys.argv[3])
    with torch.inference_mode():
        torch.save(program.module()(clips), sys.argv[4])
    print(sorted(m for m in sys.modules if m.startswith("multimodal_emotion")))
""")


def test_flagship_file_serves_in_a_fresh_process_that_imports_only_the_ops(flagship):
    _, tmp, overrides, port_ckpt, clips = flagship
    features = {m: torch.from_numpy(a) for m, a in clips.items()}
    torch.save(features, tmp / "clips.pt")
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")

    def serve(mode):
        return subprocess.run(
            [sys.executable, "-c", FRESH, mode, str(tmp / "model.pt2"),
             str(tmp / "clips.pt"), str(tmp / f"logits_{mode}.pt")],
            capture_output=True, text=True, env=env, cwd=tmp, timeout=120)

    done = serve("ops")
    assert done.returncode == 0, done.stderr
    # the ops package and its modules, nothing of the models or tools
    loaded = eval(done.stdout.strip().splitlines()[-1])
    assert all(m.startswith("multimodal_emotion_detection_tpu_torch.ops")
               or m == "multimodal_emotion_detection_tpu_torch" for m in loaded), loaded
    torch.testing.assert_close(torch.load(tmp / "logits_ops.pt"),
                               _port_eager(overrides, port_ckpt, clips), rtol=0, atol=0)
    refused = serve("bare")
    assert refused.returncode != 0
    assert "med_torch" in refused.stderr


def test_export_without_cpu_override_raises_on_a_host_without_a_card(
        flagship, monkeypatch):
    _, tmp, overrides, port_ckpt, _ = flagship
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="runtime.platform=cpu"):
        port_export(["--checkpoint", str(port_ckpt), "--config", BASE,
                     "--out", str(tmp / "never.pt2"),
                     *[o for o in overrides if o != "runtime.platform=cpu"]])
    assert not (tmp / "never.pt2").exists()
