"""PyTorch port, the streaming monitor (``tools/stream.py``) and the
microbatched serving forward (``runtime.platform=cpu``, where every kernel
wrapper runs its plain version): the windowing and smoothing against the
JAX package's, ``make_batched_forward_fn`` bit for bit the per-microbatch
``forward`` and against JAX's on the converted tree, the CLI end to end on
a narrow log-mel flagship against JAX ``tools.stream.main`` on the same
weights, and the CLI's argument errors."""

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
from multimodal_emotion_detection_tpu.tools import stream as jax_stream
from multimodal_emotion_detection_tpu.training.checkpoints import save_checkpoint
from multimodal_emotion_detection_tpu.training.optim import build_optimizer
from multimodal_emotion_detection_tpu.training.steps import (
    create_train_state,
    make_batched_forward_fn as jax_batched_forward,
)
from multimodal_emotion_detection_tpu_torch.config import load_config
from multimodal_emotion_detection_tpu_torch.models.classifier import (
    classifier_from_config,
)
from multimodal_emotion_detection_tpu_torch.tools import stream as port_stream
from multimodal_emotion_detection_tpu_torch.training.steps import (
    forward,
    make_batched_forward_fn,
)
from multimodal_emotion_detection_tpu_torch.utils.weights import (
    state_dict_from_jax_params,
)

ROOT = Path(__file__).resolve().parents[1]
CONFIG = str(ROOT / "configs" / "base.yaml")
# the flagship (log-mel -> LSTM -> frame encoder -> concat head), narrow
NARROW = [
    "model.frontend.audio=logmel",
    "model.encoders.audio.hidden_dim=32",
    "model.encoders.video.input_dim=16",
    "model.encoders.video.hidden_dim=32",
    "model.output_dim=16",
    "model.hidden_dim=32",
]
CLIP = 40 * 128  # audio samples a window: 37 log-mel frames
FRAMES = 4       # video frames a window


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the suite runs several test workers on the same cores; at these tiny
    # shapes a multi-threaded torch only spins idle threads that slow them all
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("t_total,window,hop,tail", [
    (10, 4, 2, (3,)), (31, 5, 3, ()), (3, 6, 2, (2,)), (6, 6, 1, (1, 2)),
    (1, 4, 4, ()),
])
def test_sliding_windows_match_jax(t_total, window, hop, tail):
    arr = np.random.RandomState(t_total).randn(t_total, *tail).astype(np.float32)
    got = port_stream.sliding_windows(arr, window, hop)
    want = jax_stream.sliding_windows(arr, window, hop)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("alpha", [1.0, 0.6, 0.05])
def test_ema_smooth_matches_jax(alpha):
    probs = np.random.RandomState(3).dirichlet(np.ones(5), size=17).astype(np.float32)
    np.testing.assert_array_equal(port_stream.ema_smooth(probs, alpha),
                                  jax_stream.ema_smooth(probs, alpha))


@pytest.fixture(scope="module")
def flagship(tmp_path_factory):
    """A seeded narrow flagship: the JAX model and params, its checkpoint
    in both formats, and the port's model with the converted tree."""
    tmp = tmp_path_factory.mktemp("port_stream")
    cfg = jax_load_config(CONFIG, NARROW)
    model = jax_classifier_from_config(cfg)
    tx, _ = build_optimizer(cfg.training, steps_per_epoch=2)
    rng = np.random.RandomState(9)
    sample = {"audio": jnp.asarray(rng.randn(4, CLIP, 1), jnp.float32),
              "video": jnp.asarray(rng.rand(4, FRAMES, 16), jnp.float32)}
    state = create_train_state(model, tx, sample, jnp.ones((4, 2)),
                               jax.random.PRNGKey(5))
    jax_ckpt = tmp / "best.ckpt"
    save_checkpoint(jax_ckpt, state, {"epoch": 1, "step": 2})
    spec = importlib.util.spec_from_file_location(
        "jax_ckpt_to_torch", ROOT / "scripts" / "jax_ckpt_to_torch.py")
    conv = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(conv)
    port_ckpt = tmp / "best.pt"
    conv.main([str(jax_ckpt), str(port_ckpt)])
    port_model = classifier_from_config(load_config(CONFIG, NARROW))
    params = jax.tree_util.tree_map(np.asarray, state.params)
    port_model.load_state_dict(state_dict_from_jax_params(params))
    return tmp, model, state, jax_ckpt, port_ckpt, port_model.eval()


def _stacked(s, b, seed):
    rng = np.random.RandomState(seed)
    return {"audio": rng.randn(s, b, CLIP, 1).astype(np.float32),
            "video": rng.rand(s, b, FRAMES, 16).astype(np.float32)}


def test_batched_forward_equals_forward_and_jax(flagship):
    _, jmodel, state, _, _, model = flagship
    feats = _stacked(3, 4, 1)
    tfeats = {k: torch.from_numpy(v) for k, v in feats.items()}
    got = make_batched_forward_fn(model)(tfeats)
    assert got.shape == (3, 4, 8)
    for i in range(3):
        assert torch.equal(got[i], forward(model, {k: v[i] for k, v in tfeats.items()}))
    # a mask: one modality dropped on some rows
    mask = torch.ones(3, 4, 2)
    mask[1, :2, 1] = 0.0
    masked = make_batched_forward_fn(model)(tfeats, mask)
    for i in range(3):
        assert torch.equal(masked[i],
                           forward(model, {k: v[i] for k, v in tfeats.items()}, mask[i]))
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax_batched_forward(jmodel, 2)(
            state.params, state.model_state, {k: jnp.asarray(v) for k, v in feats.items()}))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


def _streams(tmp, windows=11):
    rng = np.random.RandomState(4)
    audio = rng.randn(CLIP + (windows - 1) * 1280, 1).astype(np.float32)
    video = rng.rand(FRAMES + windows - 1, 16).astype(np.float32)
    np.save(tmp / "audio.npy", audio)
    np.save(tmp / "video.npy", video)
    return ["--input", f"audio={tmp / 'audio.npy'}", "--input", f"video={tmp / 'video.npy'}",
            "--window", f"audio={CLIP}", "--window", f"video={FRAMES}",
            "--hop", "audio=1280", "--hop", "video=1"]


@pytest.mark.parametrize("smooth,microbatch", [(1.0, 4), (0.5, 32)])
def test_stream_main_matches_jax(flagship, smooth, microbatch):
    tmp, _, _, jax_ckpt, port_ckpt, _ = flagship
    args = _streams(tmp) + ["--config", CONFIG, "--smooth", str(smooth),
                            "--microbatch", str(microbatch)]
    out = {}
    for name, main, ckpt in (("jax", jax_stream.main, jax_ckpt),
                             ("port", port_stream.main, port_ckpt)):
        out[name] = tmp / f"{name}_{smooth}_{microbatch}"
        extra = ["runtime.platform=cpu"] if name == "port" else []
        with jax.default_matmul_precision("highest"):
            main(["--checkpoint", str(ckpt), "--out", str(out[name]), *args,
                  *NARROW, *extra])
    jdir, pdir = out["jax"], out["port"]
    probs = np.load(pdir / "probs.npy")
    assert probs.shape == (11, 8)
    np.testing.assert_allclose(probs, np.load(jdir / "probs.npy"), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(np.load(pdir / "predictions.npy"),
                                  np.load(jdir / "predictions.npy"))
    assert (json.loads((pdir / "summary.json").read_text())
            == json.loads((jdir / "summary.json").read_text()))
    p_lines = (pdir / "timeline.csv").read_text().splitlines()
    j_lines = (jdir / "timeline.csv").read_text().splitlines()
    assert p_lines[0] == j_lines[0] and len(p_lines) == len(j_lines) == 12
    # window, the spans of both modalities and the label agree exactly
    assert [r.split(",")[:6] for r in p_lines[1:]] == [r.split(",")[:6] for r in j_lines[1:]]


@pytest.mark.parametrize("case", [
    ["--input", "audio"],                                   # no name=value
    ["--input", "audio=a.npy", "--input", "audio=b.npy"],   # duplicate key
    ["--input", "audio=a.npy"],                             # a modality missing
    ["--window", "depth=3"],                                # no such stream
    ["--hop", "video=0"],                                   # not positive
    ["--smooth", "0"],                                      # out of (0, 1]
    ["--smooth", "1.5"],
])
def test_argument_errors_match_jax(flagship, case):
    tmp, _, _, jax_ckpt, port_ckpt, _ = flagship
    np.save(tmp / "a.npy", np.zeros((CLIP, 1), np.float32))
    np.save(tmp / "b.npy", np.zeros((FRAMES, 16), np.float32))
    inputs = ([] if "--input" in case else
              ["--input", f"audio={tmp / 'a.npy'}", "--input", f"video={tmp / 'b.npy'}"])
    args = [*inputs, *[c.replace("a.npy", str(tmp / "a.npy")).replace(
        "b.npy", str(tmp / "b.npy")) for c in case], "--config", CONFIG,
        "--out", str(tmp / "never"), *NARROW]
    with pytest.raises(SystemExit) as want:
        jax_stream.main(["--checkpoint", str(jax_ckpt), *args])
    with pytest.raises(SystemExit) as got:
        port_stream.main(["--checkpoint", str(port_ckpt), *args, "runtime.platform=cpu"])
    assert str(got.value) == str(want.value) and str(got.value)
    assert not (tmp / "never").exists()
