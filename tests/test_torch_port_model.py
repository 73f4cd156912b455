"""PyTorch port, whole concat classifier: logits against the JAX package
at a narrow width, with the JAX weights carried across by
``state_dict_from_jax_params``.  Both JAX routes are held: the XLA scan +
XLA frontend, and the Pallas kernels (interpret mode) for the frontend and
the LSTM.  Tolerance 1e-4: the interpret-mode envelope of
``ops/envelope.py`` (flax's LayerNorm variance differs from torch's in the
last bits)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_emotion_detection_tpu.config import load_config as jax_load_config
from multimodal_emotion_detection_tpu.models.classifier import (
    classifier_from_config as jax_classifier_from_config,
)
from multimodal_emotion_detection_tpu_torch.config import load_config
from multimodal_emotion_detection_tpu_torch.models.classifier import (
    classifier_from_config,
    init_weights,
)
from multimodal_emotion_detection_tpu_torch.training.steps import forward
from multimodal_emotion_detection_tpu_torch.utils.weights import (
    state_dict_from_jax_params,
)

NARROW = [
    "model.frontend.audio=logmel",
    "model.encoders.audio.hidden_dim=128",
    "model.encoders.video.input_dim=16",
    "model.encoders.video.hidden_dim=32",
    "model.output_dim=16",
    "model.hidden_dim=32",
]
B, SAMPLES, FRAMES, FRAME_DIM = 8, 40 * 128, 4, 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the suite runs several test workers on the same cores; at these tiny
    # shapes a multi-threaded torch only spins idle threads that slow them all
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    return {
        "audio": rng.randn(B, SAMPLES, 1).astype(np.float32),
        "video": rng.rand(B, FRAMES, FRAME_DIM).astype(np.float32),
    }


@pytest.mark.parametrize("jax_kernels", [False, True],
                         ids=["jax_scan", "jax_pallas_interpret"])
def test_classifier_logits_match_jax(jax_kernels):
    overrides = NARROW + [
        f"model.encoders.audio.inference_kernel={str(jax_kernels).lower()}"]
    jcfg = jax_load_config("configs/base.yaml", overrides)
    jmodel = jax_classifier_from_config(jcfg)
    if jax_kernels:
        jmodel = jmodel.clone(frontend_interpret=True)
    feats = _inputs()
    jfeats = {k: jnp.asarray(v) for k, v in feats.items()}
    mask = jnp.ones((B, 2), jnp.float32)
    with jax.default_matmul_precision("highest"):
        variables = jmodel.init(jax.random.PRNGKey(3), jfeats, mask)
        ref = np.asarray(jmodel.apply(variables, jfeats, mask,
                                      deterministic=True))

    model = classifier_from_config(load_config("configs/base.yaml", overrides))
    model.load_state_dict(state_dict_from_jax_params(
        jax.tree_util.tree_map(np.asarray, variables["params"])))
    torch.backends.cuda.matmul.allow_tf32 = False
    logits = forward(model, {k: torch.from_numpy(v) for k, v in feats.items()})
    assert logits.shape == (B, 8)
    np.testing.assert_allclose(logits.numpy(), ref, rtol=1e-4, atol=1e-4)


# the image encoder (type: pretrained_cnn) is ported since: its cases keep
# their ids, build, and serve rank-5 frames, or refuse as the JAX package
# does (the resize frontend hands the encoder rank-3 frames)
RANK = "Expected rank-4/5 frames"


@pytest.mark.parametrize("override,item", [
    # a GRU wider than every GRU kernel takes; the id is the one this case
    # had while every GRU was refused
    pytest.param(["model.encoders.audio.encoder_type=gru",
                  "model.encoders.audio.hidden_dim=1064"], "shape ceilings",
                 id="model.encoders.audio.encoder_type=gru-item 6"),
    # the image encoder on rank-5 frames; the id is the one this case had
    # while the transformer was refused
    pytest.param(["model.encoders.video.type=pretrained_cnn"], None,
                 id="model.encoders.audio.encoder_type=transformer-item 8"),
    # the on-device video resize beside the image encoder: rank-3 frames
    # reach it, which JAX refuses too; the id is the one-layer LSTM's
    pytest.param(["model.frontend.video=resize",
                  "model.encoders.video.type=pretrained_cnn"], RANK,
                 id="model.encoders.audio.num_layers=1-item 3"),
    # the image encoder beside a bf16 audio encoder; the id is the one this
    # case had while the fusion library was refused
    pytest.param(["model.encoders.audio.dtype=bfloat16",
                  "model.encoders.video.type=pretrained_cnn"], None,
                 id="model.train_fusion=library-item 7"),
    # the bf16 compute dtype and the video resize beside the image encoder:
    # refused as the JAX package refuses it
    pytest.param(["runtime.compute_dtype=bfloat16", "model.frontend.video=resize",
                  "model.encoders.video.type=pretrained_cnn"],
                 RANK, id="runtime.compute_dtype=bfloat16-item 13"),
])
def test_configs_outside_the_slice_raise(override, item):
    extra = override if isinstance(override, list) else [override]
    cfg = load_config("configs/base.yaml", NARROW + extra)
    if item == "shape ceilings":
        with pytest.raises(NotImplementedError, match=item):
            classifier_from_config(cfg)
        return
    model = init_weights(classifier_from_config(cfg), torch.Generator().manual_seed(0))
    frames = np.random.RandomState(1).rand(2, 2, 16, 16, 3).astype(np.float32)
    feats = {"audio": torch.from_numpy(_inputs()["audio"][:2]),
             "video": torch.from_numpy(frames)}
    if item is None:
        logits = forward(model, feats)
        assert logits.shape == (2, 8) and torch.isfinite(logits).all()
    else:
        with pytest.raises(ValueError, match=item):
            forward(model, feats)
