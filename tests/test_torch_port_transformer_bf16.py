"""PyTorch port, the transformer config with bf16 encoders
(``model.encoders.audio.dtype=bfloat16`` and
``model.encoders.video.dtype=bfloat16``: the JAX factory's per-encoder
dtype override) at a narrow width (hidden 64, 2 blocks, ~30 frames, dropout
0) on the CPU, where the flash wrappers run their bf16 plain versions,
against the JAX modules with ``use_flash=True, flash_interpret=True``:

* ``TransformerBlock``, the transformer ``SequenceEncoder`` (within
  ``max_len`` and blockwise) and ``FrameEncoder`` in bf16: outputs, and
  the float32 parameters' gradients;
* the classifier with both overrides: float32 logits, and a JAX tree built
  with bf16 encoders loading ``strict=True``;
* a 3-step train-step trajectory and a ``Trainer`` epoch against JAX's;
* bf16 settings beside the image encoder (serving rank-5 frames, or
  refusing rank-3 features as JAX does) and the refusal of a GRU wider
  than its kernels take: the bf16 compute dtype, ``dtype: bfloat16`` on
  the LSTM, GRU, CNN and MLP encoders and the video resize are ported
  since (``test_torch_port_compute_bf16.py``).

Tolerances.  Both sides round to bf16 at flax's points, but not always to
the same ulp: GELU, softmax and the bias-gradient reductions are fused
differently (JAX's jitted ``gelu`` lands an ulp off torch's on ~40% of
bf16 inputs; XLA reduces a bf16 bias cotangent in bf16).  So outputs are
held to a few bf16 ulps (one = 2^-8 of the largest entry), and gradients
by the structure of the card's bf16 step check: each side's bf16 gradient
against the float32 gradient of the same module, the port's within
max(2e-2, 2 x JAX's distance) of the largest gradient."""

from pathlib import Path

import jax
import jax.numpy as jnp
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
from multimodal_emotion_detection_tpu.models.encoders import (
    FrameEncoder as JaxFrameEncoder,
)
from multimodal_emotion_detection_tpu.models.encoders import (
    SequenceEncoder as JaxSequenceEncoder,
)
from multimodal_emotion_detection_tpu.models.encoders import (
    TransformerBlock as JaxTransformerBlock,
)
from multimodal_emotion_detection_tpu.training import optim as jax_optim
from multimodal_emotion_detection_tpu.training.loop import Trainer as JaxTrainer
from multimodal_emotion_detection_tpu.training.steps import (
    create_train_state,
    make_train_step,
)
from multimodal_emotion_detection_tpu_torch.config import load_config
from multimodal_emotion_detection_tpu_torch.data.loader import create_dataloaders
from multimodal_emotion_detection_tpu_torch.models.classifier import (
    classifier_from_config,
    init_weights,
)
from multimodal_emotion_detection_tpu_torch.models.encoders import (
    FrameEncoder,
    SequenceEncoder,
    TransformerBlock,
)
from multimodal_emotion_detection_tpu_torch.models.noise import Noise
from multimodal_emotion_detection_tpu_torch.ops import flash_attention as fa
from multimodal_emotion_detection_tpu_torch.training import optim
from multimodal_emotion_detection_tpu_torch.training.loop import Trainer
from multimodal_emotion_detection_tpu_torch.training.steps import forward, train_step
from multimodal_emotion_detection_tpu_torch.utils.weights import (
    state_dict_from_jax_params,
)

ROOT = Path(__file__).resolve().parents[1]
CONFIG = str(ROOT / "configs" / "base.yaml")
ULP = 2.0 ** -8  # one bf16 ulp, relative to the largest entry
# the transformer leg's encoder, narrowed as the float32 file narrows it
# (hidden 256 -> 64: 4 heads of 16), both encoders in bf16
TF_BF16 = [
    "model.frontend.audio=logmel",
    "model.encoders.audio.encoder_type=transformer",
    "model.encoders.audio.hidden_dim=64",
    "model.encoders.video.input_dim=16",
    "model.encoders.video.hidden_dim=32",
    "model.output_dim=16",
    "model.hidden_dim=32",
    "model.encoders.audio.dtype=bfloat16",
    "model.encoders.video.dtype=bfloat16",
]
NO_DROPOUT = [
    "model.encoders.audio.dropout=0.0",
    "model.encoders.video.dropout=0.0",
    "training.augmentation.modality_dropout=0.0",
]
B, SAMPLES, FRAMES, FRAME_DIM = 8, 30 * 128, 4, 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the suite runs several test workers on the same cores; at these tiny
    # shapes a multi-threaded torch only spins idle threads that slow them all
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _state(params):
    return state_dict_from_jax_params(jax.tree_util.tree_map(np.asarray, params))


def _within_ulps(got, want, ulps, what):
    err = float(np.abs(np.asarray(got, np.float32) - np.asarray(want, np.float32)).max())
    bound = ulps * ULP * float(np.abs(np.asarray(want, np.float32)).max())
    assert err <= bound, f"{what}: {err:.3e} > {bound:.3e}"


def _check_module(jmod16, jmod32, module, args, targs, out_ulps, what):
    """``module`` (the port, bf16) against ``jmod16`` (JAX, bf16) on the
    same parameters: the bf16 output to ``out_ulps``, and each side's
    float32 parameter gradient of sum(out * w) against ``jmod32``'s (JAX,
    float32)."""
    with jax.default_matmul_precision("highest"):
        variables = jmod16.init(jax.random.PRNGKey(1), *args)
        want = jmod16.apply(variables, *args)
        assert want.dtype == jnp.bfloat16
        w = np.random.RandomState(9).randn(*want.shape).astype(np.float32)

        def grads(mod):
            def loss(p):
                return jnp.sum(mod.apply({"params": p}, *args).astype(jnp.float32) * w)
            return _state(jax.grad(loss)(variables["params"]))

        g16, g32 = grads(jmod16), grads(jmod32)
    module.load_state_dict(_state(variables["params"]))  # strict: every key
    module.eval()
    got = module(*targs)
    assert got.dtype == torch.bfloat16
    _within_ulps(got.detach().float().numpy(), want.astype(jnp.float32), out_ulps, what)
    (got.float() * torch.from_numpy(w)).sum().backward()
    named = dict(module.named_parameters())
    assert all(p.grad.dtype == torch.float32 for p in named.values())
    g_max = max(float(g.abs().max()) for g in g32.values())

    def dist(side):
        return max(float((side[k] - g).abs().max()) for k, g in g32.items()) / g_max

    port = dist({k: p.grad for k, p in named.items()})
    jax_dist = dist(g16)
    assert port <= max(2e-2, 2 * jax_dist), (what, port, jax_dist)


def _bf16_exact(a):
    return np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))


def test_transformer_block_in_bf16_matches_jax():
    rng = np.random.RandomState(0)
    x = _bf16_exact(rng.randn(3, 29, 64).astype(np.float32))
    valid = rng.rand(3, 29) > 0.3
    valid[:, 0] = True
    kw = dict(hidden_dim=64, num_heads=4, dropout=0.0, use_flash=True,
              flash_interpret=True)
    bias = torch.from_numpy(np.where(valid, 0.0, -1e9).astype(np.float32))
    # bf16 in, bf16 out through the bf16 flash forms; 2 ulps: GELU and the
    # softmax round an ulp apart now and then, LayerNorm renormalises
    _check_module(JaxTransformerBlock(**kw, dtype=jnp.bfloat16), JaxTransformerBlock(**kw),
                  TransformerBlock(64, 4, 0.0),
                  (jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(valid)),
                  (torch.from_numpy(np.array(x)).to(torch.bfloat16), bias), 2, "block")


@pytest.mark.parametrize("seq_len,max_len", [(30, 4096), (37, 16)],
                         ids=["within_max_len", "blockwise"])
def test_transformer_encoder_in_bf16_matches_jax(seq_len, max_len):
    kw = dict(input_dim=8, hidden_dim=64, output_dim=16, num_layers=2, dropout=0.0,
              encoder_type="transformer", max_len=max_len, attention_block=8)
    x = np.random.RandomState(seq_len).randn(2, seq_len, 8).astype(np.float32)
    jkw = dict(kw, use_flash=True, flash_interpret=True)
    counts = [c.launches for c in (fa.FLASH_FWD_BF16, fa.FLASH_BWD_FUSED_BF16)]
    # float32 input cast to bf16 inside, as JAX's sequence.astype(dtype);
    # two blocks, the mean and the projection: 3 ulps
    _check_module(JaxSequenceEncoder(**jkw, dtype=jnp.bfloat16), JaxSequenceEncoder(**jkw),
                  SequenceEncoder(**kw, dtype=torch.bfloat16), (jnp.asarray(x),),
                  (torch.from_numpy(x),), 3, f"encoder T {seq_len}")
    # CPU tensors: the plain versions ran, no kernel launched
    assert [c.launches for c in (fa.FLASH_FWD_BF16, fa.FLASH_BWD_FUSED_BF16)] == counts


@pytest.mark.parametrize("pooling", ["attention", "average", "max"])
def test_frame_encoder_in_bf16_matches_jax(pooling):
    rng = np.random.RandomState(5)
    frames = rng.rand(3, 6, 16).astype(np.float32)
    mask = np.ones((3, 6), bool)
    mask[0, 4:] = False
    kw = dict(frame_dim=16, hidden_dim=32, output_dim=16, temporal_pooling=pooling)
    _check_module(JaxFrameEncoder(**kw, dtype=jnp.bfloat16), JaxFrameEncoder(**kw),
                  FrameEncoder(16, 32, 16, temporal_pooling=pooling, dropout=0.0,
                               dtype=torch.bfloat16),
                  (jnp.asarray(frames), jnp.asarray(mask)),
                  (torch.from_numpy(frames), torch.from_numpy(mask)), 2,
                  f"frame encoder {pooling}")


def _split(n, seed, samples=SAMPLES):
    rng = np.random.RandomState(seed)
    return ({"audio": rng.randn(n, samples, 1).astype(np.float32),
             "video": rng.rand(n, FRAMES, FRAME_DIM).astype(np.float32)},
            rng.randint(0, 8, n).astype(np.int32))


def test_classifier_with_bf16_encoders_matches_jax():
    jmodel = jax_classifier_from_config(jax_load_config(CONFIG, TF_BF16))
    feats, _ = _split(2, 0)
    jfeats = {k: jnp.asarray(v) for k, v in feats.items()}
    mask = jnp.ones((2, 2), jnp.float32)
    with jax.default_matmul_precision("highest"):
        variables = jmodel.init(jax.random.PRNGKey(3), jfeats, mask)
        ref = np.asarray(jmodel.apply(variables, jfeats, mask, deterministic=True))
    # the parameter tree is the float32 one: float32 leaves, same keys
    leaves = jax.tree_util.tree_leaves(variables["params"])
    assert all(leaf.dtype == jnp.float32 for leaf in leaves)

    model = classifier_from_config(load_config(CONFIG, TF_BF16))
    state = _state(variables["params"])
    model.load_state_dict(state)  # strict: every key of both trees
    assert model.audio_encoder.compute_dtype == model.video_encoder.compute_dtype == torch.bfloat16
    logits = forward(model, {k: torch.from_numpy(v) for k, v in feats.items()})
    # the embeddings rejoin float32 before the head
    assert logits.dtype == torch.float32 and logits.shape == (2, 8)
    with torch.no_grad():
        encoded = model.encode({k: torch.from_numpy(v) for k, v in feats.items()})
    assert all(e.dtype == torch.float32 for e in encoded.values())
    # two bf16 encoders, then a float32 head: 4 ulps of the largest logit
    _within_ulps(logits.numpy(), ref, 4, "logits")


def _jax_trajectory(overrides, feats, labels, idx, valid):
    jcfg = jax_load_config(CONFIG, overrides)
    jmodel = jax_classifier_from_config(jcfg)
    tx, _ = jax_optim.build_optimizer(jcfg.training, 3)
    jfeats = {k: jnp.asarray(v) for k, v in feats.items()}
    with jax.default_matmul_precision("highest"):
        state = create_train_state(jmodel, tx, {k: v[:B] for k, v in jfeats.items()},
                                   jnp.ones((B, 2)), jax.random.PRNGKey(4))
        params0 = jax.tree_util.tree_map(np.asarray, state.params)
        step = make_train_step(jmodel, tx, num_modalities=2, donate=False)
        losses = []
        for s in range(len(idx)):
            state, metrics = step(state, jfeats, jnp.asarray(labels), jnp.asarray(idx[s]),
                                  jnp.asarray(valid[s]), jax.random.PRNGKey(0))
            losses.append(float(metrics["loss"]))
    return params0, losses


def test_train_step_trajectory_with_bf16_encoders_matches_jax():
    overrides = TF_BF16 + NO_DROPOUT
    feats, labels = _split(20, 1)
    rng = np.random.RandomState(2)
    idx = [rng.randint(0, 20, B).astype(np.int32) for _ in range(3)]
    valid = [np.ones(B, np.float32)] * 2 + [np.array([1] * 5 + [0] * 3, np.float32)]
    params0, want = _jax_trajectory(overrides, feats, labels, idx, valid)

    cfg = load_config(CONFIG, overrides)
    model = classifier_from_config(cfg)
    model.load_state_dict(_state(params0))
    opt, sched = optim.build_optimizer(cfg.training, model.parameters(), 3)
    tfeats = {k: torch.from_numpy(v) for k, v in feats.items()}
    got = []
    for s in range(3):
        metrics = train_step(
            model, opt, tfeats, torch.from_numpy(labels.astype(np.int64)),
            torch.from_numpy(idx[s].astype(np.int64)), torch.from_numpy(valid[s]),
            lr=sched(s), clip_norm=1.0, modality_dropout=0.0,
            noise=Noise(torch.Generator().manual_seed(s)))
        got.append(float(metrics["loss"]))
    assert all(p.dtype == torch.float32 for p in model.parameters())
    # a float32 cross entropy of ~2.3 from logits a few bf16 ulps apart,
    # and Adam steps of lr x sign(g) where g is within bf16 round-off of 0
    # on both sides: the trajectories part by a few 1e-3 over 3 steps;
    # bound 1e-2, under one bf16 ulp of the loss (2^-6 at 2.3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-2)


def _write_splits(root, sizes):
    for seed, (split, n) in enumerate(sizes.items()):
        feats, labels = _split(n, 10 + seed)
        (root / split).mkdir(parents=True)
        for name, arr in (*feats.items(), ("labels", labels)):
            np.save(root / split / f"{name}.npy", arr)


def test_trainer_epoch_with_bf16_encoders_matches_jax(tmp_path):
    sizes = {"train": 24, "val": 8, "test": 8}  # 3 train steps of 8, one val batch
    data = tmp_path / "data"
    _write_splits(data, sizes)

    def overrides(save):
        return TF_BF16 + NO_DROPOUT + [
            "dataset.batch_size=8", "training.max_epochs=1", "runtime.platform=cpu",
            "runtime.epoch_scan=off", f"dataset.data_dir={data}",
            f"experiment.save_dir={save}", "experiment.name=run"]

    def loaders(cfg, create):
        return create(cfg.dataset.name, cfg.dataset.data_dir, cfg.dataset.modalities,
                      batch_size=cfg.dataset.batch_size, seed=cfg.seed)

    jcfg = jax_load_config(CONFIG, overrides(tmp_path / "jax"))
    jtrainer = JaxTrainer(jcfg, save_dir=tmp_path / "jax")
    jtrain, jval, _ = loaders(jcfg, jax_create_dataloaders)
    with jax.default_matmul_precision("highest"):
        jtrainer._build(jtrain)
        params = jax.tree_util.tree_map(np.asarray, jtrainer.state.params)
        jtrainer.fit(jtrain, jval)

    cfg = load_config(CONFIG, overrides(tmp_path / "port"))
    model = classifier_from_config(cfg)
    model.load_state_dict(state_dict_from_jax_params(params))
    trainer = Trainer(cfg, model=model, save_dir=tmp_path / "port" / "run")
    train_loader, val_loader, _ = loaders(cfg, create_dataloaders)
    trainer.fit(train_loader, val_loader)
    for key in ("train/loss", "val/loss"):
        want = [row[key] for row in jtrainer.history]
        got = [row[key] for row in trainer.history]
        assert len(got) == len(want) == 1
        # as the step trajectory's: 1e-2
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-2, err_msg=key)


# each case keeps the id it had while its bf16 setting was refused (item 13,
# ported since); the image encoder beside it is ported since too: it
# serves rank-5 frames in bf16, or refuses as the JAX package does (the
# resize frontend and the log-mel audio hand it rank-3 features)
RANK = "Expected rank-4/5 frames"


@pytest.mark.parametrize("override,item", [
    (["runtime.compute_dtype=bfloat16", "model.encoders.video.type=pretrained_cnn"],
     None),
    (["model.encoders.audio.dtype=bfloat16", "model.frontend.video=resize",
      "model.encoders.video.type=pretrained_cnn"], RANK),
    (["model.encoders.audio.encoder_type=gru", "model.encoders.audio.dtype=bfloat16",
      "model.encoders.audio.hidden_dim=1064"], "shape ceilings"),
    (["model.encoders.audio.type=pretrained_cnn", "model.encoders.audio.dtype=bfloat16"],
     RANK),
    (["model.encoders.video.type=pretrained_cnn", "model.encoders.video.dtype=bfloat16"],
     None),
], ids=["compute_dtype", "lstm", "gru", "cnn", "mlp"])
def test_bf16_outside_the_slice_raises(override, item):
    cfg = load_config(CONFIG, ["model.frontend.audio=logmel"] + override)
    if item == "shape ceilings":
        with pytest.raises(NotImplementedError, match=item):
            classifier_from_config(cfg)
        return
    model = init_weights(classifier_from_config(cfg), torch.Generator().manual_seed(0))
    rng = np.random.RandomState(4)
    feats = {"audio": torch.from_numpy(rng.randn(2, SAMPLES, 1).astype(np.float32)),
             "video": torch.from_numpy(rng.rand(2, 2, 16, 16, 3).astype(np.float32))}
    if item is not None:
        with pytest.raises(ValueError, match=item):
            forward(model, feats)
        return
    logits = forward(model, feats)
    assert logits.shape == (2, 8) and torch.isfinite(logits.float()).all()
    assert logits.dtype == (torch.bfloat16 if "runtime.compute_dtype=bfloat16" in override
                            else torch.float32)
