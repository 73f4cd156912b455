"""PyTorch port, the training step's parts against the JAX package:
learning-rate schedules, clip + AdamW / Adam against optax, the masked
loss and metrics, the loader's batch order, the modality-dropout mask, and
the whole train step over 5 updates of the narrow flagship from the same
weights (tolerance 1e-4, ``ops/envelope.py``'s ``INTERPRET_STRICT_ATOL``:
the two frameworks sum in other orders)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from multimodal_emotion_detection_tpu.config import Config as JaxConfig
from multimodal_emotion_detection_tpu.config import load_config as jax_load_config
from multimodal_emotion_detection_tpu.data.dataset import (
    MultimodalArrays as JaxArrays,
)
from multimodal_emotion_detection_tpu.data.loader import (
    MultimodalLoader as JaxLoader,
)
from multimodal_emotion_detection_tpu.models.classifier import (
    classifier_from_config as jax_classifier_from_config,
)
from multimodal_emotion_detection_tpu.ops.lstm_vjp import (
    set_bwd_kernel_mode,
    set_fwd_kernel_mode,
)
from multimodal_emotion_detection_tpu.training import optim as jax_optim
from multimodal_emotion_detection_tpu.training.steps import (
    _batch_metrics as jax_batch_metrics,
    _cross_entropy as jax_cross_entropy,
    create_train_state,
    make_train_step,
)
from multimodal_emotion_detection_tpu_torch.config import Config, load_config
from multimodal_emotion_detection_tpu_torch.data.dataset import MultimodalArrays
from multimodal_emotion_detection_tpu_torch.data.loader import MultimodalLoader
from multimodal_emotion_detection_tpu_torch.data.masking import (
    modality_dropout_mask,
)
from multimodal_emotion_detection_tpu_torch.models.classifier import (
    classifier_from_config,
)
from multimodal_emotion_detection_tpu_torch.models.noise import Noise
from multimodal_emotion_detection_tpu_torch.training import optim
from multimodal_emotion_detection_tpu_torch.training.steps import (
    batch_metrics,
    cross_entropy,
    optimizer_update,
    train_step,
)
from multimodal_emotion_detection_tpu_torch.utils.weights import (
    state_dict_from_jax_params,
)

NARROW = [
    "model.frontend.audio=logmel",
    "model.encoders.audio.hidden_dim=128",
    "model.encoders.audio.dropout=0.0",
    "model.encoders.video.input_dim=16",
    "model.encoders.video.hidden_dim=32",
    "model.encoders.video.dropout=0.0",
    "model.output_dim=16",
    "model.hidden_dim=32",
    "training.augmentation.modality_dropout=0.0",
    "runtime.lstm_kernels=off",
]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the suite runs several test workers on the same cores; at these tiny
    # shapes a multi-threaded torch only spins idle threads that slow them all
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _training_cfgs(kind):
    cfgs = []
    for cfg in (JaxConfig().training, Config().training):
        cfg.scheduler = kind
        cfg.learning_rate = 3e-3
        cfg.max_epochs = 3
        cfg.warmup_steps = 5
        cfg.scheduler_step_size = 2
        cfg.scheduler_gamma = 0.5
        cfgs.append(cfg)
    return cfgs


@pytest.mark.parametrize("kind", ["none", "cosine", "step", "warmup_cosine"])
def test_lr_schedule_matches_optax(kind):
    spe = 4
    jcfg, cfg = _training_cfgs(kind)
    jsched = jax_optim.lr_schedule(jcfg, spe)
    sched = optim.lr_schedule(cfg, spe)
    steps = range(3 * spe + 1)
    want = np.array([float(jsched(s)) for s in steps])
    got = np.array([sched(s) for s in steps])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)
    if kind == "warmup_cosine":
        assert got[0] == 0.0  # optax reads the count before the update


@pytest.mark.parametrize("name", ["adamw", "adam"])
def test_clip_and_optimizer_match_optax(name):
    jcfg, cfg = _training_cfgs("warmup_cosine")
    jcfg.optimizer = cfg.optimizer = name
    jcfg.weight_decay = cfg.weight_decay = 0.05
    jcfg.gradient_clip_norm = cfg.gradient_clip_norm = 1.0
    rng = np.random.RandomState(0)
    params = {"w": rng.randn(6, 5).astype(np.float32),
              "b": rng.randn(5).astype(np.float32)}
    # norms above and below the clip threshold
    grads = [{k: (scale * rng.randn(*v.shape)).astype(np.float32)
              for k, v in params.items()} for scale in (2.0, 0.05, 1.5, 0.1, 3.0)]

    tx, jsched = jax_optim.build_optimizer(jcfg, steps_per_epoch=2)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jparams)
    for g in grads:
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                   state, jparams)
        jparams = optax.apply_updates(jparams, updates)

    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
               for k, v in params.items()}
    opt, sched = optim.build_optimizer(cfg, tparams.values(), steps_per_epoch=2)
    for step, g in enumerate(grads):
        for k, p in tparams.items():
            p.grad = torch.from_numpy(g[k].copy())
        optimizer_update(opt, sched(step), cfg.gradient_clip_norm)
    for k, p in tparams.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams[k]),
                                   rtol=0, atol=1e-6, err_msg=k)


def test_loss_and_metrics_with_partial_valid():
    rng = np.random.RandomState(1)
    logits = rng.randn(6, 8).astype(np.float32)
    labels = rng.randint(0, 8, 6).astype(np.int64)
    valid = np.array([1, 1, 1, 1, 0, 0], np.float32)
    jl, jlab, jv = jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(valid)
    tl, tlab, tv = (torch.from_numpy(a) for a in (logits, labels, valid))
    np.testing.assert_allclose(float(cross_entropy(tl, tlab, tv)),
                               float(jax_cross_entropy(jl, jlab, jv)), rtol=1e-6)
    want = jax_batch_metrics(jl, jlab, jv)
    for k, v in batch_metrics(tl, tlab, tv).items():
        np.testing.assert_allclose(float(v), float(want[k]), rtol=1e-6, err_msg=k)


@pytest.mark.parametrize("n,shuffle", [(20, True), (16, True), (5, True),
                                       (20, False)])
def test_batch_order_equals_jax(n, shuffle):
    feats = {"a": np.zeros((n, 2), np.float32)}
    labels = np.zeros(n, np.int32)
    jl = JaxLoader(JaxArrays(feats, labels, ["a"]), 8, shuffle=shuffle, seed=7)
    tl = MultimodalLoader(MultimodalArrays(feats, labels, ["a"]), 8,
                          shuffle=shuffle, seed=7)
    for epoch in range(3):
        np.testing.assert_array_equal(tl.epoch_batch_indices(epoch),
                                      jl.epoch_batch_indices(epoch))
    np.testing.assert_array_equal(tl.epoch_batch_valid(), jl.epoch_batch_valid())


def test_modality_dropout_mask():
    b, m, p = 4000, 2, 0.3
    masks = [modality_dropout_mask(torch.Generator().manual_seed(5), b, m, p,
                                   torch.device("cpu")) for _ in range(2)]
    torch.testing.assert_close(masks[0], masks[1], rtol=0, atol=0)
    mask = masks[0]
    assert bool((mask.sum(dim=1) >= 1).all())
    # P(dropped) = p, except a both-dropped row (p^2) gets one back
    rate = 1.0 - float(mask.mean())
    expect = p - p * p / m
    assert abs(rate - expect) < 3 * np.sqrt(expect * (1 - expect) / (b * m))
    ones = modality_dropout_mask(None, 3, m, 0.0, torch.device("cpu"))
    torch.testing.assert_close(ones, torch.ones(3, m))


# the attention pool's score bias: softmax over time does not see it
SHIFT_INVARIANT = "video_encoder.pool.attention.bias"


def _split(n, seed):
    rng = np.random.RandomState(seed)
    return ({"audio": rng.randn(n, 40 * 128, 1).astype(np.float32),
             "video": rng.rand(n, 4, 16).astype(np.float32)},
            rng.randint(0, 8, n).astype(np.int32))


def test_train_step_trajectory_matches_jax():
    feats, labels = _split(20, 0)
    rng = np.random.RandomState(1)
    idx = [rng.randint(0, 20, 8).astype(np.int32) for _ in range(5)]
    valid = [np.ones(8, np.float32)] * 4 + [np.array([1] * 5 + [0] * 3, np.float32)]

    jcfg = jax_load_config("configs/base.yaml", NARROW)
    jmodel = jax_classifier_from_config(jcfg)
    tx, jsched = jax_optim.build_optimizer(jcfg.training, 3)
    jfeats = {k: jnp.asarray(v) for k, v in feats.items()}
    prev_f, prev_b = set_fwd_kernel_mode("off"), set_bwd_kernel_mode("off")
    try:
        with jax.default_matmul_precision("highest"):
            sample = {k: v[:8] for k, v in jfeats.items()}
            state = create_train_state(jmodel, tx, sample, jnp.ones((8, 2)),
                                       jax.random.PRNGKey(3))
            params0 = jax.tree_util.tree_map(np.asarray, state.params)
            step = make_train_step(jmodel, tx, num_modalities=2, donate=False)
            want_loss, want_params = [], []
            for s in range(5):
                state, metrics = step(state, jfeats, jnp.asarray(labels),
                                      jnp.asarray(idx[s]), jnp.asarray(valid[s]),
                                      jax.random.PRNGKey(0))
                want_loss.append(float(metrics["loss"]))
                want_params.append(state_dict_from_jax_params(
                    jax.tree_util.tree_map(np.asarray, state.params)))
    finally:
        set_fwd_kernel_mode(prev_f), set_bwd_kernel_mode(prev_b)

    cfg = load_config("configs/base.yaml", NARROW)
    model = classifier_from_config(cfg)
    params0_t = state_dict_from_jax_params(params0)
    model.load_state_dict(params0_t)
    opt, sched = optim.build_optimizer(cfg.training, model.parameters(), 3)
    tfeats = {k: torch.from_numpy(v) for k, v in feats.items()}
    tlabels = torch.from_numpy(labels.astype(np.int64))
    for s in range(5):
        metrics = train_step(
            model, opt, tfeats, tlabels, torch.from_numpy(idx[s].astype(np.int64)),
            torch.from_numpy(valid[s]), lr=sched(s), clip_norm=1.0,
            modality_dropout=0.0, noise=Noise(torch.Generator().manual_seed(s)))
        np.testing.assert_allclose(float(metrics["loss"]), want_loss[s],
                                   rtol=0, atol=1e-4, err_msg=f"loss, step {s}")
        got = model.state_dict()
        for k, v in want_params[s].items():
            if k == SHIFT_INVARIANT:
                # its true gradient is zero; Adam scales the round-off of
                # either framework to a step of at most ~lr (1e-3) each
                assert np.abs(got[k].numpy() - params0_t[k].numpy()).max() <= 1.1e-3 * (s + 1)
                continue
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0,
                                       atol=1e-4, err_msg=f"{k}, step {s}")


def test_clip_by_global_norm_is_exact_on_a_wide_gradient():
    # the big config's video frame layer: a 4096 x 512 gradient, where a
    # float32 reduction on the CPU is off by ~3e-5 relative
    g = torch.Generator().manual_seed(0)
    grads = [torch.randn(4096, 512, generator=g) * 1e-3,
             torch.randn(512, 2048, generator=g) * 1e-3, torch.randn(8, generator=g)]
    norm = float(torch.sqrt(sum((t.double() ** 2).sum() for t in grads)))
    clipped = [t.clone() for t in grads]
    optim.clip_by_global_norm(clipped, 1.0)
    for c, t in zip(clipped, grads):
        np.testing.assert_allclose(c.double().numpy(), t.double().numpy() / norm,
                                   rtol=1e-6, atol=0)
    small = [t * 1e-3 / norm for t in grads]  # norm 1e-3: left as it is
    kept = [t.clone() for t in small]
    optim.clip_by_global_norm(kept, 1.0)
    for k, t in zip(kept, small):
        torch.testing.assert_close(k, t, rtol=0, atol=0)
