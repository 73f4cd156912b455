"""PyTorch port, the unimodal configs (``configs/audio_only.yaml``: log-mel
-> the CNN encoder with BatchNorm; ``configs/video_only.yaml``: the frame
encoder alone) and ``SimpleMLPEncoder``, against the JAX package at small
widths on the CPU (``runtime.platform=cpu``):

* the CNN and MLP encoders (rank 2 and 3) in eval mode 1e-5, in train mode
  at dropout 0 1e-5, their running statistics after one train-mode forward
  against flax's ``mutable=["batch_stats"]`` 1e-6 (a batch with
  wrap-padded rows included), ``bn_eval=True`` in train mode against JAX
  ``deterministic=False, bn_eval=True`` with the port's dropout masks
  handed to flax's ``Dropout`` (the statistics untouched);
* ``utils/weights.py``: a Conv and a DenseGeneral kernel in one tree, an
  unknown 3-D kernel refused, ``batch_stats`` into the buffers, the JAX
  trees loaded ``strict=True``;
* the classifiers' logits against JAX (log-mel on the XLA and the Pallas
  interpret routes), 5 train steps against JAX ``make_train_step`` with
  ``has_batch_stats=True``, the buffers included, and 2 epochs of
  ``Trainer.fit``'s val/loss against the JAX Trainer;
* the train CLI, ``best.ckpt`` and a resumed run carrying the buffers,
  ``predict`` and ``predict --mc-dropout`` (buffers bit for bit
  unchanged) on both configs; ``scripts/jax_ckpt_to_torch.py`` on a JAX
  checkpoint with BatchNorm statistics."""

import importlib.util
import json
from pathlib import Path

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_emotion_detection_tpu import train as jax_train
from multimodal_emotion_detection_tpu.config import load_config as jax_load_config
from multimodal_emotion_detection_tpu.data.loader import (
    create_dataloaders as jax_create_dataloaders,
)
from multimodal_emotion_detection_tpu.models.classifier import (
    classifier_from_config as jax_classifier_from_config,
)
from multimodal_emotion_detection_tpu.models.encoders import (
    SequenceEncoder as JaxSequenceEncoder,
    SimpleMLPEncoder as JaxSimpleMLPEncoder,
)
from multimodal_emotion_detection_tpu.training import optim as jax_optim
from multimodal_emotion_detection_tpu.training.checkpoints import (
    save_checkpoint as jax_save_checkpoint,
)
from multimodal_emotion_detection_tpu.training.loop import Trainer as JaxTrainer
from multimodal_emotion_detection_tpu.training.steps import (
    create_train_state,
    make_train_step,
)
from multimodal_emotion_detection_tpu_torch import train as port_train
from multimodal_emotion_detection_tpu_torch.config import load_config
from multimodal_emotion_detection_tpu_torch.data.loader import create_dataloaders
from multimodal_emotion_detection_tpu_torch.models.batchnorm import BatchNorm
from multimodal_emotion_detection_tpu_torch.models.classifier import (
    classifier_from_config,
    init_weights,
)
from multimodal_emotion_detection_tpu_torch.models.encoders import (
    SequenceEncoder,
    SimpleMLPEncoder,
    build_encoder,
)
from multimodal_emotion_detection_tpu_torch.models.noise import Noise
from multimodal_emotion_detection_tpu_torch.tools._restore import restore_for_eval
from multimodal_emotion_detection_tpu_torch.tools.predict import (
    main as port_predict,
)
from multimodal_emotion_detection_tpu_torch.training import optim
from multimodal_emotion_detection_tpu_torch.training.checkpoints import (
    load_checkpoint,
)
from multimodal_emotion_detection_tpu_torch.training.loop import Trainer
from multimodal_emotion_detection_tpu_torch.training.steps import forward, train_step
from multimodal_emotion_detection_tpu_torch.uncertainty.mc_dropout import (
    mc_dropout_predict,
)
from multimodal_emotion_detection_tpu_torch.utils.weights import (
    state_dict_from_jax_params,
)

ROOT = Path(__file__).resolve().parents[1]
AUDIO = str(ROOT / "configs" / "audio_only.yaml")
VIDEO = str(ROOT / "configs" / "video_only.yaml")
MLP = ["model.encoders.audio.type=mlp"]
NARROW = {
    AUDIO: ["model.encoders.audio.hidden_dim=32", "model.output_dim=16",
            "model.hidden_dim=32"],
    VIDEO: ["model.encoders.video.input_dim=16", "model.encoders.video.hidden_dim=32",
            "model.output_dim=16", "model.hidden_dim=32"],
}
NO_DROPOUT = {AUDIO: ["model.encoders.audio.dropout=0.0"],
              VIDEO: ["model.encoders.video.dropout=0.0"]}
CONFIGS = [pytest.param(AUDIO, [], id="audio_only"),
           pytest.param(AUDIO, MLP, id="audio_only-mlp"),
           pytest.param(VIDEO, [], id="video_only")]
SAMPLES, FRAMES = 40 * 128, 4
BN_KEYS = ("weight", "bias", "running_mean", "running_var")


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


def _jax_masks(masks):
    """Hand ``masks`` (the port's inverted-dropout masks, in draw order) to
    flax's ``Dropout`` calls in call order, in place of its own draws."""
    queue = [jnp.asarray(m.numpy()) for m in masks]

    def interceptor(next_fun, args, kwargs, context):
        module = context.module
        if (isinstance(module, fnn.Dropout) and context.method_name == "__call__"
                and module.rate > 0 and not kwargs.get("deterministic", True)):
            return args[0] * queue.pop(0)
        return next_fun(*args, **kwargs)

    return fnn.intercept_methods(interceptor)


# ------------------------------------------------------------------ encoders


def _encoder_pair(kind, rate, batch_norm=True):
    """(JAX module, port module) of one encoder at narrow widths."""
    if kind == "cnn":
        return (JaxSequenceEncoder(input_dim=8, hidden_dim=24, output_dim=12,
                                   encoder_type="cnn", dropout=rate),
                SequenceEncoder(8, 24, 12, encoder_type="cnn", dropout=rate))
    return (JaxSimpleMLPEncoder(input_dim=8, hidden_dim=24, output_dim=12,
                                num_layers=2, dropout=rate, batch_norm=batch_norm),
            SimpleMLPEncoder(8, 24, 12, num_layers=2, dropout=rate,
                             batch_norm=batch_norm))


def _encoder_input(kind, seed=0, b=6, t=11, wrap=0):
    """(B, T, 8) for the CNN and the rank-3 MLP, (B, 8) for the rank-2 MLP;
    the last ``wrap`` rows repeat the first ones, as wrap padding does."""
    rng = np.random.RandomState(seed)
    shape = (b, 8) if kind == "mlp2" else (b, t, 8)
    x = (rng.randn(*shape) * 2.0 + 0.5).astype(np.float32)
    if wrap:
        x[b - wrap:] = x[:wrap]
    return x


def _init(jmod, x, seed=1):
    variables = jmod.init(jax.random.PRNGKey(seed), jnp.asarray(x))
    params = _np_tree(variables["params"])
    stats = _np_tree(variables.get("batch_stats", {}))
    # running statistics away from their initial 0 / 1, so eval reads them
    rng = np.random.RandomState(seed + 7)
    stats = jax.tree_util.tree_map(
        lambda a: (rng.rand(*a.shape) + 0.5).astype(np.float32), stats)
    return params, stats


def _load(port, params, stats):
    port.load_state_dict(state_dict_from_jax_params(params, stats or None),
                         strict=True)
    return port


ENCODERS = [pytest.param("cnn", id="cnn"), pytest.param("mlp2", id="mlp-rank2"),
            pytest.param("mlp3", id="mlp-rank3")]


@pytest.mark.parametrize("kind", ENCODERS)
def test_encoder_eval_matches_jax(kind):
    jmod, port = _encoder_pair(kind[:3], 0.1)
    x = _encoder_input(kind)
    params, stats = _init(jmod, x)
    with jax.default_matmul_precision("highest"):
        ref = jmod.apply({"params": params, "batch_stats": stats}, jnp.asarray(x),
                         deterministic=True)
    _load(port, params, stats).eval()
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-5)


@pytest.mark.parametrize("wrap", [0, 2], ids=["full", "wrap-padded"])
@pytest.mark.parametrize("kind", ENCODERS)
def test_encoder_train_step_statistics_match_flax(kind, wrap):
    # train mode at dropout 0: batch statistics over every row, the
    # running average 0.99 old + 0.01 batch with the biased variance
    jmod, port = _encoder_pair(kind[:3], 0.0)
    x = _encoder_input(kind, seed=3, wrap=wrap)
    params, stats = _init(jmod, x)
    with jax.default_matmul_precision("highest"):
        ref, new_state = jmod.apply({"params": params, "batch_stats": stats},
                                    jnp.asarray(x), deterministic=False,
                                    mutable=["batch_stats"])
    _load(port, params, stats).train()
    with torch.no_grad():
        got = port(torch.from_numpy(x), noise=Noise(torch.Generator().manual_seed(0)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-5)
    want = state_dict_from_jax_params({}, _np_tree(new_state["batch_stats"]))
    sd = port.state_dict()
    assert want and all(k.endswith(("running_mean", "running_var")) for k in want)
    for k, v in want.items():
        np.testing.assert_allclose(sd[k].numpy(), v.numpy(), rtol=0, atol=1e-6,
                                   err_msg=k)
        assert not np.allclose(sd[k].numpy(), _load_stat(stats, k)), k


def _load_stat(stats, key):
    *path, leaf = key.split(".")
    node = stats
    for p in path:
        node = node[p]
    return node[{"running_mean": "mean", "running_var": "var"}[leaf]]


@pytest.mark.parametrize("kind", ENCODERS)
def test_bn_eval_in_train_mode_matches_jax_with_the_same_masks(kind):
    # MC dropout's forward: dropout on, running statistics read and kept
    jmod, port = _encoder_pair(kind[:3], 0.25)
    x = _encoder_input(kind, seed=5)
    params, stats = _init(jmod, x)
    _load(port, params, stats).train()
    before = {k: v.clone() for k, v in port.state_dict().items()}
    noise = Noise(torch.Generator().manual_seed(4))
    with torch.no_grad():
        got = port(torch.from_numpy(x), noise=noise, bn_eval=True)
    assert len(noise.drawn) == 2 and all(float(m.min()) == 0 for m in noise.drawn)
    with jax.default_matmul_precision("highest"), _jax_masks(noise.drawn):
        ref = jmod.apply({"params": params, "batch_stats": stats}, jnp.asarray(x),
                         deterministic=False, bn_eval=True,
                         rngs={"dropout": jax.random.PRNGKey(0)})
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-5)
    assert all(torch.equal(v, port.state_dict()[k]) for k, v in before.items())
    # bn_eval=False in eval mode: batch statistics, which move the buffers
    port.eval()
    with torch.no_grad():
        port(torch.from_numpy(x), bn_eval=False)
    assert not torch.equal(before[_first_stat(port)], port.state_dict()[_first_stat(port)])


def _first_stat(module):
    return next(k for k in module.state_dict() if k.endswith("running_mean"))


def test_mlp_without_batch_norm_matches_jax():
    jmod, port = _encoder_pair("mlp", 0.0, batch_norm=False)
    x = _encoder_input("mlp3", seed=6)
    params, stats = _init(jmod, x)
    assert not stats
    _load(port, params, None).train()
    assert not any(isinstance(m, BatchNorm) for m in port.modules())
    ref = jmod.apply({"params": params}, jnp.asarray(x), deterministic=False)
    with torch.no_grad():
        got = port(torch.from_numpy(x), noise=Noise(torch.Generator().manual_seed(0)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-5)


def test_batch_norm_state_dict_holds_exactly_flax_leaves():
    bn = BatchNorm(5)
    assert sorted(bn.state_dict()) == sorted(BN_KEYS)
    assert sorted(k for k, _ in bn.named_buffers()) == ["running_mean", "running_var"]
    assert bn.momentum == 0.99 and bn.epsilon == 1e-5


# ------------------------------------------------------------------- factory


@pytest.mark.parametrize("cfg,kind,hidden", [
    ({"type": "sequence", "encoder_type": "cnn"}, SequenceEncoder, 2 * 16),
    ({"type": "mlp"}, SimpleMLPEncoder, 64),  # max(output_dim, 64)
    ({"type": "mlp", "encoder_type": "cnn", "hidden_dim": 40}, SimpleMLPEncoder, 40),
    ({}, SimpleMLPEncoder, 64),  # an unnamed modality is an mlp
])
def test_build_encoder_routes_cnn_and_mlp_like_jax(cfg, kind, hidden):
    from multimodal_emotion_detection_tpu.models.encoders import (
        build_encoder as jax_build_encoder,
    )

    enc = build_encoder("audio" if "type" in cfg else "sensor", 8, 16, cfg)
    jenc = jax_build_encoder("audio" if "type" in cfg else "sensor", 8, 16, cfg)
    assert isinstance(enc, kind)
    assert jenc.hidden_dim == hidden
    first = enc.conv1 if kind is SequenceEncoder else enc.dense_0
    assert first.weight.shape[0] == hidden


def test_build_encoder_still_refuses_pretrained_cnn():
    with pytest.raises(NotImplementedError, match="item 8"):
        build_encoder("video", 8, 16, {"type": "pretrained_cnn"})


# ------------------------------------------------------------------- weights


def test_weights_map_conv_and_dense_general_kernels_in_one_tree():
    rng = np.random.RandomState(0)
    conv = rng.randn(5, 3, 7).astype(np.float32)  # (k, in, out)
    q = rng.randn(8, 2, 4).astype(np.float32)  # (D, H, Dh)
    out = rng.randn(2, 4, 8).astype(np.float32)  # (H, Dh, D)
    tree = {"enc": {"conv1": {"kernel": conv, "bias": np.zeros(7, np.float32)},
                    "attn": {"query": {"kernel": q, "bias": np.ones((2, 4), np.float32)},
                             "out": {"kernel": out, "bias": np.zeros(8, np.float32)}},
                    "bn1": {"scale": np.ones(7, np.float32), "bias": np.zeros(7, np.float32)}}}
    stats = {"enc": {"bn1": {"mean": np.full(7, 0.5, np.float32),
                             "var": np.full(7, 2.0, np.float32)}}}
    sd = state_dict_from_jax_params(tree, stats)
    np.testing.assert_array_equal(sd["enc.conv1.weight"].numpy(), conv.transpose(2, 1, 0))
    np.testing.assert_array_equal(sd["enc.attn.query.weight"].numpy(), q.reshape(8, 8).T)
    np.testing.assert_array_equal(sd["enc.attn.query.bias"].numpy(), np.ones(8))
    np.testing.assert_array_equal(sd["enc.attn.out.weight"].numpy(), out.reshape(8, 8).T)
    assert sd["enc.bn1.running_mean"].tolist() == [0.5] * 7
    assert sd["enc.bn1.running_var"].tolist() == [2.0] * 7
    # torch's own Conv1d computes what flax's conv does with that kernel
    x = rng.randn(2, 9, 3).astype(np.float32)
    ref = fnn.Conv(7, (5,), padding="SAME").apply(
        {"params": {"kernel": conv, "bias": np.zeros(7, np.float32)}}, x)
    got = torch.nn.functional.conv1d(torch.from_numpy(x).transpose(1, 2),
                                     sd["enc.conv1.weight"], padding=2).transpose(1, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-5)


@pytest.mark.parametrize("tree,match", [
    ({"dense": {"kernel": np.zeros((2, 3, 4), np.float32)}}, "kernel has shape"),
    ({"pool": {"kernel": np.zeros((2, 3, 4), np.float32)}}, "kernel has shape"),
    ({"conv1": {"kernel": np.zeros((2, 3, 4, 5), np.float32)}}, "kernel has shape"),
])
def test_weights_refuse_an_unknown_3d_kernel(tree, match):
    with pytest.raises(ValueError, match=match):
        state_dict_from_jax_params(tree)


def test_weights_refuse_a_batch_stats_leaf_that_is_not_mean_or_var():
    with pytest.raises(ValueError, match="batch_stats"):
        state_dict_from_jax_params({}, {"bn1": {"scale": np.ones(3, np.float32)}})


# --------------------------------------------------------------- classifiers


def _inputs(config, seed=0, b=6):
    rng = np.random.RandomState(seed)
    if config == AUDIO:
        return {"audio": rng.randn(b, SAMPLES, 1).astype(np.float32)}
    return {"video": rng.rand(b, FRAMES, 16).astype(np.float32)}


def _jax_classifier(config, extra=(), interpret=False):
    jcfg = jax_load_config(config, NARROW[config] + list(extra))
    jmodel = jax_classifier_from_config(jcfg)
    return jmodel.clone(frontend_interpret=True) if interpret else jmodel


def _port_classifier(config, extra=()):
    return classifier_from_config(load_config(config, NARROW[config] + list(extra)))


@pytest.mark.parametrize("config,extra,interpret", [
    # log-mel on JAX's XLA route and on its Pallas kernel in interpret mode
    pytest.param(AUDIO, [], False, id="audio_only-xla"),
    pytest.param(AUDIO, [], True, id="audio_only-pallas-interpret"),
    pytest.param(AUDIO, MLP, False, id="audio_only-mlp-xla"),
    pytest.param(AUDIO, MLP, True, id="audio_only-mlp-pallas-interpret"),
    pytest.param(VIDEO, [], False, id="video_only"),
])
def test_classifier_logits_match_jax(config, extra, interpret):
    jmodel = _jax_classifier(config, extra, interpret)
    feats = _inputs(config)
    jfeats = {k: jnp.asarray(v) for k, v in feats.items()}
    mask = jnp.ones((6, 1), jnp.float32)
    with jax.default_matmul_precision("highest"):
        variables = jmodel.init(jax.random.PRNGKey(3), jfeats, mask)
        if "batch_stats" in variables:
            # a training-mode forward moves the running statistics off 0 / 1
            _, state = jmodel.apply(variables, jfeats, mask, deterministic=False,
                                    rngs={"dropout": jax.random.PRNGKey(1)},
                                    mutable=["batch_stats"])
            variables = {**variables, **state}
        ref = np.asarray(jmodel.apply(variables, jfeats, mask, deterministic=True))
    model = _port_classifier(config, extra)
    model.load_state_dict(state_dict_from_jax_params(
        _np_tree(variables["params"]), _np_tree(variables.get("batch_stats")) or None),
        strict=True)
    logits = forward(model, {k: torch.from_numpy(v) for k, v in feats.items()})
    assert logits.shape == (6, 8)
    np.testing.assert_allclose(logits.numpy(), ref, rtol=1e-4, atol=1e-4)


# true gradient zero: the attention pool's score bias (softmax over time
# does not see it) and every bias right before a BatchNorm (the batch mean
# takes it out)
SHIFT_INVARIANT = {"video_encoder.pool.attention.bias", "audio_encoder.conv1.bias",
                   "audio_encoder.conv2.bias", "audio_encoder.dense_0.bias",
                   "audio_encoder.dense_1.bias"}


@pytest.mark.parametrize("config,extra", CONFIGS)
def test_train_step_trajectory_matches_jax_with_batch_stats(config, extra):
    n = 20
    feats = _inputs(config, seed=1, b=n)
    labels = np.random.RandomState(2).randint(0, 8, n).astype(np.int32)
    rng = np.random.RandomState(3)
    idx = [rng.randint(0, n, 8).astype(np.int32) for _ in range(5)]
    # the last batch wrap-padded: its padding rows still feed BatchNorm
    idx[4][5:] = idx[4][:3]
    valid = [np.ones(8, np.float32)] * 4 + [np.array([1] * 5 + [0] * 3, np.float32)]
    overrides = NARROW[config] + NO_DROPOUT[config] + list(extra)

    jcfg = jax_load_config(config, overrides)
    jmodel = jax_classifier_from_config(jcfg)
    tx, _ = jax_optim.build_optimizer(jcfg.training, 3)
    jfeats = {k: jnp.asarray(v) for k, v in feats.items()}
    with jax.default_matmul_precision("highest"):
        state = create_train_state(jmodel, tx, {k: v[:8] for k, v in jfeats.items()},
                                   jnp.ones((8, 1)), jax.random.PRNGKey(3))
        has_bn = bool(state.model_state)
        assert has_bn == (config == AUDIO)
        start = state_dict_from_jax_params(
            _np_tree(state.params), _np_tree(state.model_state.get("batch_stats")))
        step = make_train_step(jmodel, tx, num_modalities=1,
                               has_batch_stats=has_bn, donate=False)
        want = []
        for s in range(5):
            state, metrics = step(state, jfeats, jnp.asarray(labels), jnp.asarray(idx[s]),
                                  jnp.asarray(valid[s]), jax.random.PRNGKey(0))
            want.append((float(metrics["loss"]), state_dict_from_jax_params(
                _np_tree(state.params), _np_tree(state.model_state.get("batch_stats")))))

    cfg = load_config(config, overrides)
    model = classifier_from_config(cfg)
    model.load_state_dict(start, strict=True)
    opt, sched = optim.build_optimizer(cfg.training, model.parameters(), 3)
    assert not any(p is b for p in model.parameters() for b in model.buffers())
    tfeats = {k: torch.from_numpy(v) for k, v in feats.items()}
    for s in range(5):
        metrics = train_step(
            model, opt, tfeats, torch.from_numpy(labels.astype(np.int64)),
            torch.from_numpy(idx[s].astype(np.int64)), torch.from_numpy(valid[s]),
            lr=sched(s), clip_norm=1.0, modality_dropout=0.0,
            noise=Noise(torch.Generator().manual_seed(s)))
        loss, params = want[s]
        np.testing.assert_allclose(float(metrics["loss"]), loss, rtol=0, atol=1e-4,
                                   err_msg=f"loss, step {s}")
        got = model.state_dict()
        assert sorted(got) == sorted(params)
        for k, v in params.items():
            if k in SHIFT_INVARIANT:
                # its true gradient is zero; Adam scales either framework's
                # round-off to a step of at most ~lr (1e-3) each
                assert np.abs(got[k].numpy() - start[k].numpy()).max() <= 1.1e-3 * (s + 1)
                continue
            # the running means too: each batch mean carries the bias before
            # the BatchNorm, whose round-off steps differ by framework
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0, atol=1e-4,
                                       err_msg=f"{k}, step {s}")


def test_ensemble_members_keep_their_own_running_statistics():
    # a port state_dict carries the buffers: each member normalises with
    # its own statistics, and the model handed in keeps its own
    from multimodal_emotion_detection_tpu_torch.uncertainty.ensemble import (
        ensemble_predict_list,
    )

    members = []
    for seed in range(3):
        m = init_weights(_port_classifier(AUDIO), torch.Generator().manual_seed(seed))
        for i, b in enumerate(m.buffers()):
            b.copy_(torch.rand(b.shape, generator=torch.Generator().manual_seed(
                10 * seed + i)) + 0.5)
        members.append(m.eval())
    feats = {k: torch.from_numpy(v) for k, v in _inputs(AUDIO, seed=9).items()}
    model = _port_classifier(AUDIO)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    probs, unc = ensemble_predict_list(model, [m.state_dict() for m in members], feats)
    each = torch.stack([torch.softmax(forward(m, feats), -1) for m in members])
    np.testing.assert_allclose(probs.numpy(), each.mean(0).numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(unc.numpy(), each.var(0, unbiased=False).mean(-1).numpy(),
                               rtol=0, atol=1e-7)
    assert all(torch.equal(v, model.state_dict()[k]) for k, v in before.items())


# ---------------------------------------------------------------------- CLIs

SIZES = {"train": 20, "val": 12, "test": 12}  # 3 / 2 / 2 batches of 8


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("port_unimodal_data")
    for seed, (split, n) in enumerate(SIZES.items()):
        rng = np.random.RandomState(seed)
        d = root / split
        d.mkdir()
        np.save(d / "audio.npy", rng.randn(n, SAMPLES, 1).astype(np.float32))
        np.save(d / "video.npy", rng.rand(n, FRAMES, 16).astype(np.float32))
        np.save(d / "labels.npy", rng.randint(0, 8, n).astype(np.int32))
    return root


def _overrides(config, data_dir, root, *extra):
    return NARROW[config] + ["dataset.batch_size=8", "training.max_epochs=2",
                             "runtime.epoch_scan=off",
                             "runtime.platform=cpu", f"dataset.data_dir={data_dir}",
                             f"experiment.save_dir={root}", "experiment.name=run",
                             *extra]


def _buffers(state_dict):
    return {k: v for k, v in state_dict.items()
            if k.endswith(("running_mean", "running_var"))}


@pytest.fixture(scope="module")
def cli_runs(data_dir, tmp_path_factory):
    """The train CLI on both configs (and the CNN config with the MLP
    encoder), port and JAX, each in a directory of its own."""
    runs = {}
    for name, config, extra in (("audio", AUDIO, []), ("mlp", AUDIO, MLP),
                                ("video", VIDEO, [])):
        for pkg, main in (("port", port_train.main), ("jax", jax_train.main)):
            root = tmp_path_factory.mktemp(f"{name}_{pkg}")
            results = main(["--config", config,
                            *_overrides(config, data_dir, root, *extra)])
            runs[name, pkg] = (root, results)
    return runs


CLI = [pytest.param("audio", AUDIO, [], id="audio_only"),
       pytest.param("mlp", AUDIO, MLP, id="audio_only-mlp"),
       pytest.param("video", VIDEO, [], id="video_only")]


@pytest.mark.parametrize("name,config,extra", CLI)
def test_train_cli_writes_the_jax_artifacts_and_carries_the_buffers(
        cli_runs, name, config, extra):
    (root, results), (jroot, jresults) = cli_runs[name, "port"], cli_runs[name, "jax"]
    for rel in ("results.json", "best.ckpt", "checkpoints/last.ckpt",
                "confusion_matrix.npy", "csv_logs/version_0/metrics.csv"):
        assert (root / "run" / rel).exists(), rel
        assert (jroot / "run" / rel).exists(), rel
    assert sorted(results) == sorted(jresults)
    assert np.isfinite(list(results.values())).all()
    best, _ = load_checkpoint(root / "run" / "best.ckpt")
    last, _ = load_checkpoint(root / "run" / "checkpoints" / "last.ckpt")
    model = _port_classifier(config, extra)
    model.load_state_dict(best, strict=True)
    stats = _buffers(best)
    assert bool(stats) == (config == AUDIO)
    assert sorted(last) == sorted(best)
    fresh = init_weights(_port_classifier(config, extra), torch.Generator().manual_seed(42))
    for k, v in stats.items():
        # trained off their initial 0 / 1, in both checkpoints
        assert not torch.equal(v, fresh.state_dict()[k]), k
        assert not torch.equal(last[k], fresh.state_dict()[k]), k


@pytest.mark.parametrize("name,config,extra", CLI)
def test_predict_and_mc_dropout_serve_the_trained_checkpoint(
        cli_runs, data_dir, tmp_path, name, config, extra):
    root, _ = cli_runs[name, "port"]
    ckpt = root / "run" / "best.ckpt"
    overrides = _overrides(config, data_dir, tmp_path, *extra)
    plain = port_predict(["--checkpoint", str(ckpt), "--config", config,
                          "--out", str(tmp_path / "plain"), *overrides])
    mc = port_predict(["--checkpoint", str(ckpt), "--config", config,
                       "--mc-dropout", "4", "--out", str(tmp_path / "mc"), *overrides])
    assert plain["mc_dropout_samples"] == 0 and mc["mc_dropout_samples"] == 4
    n = SIZES["test"]
    cfg = load_config(config, overrides)
    model, _, loader = restore_for_eval(cfg, ckpt, "test", torch.device("cpu"))
    ref = np.concatenate([forward(model, f, m).numpy() for f, m in
                          ((f, m) for f, _, m in loader)])[:n]
    logits = np.load(tmp_path / "plain" / "logits.npy")
    assert logits.shape == (n, 8)
    np.testing.assert_array_equal(logits, ref)
    unc = np.load(tmp_path / "mc" / "uncertainty.npy")
    assert unc.shape == (n,) and np.isfinite(unc).all() and unc.max() > 0

    # MC dropout reads the running statistics and leaves them bit for bit
    before = {k: v.clone() for k, v in model.state_dict().items()}
    features, _, mask = next(iter(loader))
    mean, _ = mc_dropout_predict(model, features, 4, mask=mask,
                                 noise=Noise(torch.Generator().manual_seed(cfg.seed)))
    np.testing.assert_array_equal(mean.numpy(), np.load(tmp_path / "mc" / "logits.npy")[:8])
    after = model.state_dict()
    assert all(torch.equal(v, after[k]) for k, v in before.items())
    if config == AUDIO:
        # a training-mode forward without bn_eval would have moved them
        model.train()
        with torch.no_grad():
            model(features, mask, noise=Noise(torch.Generator().manual_seed(0)))
        assert not all(torch.equal(v, model.state_dict()[k])
                       for k, v in _buffers(before).items())


def _loaders(cfg, create):
    return create(cfg.dataset.name, cfg.dataset.data_dir, cfg.dataset.modalities,
                  batch_size=cfg.dataset.batch_size, seed=cfg.seed)


def _port_fit(config, data_dir, save_dir, *extra, model=None, resume=False):
    cfg = load_config(config, _overrides(config, data_dir, save_dir, *extra))
    trainer = Trainer(cfg, model=model, save_dir=Path(save_dir) / "run")
    train_loader, val_loader, _ = _loaders(cfg, create_dataloaders)
    trainer.fit(train_loader, val_loader, resume=resume)
    return trainer


@pytest.mark.parametrize("config,extra", CONFIGS)
def test_fit_val_loss_matches_jax_trainer(data_dir, tmp_path, config, extra):
    overrides = [*NO_DROPOUT[config], *extra]
    jcfg = jax_load_config(config, _overrides(config, data_dir, tmp_path / "jax",
                                              *overrides))
    jtrainer = JaxTrainer(jcfg, save_dir=tmp_path / "jax")
    jtrain, jval, _ = _loaders(jcfg, jax_create_dataloaders)
    with jax.default_matmul_precision("highest"):
        jtrainer._build(jtrain)
        start = state_dict_from_jax_params(
            _np_tree(jtrainer.state.params),
            _np_tree(jtrainer.state.model_state.get("batch_stats")))
        jtrainer.fit(jtrain, jval)
        final = state_dict_from_jax_params(
            _np_tree(jtrainer.state.params),
            _np_tree(jtrainer.state.model_state.get("batch_stats")))

    model = _port_classifier(config, overrides)
    model.load_state_dict(start, strict=True)
    trainer = _port_fit(config, data_dir, tmp_path / "port", *overrides, model=model)
    assert len(trainer.history) == len(jtrainer.history) == 2
    for key in ("train/loss", "val/loss"):
        got = [row[key] for row in trainer.history]
        want = [row[key] for row in jtrainer.history]
        # eval mode subtracts the running mean, which trails the bias before
        # each BatchNorm; that bias has no true gradient, so Adam steps each
        # framework's round-off to up to lr (1e-3) a step, and the two
        # differ by that much after the 6 steps: 1e-3 there
        tol = 1e-3 if key == "val/loss" and config == AUDIO else 1e-4
        np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=key)
    sd = trainer.model.state_dict()
    for k, v in _buffers(final).items():
        # the running means follow those biases too
        np.testing.assert_allclose(sd[k].numpy(), v.numpy(), rtol=0, atol=1e-3,
                                   err_msg=k)


@pytest.mark.parametrize("extra", [[], MLP], ids=["cnn", "mlp"])
def test_resume_carries_the_running_statistics(data_dir, tmp_path, extra):
    straight = _port_fit(AUDIO, data_dir, tmp_path / "straight",
                         "training.max_epochs=3", *extra)
    _port_fit(AUDIO, data_dir, tmp_path / "resumed", "training.max_epochs=2", *extra)
    resumed = _port_fit(AUDIO, data_dir, tmp_path / "resumed",
                        "training.max_epochs=3", *extra, resume=True)
    assert [r["epoch"] for r in resumed.history] == [2]
    want, got = straight.model.state_dict(), resumed.model.state_dict()
    stats = _buffers(want)
    assert stats
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0,
                                   atol=1e-6, err_msg=k)


def _converter():
    spec = importlib.util.spec_from_file_location(
        "jax_ckpt_to_torch", ROOT / "scripts" / "jax_ckpt_to_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.main


def test_jax_ckpt_to_torch_carries_batch_stats(data_dir, tmp_path):
    overrides = NARROW[AUDIO] + NO_DROPOUT[AUDIO]
    jcfg = jax_load_config(AUDIO, overrides)
    jmodel = jax_classifier_from_config(jcfg)
    tx, _ = jax_optim.build_optimizer(jcfg.training, 2)
    feats = _inputs(AUDIO, seed=8, b=8)
    jfeats = {k: jnp.asarray(v) for k, v in feats.items()}
    with jax.default_matmul_precision("highest"):
        state = create_train_state(jmodel, tx, jfeats, jnp.ones((8, 1)),
                                   jax.random.PRNGKey(4))
        step = make_train_step(jmodel, tx, num_modalities=1, has_batch_stats=True,
                               donate=False)
        state, _ = step(state, jfeats, jnp.zeros(8, jnp.int32), jnp.arange(8),
                        jnp.ones(8), jax.random.PRNGKey(0))
        ref = np.asarray(jmodel.apply({"params": state.params, **state.model_state},
                                      jfeats, jnp.ones((8, 1)), deterministic=True))
    jax_ckpt = tmp_path / "best.ckpt"
    jax_save_checkpoint(jax_ckpt, state, {"epoch": 0, "step": 1})
    out = _converter()([str(jax_ckpt), str(tmp_path / "best.pt")])
    state_dict, meta = load_checkpoint(out)
    assert meta["converted_from"] == "best.ckpt" and meta["step"] == 1
    stats = _buffers(state_dict)
    assert sorted(stats) == sorted(
        f"audio_encoder.{bn}.{leaf}" for bn in ("bn1", "bn2")
        for leaf in ("running_mean", "running_var"))
    assert not np.allclose(stats["audio_encoder.bn1.running_var"].numpy(), 1.0)
    model = _port_classifier(AUDIO, NO_DROPOUT[AUDIO])
    model.load_state_dict(state_dict, strict=True)
    logits = forward(model, {k: torch.from_numpy(v) for k, v in feats.items()})
    np.testing.assert_allclose(logits.numpy(), ref, rtol=1e-4, atol=1e-4)


def test_video_only_trains_with_no_audio_input(cli_runs):
    root, _ = cli_runs["video", "port"]
    snapshot = json.loads((root / "run" / "results.json").read_text())["config"]
    assert snapshot["dataset"]["modalities"] == ["video"]
    best, _ = load_checkpoint(root / "run" / "best.ckpt")
    assert not any(k.startswith("audio_encoder") for k in best)
