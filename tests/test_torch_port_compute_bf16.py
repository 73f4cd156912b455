"""PyTorch port, the bf16 compute dtype (``runtime.compute_dtype=bfloat16``,
and ``dtype: bfloat16`` on the CNN and MLP encoders) at narrow widths on the
CPU, where every kernel wrapper runs its plain version, against the JAX
package with its recurrent kernels in interpret mode, as its own tests run
them:

* ``BatchNorm``'s bf16 form (flax's ``dtype=bfloat16``: float32
  statistics from the upcast input, the result rounded once, float32
  running statistics), the CNN and MLP encoders in bf16, train and eval;
* the four fusion kinds (early, late, hybrid cross-attention,
  uncertainty-weighted) in bf16;
* the classifier under ``runtime.compute_dtype=bfloat16`` on the flagship,
  the GRU and transformer configs, ``audio_only.yaml``, ``av_hybrid.yaml``
  and ``uncertainty.yaml``, narrowed: the JAX tree loads ``strict=True``
  and the bf16 logits agree;
* the cross-entropy on bf16 logits (optax's logsumexp, op by op in bf16);
* a 3-step train-step trajectory and a ``Trainer`` epoch against JAX's,
  and the train, predict, stream and sweep CLIs on the CPU.

Tolerances.  Both sides round to bf16 at flax's points, but not always to
the same ulp (XLA fuses some bf16 chains and keeps float32 inside), so
outputs are held to a few bf16 ulps (one = 2^-8 of the largest entry) and
gradients by the card's bf16 step rule: each side's bf16 gradient against
the float32 gradient of the same module, the port's distance within
max(2e-2, 2 x JAX's) of the largest gradient.  The classifiers' logits
take 4 ulps: JAX's default bf16 eval forward of an LSTM or GRU is an XLA
scan in bf16 arithmetic, up to ~3 ulps of h from the port's (JAX's
``inference_kernel=True``) numerics (``test_torch_port_recurrent_bf16.py``),
which the projection and the head carry to the logits."""

import contextlib
import json
from pathlib import Path

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
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
    SequenceEncoder as JaxSequenceEncoder,
)
from multimodal_emotion_detection_tpu.models.encoders import (
    SimpleMLPEncoder as JaxSimpleMLPEncoder,
)
from multimodal_emotion_detection_tpu.models import recurrent as jax_recurrent
from multimodal_emotion_detection_tpu.models.fusion import (
    build_fusion_model as jax_build_fusion_model,
)
from multimodal_emotion_detection_tpu.ops import lstm_vjp as jax_lstm_vjp
from multimodal_emotion_detection_tpu.training import optim as jax_optim
from multimodal_emotion_detection_tpu.training.loop import Trainer as JaxTrainer
from multimodal_emotion_detection_tpu.training.steps import (
    create_train_state,
    make_train_step,
)
from multimodal_emotion_detection_tpu_torch import train as port_train
from multimodal_emotion_detection_tpu_torch.config import ConfigError, load_config
from multimodal_emotion_detection_tpu_torch.data.loader import create_dataloaders
from multimodal_emotion_detection_tpu_torch.models.batchnorm import BatchNorm
from multimodal_emotion_detection_tpu_torch.models.classifier import (
    classifier_from_config,
)
from multimodal_emotion_detection_tpu_torch.models.encoders import (
    SequenceEncoder,
    SimpleMLPEncoder,
)
from multimodal_emotion_detection_tpu_torch.models.fusion import build_fusion_model
from multimodal_emotion_detection_tpu_torch.models.noise import Noise
from multimodal_emotion_detection_tpu_torch.models.recurrent import FusedStackedRNN
from multimodal_emotion_detection_tpu_torch.tools import predict as port_predict
from multimodal_emotion_detection_tpu_torch.training import optim
from multimodal_emotion_detection_tpu_torch.training.loop import Trainer
from multimodal_emotion_detection_tpu_torch.training.steps import (
    forward,
    softmax_cross_entropy,
    train_step,
)
from multimodal_emotion_detection_tpu_torch.utils.weights import (
    state_dict_from_jax_params,
)

ROOT = Path(__file__).resolve().parents[1]
BASE = str(ROOT / "configs" / "base.yaml")
AUDIO = str(ROOT / "configs" / "audio_only.yaml")
HYBRID = str(ROOT / "configs" / "av_hybrid.yaml")
UNCERTAINTY = str(ROOT / "configs" / "uncertainty.yaml")
ULP = 2.0 ** -8
BF16 = jnp.bfloat16
HALF = ["runtime.compute_dtype=bfloat16"]
# the flagship narrowed as the float32 files narrow it: log-mel in the
# forward, LSTM 2 x 128, frame encoder 16 -> 32, embeddings 16, head 32
NARROW = ["model.frontend.audio=logmel", "model.encoders.audio.hidden_dim=128",
          "model.encoders.video.input_dim=16", "model.encoders.video.hidden_dim=32",
          "model.output_dim=16", "model.hidden_dim=32"]
NO_DROPOUT = ["model.encoders.audio.dropout=0.0", "model.encoders.video.dropout=0.0",
              "model.dropout=0.0", "training.augmentation.modality_dropout=0.0"]
# (config file, its narrowing, the modalities)
MODELS = {
    "flagship": (BASE, NARROW, ("audio", "video")),
    "gru": (BASE, NARROW + ["model.encoders.audio.encoder_type=gru"], ("audio", "video")),
    "transformer": (BASE, NARROW[:1] + ["model.encoders.audio.encoder_type=transformer",
                                        "model.encoders.audio.hidden_dim=64"] + NARROW[2:],
                    ("audio", "video")),
    "audio_only": (AUDIO, ["model.encoders.audio.hidden_dim=32", "model.output_dim=16",
                           "model.hidden_dim=32"], ("audio",)),
    "av_hybrid": (HYBRID, NARROW[1:], ("audio", "video")),
    "uncertainty": (UNCERTAINTY, NARROW[1:], ("audio", "video")),
}
SAMPLES, FRAMES = 30 * 128, 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the suite runs several test workers on the same cores; at these tiny
    # shapes a multi-threaded torch only spins idle threads that slow them all
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@contextlib.contextmanager
def _jax_kernels():
    """JAX's recurrent kernels in interpret mode (its TPU routes: the
    residual-native pairs with float32 streams, its inference kernel on) at
    matmul precision highest, restored after (its trainer sets these module
    globals and leaves them)."""
    prev = (jax_lstm_vjp.set_fwd_kernel_mode("interpret"),
            jax_lstm_vjp.set_bwd_kernel_mode("interpret"),
            jax_lstm_vjp.set_res2_dtype("float32"), jax_lstm_vjp.set_res2_remat("off"),
            jax_lstm_vjp.set_res2_mode("auto"), jax_recurrent.set_infer_kernel_enabled(True))
    try:
        with jax.default_matmul_precision("highest"):
            yield
    finally:
        jax_lstm_vjp.set_res2_dtype(prev[2])
        jax_lstm_vjp.set_res2_remat(prev[3])
        jax_lstm_vjp.set_res2_mode(prev[4])
        jax_recurrent.set_infer_kernel_enabled(prev[5])
        jax_lstm_vjp.set_fwd_kernel_mode(prev[0])
        jax_lstm_vjp.set_bwd_kernel_mode(prev[1])


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _f32(a):
    """A torch tensor, a JAX array or a numpy array in float32 numpy."""
    if torch.is_tensor(a):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _ulps(got, want):
    got, want = _f32(got), _f32(want)
    return float(np.abs(got - want).max()) / (ULP * float(np.abs(want).max()))


def _bf16_exact(a):
    return np.asarray(jnp.asarray(a).astype(BF16).astype(jnp.float32))


def _grad_rule(port, jax16, jax32, what):
    """The port's and JAX's bf16 gradients (state-dict keyed) against JAX's
    float32 ones: the port within max(2e-2, 2 x JAX's distance) of the
    largest."""
    g_max = max(float(np.abs(g).max()) for g in jax32.values())

    def dist(side):
        return max(float(np.abs(np.asarray(side[k], np.float32) - g).max())
                   for k, g in jax32.items()) / g_max

    ours, theirs = dist(port), dist(jax16)
    print(f"{what}: gradient distance from float32, of the largest ({g_max:.3e}): port "
          f"{ours:.3e}, JAX bf16 {theirs:.3e}")
    assert ours <= max(2e-2, 2 * theirs), (what, ours, theirs)


def _state_grads(params_grads, stats=None):
    return {k: v.numpy() for k, v in state_dict_from_jax_params(
        _np_tree(params_grads), stats).items()}


# ------------------------------------------------------------ BatchNorm


@pytest.mark.parametrize("train", [True, False], ids=["batch_stats", "running"])
def test_batch_norm_bf16_form_matches_flax(train):
    rng = np.random.RandomState(0)
    # a mean several times the spread, as after the log-mel CNN's first conv
    x = _bf16_exact((rng.randn(4, 9, 24) * 0.5 + 3.0).astype(np.float32))
    jbn = fnn.BatchNorm(use_running_average=not train, dtype=BF16)
    stats0 = {"mean": rng.rand(24).astype(np.float32) + 2.5,
              "var": rng.rand(24).astype(np.float32) + 0.2}
    params = {"scale": rng.rand(24).astype(np.float32) + 0.5,
              "bias": rng.randn(24).astype(np.float32)}
    out, state = jbn.apply({"params": params, "batch_stats": stats0},
                           jnp.asarray(x).astype(BF16), mutable=["batch_stats"])
    assert out.dtype == BF16
    bn = BatchNorm(24)
    bn.load_state_dict({"weight": torch.from_numpy(params["scale"]),
                        "bias": torch.from_numpy(params["bias"]),
                        "running_mean": torch.from_numpy(stats0["mean"]),
                        "running_var": torch.from_numpy(stats0["var"])})
    got = bn(torch.from_numpy(x).to(torch.bfloat16), use_running_average=not train)
    assert got.dtype == torch.bfloat16
    assert bn.running_mean.dtype == bn.running_var.dtype == torch.float32
    # one rounding of float32 values that agree to round-off: at most 1 ulp
    assert _ulps(got, out) <= 1.0
    for key, name in (("mean", "running_mean"), ("var", "running_var")):
        np.testing.assert_allclose(getattr(bn, name).numpy(),
                                   np.asarray(state["batch_stats"][key]), rtol=0,
                                   atol=1e-6, err_msg=key)
    if train:
        assert not np.allclose(bn.running_mean.numpy(), stats0["mean"])


# ------------------------------------------------------------ encoders


def _encoder(kind, dtype):
    """(JAX module, port module) of the CNN or the MLP encoder, narrow."""
    jdt = {torch.float32: jnp.float32, torch.bfloat16: BF16}[dtype]
    if kind == "cnn":
        return (JaxSequenceEncoder(input_dim=8, hidden_dim=24, output_dim=12,
                                   encoder_type="cnn", dropout=0.0, dtype=jdt),
                SequenceEncoder(8, 24, 12, encoder_type="cnn", dropout=0.0, dtype=dtype))
    return (JaxSimpleMLPEncoder(input_dim=8, hidden_dim=24, output_dim=12, num_layers=2,
                                dropout=0.0, dtype=jdt),
            SimpleMLPEncoder(8, 24, 12, num_layers=2, dropout=0.0, dtype=dtype))


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("kind", ["cnn", "mlp2", "mlp3"])
def test_encoder_in_bf16_matches_jax(kind, train):
    rng = np.random.RandomState(3)
    shape = (6, 8) if kind == "mlp2" else (6, 11, 8)
    x = (rng.randn(*shape) * 2.0 + 0.5).astype(np.float32)
    (jmod16, port), (jmod32, _) = _encoder(kind[:3], torch.bfloat16), _encoder(
        kind[:3], torch.float32)
    variables = jmod32.init(jax.random.PRNGKey(1), jnp.asarray(x))
    params = _np_tree(variables["params"])
    stats = jax.tree_util.tree_map(lambda a: (rng.rand(*a.shape) + 0.5).astype(np.float32),
                                   _np_tree(variables["batch_stats"]))
    w = _bf16_exact(rng.randn(6, 12).astype(np.float32))

    def run(mod, p):
        return mod.apply({"params": p, "batch_stats": stats}, jnp.asarray(x),
                         deterministic=not train, mutable=["batch_stats"])

    with jax.default_matmul_precision("highest"):
        want, new_stats = run(jmod16, params)
        assert want.dtype == BF16

        def grads(mod):
            return _state_grads(jax.grad(lambda p: jnp.sum(
                run(mod, p)[0].astype(jnp.float32) * w))(params))

        g16, g32 = grads(jmod16), grads(jmod32)
    port.load_state_dict(state_dict_from_jax_params(params, stats), strict=True)
    port.train(train)
    got = port(torch.from_numpy(x), noise=Noise(torch.Generator().manual_seed(0)))
    assert got.dtype == torch.bfloat16
    print(f"{kind} {'train' if train else 'eval'}: {_ulps(got.detach(), want):.3f} ulps")
    assert _ulps(got.detach(), want) <= 3.0
    (got.float() * torch.from_numpy(w)).sum().backward()
    _grad_rule({k: p.grad for k, p in port.named_parameters()}, g16, g32, kind)
    want_stats = state_dict_from_jax_params({}, _np_tree(new_stats["batch_stats"]))
    for k, v in want_stats.items():
        buf = port.state_dict()[k]
        assert buf.dtype == torch.float32
        # statistics of bf16 values a rounding apart at most: 1e-3 of the
        # largest entry
        np.testing.assert_allclose(buf.numpy(), v.numpy(), rtol=0,
                                   atol=1e-3 * float(v.abs().max()), err_msg=k)


# ------------------------------------------------------------ fusions


FUSIONS = ["early", "late", "hybrid", "uncertainty"]


@pytest.mark.parametrize("kind", FUSIONS)
def test_fusion_in_bf16_matches_jax(kind):
    rng = np.random.RandomState(7)
    dims = {"audio": 16, "video": 16}
    feats = {m: _bf16_exact(rng.randn(6, 16).astype(np.float32)) for m in dims}
    mask = np.ones((6, 2), np.float32)
    mask[1, 0] = mask[4, 1] = 0.0  # a missing modality on two rows
    kw = dict(hidden_dim=32, num_heads=4, dropout=0.0)

    def jmod(dtype):
        return jax_build_fusion_model(kind, dims, 8, dtype=dtype, **kw)

    jfeats = {m: jnp.asarray(v).astype(BF16) for m, v in feats.items()}
    w = _bf16_exact(rng.randn(6, 8).astype(np.float32))

    def logits(out):
        return out[0] if isinstance(out, tuple) else out

    with jax.default_matmul_precision("highest"):
        variables = jmod(jnp.float32).init(jax.random.PRNGKey(2), jfeats, jnp.asarray(mask))
        params = _np_tree(variables["params"])
        if kind == "late":  # fusion weights off their uniform init
            params["fusion_logits"] = np.array([0.3, -0.4], np.float32)
        want = logits(jmod(BF16).apply({"params": params}, jfeats, jnp.asarray(mask)))
        assert want.dtype == BF16

        def grads(dtype):
            return _state_grads(jax.grad(lambda p: jnp.sum(logits(jmod(dtype).apply(
                {"params": p}, jfeats, jnp.asarray(mask))).astype(jnp.float32) * w))(params))

        g16, g32 = grads(BF16), grads(jnp.float32)
    port = build_fusion_model(kind, dims, 8, dtype=torch.bfloat16, **kw)
    port.load_state_dict(state_dict_from_jax_params(params), strict=True)
    port.eval()
    got = logits(port({m: torch.from_numpy(v) for m, v in feats.items()},
                      torch.from_numpy(mask)))
    assert got.dtype == torch.bfloat16
    print(f"{kind}: {_ulps(got.detach(), want):.3f} ulps")
    assert _ulps(got.detach(), want) <= 4.0
    (got.float() * torch.from_numpy(w)).sum().backward()
    _grad_rule({k: p.grad for k, p in port.named_parameters()}, g16, g32, kind)


# ------------------------------------------------------------ classifier


def _feats(modalities, n, seed):
    rng = np.random.RandomState(seed)
    out = {"audio": rng.randn(n, SAMPLES, 1).astype(np.float32),
           "video": rng.rand(n, FRAMES, 16).astype(np.float32)}
    return {m: out[m] for m in modalities}


@pytest.mark.parametrize("name", list(MODELS))
def test_classifier_in_bf16_compute_matches_jax(name):
    config, narrow, modalities = MODELS[name]
    overrides = narrow + HALF
    jmodel = jax_classifier_from_config(jax_load_config(config, overrides))
    feats = _feats(modalities, 6, seed=1)
    jfeats = {k: jnp.asarray(v) for k, v in feats.items()}
    mask = jnp.ones((6, len(modalities)), jnp.float32)
    with jax.default_matmul_precision("highest"):
        variables = jmodel.init(jax.random.PRNGKey(3), jfeats, mask)
        if "batch_stats" in variables:
            # a training-mode forward moves the running statistics off 0 / 1
            _, state = jmodel.apply(variables, jfeats, mask, deterministic=False,
                                    rngs={"dropout": jax.random.PRNGKey(1)},
                                    mutable=["batch_stats"])
            variables = {**variables, **state}
        ref = jmodel.apply(variables, jfeats, mask, deterministic=True)
        ref = ref[0] if isinstance(ref, tuple) else ref
    assert ref.dtype == BF16
    # the parameter tree is the float32 one
    assert all(leaf.dtype == jnp.float32
               for leaf in jax.tree_util.tree_leaves(variables["params"]))
    model = classifier_from_config(load_config(config, overrides))
    assert model.compute_dtype == torch.bfloat16
    model.load_state_dict(state_dict_from_jax_params(
        _np_tree(variables["params"]), _np_tree(variables.get("batch_stats")) or None),
        strict=True)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    logits = forward(model, {k: torch.from_numpy(v) for k, v in feats.items()})
    assert logits.dtype == torch.bfloat16 and logits.shape == (6, 8)
    with torch.no_grad():
        encoded = model.encode({k: torch.from_numpy(v) for k, v in feats.items()})
    assert all(e.dtype == torch.bfloat16 for e in encoded.values())
    print(f"{name}: logits {_ulps(logits, ref):.3f} ulps of the largest")
    assert _ulps(logits, ref) <= 4.0


def test_per_encoder_float32_overrides_the_bf16_compute_dtype():
    config, narrow, _ = MODELS["flagship"]
    model = classifier_from_config(load_config(
        config, narrow + HALF + ["model.encoders.audio.dtype=float32"]))
    rnn = next(m for m in model.modules() if isinstance(m, FusedStackedRNN))
    assert rnn.compute_dtype == torch.float32
    assert model.video_encoder.compute_dtype == torch.bfloat16
    assert model.compute_dtype == torch.bfloat16


def test_compute_dtype_is_validated():
    with pytest.raises(ConfigError, match="compute_dtype"):
        load_config(BASE, ["runtime.compute_dtype=float16"])


@pytest.mark.parametrize("seed", [0, 1])
def test_cross_entropy_on_bf16_logits_is_optax(seed):
    rng = np.random.RandomState(seed)
    logits = _bf16_exact((rng.randn(64, 8) * 3).astype(np.float32))
    labels = rng.randint(0, 8, 64)
    want = optax.softmax_cross_entropy_with_integer_labels(
        jnp.asarray(logits).astype(BF16), jnp.asarray(labels))
    got = softmax_cross_entropy(torch.from_numpy(logits).to(torch.bfloat16),
                                torch.from_numpy(labels))
    assert got.dtype == torch.bfloat16
    # each op rounded to bf16 as optax's: at most an ulp of a row's loss
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=2.0 ** -7, atol=0)
    # float32 logits: F.cross_entropy, as before
    f32 = softmax_cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels))
    np.testing.assert_allclose(f32.numpy(), np.asarray(
        optax.softmax_cross_entropy_with_integer_labels(jnp.asarray(logits),
                                                        jnp.asarray(labels))),
        rtol=1e-6, atol=1e-6)


# ------------------------------------------------------------ training


@pytest.mark.parametrize("name", ["flagship", "gru", "audio_only"])
def test_train_step_trajectory_in_bf16_compute_matches_jax(name):
    config, narrow, modalities = MODELS[name]
    overrides = narrow + NO_DROPOUT + HALF
    feats = _feats(modalities, 20, seed=1)
    labels = np.random.RandomState(2).randint(0, 8, 20).astype(np.int32)
    rng = np.random.RandomState(3)
    idx = [rng.randint(0, 20, 8).astype(np.int32) for _ in range(3)]
    valid = [np.ones(8, np.float32)] * 2 + [np.array([1] * 5 + [0] * 3, np.float32)]
    m = len(modalities)

    jcfg = jax_load_config(config, overrides)
    jmodel = jax_classifier_from_config(jcfg)
    tx, _ = jax_optim.build_optimizer(jcfg.training, 3)
    jfeats = {k: jnp.asarray(v) for k, v in feats.items()}
    with _jax_kernels():
        state = create_train_state(jmodel, tx, {k: v[:8] for k, v in jfeats.items()},
                                   jnp.ones((8, m)), jax.random.PRNGKey(4))
        has_bn = bool(state.model_state)
        start = state_dict_from_jax_params(
            _np_tree(state.params), _np_tree(state.model_state.get("batch_stats")) or None)
        step = make_train_step(jmodel, tx, num_modalities=m, has_batch_stats=has_bn,
                               donate=False)
        want = []
        for s in range(3):
            state, metrics = step(state, jfeats, jnp.asarray(labels), jnp.asarray(idx[s]),
                                  jnp.asarray(valid[s]), jax.random.PRNGKey(0))
            want.append(float(metrics["loss"]))

    cfg = load_config(config, overrides)
    model = classifier_from_config(cfg)
    model.load_state_dict(start, strict=True)
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
    print(f"{name}: losses port {got}, JAX {want}")
    # a float32 mean of bf16 per-row losses (one ulp of a loss of ~2 is
    # 2^-6) and Adam steps of lr x sign(g) where g is within bf16 round-off
    # of 0 on both sides: bound 1e-2
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-2)


def _write_splits(root, sizes, modalities=("audio", "video")):
    for seed, (split, n) in enumerate(sizes.items()):
        feats = _feats(modalities, n, 10 + seed)
        labels = np.random.RandomState(20 + seed).randint(0, 8, n).astype(np.int32)
        (root / split).mkdir(parents=True)
        for name, arr in (*feats.items(), ("labels", labels)):
            np.save(root / split / f"{name}.npy", arr)


def _run_overrides(data, save, extra=()):
    return MODELS["flagship"][1] + HALF + [
        "dataset.batch_size=8", "training.max_epochs=1", "runtime.platform=cpu",
        "runtime.epoch_scan=off", f"dataset.data_dir={data}",
        f"experiment.save_dir={save}", "experiment.name=run", *extra]


def _loaders(cfg, create):
    return create(cfg.dataset.name, cfg.dataset.data_dir, cfg.dataset.modalities,
                  batch_size=cfg.dataset.batch_size, seed=cfg.seed)


def test_trainer_epoch_in_bf16_compute_matches_jax(tmp_path):
    data = tmp_path / "data"
    _write_splits(data, {"train": 24, "val": 8, "test": 8})  # 3 steps, one val batch
    jcfg = jax_load_config(BASE, _run_overrides(data, tmp_path / "jax", NO_DROPOUT))
    jtrainer = JaxTrainer(jcfg, save_dir=tmp_path / "jax")
    jtrain, jval, _ = _loaders(jcfg, jax_create_dataloaders)
    with _jax_kernels():
        jtrainer._build(jtrain)
        params = _np_tree(jtrainer.state.params)
        jtrainer.fit(jtrain, jval)

    cfg = load_config(BASE, _run_overrides(data, tmp_path / "port", NO_DROPOUT))
    model = classifier_from_config(cfg)
    model.load_state_dict(state_dict_from_jax_params(params))
    trainer = Trainer(cfg, model=model, save_dir=tmp_path / "port" / "run")
    train_loader, val_loader, _ = _loaders(cfg, create_dataloaders)
    trainer.fit(train_loader, val_loader)
    for key in ("train/loss", "val/loss"):
        want = [row[key] for row in jtrainer.history]
        got = [row[key] for row in trainer.history]
        assert len(got) == len(want) == 1
        print(f"{key}: port {got}, JAX {want}")
        # as the step trajectory's: 1e-2
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-2, err_msg=key)


@pytest.mark.parametrize("name", ["av_hybrid", "uncertainty"])
def test_debug_and_visualize_in_bf16_compute(tmp_path, name):
    """The activation probe and the attention heatmap's matrix on bf16
    activations: float32 numbers, finite."""
    from multimodal_emotion_detection_tpu_torch.models.classifier import init_weights
    from multimodal_emotion_detection_tpu_torch.tools.debug import activation_stats
    from multimodal_emotion_detection_tpu_torch.tools.visualize import attention_matrix

    config, narrow, modalities = MODELS[name]
    data = tmp_path / "data"
    _write_splits(data, {"train": 8, "val": 8, "test": 8})
    cfg = load_config(config, narrow + HALF + [f"dataset.data_dir={data}",
                                              "dataset.batch_size=8"])
    model = init_weights(classifier_from_config(cfg), torch.Generator().manual_seed(0))
    loader = _loaders(cfg, create_dataloaders)[0]
    stats = activation_stats(cfg, loader, model)
    assert set(stats) == {*modalities, "logits"}
    assert all(np.isfinite(v) for s in stats.values() for v in s.values())
    features = {m: torch.from_numpy(a[:4]) for m, a in _feats(modalities, 4, 3).items()}
    matrix = attention_matrix(model, features, torch.ones(4, 2), list(modalities))
    assert matrix.dtype == np.float32 and np.isfinite(matrix).all()
    assert matrix.shape == ((2, 2) if name == "av_hybrid" else (1, 2))


def test_train_predict_stream_and_sweep_clis_in_bf16_compute(tmp_path):
    from multimodal_emotion_detection_tpu_torch.tools import stream as port_stream
    from multimodal_emotion_detection_tpu_torch.tools import sweep as port_sweep

    data = tmp_path / "data"
    _write_splits(data, {"train": 16, "val": 8, "test": 8})
    overrides = _run_overrides(data, tmp_path)
    results = port_train.main(["--config", BASE, *overrides])
    assert results and all(np.isfinite(v) for v in results.values())
    run = tmp_path / "run"
    for rel in ("results.json", "best.ckpt", "confusion_matrix.npy"):
        assert (run / rel).exists(), rel
    metrics = port_predict.main(["--checkpoint", str(run / "best.ckpt"), "--config", BASE,
                                 "--split", "test", "--out", str(tmp_path / "pred"),
                                 *overrides])
    logits = np.load(tmp_path / "pred" / "logits.npy")
    # written in float32, from bf16 logits
    assert logits.dtype == np.float32 and logits.shape == (8, 8)
    assert np.isfinite(logits).all()
    assert np.array_equal(logits, _bf16_exact(logits))
    assert json.loads((tmp_path / "pred" / "metrics.json").read_text()) == metrics

    rng = np.random.RandomState(4)
    np.save(tmp_path / "audio.npy", rng.randn(SAMPLES + 5 * 1280, 1).astype(np.float32))
    np.save(tmp_path / "video.npy", rng.rand(FRAMES + 5, 16).astype(np.float32))
    out = port_stream.main([
        "--checkpoint", str(run / "best.ckpt"), "--config", BASE,
        "--input", f"audio={tmp_path / 'audio.npy'}",
        "--input", f"video={tmp_path / 'video.npy'}", "--window", f"audio={SAMPLES}",
        "--window", f"video={FRAMES}", "--hop", "audio=1280", "--hop", "video=1",
        "--microbatch", "4", "--out", str(tmp_path / "stream"), *overrides])
    assert out["windows"] == 6
    assert np.isfinite(np.load(tmp_path / "stream" / "probs.npy")).all()

    # the step-major sweep of two learning rates, each trained in bf16 compute
    runs = port_sweep.main(["--config", BASE, "--vmap-lrs", "1e-3,5e-4",
                            "--out", str(tmp_path / "sweep"), *overrides])
    assert [r["learning_rate"] for r in runs] == [1e-3, 5e-4]
    assert all(np.isfinite(r["best_val_loss"]) for r in runs)
