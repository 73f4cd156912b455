"""PyTorch port, the fusion library: the attention and fusion modules, the
library classifier and its train step, against the JAX package at small
widths, with the JAX weights carried across by
``state_dict_from_jax_params`` (``strict=True``).

Tolerances: a module's output 1e-5 absolute (flax's LayerNorm takes the
variance as E[x^2] - E[x]^2, torch's in two passes: ~1e-6 apart at these
widths); the whole classifier's logits 1e-4, as
``tests/test_torch_port_model.py`` (the log-mel and LSTM routes add their
own envelope, ``ops/envelope.py``); one train step at dropout 0: loss 1e-5,
gradients 1e-4 of the largest.  Masks: none, all present, one modality
dropped (each in half the rows), both dropped in some rows, and a modality
absent from the features."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_emotion_detection_tpu.config import load_config as jax_load_config
from multimodal_emotion_detection_tpu.models import attention as jatt
from multimodal_emotion_detection_tpu.models import fusion as jfus
from multimodal_emotion_detection_tpu.models.classifier import (
    classifier_from_config as jax_classifier_from_config,
)
from multimodal_emotion_detection_tpu.training.steps import (
    _cross_entropy as jax_cross_entropy,
)
from multimodal_emotion_detection_tpu_torch.config import load_config
from multimodal_emotion_detection_tpu_torch.models import attention as att
from multimodal_emotion_detection_tpu_torch.models import fusion as fus
from multimodal_emotion_detection_tpu_torch.models.classifier import (
    classifier_from_config,
)
from multimodal_emotion_detection_tpu_torch.models.noise import Noise
from multimodal_emotion_detection_tpu_torch.training import optim
from multimodal_emotion_detection_tpu_torch.training.steps import forward, train_step
from multimodal_emotion_detection_tpu_torch.utils.weights import (
    state_dict_from_jax_params,
)

B, C, HID, HEADS = 6, 5, 16, 4
DIMS = {"audio": 8, "video": 12}
MASKS = {
    "none": None,
    "all": np.ones((B, 2), np.float32),
    "drop_one": np.array([[1, 0], [0, 1]] * (B // 2), np.float32),
    "drop_both": np.array([[1, 1], [0, 0], [1, 0]] * (B // 3), np.float32),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the suite runs several test workers on the same cores; at these tiny
    # shapes a multi-threaded torch only spins idle threads that slow them all
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.set_num_threads(threads)


def _carry(variables, port_module):
    """Load the JAX module's parameters into the port module, strictly."""
    port_module.load_state_dict(state_dict_from_jax_params(
        jax.tree_util.tree_map(np.asarray, variables["params"])))
    return port_module.eval()


def _t(x):
    return None if x is None else torch.from_numpy(np.asarray(x))


def _feats(seed, dims=DIMS, b=B):
    rng = np.random.RandomState(seed)
    return {k: rng.randn(b, d).astype(np.float32) for k, d in dims.items()}


def _close(out, ref, atol=1e-5):
    np.testing.assert_allclose(np.asarray(out.detach()), np.asarray(ref), rtol=0,
                               atol=atol)


# ---------------------------------------------------------------- attention


@pytest.mark.parametrize("shape,kind", [
    ((B,), "bool"), ((B,), "float"), ((B, 1), "bool"), ((B, 1), "float"),
    ((B, 3), "bool"), ((B, 3), "float"), ((B, 3), "int"),
])
def test_normalize_key_mask_matches_jax(shape, kind):
    rng = np.random.RandomState(len(shape) * 10 + shape[-1])
    raw = rng.rand(*shape)
    mask = {"bool": raw > 0.5, "float": (raw > 0.5).astype(np.float32),
            "int": (raw > 0.5).astype(np.int32)}[kind]
    ref = np.asarray(jatt.normalize_key_mask(jnp.asarray(mask), B, 3))
    out = att.normalize_key_mask(torch.from_numpy(mask), B, 3)
    assert out.dtype == torch.bool and out.shape == (B, 3)
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("shape", [(B, 4), (B, 3, 1), (B, 1, 1)])
def test_normalize_key_mask_refuses_what_jax_refuses(shape):
    mask = np.ones(shape, np.float32)
    with pytest.raises(ValueError):
        jatt.normalize_key_mask(jnp.asarray(mask), B, 3)
    with pytest.raises(ValueError):
        att.normalize_key_mask(torch.from_numpy(mask), B, 3)


@pytest.mark.parametrize("mask_kind", list(MASKS))
@pytest.mark.parametrize("query_2d", [True, False], ids=["q2d", "q3d"])
def test_cross_modal_attention_matches_jax(mask_kind, query_2d):
    rng = np.random.RandomState(1)
    q = rng.randn(B, 8).astype(np.float32) if query_2d else rng.randn(B, 3, 8).astype(np.float32)
    kv = rng.randn(B, 2, 12).astype(np.float32)
    mask = MASKS[mask_kind]
    jm = jatt.CrossModalAttention(query_dim=8, key_dim=12, hidden_dim=HID,
                                  num_heads=HEADS, dropout=0.1)
    with jax.default_matmul_precision("highest"):
        variables = jm.init(jax.random.PRNGKey(0), q, kv, kv, mask=mask)
        ref_out, ref_attn = jm.apply(variables, q, kv, kv, mask=mask)
    pm = _carry(variables, att.CrossModalAttention(8, 12, HID, HEADS, 0.1))
    out, attn = pm(_t(q), _t(kv), _t(kv), mask=_t(mask))
    assert out.shape == ref_out.shape and attn.shape == ref_attn.shape
    _close(out, ref_out)
    _close(attn, ref_attn)
    if mask_kind == "drop_both":
        assert float(attn[1].detach().abs().max()) == 0.0  # every key masked: zero, not NaN


@pytest.mark.parametrize("masked", [False, True])
def test_temporal_attention_and_pooling_match_jax(masked):
    rng = np.random.RandomState(2)
    seq = rng.randn(B, 7, 10).astype(np.float32)
    mask = None
    if masked:
        mask = (rng.rand(B, 7) > 0.4).astype(np.float32)
        mask[:, 0] = 1.0  # a row with no valid step softmaxes to NaN in both
    jm = jatt.TemporalAttention(feature_dim=10, hidden_dim=HID, num_heads=HEADS)
    with jax.default_matmul_precision("highest"):
        variables = jm.init(jax.random.PRNGKey(1), seq, mask)
        ref_out, ref_w = jm.apply(variables, seq, mask)
        ref_pool = jatt.TemporalAttention.pool_sequence(jnp.asarray(seq), ref_w)
    pm = _carry(variables, att.TemporalAttention(10, HID, HEADS))
    out, w = pm(_t(seq), _t(mask))
    _close(out, ref_out)
    _close(w, ref_w)
    _close(att.TemporalAttention.pool_sequence(_t(seq), w), ref_pool)


@pytest.mark.parametrize("mask_kind", ["none", "drop_one", "drop_both"])
def test_pairwise_modality_attention_matches_jax(mask_kind):
    dims = {"audio": 8, "video": 12, "imu": 6}
    feats = _feats(3, dims)
    mask = {"none": None,
            "drop_one": np.array([[1, 0, 1], [0, 1, 1]] * (B // 2), np.float32),
            "drop_both": np.array([[1, 1, 1], [0, 0, 1], [1, 0, 0]] * (B // 3),
                                  np.float32)}[mask_kind]
    jm = jatt.PairwiseModalityAttention(modality_dims=dims, hidden_dim=HID,
                                        num_heads=HEADS)
    with jax.default_matmul_precision("highest"):
        variables = jm.init(jax.random.PRNGKey(2), feats, mask)
        ref, ref_maps = jm.apply(variables, feats, mask)
    pm = _carry(variables, att.PairwiseModalityAttention(dims, HID, HEADS))
    out, maps = pm({k: _t(v) for k, v in feats.items()}, _t(mask))
    assert list(out) == list(ref) and sorted(maps) == sorted(ref_maps)
    for name in ref:
        _close(out[name], ref[name])
    for name in ref_maps:
        _close(maps[name], ref_maps[name])


# ------------------------------------------------------------------- fusion


def _fusion_pair(kind, **kw):
    if kind == "early":
        return (jfus.EarlyFusion(modality_dims=DIMS, hidden_dim=HID, num_classes=C, **kw),
                fus.EarlyFusion(DIMS, C, hidden_dim=HID, **kw))
    if kind == "late":
        return (jfus.LateFusion(modality_dims=DIMS, hidden_dim=HID, num_classes=C),
                fus.LateFusion(DIMS, C, hidden_dim=HID))
    if kind == "hybrid":
        return (jfus.HybridFusion(modality_dims=DIMS, hidden_dim=HID, num_classes=C,
                                  num_heads=HEADS),
                fus.HybridFusion(DIMS, C, hidden_dim=HID, num_heads=HEADS))
    return (jfus.LateFusionWithUncertainty(modality_dims=DIMS, num_classes=C,
                                           hidden_dim=HID, dropout=0.3),
            fus.LateFusionWithUncertainty(DIMS, C, hidden_dim=HID, dropout=0.3))


def _flat(out):
    """A fusion's output as a flat {name: array}."""
    if not isinstance(out, tuple):
        return {"logits": out}
    logits, aux = out
    flat = {"logits": logits}
    for k, v in aux.items():
        if isinstance(v, dict):
            flat.update({f"{k}.{n}": a for n, a in v.items()})
        else:
            flat[k] = v
    return flat


@pytest.mark.parametrize("mask_kind", list(MASKS) + ["absent"])
@pytest.mark.parametrize("kind", ["early", "early_learned", "late", "hybrid",
                                  "uncertainty"])
def test_fusion_matches_jax(kind, mask_kind):
    kw = {"learned_missing": True} if kind == "early_learned" else {}
    jm, pm = _fusion_pair(kind.replace("_learned", ""), **kw)
    feats = _feats(4)
    mask = MASKS["drop_both" if mask_kind == "absent" else mask_kind]
    if mask_kind == "absent":
        del feats["video"]
    if mask is None and kind == "uncertainty":
        mask = MASKS["all"]  # it requires one, in both packages
    init_mask = MASKS["all"] if mask is None else mask  # creates missing_<m>
    with jax.default_matmul_precision("highest"):
        variables = jm.init(jax.random.PRNGKey(5), _feats(4), init_mask)
        if kw:  # the learned tokens are zeros at init: make them count
            params = jax.tree_util.tree_map(np.asarray, variables["params"])
            params = {**params, "missing_audio": np.full(8, 0.5, np.float32),
                      "missing_video": np.linspace(-1, 1, 12).astype(np.float32)}
            variables = {"params": params}
        ref = _flat(jm.apply(variables, feats, mask))
    pm = _carry(variables, pm)
    out = _flat(pm({k: _t(v) for k, v in feats.items()}, _t(mask)))
    assert sorted(out) == sorted(ref)
    for name in ref:
        _close(out[name], ref[name])
    assert np.isfinite(out["logits"].detach().numpy()).all()


def test_hybrid_attention_outputs_match_jax():
    jm, pm = _fusion_pair("hybrid")
    feats, mask = _feats(6), MASKS["drop_both"]
    with jax.default_matmul_precision("highest"):
        variables = jm.init(jax.random.PRNGKey(6), feats, mask)
        ref_logits, ref_info = jm.apply(variables, feats, mask, return_attention=True)
    pm = _carry(variables, pm)
    logits, info = pm({k: _t(v) for k, v in feats.items()}, _t(mask),
                      return_attention=True)
    _close(logits, ref_logits)
    _close(info["fusion_weights"], ref_info["fusion_weights"])
    _close(info["H_att"], ref_info["H_att"])
    for name in DIMS:
        _close(info["per_modality_attention"][name],
               ref_info["per_modality_attention"][name])


@pytest.mark.parametrize("mask_kind", ["all", "drop_one", "drop_both"])
def test_adaptive_and_uncertainty_weights_match_jax(mask_kind):
    feats, mask = _feats(7), MASKS[mask_kind]
    names = list(DIMS)
    ref = jfus.compute_adaptive_weights(feats, jnp.asarray(mask), names)
    out = fus.compute_adaptive_weights({k: _t(v) for k, v in feats.items()},
                                       _t(mask), names)
    _close(out, ref, atol=1e-6)
    rng = np.random.RandomState(8)
    logits = rng.randn(B, 2, C).astype(np.float32)
    unc = rng.rand(B, 2).astype(np.float32) + 0.1
    ref_f, ref_w = jfus.uncertainty_weighted_fusion(jnp.asarray(logits), jnp.asarray(unc),
                                                    jnp.asarray(mask))
    f, w = fus.uncertainty_weighted_fusion(_t(logits), _t(unc), _t(mask))
    _close(f, ref_f, atol=1e-6)
    _close(w, ref_w, atol=1e-6)


def test_build_fusion_model_routes_like_jax():
    for name in ("early", "late", "hybrid", *sorted(fus._UNCERTAINTY_ALIASES)):
        j = jfus.build_fusion_model(name, DIMS, C, hidden_dim=HID, num_heads=HEADS,
                                    dropout=0.2)
        p = fus.build_fusion_model(name, DIMS, C, hidden_dim=HID, num_heads=HEADS,
                                   dropout=0.2)
        assert type(p).__name__ == type(j).__name__
        assert p.dropout == j.dropout
    with pytest.raises(ValueError, match="Unknown fusion type"):
        fus.build_fusion_model("attention", DIMS, C)
    with pytest.raises(ValueError, match="modality_mask"):
        fus.LateFusionWithUncertainty(DIMS, C)({"audio": torch.zeros(2, 8)}, None)


# --------------------------------------------------------------- classifier

NARROW = [
    "model.encoders.audio.hidden_dim=32",
    "model.encoders.video.input_dim=16",
    "model.encoders.video.hidden_dim=32",
    "model.output_dim=16",
    "model.hidden_dim=32",
]
CB, SAMPLES, FRAMES = 6, 40 * 128, 4
CLASSIFIERS = {
    "hybrid": ("configs/av_hybrid.yaml", []),
    "uncertainty": ("configs/uncertainty.yaml", []),
    "early": ("configs/av_hybrid.yaml", ["model.fusion_type=early"]),
    "late": ("configs/av_hybrid.yaml", ["model.fusion_type=late"]),
}


def _clf_inputs(seed=0):
    rng = np.random.RandomState(seed)
    feats = {"audio": rng.randn(CB, SAMPLES, 1).astype(np.float32),
             "video": rng.rand(CB, FRAMES, 16).astype(np.float32)}
    mask = np.array([[1, 1], [1, 0], [0, 1]] * (CB // 3), np.float32)
    return feats, mask


@pytest.mark.parametrize("jax_kernels", [False, True],
                         ids=["jax_scan", "jax_pallas_interpret"])
@pytest.mark.parametrize("fusion", list(CLASSIFIERS))
def test_library_classifier_logits_match_jax(fusion, jax_kernels):
    path, extra = CLASSIFIERS[fusion]
    overrides = NARROW + extra + [
        f"model.encoders.audio.inference_kernel={str(jax_kernels).lower()}"]
    jmodel = jax_classifier_from_config(jax_load_config(path, overrides))
    if jax_kernels:
        jmodel = jmodel.clone(frontend_interpret=True)
    feats, mask = _clf_inputs()
    jfeats = {k: jnp.asarray(v) for k, v in feats.items()}
    with jax.default_matmul_precision("highest"):
        variables = jmodel.init(jax.random.PRNGKey(3), jfeats, mask)
        ref = np.asarray(jmodel.apply(variables, jfeats, mask, deterministic=True))

    model = classifier_from_config(load_config(path, overrides))
    model.load_state_dict(state_dict_from_jax_params(
        jax.tree_util.tree_map(np.asarray, variables["params"])))
    logits = forward(model, {k: _t(v) for k, v in feats.items()}, _t(mask))
    assert logits.shape == (CB, 8)
    np.testing.assert_allclose(logits.numpy(), ref, rtol=1e-4, atol=1e-4)


def test_library_classifier_aux_matches_jax():
    path, extra = CLASSIFIERS["uncertainty"]
    jmodel = jax_classifier_from_config(jax_load_config(path, NARROW + extra))
    feats, mask = _clf_inputs(1)
    with jax.default_matmul_precision("highest"):
        variables = jmodel.init(jax.random.PRNGKey(4), feats, mask)
        ref_logits, ref_aux = jmodel.apply(variables, feats, mask, return_aux=True)
    model = classifier_from_config(load_config(path, NARROW + extra)).eval()
    model.load_state_dict(state_dict_from_jax_params(
        jax.tree_util.tree_map(np.asarray, variables["params"])))
    with torch.no_grad():
        logits, aux = model({k: _t(v) for k, v in feats.items()}, _t(mask),
                            return_aux=True)
    assert sorted(aux) == sorted(ref_aux)
    np.testing.assert_allclose(logits.numpy(), ref_logits, rtol=1e-4, atol=1e-4)
    for key in ("per_modality_logits", "fusion_weights", "uncertainties"):
        np.testing.assert_allclose(aux[key].numpy(), ref_aux[key], rtol=1e-4,
                                   atol=1e-4, err_msg=key)
    for m in ("audio", "video"):
        np.testing.assert_allclose(aux["encoded"][m].numpy(), ref_aux["encoded"][m],
                                   rtol=1e-4, atol=1e-4)


NO_DROPOUT = ["model.dropout=0.0", "model.encoders.audio.dropout=0.0",
              "model.encoders.video.dropout=0.0",
              "training.augmentation.modality_dropout=0.0"]


@pytest.mark.parametrize("fusion", ["hybrid", "uncertainty"])
def test_library_train_step_matches_jax_grad(fusion):
    path, extra = CLASSIFIERS[fusion]
    overrides = NARROW + extra + NO_DROPOUT
    jmodel = jax_classifier_from_config(jax_load_config(path, overrides))
    feats, _ = _clf_inputs(2)
    labels = np.arange(CB, dtype=np.int32) % 8
    valid = np.array([1, 1, 1, 1, 1, 0], np.float32)
    mask = np.ones((CB, 2), np.float32) * valid[:, None]
    with jax.default_matmul_precision("highest"):
        variables = jmodel.init(jax.random.PRNGKey(5), feats, mask)

        def loss_fn(params):
            logits = jmodel.apply({"params": params}, feats, mask, deterministic=False,
                                  rngs={"dropout": jax.random.PRNGKey(0)})
            return jax_cross_entropy(logits, jnp.asarray(labels), jnp.asarray(valid))

        ref_loss, ref_grads = jax.value_and_grad(loss_fn)(variables["params"])
    ref_grads = state_dict_from_jax_params(jax.tree_util.tree_map(np.asarray, ref_grads))

    cfg = load_config(path, overrides)
    model = classifier_from_config(cfg)
    model.load_state_dict(state_dict_from_jax_params(
        jax.tree_util.tree_map(np.asarray, variables["params"])))
    opt, _ = optim.build_optimizer(cfg.training, model.parameters(), 1)
    metrics = train_step(
        model, opt, {k: _t(v) for k, v in feats.items()},
        torch.from_numpy(labels.astype(np.int64)), torch.arange(CB), _t(valid),
        lr=0.0, clip_norm=0.0, modality_dropout=0.0,
        noise=Noise(torch.Generator().manual_seed(0)))
    assert abs(float(metrics["loss"]) - float(ref_loss)) <= 1e-5
    grads = {k: p.grad for k, p in model.named_parameters()}
    assert sorted(grads) == sorted(ref_grads)
    g_max = max(float(g.abs().max()) for g in ref_grads.values())
    worst = max(float((grads[k] - g).abs().max()) for k, g in ref_grads.items())
    assert worst <= 1e-4 * g_max, (worst, g_max)
