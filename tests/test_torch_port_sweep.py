"""PyTorch port, the sweep tools against the JAX package: the step-major
grid step from JAX ``init_sweep_state``'s member parameters against JAX
``make_vmapped_train_step``'s per-member losses and parameters over 5
steps (1e-4; the MLP classifiers of the JAX package's own sweep tests,
BatchNorm members with their running statistics), a grid member against a
standalone ``member_ids`` run bit for bit (the narrow flagship too, its
LSTM dropout masks replayed), the monotone coupling of the modality
draws, the 12 tags and result keys of ``tools.sweep --vmap-grid`` /
``--vmap-lrs`` against JAX's, ``run_sweep``'s harvest against JAX's, and
``train_ensemble`` feeding ``ensemble_predict``."""

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
from multimodal_emotion_detection_tpu.ops.lstm_vjp import (
    set_bwd_kernel_mode,
    set_fwd_kernel_mode,
)
from multimodal_emotion_detection_tpu.parallel import vmap_sweep as jvs
from multimodal_emotion_detection_tpu.tools import sweep as jax_sweep
from multimodal_emotion_detection_tpu_torch.config import load_config
from multimodal_emotion_detection_tpu_torch.data.dataset import MultimodalArrays
from multimodal_emotion_detection_tpu_torch.data.loader import MultimodalLoader
from multimodal_emotion_detection_tpu_torch.data.masking import (
    modality_dropout_mask,
    modality_dropout_mask_from_uniforms,
)
from multimodal_emotion_detection_tpu_torch.data.synthetic import synthetic_split
from multimodal_emotion_detection_tpu_torch.models.classifier import (
    classifier_from_config,
)
from multimodal_emotion_detection_tpu_torch.parallel import vmap_sweep as pvs
from multimodal_emotion_detection_tpu_torch.tools import sweep as port_sweep
from multimodal_emotion_detection_tpu_torch.uncertainty.ensemble import (
    ensemble_predict,
)
from multimodal_emotion_detection_tpu_torch.utils.weights import (
    state_dict_from_jax_params,
)

ROOT = Path(__file__).resolve().parents[1]
TINY = [
    "dataset.name=synthetic", "dataset.modalities=[s1,s2]", "dataset.num_samples=48",
    "dataset.num_samples_eval=40", "dataset.num_classes=4", "dataset.batch_size=16",
    "dataset.sequence_length=6", "dataset.modality_dim=8",
    "model.output_dim=8", "model.hidden_dim=16", "model.use_modality_mask=true",
    "training.max_epochs=1", "training.learning_rate=1e-2", "runtime.platform=cpu",
]


def _mlp(bn: bool, dropout: float = 0.0):
    return [("model.encoders={s1: {type: mlp, input_dim: 8, hidden_dim: 16, num_layers: 1, "
             f"batch_norm: {str(bn).lower()}, dropout: {dropout}}}, s2: {{type: mlp, "
             f"input_dim: 8, hidden_dim: 16, num_layers: 1, batch_norm: false, "
             f"dropout: {dropout}}}}}")]


# its true gradient is zero (BatchNorm takes out the bias of the Dense
# before it): Adam scales either framework's round-off to a step of at
# most ~lr each
SHIFT_INVARIANT = {"s1_encoder.dense_0.bias"}
FLAGSHIP = ["model.frontend.audio=logmel", "model.encoders.audio.hidden_dim=32",
            "model.encoders.video.input_dim=16", "model.encoders.video.hidden_dim=32",
            "model.output_dim=16", "model.hidden_dim=32"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the suite runs several test workers on the same cores; at these tiny
    # shapes a multi-threaded torch only spins idle threads that slow them all
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _case(name):
    """(config path, overrides, features, labels) of a parity case."""
    if name == "flagship":
        rng = np.random.RandomState(0)
        feats = {"audio": rng.randn(20, 40 * 128, 1).astype(np.float32),
                 "video": rng.rand(20, 4, 16).astype(np.float32)}
        return (str(ROOT / "configs/base.yaml"), FLAGSHIP, feats,
                rng.randint(0, 8, 20).astype(np.int32))
    arrays = synthetic_split("train", ["s1", "s2"], 1, num_samples=20, num_classes=4,
                             modality_dim=8, sequence_length=6)
    return None, TINY + _mlp(bn=name == "mlp_bn"), arrays.features, arrays.labels


@pytest.mark.parametrize("grid", [False, True], ids=["lr_sweep", "grid"])
@pytest.mark.parametrize("name", ["mlp", "mlp_bn"])
def test_members_match_jax_vmapped_step(name, grid):
    config, overrides, feats, labels = _case(name)
    lrs, mdrops = [5e-4, 1e-3], ([0.0, 0.0] if grid else None)
    b, m = 8, len(feats)
    rng = np.random.RandomState(1)
    idx = [rng.randint(0, 20, b).astype(np.int32) for _ in range(5)]
    valid = [np.ones(b, np.float32)] * 4 + [np.array([1] * 5 + [0] * 3, np.float32)]

    jmodel = jax_classifier_from_config(jax_load_config(config, overrides))
    jfeats = {k: jnp.asarray(v) for k, v in feats.items()}
    prev_f, prev_b = set_fwd_kernel_mode("off"), set_bwd_kernel_mode("off")
    try:
        with jax.default_matmul_precision("highest"):
            state = jvs.init_sweep_state(
                jmodel, {k: v[:b] for k, v in jfeats.items()}, jnp.ones((b, m)), lrs,
                1.0, 5, mdrops=mdrops)
            init = [(_np(jvs.member_params(state, i)),
                     _np(jax.tree_util.tree_map(lambda x: x[i], state.model_state)))
                    for i in range(2)]
            step = jvs.make_vmapped_train_step(jmodel, m, 0.0, 1.0, 1e-4)
            want = []
            for s in range(5):
                state, metrics = step(state, jfeats, jnp.asarray(labels),
                                      jnp.asarray(idx[s]), jnp.asarray(valid[s]),
                                      jax.random.PRNGKey(0))
                want.append((np.asarray(metrics["loss"]), [
                    state_dict_from_jax_params(
                        _np(jvs.member_params(state, i)),
                        _np(jax.tree_util.tree_map(lambda x: x[i], state.model_state))
                        .get("batch_stats"))
                    for i in range(2)]))
    finally:
        set_fwd_kernel_mode(prev_f), set_bwd_kernel_mode(prev_b)

    model = classifier_from_config(load_config(config, overrides))
    pstate = pvs.init_sweep_state(model, lrs, 5, mdrops=mdrops)
    for member, (params, ms) in zip(pstate.members, init):
        member.load_state_dict(state_dict_from_jax_params(params, ms.get("batch_stats")))
    start = [pvs.member_params(pstate, i) for i in range(2)]
    pstep = pvs.make_vmapped_train_step(m, 0.0, 1.0, 1e-4)
    tfeats = {k: torch.from_numpy(v) for k, v in feats.items()}
    tlabels = torch.from_numpy(labels.astype(np.int64))
    for s in range(5):
        metrics = pstep(pstate, tfeats, tlabels, torch.from_numpy(idx[s].astype(np.int64)),
                        torch.from_numpy(valid[s]), 0)
        want_loss, want_params = want[s]
        np.testing.assert_allclose(metrics["loss"].numpy(), want_loss, rtol=0, atol=1e-4,
                                   err_msg=f"losses, step {s}")
        for i, member in enumerate(pstate.members):
            got = member.state_dict()
            assert got.keys() == want_params[i].keys()
            for k, v in want_params[i].items():
                if k in SHIFT_INVARIANT and name == "mlp_bn":
                    moved = (got[k] - start[i][k]).abs().max()
                    assert moved <= 1.1 * lrs[i] * (s + 1), (i, k, s)
                    continue
                np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0, atol=1e-4,
                                           err_msg=f"member {i} {k}, step {s}")
    assert pstate.step == 5


def _loaders(overrides, n=40):
    cfg = load_config(None, overrides)
    arrays = {s: synthetic_split(s, ["s1", "s2"], cfg.seed, num_samples=n,
                                 num_samples_eval=n, num_classes=4, modality_dim=8,
                                 sequence_length=6) for s in ("train", "val")}
    return (cfg, MultimodalLoader(arrays["train"], 16, shuffle=True, seed=cfg.seed),
            MultimodalLoader(arrays["val"], 16))


@pytest.mark.parametrize("name", ["mlp_bn", "flagship"])
def test_grid_member_equals_a_standalone_member_ids_run(name):
    # dropout in the encoders and the head: member 0 draws the masks (the
    # flagship's LSTM keep masks among them), the others replay them;
    # modality dropout at each member's own rate
    if name == "flagship":
        # base.yaml's dropout rates
        config, overrides, feats, labels = _case("flagship")
        cfg = load_config(config, overrides)
        arrays = MultimodalArrays(feats, labels, ["audio", "video"])
        train = MultimodalLoader(arrays, 8, shuffle=True, seed=cfg.seed)
        val = MultimodalLoader(arrays, 8)
        epochs = 1
    else:
        cfg, train, val = _loaders(TINY + _mlp(bn=True, dropout=0.2) + ["model.dropout=0.3"])
        epochs = 2
    model = classifier_from_config(cfg)
    members = [(1e-3, 0.0), (2e-3, 0.5), (1e-3, 0.5)]
    grid, hist = pvs._train_members(model, train, val, [lr for lr, _ in members], epochs,
                                    0.0, 1.0, 1e-4, 7, mdrops=[md for _, md in members])
    for i in (0, 2):
        solo, solo_hist = pvs._train_members(model, train, val, [members[i][0]], epochs,
                                             0.0, 1.0, 1e-4, 7, mdrops=[members[i][1]],
                                             member_ids=[i])
        want = pvs.member_params(solo, 0)
        for k, v in pvs.member_params(grid, i).items():
            torch.testing.assert_close(v, want[k], rtol=0, atol=0, msg=k)
        assert [h["val_loss"][i] for h in hist] == [h["val_loss"][0] for h in solo_hist]
    # the members did train apart
    a, b = pvs.member_params(grid, 0), pvs.member_params(grid, 2)
    assert any(not torch.equal(a[k], b[k]) for k in a)
    stacked = pvs.stacked_state_dict(grid)
    assert all(v.shape[0] == 3 for v in stacked.values())


def test_modality_draws_are_monotone_coupled():
    g = torch.Generator().manual_seed(3)
    u = torch.rand((64, 3), generator=g)
    fb = torch.randint(0, 3, (64,), generator=g)
    probs = (0.0, 0.05, 0.3, 0.7, 0.95)
    masks = [modality_dropout_mask_from_uniforms(u, fb, p) for p in probs]
    assert torch.equal(masks[0], torch.ones(64, 3))
    for (p_low, low), (p_high, high) in zip(zip(probs, masks), zip(probs[1:], masks[1:])):
        # a row the Bernoulli draw leaves a modality drops a superset at the
        # higher rate; a row it empties keeps the one fallback modality
        kept = (u >= p_high).any(-1)
        assert bool(((high == 0) | (low == 1))[kept].all())
        fallback = torch.nn.functional.one_hot(fb, 3).float()
        torch.testing.assert_close(high[~kept], fallback[~kept], rtol=0, atol=0)
    assert all(bool((mk.sum(-1) >= 1).all()) for mk in masks)
    assert not bool((u >= 0.95).any(-1).all())  # the fallback did come into play
    # the same rule as modality_dropout_mask on the same draws
    want = modality_dropout_mask(torch.Generator().manual_seed(3), 64, 3, 0.3,
                                 torch.device("cpu"))
    torch.testing.assert_close(masks[2], want, rtol=0, atol=0)


def test_grid_and_lr_sweep_tags_and_keys_match_jax(tmp_path):
    overrides = TINY + _mlp(bn=False)
    jout = jax_sweep.main(["--vmap-grid", "--out", str(tmp_path / "jax"), *overrides])
    pout = port_sweep.main(["--vmap-grid", "--out", str(tmp_path / "port"), *overrides])
    assert [r["tag"] for r in pout] == [r["tag"] for r in jout]
    assert len({r["tag"] for r in pout}) == 12
    assert [list(r) for r in pout] == [list(r) for r in jout]
    for r in pout:
        assert r["tag"] == jax_sweep.format_tag(r["learning_rate"], r["model_dropout"],
                                                r["modality_dropout"])
        assert np.isfinite(r["best_val_loss"])
    assert (json.loads((tmp_path / "port" / "vmap_grid_results.json").read_text())
            == pout)
    lrs = ["--vmap-lrs", "1e-3,5e-3"]
    jl = jax_sweep.main([*lrs, "--out", str(tmp_path / "jax"), *overrides])
    pl = port_sweep.main([*lrs, "--out", str(tmp_path / "port"), *overrides])
    assert [list(r) for r in pl] == [list(r) for r in jl]
    assert [r["learning_rate"] for r in pl] == [1e-3, 5e-3]
    assert (json.loads((tmp_path / "port" / "vmap_sweep_results.json").read_text()) == pl)
    for a, b in ((2e-3, 0.05), (5e-4, 0.0), (1e-3, -0.5)):
        assert port_sweep.format_tag(a, 0.1, b) == jax_sweep.format_tag(a, 0.1, b)


def test_run_sweep_harvest_matches_jax(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    overrides = TINY + _mlp(bn=False)
    grid = dict(learning_rates=[1e-3], dropouts=[0.1], modality_dropouts=[0.0])
    trees = {}
    for name, sweep, loader in (("jax", jax_sweep, jax_load_config),
                                ("port", port_sweep, load_config)):
        cfg = loader(None, overrides + [f"experiment.save_dir={tmp_path / name / 'outputs'}"])
        results = sweep.run_sweep(cfg, out_root=str(tmp_path / name / "grid"), **grid)
        assert [r["tag"] for r in results] == ["lr0p001_drop0p1_mDrop0p0"]
        root = tmp_path / name / "grid"
        trees[name] = sorted(str(p.relative_to(root)) for p in root.rglob("*"))
        summary = json.loads((root / "sweep_summary.json").read_text())
        assert [r["tag"] for r in summary] == [r["tag"] for r in results]
        for r in results:
            text = (root / r["tag"] / "hyperparams.txt").read_text()
            assert text.startswith(f"experiment.name = {cfg.experiment.name}_{r['tag']}\n")
        trees[f"{name}_hp"] = [(root / r["tag"] / "hyperparams.txt").read_text()
                               for r in results]
        trees[f"{name}_keys"] = sorted(summary[0])
    assert trees["port"] == trees["jax"]
    assert trees["port_hp"] == trees["jax_hp"]
    assert trees["port_keys"] == trees["jax_keys"]


def test_train_ensemble_feeds_ensemble_predict():
    cfg, train, _ = _loaders(TINY + _mlp(bn=True))
    model = classifier_from_config(cfg)
    stacked = pvs.train_ensemble(model, train, n_members=3, epochs=1, seed=2)
    assert set(stacked) == set(model.state_dict())
    assert all(v.shape[0] == 3 for v in stacked.values())
    feats, _ = train.device_arrays()
    probs, unc = ensemble_predict(model, stacked, {k: v[:5] for k, v in feats.items()})
    assert probs.shape == (5, 4) and unc.shape == (5,)
    torch.testing.assert_close(probs.sum(-1), torch.ones(5), rtol=0, atol=1e-6)
    assert bool((unc > 0).all())


def test_sweep_cli_raises_without_a_card_or_cpu_override(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="runtime.platform=cpu"):
        port_sweep.main(["--vmap-lrs", "1e-3", "--out", str(tmp_path / "never"),
                         *TINY[:-1], *_mlp(bn=False)])
    assert not (tmp_path / "never").exists()
