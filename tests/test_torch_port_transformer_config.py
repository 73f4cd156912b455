"""PyTorch port, the transformer audio encoder config (``bench.py``'s
``transformer`` leg: ``model.encoders.audio.encoder_type=transformer``) at
a narrow width, on the CPU (every kernel wrapper runs its plain version):

* ``TransformerBlock`` and ``SequenceEncoder`` (including the blockwise
  fold past ``max_len``) against the JAX modules on both attention routes,
  the XLA MHA and the Pallas flash kernel in interpret mode;
* a JAX transformer classifier's tree loads with ``strict=True``, and its
  logits match, with log-mel and with the raw waveform (blockwise);
* a 5-step train-step trajectory against JAX ``make_train_step`` and 2
  epochs of ``Trainer.fit`` against the JAX ``Trainer``, dropout rates 0;
* the train CLI then the predict CLI on its ``best.ckpt``.

Tolerance 1e-4, as the flagship's tests (``ops/envelope.py``'s
``INTERPRET_STRICT_ATOL``)."""

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
from multimodal_emotion_detection_tpu_torch import train as port_train
from multimodal_emotion_detection_tpu_torch.config import load_config
from multimodal_emotion_detection_tpu_torch.data.loader import create_dataloaders
from multimodal_emotion_detection_tpu_torch.models.classifier import (
    classifier_from_config,
)
from multimodal_emotion_detection_tpu_torch.models.encoders import (
    SequenceEncoder,
    TransformerBlock,
)
from multimodal_emotion_detection_tpu_torch.models.noise import Noise
from multimodal_emotion_detection_tpu_torch.ops import flash_attention as fa
from multimodal_emotion_detection_tpu_torch.ops import logmel
from multimodal_emotion_detection_tpu_torch.tools.predict import (
    main as port_predict,
)
from multimodal_emotion_detection_tpu_torch.training import optim
from multimodal_emotion_detection_tpu_torch.training.loop import Trainer
from multimodal_emotion_detection_tpu_torch.training.steps import (
    forward,
    train_step,
)
from multimodal_emotion_detection_tpu_torch.utils.weights import (
    state_dict_from_jax_params,
)

ROOT = Path(__file__).resolve().parents[1]
CONFIG = str(ROOT / "configs" / "base.yaml")
# the transformer leg's encoder; widths narrowed (hidden 256 -> 64, so 4
# heads of 16; output 128 -> 16, head 256 -> 32, video 256 -> 32) and ~37
# log-mel frames per clip
TF_NARROW = [
    "model.frontend.audio=logmel",
    "model.encoders.audio.encoder_type=transformer",
    "model.encoders.audio.hidden_dim=64",
    "model.encoders.video.input_dim=16",
    "model.encoders.video.hidden_dim=32",
    "model.output_dim=16",
    "model.hidden_dim=32",
]
NO_DROPOUT = [
    "model.encoders.audio.dropout=0.0",
    "model.encoders.video.dropout=0.0",
    "training.augmentation.modality_dropout=0.0",
]
B, SAMPLES, FRAMES, FRAME_DIM = 8, 40 * 128, 4, 16
# the attention pool's score bias: softmax over time does not see it
SHIFT_INVARIANT = "video_encoder.pool.attention.bias"
FLASH = (fa.FLASH_FWD, fa.FLASH_BWD_FUSED, fa.FLASH_BWD_DKV, fa.FLASH_BWD_DQ)
ROUTES = pytest.mark.parametrize("use_flash", [False, True],
                                 ids=["jax_xla_mha", "jax_flash_interpret"])


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the suite runs several test workers on the same cores; at these tiny
    # shapes a multi-threaded torch only spins idle threads that slow them all
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _split(n, seed, samples=SAMPLES):
    rng = np.random.RandomState(seed)
    return ({"audio": rng.randn(n, samples, 1).astype(np.float32),
             "video": rng.rand(n, FRAMES, FRAME_DIM).astype(np.float32)},
            rng.randint(0, 8, n).astype(np.int32))


def _load(module, params):
    module.load_state_dict(state_dict_from_jax_params(
        jax.tree_util.tree_map(np.asarray, params)))  # strict: every key
    return module.eval()


@ROUTES
def test_transformer_block_matches_jax(use_flash):
    rng = np.random.RandomState(0)
    x = rng.randn(3, 29, 64).astype(np.float32)
    valid = rng.rand(3, 29) > 0.3
    valid[:, 0] = True
    jblock = JaxTransformerBlock(hidden_dim=64, num_heads=4, dropout=0.0,
                                 use_flash=use_flash)
    with jax.default_matmul_precision("highest"):
        variables = jblock.init(jax.random.PRNGKey(1), jnp.asarray(x),
                                jnp.asarray(valid))
        want = np.asarray(jblock.apply(variables, jnp.asarray(x), jnp.asarray(valid)))
    block = _load(TransformerBlock(64, 4, 0.0), variables["params"])
    bias = torch.from_numpy(np.where(valid, 0.0, -1e9).astype(np.float32))
    with torch.no_grad():
        got = block(torch.from_numpy(x), bias).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@ROUTES
@pytest.mark.parametrize("seq_len", [12, 37], ids=["within_max_len", "blockwise"])
def test_sequence_encoder_matches_jax(use_flash, seq_len):
    # max_len 16, blocks of 8: 37 steps fold into 5 blocks, the last one
    # padded (and a fully padded block would keep a sentinel key)
    kw = dict(input_dim=8, hidden_dim=32, output_dim=16, num_layers=2, dropout=0.0)
    x = np.random.RandomState(seq_len).randn(2, seq_len, 8).astype(np.float32)
    jenc = JaxSequenceEncoder(**kw, encoder_type="transformer", max_len=16,
                              attention_block=8, use_flash=use_flash)
    with jax.default_matmul_precision("highest"):
        variables = jenc.init(jax.random.PRNGKey(2), jnp.asarray(x))
        want = np.asarray(jenc.apply(variables, jnp.asarray(x)))
    enc = _load(SequenceEncoder(**kw, encoder_type="transformer", max_len=16,
                                attention_block=8), variables["params"])
    with torch.no_grad():
        got = enc(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@ROUTES
@pytest.mark.parametrize("frontend,samples", [("logmel", SAMPLES), ("raw", 4700)],
                         ids=["logmel", "raw_blockwise"])
def test_classifier_logits_match_jax(use_flash, frontend, samples):
    overrides = TF_NARROW + [f"model.frontend.audio={frontend}",
                             f"model.encoders.audio.use_flash={str(use_flash).lower()}"]
    jmodel = jax_classifier_from_config(jax_load_config(CONFIG, overrides))
    feats, _ = _split(2, 0, samples)
    jfeats = {k: jnp.asarray(v) for k, v in feats.items()}
    mask = jnp.ones((2, 2), jnp.float32)
    with jax.default_matmul_precision("highest"):
        variables = jmodel.init(jax.random.PRNGKey(3), jfeats, mask)
        ref = np.asarray(jmodel.apply(variables, jfeats, mask, deterministic=True))

    model = classifier_from_config(load_config(CONFIG, overrides))
    state = state_dict_from_jax_params(
        jax.tree_util.tree_map(np.asarray, variables["params"]))
    assert {"audio_encoder.block_1.self_attn.out.weight",
            "audio_encoder.pos_embedding.weight"} <= set(state)
    model.load_state_dict(state)  # strict: every key of both trees
    logits = forward(model, {k: torch.from_numpy(v) for k, v in feats.items()})
    assert logits.shape == (2, 8)
    np.testing.assert_allclose(logits.numpy(), ref, rtol=1e-4, atol=1e-4)


def test_training_forward_draws_seeds_and_replays():
    cfg = load_config(CONFIG, TF_NARROW)
    model = classifier_from_config(cfg)
    feats = {k: torch.from_numpy(v) for k, v in _split(4, 5)[0].items()}
    feats["audio"] = logmel.log_mel_spectrogram(
        feats["audio"], model.audio_frontend)
    model.audio_frontend = None
    model.train()
    noise = Noise(torch.Generator().manual_seed(0))
    out = model(feats, noise=noise)
    # per block one int64 attention seed then the feed-forward keep mask,
    # then the video encoder's two masks
    kinds = [(t.dtype, tuple(t.shape)) for t in noise.drawn]
    assert kinds[0] == kinds[2] == (torch.int64, (1,))
    assert kinds[1] == kinds[3] == (torch.float32, (4, 37, 256))
    torch.testing.assert_close(model(feats, noise=Noise(replay=noise.drawn)), out,
                               rtol=0, atol=0)
    again = model(feats, noise=Noise(torch.Generator().manual_seed(1)))
    assert float((again - out).detach().abs().max()) > 1e-4
    with pytest.raises(ValueError, match="Noise"):
        model(feats)


def test_train_step_trajectory_matches_jax():
    overrides = TF_NARROW + NO_DROPOUT
    feats, labels = _split(20, 1)
    rng = np.random.RandomState(2)
    idx = [rng.randint(0, 20, B).astype(np.int32) for _ in range(5)]
    valid = [np.ones(B, np.float32)] * 4 + [np.array([1] * 5 + [0] * 3, np.float32)]

    jcfg = jax_load_config(CONFIG, overrides)
    jmodel = jax_classifier_from_config(jcfg)
    tx, _ = jax_optim.build_optimizer(jcfg.training, 3)
    jfeats = {k: jnp.asarray(v) for k, v in feats.items()}
    with jax.default_matmul_precision("highest"):
        sample = {k: v[:B] for k, v in jfeats.items()}
        state = create_train_state(jmodel, tx, sample, jnp.ones((B, 2)),
                                   jax.random.PRNGKey(4))
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

    cfg = load_config(CONFIG, overrides)
    model = classifier_from_config(cfg)
    model.load_state_dict(state_dict_from_jax_params(params0))
    opt, sched = optim.build_optimizer(cfg.training, model.parameters(), 3)
    tfeats = {k: torch.from_numpy(v) for k, v in feats.items()}
    tlabels = torch.from_numpy(labels.astype(np.int64))
    named = dict(model.named_parameters())
    # elements whose gradient has been below AdamW's eps (1e-8): there the
    # step g / (|g| + eps) turns either framework's round-off into a step of
    # up to lr (1e-3), as for the attention pool's score bias, whose true
    # gradient is zero, and the position rows past the 37 frames, which
    # get none; they are held to that, the rest to 1e-4
    ill = {k: np.zeros(p.shape, bool) for k, p in named.items()}
    for s in range(5):
        metrics = train_step(
            model, opt, tfeats, tlabels, torch.from_numpy(idx[s].astype(np.int64)),
            torch.from_numpy(valid[s]), lr=sched(s), clip_norm=1.0,
            modality_dropout=0.0, noise=Noise(torch.Generator().manual_seed(s)))
        np.testing.assert_allclose(float(metrics["loss"]), want_loss[s],
                                   rtol=0, atol=1e-4, err_msg=f"loss, step {s}")
        got = model.state_dict()
        for k, v in want_params[s].items():
            ill[k] |= np.abs(named[k].grad.numpy()) < 1e-8
            diff = np.abs(got[k].numpy() - v.numpy())
            assert diff[~ill[k]].max(initial=0.0) <= 1e-4, f"{k}, step {s}"
            assert diff[ill[k]].max(initial=0.0) <= 1.1e-3 * (s + 1), f"{k}, step {s}"
    assert ill[SHIFT_INVARIANT].all()


def _write_splits(root, sizes):
    for seed, (split, n) in enumerate(sizes.items()):
        feats, labels = _split(n, 10 + seed)
        (root / split).mkdir(parents=True)
        for name, arr in (*feats.items(), ("labels", labels)):
            np.save(root / split / f"{name}.npy", arr)


def test_fit_val_loss_matches_jax_trainer(tmp_path):
    sizes = {"train": 20, "val": 12, "test": 12}  # 3 / 2 / 2 batches of 8
    data = tmp_path / "data"
    _write_splits(data, sizes)

    def overrides(save):
        return TF_NARROW + NO_DROPOUT + [
            "dataset.batch_size=8", "training.max_epochs=2", "runtime.platform=cpu",
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
    want = [row["val/loss"] for row in jtrainer.history]
    got = [row["val/loss"] for row in trainer.history]
    assert len(got) == len(want) == 2
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_train_cli_then_predict_on_its_best_ckpt(tmp_path):
    sizes = {"train": 20, "val": 12, "test": 12}
    data = tmp_path / "data"
    _write_splits(data, sizes)
    overrides = TF_NARROW + [
        "model.frontend.cache=true", "dataset.batch_size=8",
        "training.max_epochs=2", "runtime.platform=cpu",
        f"dataset.data_dir={data}", f"experiment.save_dir={tmp_path}",
        "experiment.name=tf"]
    for c in (logmel.LOGMEL, *FLASH):
        c.launches = 0
    results = port_train.main(["--config", CONFIG, *overrides])
    run = tmp_path / "tf"
    for rel in ("results.json", "best.ckpt", "checkpoints/last.ckpt",
                "confusion_matrix.npy", "csv_logs/version_0/metrics.csv"):
        assert (run / rel).exists(), rel
    assert all(np.isfinite(v) for v in results.values())

    metrics = port_predict(["--checkpoint", str(run / "best.ckpt"), "--config",
                            CONFIG, "--out", str(tmp_path / "preds"), *overrides])
    logits = np.load(tmp_path / "preds" / "logits.npy")
    assert logits.shape == (sizes["test"], 8) and np.isfinite(logits).all()
    assert metrics["split"] == "test"
    # CPU tensors: the plain versions ran, no kernel launched
    assert [c.launches for c in (logmel.LOGMEL, *FLASH)] == [0] * 5
