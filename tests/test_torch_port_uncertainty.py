"""PyTorch port, ``uncertainty/`` and the CLIs that use it, against the JAX
package at small widths on the CPU (``runtime.platform=cpu``):

* ``mc_dropout_predict`` at dropout 0 equals the inference forward (mean
  logits 1e-5, uncertainty <= 1e-12); at nonzero rates it is reproducible
  from its seed and its samples differ;
* ``TemperatureScaling.calibrate``: T within 1e-4 (relative) of JAX's;
* ``ensemble_predict`` over 3 members: probabilities and uncertainty 1e-5;
* the calibration helpers against JAX's numpy outputs, 1e-6;
* the train CLI on ``configs/uncertainty.yaml`` writes the calibration
  report (and no ``best.ckpt`` / ``results.json``), as JAX's does; on
  ``configs/av_hybrid.yaml`` the usual artifacts; ``predict --mc-dropout``
  writes ``uncertainty.npy``, with ``--missing`` reaching the MC forward."""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_emotion_detection_tpu import train as jax_train
from multimodal_emotion_detection_tpu.config import load_config as jax_load_config
from multimodal_emotion_detection_tpu.models.classifier import (
    classifier_from_config as jax_classifier_from_config,
)
from multimodal_emotion_detection_tpu.training.evaluate import (
    write_uncertainty_json as jax_write_uncertainty_json,
)
from multimodal_emotion_detection_tpu.uncertainty import calibration as jcal
from multimodal_emotion_detection_tpu.uncertainty.ensemble import (
    ensemble_predict_list as jax_ensemble_predict_list,
)
from multimodal_emotion_detection_tpu.uncertainty.temperature import (
    TemperatureScaling as JaxTemperatureScaling,
)
from multimodal_emotion_detection_tpu_torch import train as port_train
from multimodal_emotion_detection_tpu_torch import uncertainty
from multimodal_emotion_detection_tpu_torch.config import load_config
from multimodal_emotion_detection_tpu_torch.data.masking import (
    simulate_missing_modalities,
)
from multimodal_emotion_detection_tpu_torch.models.classifier import (
    classifier_from_config,
    init_weights,
)
from multimodal_emotion_detection_tpu_torch.models.noise import Noise
from multimodal_emotion_detection_tpu_torch.tools._restore import restore_for_eval
from multimodal_emotion_detection_tpu_torch.tools.predict import (
    main as port_predict,
)
from multimodal_emotion_detection_tpu_torch.training.evaluate import (
    write_uncertainty_json,
)
from multimodal_emotion_detection_tpu_torch.training.steps import forward
from multimodal_emotion_detection_tpu_torch.uncertainty import calibration as cal
from multimodal_emotion_detection_tpu_torch.uncertainty.ensemble import (
    ensemble_predict_list,
    stack_params,
)
from multimodal_emotion_detection_tpu_torch.uncertainty.mc_dropout import (
    mc_dropout_predict,
)
from multimodal_emotion_detection_tpu_torch.uncertainty.temperature import (
    TemperatureScaling,
)
from multimodal_emotion_detection_tpu_torch.utils.weights import (
    state_dict_from_jax_params,
)

ROOT = Path(__file__).resolve().parents[1]
UNC = str(ROOT / "configs" / "uncertainty.yaml")
HYBRID = str(ROOT / "configs" / "av_hybrid.yaml")
NARROW = [
    "model.encoders.audio.hidden_dim=32",
    "model.encoders.video.input_dim=16",
    "model.encoders.video.hidden_dim=32",
    "model.output_dim=16",
    "model.hidden_dim=32",
]
NO_DROPOUT = ["model.dropout=0.0", "model.encoders.audio.dropout=0.0",
              "model.encoders.video.dropout=0.0"]
B, SAMPLES, FRAMES = 6, 40 * 128, 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the suite runs several test workers on the same cores; at these tiny
    # shapes a multi-threaded torch only spins idle threads that slow them all
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(seed=0, b=B):
    rng = np.random.RandomState(seed)
    return {"audio": torch.from_numpy(rng.randn(b, SAMPLES, 1).astype(np.float32)),
            "video": torch.from_numpy(rng.rand(b, FRAMES, 16).astype(np.float32))}


def _model(config, *extra, seed=0):
    cfg = load_config(config, NARROW + list(extra))
    return init_weights(classifier_from_config(cfg),
                        torch.Generator().manual_seed(seed)).eval()


# --------------------------------------------------------------- MC dropout


@pytest.mark.parametrize("config", [UNC, HYBRID], ids=["uncertainty", "hybrid"])
def test_mc_dropout_at_rate_zero_is_the_inference_forward(config):
    model = _model(config, *NO_DROPOUT)
    feats = _inputs()
    mask = torch.tensor([[1, 1], [1, 0], [0, 1]] * (B // 3), dtype=torch.float32)
    mean, unc = mc_dropout_predict(model, feats, num_samples=4, mask=mask)
    ref = forward(model, feats, mask)
    assert mean.shape == ref.shape == (B, 8) and unc.shape == (B,)
    np.testing.assert_allclose(mean.numpy(), ref.numpy(), rtol=0, atol=1e-5)
    assert float(unc.abs().max()) <= 1e-12


@pytest.mark.parametrize("config", [UNC, HYBRID], ids=["uncertainty", "hybrid"])
def test_mc_dropout_is_reproducible_from_its_seed_and_its_samples_differ(config):
    model = _model(config)  # the configs' rates: 0.3 fusion, 0.1 encoders
    feats = _inputs(1)

    def run(seed, samples=5):
        return mc_dropout_predict(model, feats, samples,
                                  noise=Noise(torch.Generator().manual_seed(seed)))

    mean_a, unc_a = run(7)
    mean_b, unc_b = run(7)
    assert torch.equal(mean_a, mean_b) and torch.equal(unc_a, unc_b)
    assert not model.training  # the caller's mode comes back
    assert bool((unc_a > 0).all())  # every clip's samples differ
    mean_c, unc_c = run(8)
    assert not torch.equal(mean_a, mean_c)
    # one sample: no spread; the default noise is a seed-0 generator
    _, unc_1 = run(0, samples=1)
    assert float(unc_1.abs().max()) == 0.0
    mean_d, _ = mc_dropout_predict(model, feats, 5)
    assert torch.equal(mean_d, run(0)[0])
    with pytest.raises(ValueError):
        mc_dropout_predict(model, feats, 0)


def test_mc_dropout_folds_samples_into_the_batch():
    # the S samples are S row blocks of one forward: replaying its masks on
    # one block's clips gives that sample's logits
    model = _model(UNC)
    feats = _inputs(2, b=3)
    noise = Noise(torch.Generator().manual_seed(3))
    mean, unc = mc_dropout_predict(model, feats, 2, noise=noise)
    folded = {k: v.repeat((2,) + (1,) * (v.ndim - 1)) for k, v in feats.items()}
    model.train()
    with torch.no_grad():
        logits = model(folded, torch.ones(6, 2),
                       noise=Noise(replay=noise.drawn)).reshape(2, 3, -1)
    model.eval()
    np.testing.assert_allclose(mean.numpy(), logits.mean(0).numpy(), rtol=0, atol=1e-6)
    probs = torch.softmax(logits, -1)
    np.testing.assert_allclose(unc.numpy(), probs.var(0, unbiased=False).mean(-1).numpy(),
                               rtol=0, atol=1e-7)
    assert not torch.allclose(logits[0], logits[1])


# -------------------------------------------------------------- temperature


@pytest.mark.parametrize("scale", [0.3, 1.0, 5.0])
def test_temperature_scaling_matches_jax(scale):
    rng = np.random.RandomState(int(scale * 10))
    labels = rng.randint(0, 8, 200)
    logits = (rng.randn(200, 8) + 2.0 * np.eye(8)[labels]) * scale
    logits = logits.astype(np.float32)
    ref = JaxTemperatureScaling().calibrate(jnp.asarray(logits), jnp.asarray(labels))
    ts = TemperatureScaling()
    t = ts.calibrate(torch.from_numpy(logits), torch.from_numpy(labels))
    assert t == ts.temperature
    assert abs(t - ref) <= 1e-4 * ref, (t, ref)
    np.testing.assert_allclose(ts(torch.from_numpy(logits)).numpy(), logits / t,
                               rtol=1e-6)


# ----------------------------------------------------------------- ensemble


def test_ensemble_predict_matches_jax():
    overrides = NARROW + ["model.encoders.audio.inference_kernel=false"]
    jmodel = jax_classifier_from_config(jax_load_config(UNC, overrides))
    feats = _inputs(4)
    jfeats = {k: jnp.asarray(v.numpy()) for k, v in feats.items()}
    with jax.default_matmul_precision("highest"):
        params = [jmodel.init(jax.random.PRNGKey(k), jfeats, jnp.ones((B, 2)))["params"]
                  for k in range(3)]
        ref_probs, ref_unc = jax_ensemble_predict_list(jmodel, params, [{}] * 3, jfeats)
    states = [state_dict_from_jax_params(jax.tree_util.tree_map(np.asarray, p))
              for p in params]
    model = _model(UNC, "model.encoders.audio.inference_kernel=false")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    probs, unc = ensemble_predict_list(model, states, feats)
    np.testing.assert_allclose(probs.numpy(), ref_probs, rtol=0, atol=1e-5)
    np.testing.assert_allclose(unc.numpy(), ref_unc, rtol=0, atol=1e-5)
    assert float(unc.min()) > 0
    assert all(torch.equal(v, model.state_dict()[k]) for k, v in before.items())
    stacked = stack_params(states)
    assert all(stacked[k].shape == (3,) + states[0][k].shape for k in states[0])


# -------------------------------------------------------------- calibration


def _calibration_inputs(seed=0, n=300):
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, 8, n)
    logits = rng.randn(n, 8) * 2.0 + 1.5 * np.eye(8)[labels]
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    confs = probs.max(-1)
    confs[:3] = [0.0, 1.0, 0.5]  # the edges: bin 0, the last bin's closed edge
    return logits, labels, confs, probs.argmax(-1)


@pytest.mark.parametrize("num_bins", [1, 10, 15])
def test_calibration_helpers_match_jax(num_bins, tmp_path):
    logits, labels, confs, preds = _calibration_inputs(num_bins)
    j, p = jcal.CalibrationMetrics, cal.CalibrationMetrics
    for name in ("bin_stats", "expected_calibration_error",
                 "maximum_calibration_error"):
        np.testing.assert_allclose(
            np.asarray(getattr(p, name)(confs, preds, labels, num_bins), dtype=object
                       ).astype(np.float64),
            np.asarray(getattr(j, name)(confs, preds, labels, num_bins), dtype=object
                       ).astype(np.float64), rtol=0, atol=1e-6, err_msg=name)
    assert abs(p.negative_log_likelihood(logits, labels)
               - j.negative_log_likelihood(logits, labels)) <= 1e-6
    assert cal.per_bin_accuracy(confs, preds, labels, num_bins) == jcal.per_bin_accuracy(
        confs, preds, labels, num_bins)
    got = cal.compute_calibration_metrics(logits, labels, num_bins)
    want = jcal.compute_calibration_metrics(logits, labels, num_bins)
    assert sorted(got) == sorted(want)
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-6, k
    for pkg, out in ((p, tmp_path / "port" / "d.png"), (j, tmp_path / "jax" / "d.png")):
        pkg.reliability_diagram(confs, preds, labels, num_bins, save_path=str(out))
        assert out.stat().st_size > 0


def test_calibration_over_a_loader_matches_jax():
    logits, labels, _, _ = _calibration_inputs(3, n=20)
    mask = np.ones((20, 2), np.float32)
    mask[17:] = 0.0  # wrap padding rows
    batches = [(slice(0, 8)), slice(8, 16), slice(16, 20)]
    weights = np.random.RandomState(4).randn(4, 8).astype(np.float32)
    feats = np.random.RandomState(5).randn(20, 4).astype(np.float32)
    jloader = [({"x": feats[s]}, labels[s], mask[s]) for s in batches]
    ploader = [({"x": torch.from_numpy(feats[s])}, torch.from_numpy(labels[s]),
                torch.from_numpy(mask[s])) for s in batches]
    want = jcal.compute_calibration_metrics_over_loader(
        lambda params, state, f, m: (f["x"] @ weights, None), None, None, jloader, 10)
    got = cal.compute_calibration_metrics_over_loader(
        lambda f, m: f["x"] @ torch.from_numpy(weights), ploader, 10)
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-6, k
    assert cal.compute_calibration_metrics_over_loader(lambda f, m: f, [], 10) == {
        "ece": 0.0, "mce": 0.0, "nll": 0.0, "accuracy": 0.0}


def test_uncertainty_json_matches_jax(tmp_path):
    args = ("ravdess", 0.123456, 1.98765, [0.5, 1.0], [0.25, None])
    got = write_uncertainty_json(tmp_path / "port", *args)
    want = jax_write_uncertainty_json(tmp_path / "jax", *args)
    assert got.name == want.name == "uncertainty.json"
    assert got.read_text() == want.read_text()


def test_package_exports_match_jax():
    from multimodal_emotion_detection_tpu import uncertainty as juncertainty

    names = {n for n in dir(juncertainty) if not n.startswith("_")}
    ported = {n for n in dir(uncertainty) if not n.startswith("_")}
    assert {"CalibrationMetrics", "compute_calibration_metrics", "per_bin_accuracy",
            "mc_dropout_predict", "TemperatureScaling", "ensemble_predict",
            "uncertainty_weighted_fusion"} <= names & ported


# --------------------------------------------------------------------- CLIs

SIZES = {"train": 20, "val": 12, "test": 12}  # 3 / 2 / 2 batches of 8


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("port_uncertainty_data")
    for seed, (split, n) in enumerate(SIZES.items()):
        rng = np.random.RandomState(seed)
        d = root / split
        d.mkdir()
        np.save(d / "audio.npy", rng.randn(n, SAMPLES, 1).astype(np.float32))
        np.save(d / "video.npy", rng.rand(n, FRAMES, 16).astype(np.float32))
        np.save(d / "labels.npy", rng.randint(0, 8, n).astype(np.int32))
    return root


def _overrides(data_dir, root):
    return NARROW + ["dataset.batch_size=8", "training.max_epochs=2",
                     "runtime.platform=cpu", f"dataset.data_dir={data_dir}",
                     f"experiment.save_dir={root}", "experiment.name=run",
                     f"outputs.experiments_dir={root / 'experiments'}"]


def _artifacts(run_root: Path):
    return sorted(str(p.relative_to(run_root)) for p in run_root.rglob("*")
                  if p.is_file() and "tb_logs" not in p.parts
                  and "checkpoints" not in p.parts)


@pytest.fixture(scope="module")
def unc_runs(data_dir, tmp_path_factory):
    """The train CLI on uncertainty.yaml, port and JAX, each in a working
    directory of its own (the reliability diagram goes to ./analysis)."""
    runs = {}
    with pytest.MonkeyPatch.context() as mp:
        for name, main in (("port", port_train.main), ("jax", jax_train.main)):
            root = tmp_path_factory.mktemp(f"unc_{name}")
            mp.chdir(root)
            results = main(["--config", UNC, *_overrides(data_dir, root)])
            runs[name] = (root, results)
    return runs


def test_train_cli_on_uncertainty_yaml_writes_the_calibration_report(unc_runs):
    (root, results), (jroot, jresults) = unc_runs["port"], unc_runs["jax"]
    assert _artifacts(root) == _artifacts(jroot)
    for rel in ("experiments/uncertainty.json", "analysis/calibration_diagram.png",
                "run/confusion_matrix.npy"):
        assert (root / rel).exists(), rel
    for rel in ("run/best.ckpt", "run/results.json"):
        assert not (root / rel).exists(), rel
    report = json.loads((root / "experiments/uncertainty.json").read_text())
    jreport = json.loads((jroot / "experiments/uncertainty.json").read_text())
    assert report["dataset"] == "ravdess"
    assert sorted(report["calibration_metrics"]) == sorted(jreport["calibration_metrics"])
    assert report["calibration_metrics"]["bins"] == jreport["calibration_metrics"]["bins"]
    assert sorted(results) == sorted(jresults)
    assert np.isfinite([results["ece"], results["nll"]]).all()


def _best_ckpt(root: Path) -> Path:
    (path,) = (root / "run" / "checkpoints").glob("epoch=*-val_loss=*.ckpt")
    return path


@pytest.mark.parametrize("missing", [None, "0"])
def test_predict_mc_dropout_writes_uncertainty(unc_runs, data_dir, tmp_path, missing):
    root, _ = unc_runs["port"]
    ckpt = _best_ckpt(root)
    flags = ["--missing", missing] if missing else []
    metrics = port_predict(["--checkpoint", str(ckpt), "--config", UNC,
                            "--mc-dropout", "4", *flags, "--out", str(tmp_path / "mc"),
                            *_overrides(data_dir, tmp_path)])
    assert metrics["mc_dropout_samples"] == 4
    unc = np.load(tmp_path / "mc" / "uncertainty.npy")
    logits = np.load(tmp_path / "mc" / "logits.npy")
    n = SIZES["test"]
    assert unc.shape == (n,) and logits.shape == (n, 8)
    assert np.isfinite(unc).all() and (unc >= 0).all() and unc.max() > 0

    # each batch: one MC forward from a generator seeded with the config's
    # seed, on the mask the --missing pattern rewrote
    cfg = load_config(UNC, _overrides(data_dir, tmp_path))
    cfg.model.frontend.cache = False
    model, _, loader = restore_for_eval(cfg, ckpt, "test", torch.device("cpu"))
    ref_logits, ref_unc = [], []
    for features, _, mask in loader:
        if missing:
            features, mask = simulate_missing_modalities(features, mask, [0])
        mean, u = mc_dropout_predict(model, features, 4, mask=mask, noise=Noise(
            torch.Generator().manual_seed(cfg.seed)))
        ref_logits.append(mean.numpy())
        ref_unc.append(u.numpy())
    np.testing.assert_array_equal(logits, np.concatenate(ref_logits)[:n])
    np.testing.assert_array_equal(unc, np.concatenate(ref_unc)[:n])


def test_train_and_predict_av_hybrid_yaml(data_dir, tmp_path):
    results = port_train.main(["--config", HYBRID, *_overrides(data_dir, tmp_path)])
    for rel in ("run/best.ckpt", "run/results.json", "run/confusion_matrix.npy"):
        assert (tmp_path / rel).exists(), rel
    assert not (tmp_path / "experiments").exists()
    assert np.isfinite(list(results.values())).all()
    for flags, out in (([], "plain"), (["--mc-dropout", "3"], "mc")):
        port_predict(["--checkpoint", str(tmp_path / "run" / "best.ckpt"), "--config",
                      HYBRID, *flags, "--out", str(tmp_path / out),
                      *_overrides(data_dir, tmp_path)])
        logits = np.load(tmp_path / out / "logits.npy")
        assert logits.shape == (SIZES["test"], 8) and np.isfinite(logits).all()
    assert (tmp_path / "mc" / "uncertainty.npy").exists()
    assert not (tmp_path / "plain" / "uncertainty.npy").exists()
