"""PyTorch port, ``ops/resize.py`` and ``model.frontend.video=resize``
against the JAX package, on the CPU:

* ``area_resize`` / ``bgr_to_gray`` / ``rgb_to_gray`` against JAX's at
  shapes off alignment (48x40 -> 16x16, as ``tests/test_models.py`` holds
  JAX's frontend; also upsampling and the identity), on float32 and uint8
  frames, within 1e-4 on the 0-255 scale (a few float32 ulps);
  ``area_resize_np`` bit for bit JAX's and against ``cv2.INTER_AREA``
  where cv2 is installed; TF32 switched off inside and restored after;
* the classifier with ``video_frontend='resize'`` against JAX's classifier
  carrying the same tree (logits rtol 1e-4, atol 1e-5), on raw BGR frames,
  uint8 or float32, and on gray frames;
* the raw-frame route against the ETL-flattened route (the ETL's
  ``area_resize_np`` of the gray frames / 255) through one model;
* ``classifier_from_config`` taking ``model.frontend.video=resize`` (the
  refusal it had is gone), also under bf16 compute; the train and predict
  CLIs on a split whose ``video.npy`` holds raw frames."""

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
from multimodal_emotion_detection_tpu.ops import resize as jax_resize
from multimodal_emotion_detection_tpu_torch import train as port_train
from multimodal_emotion_detection_tpu_torch.config import load_config
from multimodal_emotion_detection_tpu_torch.models.classifier import (
    classifier_from_config,
)
from multimodal_emotion_detection_tpu_torch.ops import resize
from multimodal_emotion_detection_tpu_torch.tools import predict as port_predict
from multimodal_emotion_detection_tpu_torch.training.steps import forward
from multimodal_emotion_detection_tpu_torch.utils.weights import (
    state_dict_from_jax_params,
)

ROOT = Path(__file__).resolve().parents[1]
CONFIG = str(ROOT / "configs" / "base.yaml")
BGR = np.array([0.114, 0.587, 0.299], np.float32)
# a narrow flagship, raw frames of 48x40 resized to 16x16 on the way in
NARROW = ["model.frontend.audio=logmel", "model.frontend.video=resize",
          "model.frontend.video_height=16", "model.frontend.video_width=16",
          "model.encoders.audio.hidden_dim=32", "model.encoders.video.input_dim=256",
          "model.encoders.video.hidden_dim=16", "model.output_dim=16",
          "model.hidden_dim=16", "runtime.platform=cpu"]
B, T_V, SAMPLES = 2, 3, 40 * 128


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the suite runs several test workers on the same cores; at these tiny
    # shapes a multi-threaded torch only spins idle threads that slow them all
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _frames(seed=0, shape=(B, T_V, 48, 40, 3)):
    return (np.random.RandomState(seed).rand(*shape) * 255).astype(np.float32)


@pytest.mark.parametrize("in_hw,out_hw", [((48, 40), (16, 16)), ((45, 37), (13, 9)),
                                          ((10, 7), (16, 12)), ((16, 16), (16, 16))])
def test_area_resize_matches_jax(in_hw, out_hw):
    x = _frames(1, (B, T_V) + in_hw)
    ours = resize.area_resize(torch.from_numpy(x), *out_hw)
    theirs = np.asarray(jax_resize.area_resize(jnp.asarray(x), *out_hw))
    assert ours.shape == theirs.shape == (B, T_V) + out_hw and ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), theirs, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(resize.area_resize_np(x, *out_hw),
                                  jax_resize.area_resize_np(x, *out_hw))
    np.testing.assert_allclose(resize.area_resize_np(x, *out_hw), theirs, rtol=0, atol=1e-4)
    # every output cell averages its input cells: a constant stays put
    const = resize.area_resize(torch.full((1,) + in_hw, 7.0), *out_hw)
    np.testing.assert_allclose(const.numpy(), 7.0, rtol=1e-6)


def test_gray_and_uint8_frames_match_jax():
    x = _frames(2)
    u8 = x.astype(np.uint8)
    for ours_fn, jax_fn in ((resize.bgr_to_gray, jax_resize.bgr_to_gray),
                            (resize.rgb_to_gray, jax_resize.rgb_to_gray)):
        for arr in (x, u8):
            ours = ours_fn(torch.from_numpy(arr))
            assert ours.dtype == torch.float32 and ours.shape == arr.shape[:-1]
            np.testing.assert_allclose(ours.numpy(), np.asarray(jax_fn(jnp.asarray(arr))),
                                       rtol=0, atol=1e-4)
    np.testing.assert_allclose(resize.bgr_to_gray(torch.from_numpy(x)).numpy(), x @ BGR,
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(resize.rgb_to_gray(torch.from_numpy(x)).numpy(),
                               x[..., ::-1] @ BGR, rtol=0, atol=1e-4)
    np.testing.assert_allclose(resize.area_resize(torch.from_numpy(u8[..., 0]), 16, 16).numpy(),
                               np.asarray(jax_resize.area_resize(jnp.asarray(u8[..., 0]), 16, 16)),
                               rtol=0, atol=1e-4)


def test_area_resize_np_matches_cv2_inter_area():
    cv2 = pytest.importorskip("cv2")
    gray = _frames(3)[..., 0]
    ours = resize.area_resize_np(gray, 16, 16)
    ref = np.stack([cv2.resize(f, (16, 16), interpolation=cv2.INTER_AREA)
                    for f in gray.reshape(-1, 48, 40)]).reshape(ours.shape)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-4)


def test_tf32_is_off_inside_and_restored_after():
    prev = torch.backends.cuda.matmul.allow_tf32
    seen = []
    try:
        for flag in (True, False):
            torch.backends.cuda.matmul.allow_tf32 = flag
            with resize.full_float32():
                seen.append(torch.backends.cuda.matmul.allow_tf32)
            resize.area_resize(torch.from_numpy(_frames(4)[..., 0]), 16, 16)
            assert torch.backends.cuda.matmul.allow_tf32 is flag
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    assert seen == [False, False]


def _models(extra=()):
    """The port's narrow resize flagship and JAX's, on JAX's tree."""
    overrides = NARROW + list(extra)
    jcfg = jax_load_config(CONFIG, overrides)
    jmodel = jax_classifier_from_config(jcfg)
    feats = {"audio": jnp.zeros((B, SAMPLES, 1)), "video": jnp.asarray(_frames())}
    variables = jmodel.init(jax.random.PRNGKey(0), feats)
    params = jax.tree.map(np.asarray, dict(variables["params"]))
    model = classifier_from_config(load_config(CONFIG, overrides))
    model.load_state_dict(state_dict_from_jax_params(params), strict=True)
    return model.eval(), jmodel, variables


def _clip_inputs(video):
    audio = np.random.RandomState(5).randn(B, SAMPLES, 1).astype(np.float32)
    return audio, video


@pytest.mark.parametrize("frames", ["bgr_float32", "bgr_uint8", "gray"])
def test_resize_classifier_matches_jax(frames):
    model, jmodel, variables = _models()
    assert model.video_frontend == "resize" and model.video_hw == (16, 16)
    raw = _frames(6)
    video = {"bgr_float32": raw, "bgr_uint8": raw.astype(np.uint8),
             "gray": raw @ BGR}[frames]
    audio, video = _clip_inputs(video)
    got = forward(model, {"audio": torch.from_numpy(audio), "video": torch.from_numpy(video)})
    want = jmodel.apply(variables, {"audio": jnp.asarray(audio), "video": jnp.asarray(video)})
    assert got.shape == (B, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)


def test_raw_frames_match_the_etl_flattened_route():
    model, _, _ = _models()
    raw = _frames(7)
    etl = (resize.area_resize_np(raw @ BGR, 16, 16) / 255.0).reshape(B, T_V, 256)
    audio, _ = _clip_inputs(raw)
    a = torch.from_numpy(audio)
    via_raw = forward(model, {"audio": a, "video": torch.from_numpy(raw)})
    via_etl = forward(model, {"audio": a, "video": torch.from_numpy(etl)})
    np.testing.assert_allclose(via_raw.numpy(), via_etl.numpy(), rtol=1e-4, atol=1e-5)
    # the flattened frames pass the frontend untouched: the same model
    # serves an ETL split and raw frames alike
    flat = torch.from_numpy(etl)
    assert model._apply_frontend("video", flat) is flat


@pytest.mark.parametrize("extra", [[], ["runtime.compute_dtype=bfloat16"]],
                         ids=["float32", "bf16_compute"])
def test_classifier_from_config_takes_video_resize(extra):
    cfg = load_config(CONFIG, ["model.frontend.video=resize", *extra])
    model = classifier_from_config(cfg)
    assert model.video_frontend == "resize" and model.video_hw == (64, 64)
    raw = torch.from_numpy(_frames(8, (1, 2, 72, 128, 3)).astype(np.uint8))
    x = model._apply_frontend("video", raw)
    assert x.shape == (1, 2, 4096) and x.dtype == torch.float32
    assert 0.0 <= float(x.min()) and float(x.max()) <= 1.0
    # the default, no frontend: frames pass as they are
    plain = classifier_from_config(load_config(CONFIG, extra))
    assert plain.video_frontend == "none"
    assert plain._apply_frontend("video", raw) is raw


def _write_raw_split(root: Path, n: int, seed: int) -> None:
    rng = np.random.RandomState(seed)
    d = root
    d.mkdir(parents=True, exist_ok=True)
    np.save(d / "audio.npy", rng.randn(n, SAMPLES, 1).astype(np.float32))
    np.save(d / "video.npy", rng.randint(0, 256, (n, T_V, 48, 40, 3)).astype(np.uint8))
    np.save(d / "labels.npy", rng.randint(0, 8, n).astype(np.int32))


def test_train_and_predict_clis_on_raw_frames(tmp_path):
    data = tmp_path / "data"
    for seed, (split, n) in enumerate({"train": 12, "val": 6, "test": 6}.items()):
        _write_raw_split(data / split, n, seed)
    overrides = [*NARROW, "dataset.batch_size=4", "training.max_epochs=2",
                 f"dataset.data_dir={data}", f"experiment.save_dir={tmp_path}",
                 "experiment.name=raw_frames"]
    results = port_train.main(["--config", CONFIG, *overrides])
    assert results and all(np.isfinite(v) for v in results.values())
    ckpt = tmp_path / "raw_frames" / "best.ckpt"
    assert ckpt.exists()
    port_predict.main(["--checkpoint", str(ckpt), "--config", CONFIG, "--split", "test",
                       "--out", str(tmp_path / "pred"), *overrides])
    logits = np.load(tmp_path / "pred" / "logits.npy")
    assert logits.shape == (6, 8) and np.isfinite(logits).all()
