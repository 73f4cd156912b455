"""PyTorch port, the ETL (``data/ravdess.py``, ``data/manifest.py``,
``utils/wav.py``, ``utils/native.py``) against the JAX package's, on the
CPU, on media written inside the test:

* ``parse_ravdess_filename`` / ``map_emotion_label``, the join-key map and
  the stem map, with their errors;
* ``read_wav``: mono (8, 16, 24 and 32-bit), stereo mixdown, the non-PCM
  error;
* ``resample``: the native core (built with g++ from ``csrc/``) against the
  port's scipy route at ``tests/test_native.py``'s bounds (float64 1e-12,
  float32 1e-7), and bit for bit against JAX's ``resample`` on each route
  (its native route loading the port's build of the same source, its scipy
  route with no library); ``peak_normalize_native`` too;
* ``stratified_two_stage_split``: JAX's indices, with sklearn present and
  hidden (``sys.modules``);
* ``build_ravdess_multimodal_raw`` audio-only and
  ``build_manifest_multimodal`` on WAVs and ``.npy``: every split array bit
  for bit JAX's; both CLIs' files byte for byte JAX's;
* a video decode of a clip ``cv2.VideoWriter`` wrote, against JAX's (where
  cv2 is installed);
* the port's train CLI on the CPU over a manifest ETL's output."""

import struct
import sys
import wave
from pathlib import Path

import numpy as np
import pytest
import torch

from multimodal_emotion_detection_tpu.data import manifest as jax_manifest
from multimodal_emotion_detection_tpu.data import ravdess as jax_ravdess
from multimodal_emotion_detection_tpu.utils import native as jax_native
from multimodal_emotion_detection_tpu.utils import wav as jax_wav
from multimodal_emotion_detection_tpu_torch import train as port_train
from multimodal_emotion_detection_tpu_torch.data import manifest, ravdess
from multimodal_emotion_detection_tpu_torch.utils import native, wav

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the suite runs several test workers on the same cores; at these tiny
    # shapes a multi-threaded torch only spins idle threads that slow them all
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def jax_native_route(monkeypatch):
    """JAX's resampler on its native route, loading the port's build of
    the same source (so the route does not depend on whether JAX's own
    library was built)."""
    monkeypatch.setattr(jax_native, "_LIB_PATH", native.build())
    jax_native.load_library.cache_clear()
    assert jax_native.native_available()
    yield
    jax_native.load_library.cache_clear()


@pytest.fixture
def jax_scipy_route(monkeypatch, tmp_path):
    """JAX's resampler with no native library: its scipy route."""
    monkeypatch.setattr(jax_native, "_LIB_PATH", tmp_path / "missing.so")
    jax_native.load_library.cache_clear()
    assert not jax_native.native_available()
    yield
    jax_native.load_library.cache_clear()


def write_wav(path, data, sr, sampwidth=2, channels=1):
    data = np.clip(np.asarray(data, np.float64), -1, 1)
    if sampwidth == 1:
        raw = (data * 127 + 128).astype(np.uint8).tobytes()
    elif sampwidth == 2:
        raw = (data * 32767).astype("<i2").tobytes()
    elif sampwidth == 3:
        ints = (data * (2 ** 23 - 1)).astype("<i4")
        raw = b"".join(struct.pack("<i", int(v))[:3] for v in ints)
    else:
        raw = (data * (2 ** 31 - 1)).astype("<i4").tobytes()
    with wave.open(str(path), "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(sampwidth)
        w.setframerate(sr)
        w.writeframes(raw)


def _assert_splits_equal(ours, theirs):
    assert len(ours) == len(theirs)
    for split_o, split_t in zip(ours, theirs):
        assert sorted(split_o) == sorted(split_t)
        for key in split_o:
            assert split_o[key].dtype == split_t[key].dtype, key
            np.testing.assert_array_equal(split_o[key], split_t[key], err_msg=key)


def _assert_trees_equal_bytes(ours: Path, theirs: Path):
    files = sorted(p.relative_to(theirs) for p in theirs.rglob("*.npy"))
    assert files and files == sorted(p.relative_to(ours) for p in ours.rglob("*.npy"))
    for rel in files:
        assert (ours / rel).read_bytes() == (theirs / rel).read_bytes(), rel


def test_filename_parsing_and_the_maps(tmp_path):
    for mod in (ravdess, jax_ravdess):
        meta = mod.parse_ravdess_filename("02-01-06-01-02-01-12.wav")
        assert meta == {"modality": 2, "channel": 1, "emotion": 6, "intensity": 1,
                        "statement": 2, "repetition": 1, "actor": 12}
        assert mod.map_emotion_label(meta) == 5
        with pytest.raises(ValueError, match="Unexpected RAVDESS"):
            mod.parse_ravdess_filename("01-02-03.wav")
        with pytest.raises(ValueError, match="Invalid emotion"):
            mod.map_emotion_label({"emotion": 9})
    paths = []
    for stem in ("03-01-06-01-02-01-12", "01-01-06-01-02-01-12", "02-01-05-01-01-01-01",
                 "03-01-05-01-01-01-01"):
        p = tmp_path / f"{stem}.wav"
        p.touch()
        paths.append(p)
    ours, theirs = ravdess.build_join_key_map(paths), jax_ravdess.build_join_key_map(paths)
    assert ours == theirs and len(ours) == 2
    assert ours["01-06-01-02-01-12"].stem.startswith("01-")
    assert ours["01-05-01-01-01-01"].stem.startswith("02-")
    assert ravdess.build_stem_map(paths) == jax_ravdess.build_stem_map(paths)
    (tmp_path / "sub").mkdir()
    dup = tmp_path / "sub" / paths[0].name
    dup.touch()
    for mod in (ravdess, jax_ravdess):
        with pytest.raises(ValueError, match="Duplicate stem"):
            mod.build_stem_map([paths[0], dup])
        with pytest.raises(ValueError, match="Unexpected RAVDESS"):
            mod.build_join_key_map([tmp_path / "a-b.wav"])


@pytest.mark.parametrize("sampwidth", [1, 2, 3, 4])
def test_read_wav_mono_matches_jax(tmp_path, sampwidth):
    sr = 8000
    y = 0.6 * np.sin(np.linspace(0, 90, 500))
    write_wav(tmp_path / "a.wav", y, sr, sampwidth=sampwidth)
    data, got_sr = wav.read_wav(tmp_path / "a.wav")
    ref, ref_sr = jax_wav.read_wav(tmp_path / "a.wav")
    assert got_sr == ref_sr == sr and data.dtype == np.float32
    np.testing.assert_array_equal(data, ref)
    # 8 bits: the writer truncates to 1/127 steps, the reader scales by 1/128
    np.testing.assert_allclose(data, y, atol=2e-2 if sampwidth == 1 else 1e-4)


def test_read_wav_stereo_mixdown_and_the_non_pcm_error(tmp_path):
    inter = np.empty(200)
    inter[0::2], inter[1::2] = 0.5, -0.25
    write_wav(tmp_path / "s.wav", inter, 8000, channels=2)
    data, _ = wav.read_wav(tmp_path / "s.wav")
    np.testing.assert_array_equal(data, jax_wav.read_wav(tmp_path / "s.wav")[0])
    assert data.shape == (100,)
    np.testing.assert_allclose(data, 0.125, atol=1e-4)
    # a RIFF / WAVE header claiming WAVE_FORMAT_EXTENSIBLE (0xFFFE)
    fmt = struct.pack("<HHIIHH", 0xFFFE, 1, 16000, 32000, 2, 16)
    blob = (b"RIFF" + struct.pack("<I", 36 + len(fmt)) + b"WAVE" + b"fmt "
            + struct.pack("<I", len(fmt)) + fmt + b"data" + struct.pack("<I", 0))
    (tmp_path / "ext.wav").write_bytes(blob)
    for mod in (wav, jax_wav):
        with pytest.raises(ValueError, match="plain-PCM"):
            mod.read_wav(tmp_path / "ext.wav")


@pytest.mark.parametrize("up,down,n", [
    (1, 3, 48000),     # 48 kHz -> 16 kHz (the RAVDESS case)
    (160, 441, 4410),  # 44.1 kHz -> 16 kHz
    (2, 1, 1000),      # upsample
    (3, 2, 777),       # odd length
])
def test_native_resample_poly_matches_its_plain_version(up, down, n):
    x = np.random.RandomState(0).randn(n)
    for beta, half, roll in ((12.9846, 10, 1.0), (wav._KAISER_BEST_BETA,
                             wav._KAISER_BEST_HALF_CYCLES, wav._KAISER_BEST_ROLLOFF)):
        ours = native.resample_poly_native(x, up, down, beta, half, roll)
        plain = native.resample_poly_plain(x, up, down, beta, half, roll)
        assert ours.dtype == plain.dtype == np.float64 and ours.shape == plain.shape
        np.testing.assert_allclose(ours, plain, rtol=1e-12, atol=1e-12)
    # scipy's own default design, as tests/test_native.py holds JAX's
    from scipy.signal import resample_poly

    np.testing.assert_allclose(
        native.resample_poly_native(x, up, down, beta=12.9846),
        resample_poly(x, up, down, window=("kaiser", 12.9846)), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("orig_sr,target_sr", [(48000, 16000), (22050, 16000),
                                               (8000, 16000), (16000, 16000)])
def test_resample_routes_match_jax(orig_sr, target_sr, jax_native_route):
    y = np.random.RandomState(1).randn(orig_sr // 4).astype(np.float32)
    ours = wav.resample(y, orig_sr, target_sr)
    plain = wav.resample(y, orig_sr, target_sr, plain=True)
    assert ours.dtype == plain.dtype == np.float32
    np.testing.assert_allclose(ours, plain, rtol=0, atol=1e-7)
    np.testing.assert_array_equal(ours, jax_wav.resample(y, orig_sr, target_sr))


def test_resample_plain_route_matches_jax_scipy_route(jax_scipy_route):
    y = np.random.RandomState(2).randn(12000).astype(np.float32)
    for orig in (48000, 22050):
        np.testing.assert_array_equal(wav.resample(y, orig, 16000, plain=True),
                                      jax_wav.resample(y, orig, 16000))


def test_peak_normalize_native_matches_jax(jax_native_route):
    x = np.random.RandomState(3).randn(1000).astype(np.float32)
    ours = native.peak_normalize_native(x.copy())
    np.testing.assert_array_equal(ours, jax_native.peak_normalize_native(x.copy()))
    np.testing.assert_allclose(ours, x / np.abs(x).max(), rtol=1e-6)
    # x times the peak's reciprocal: within one float32 ulp of 1
    assert abs(float(np.abs(ours).max()) - 1.0) <= 2.0 ** -23
    np.testing.assert_array_equal(native.peak_normalize_native(np.zeros(4, np.float32)),
                                  np.zeros(4, np.float32))


def test_native_build_is_named_by_its_source():
    path = native.build()
    assert path == native.library_path() and path.exists()
    assert path.parent == ROOT / "build" / "etl_native"
    # the code is the JAX package's native/etl_kernels.cc, only the header
    # comment differs
    body = native.SOURCE.read_text()
    jax_body = (ROOT / "native" / "etl_kernels.cc").read_text()
    assert body[body.index("#include"):] == jax_body[jax_body.index("#include"):]


@pytest.mark.parametrize("sklearn", ["present", "hidden"])
def test_stratified_split_matches_jax(monkeypatch, sklearn):
    if sklearn == "present":
        pytest.importorskip("sklearn")
    else:
        monkeypatch.setitem(sys.modules, "sklearn", None)
        monkeypatch.setitem(sys.modules, "sklearn.model_selection", None)
    rng = np.random.RandomState(0)
    labels = rng.randint(0, 8, size=240)
    actors = rng.randint(1, 25, size=240)
    for strat, val, test in ((labels, 0.15, 0.15), (actors, 0.1, 0.2), (None, 0.25, 0.25)):
        ours = ravdess.stratified_two_stage_split(labels, strat, val, test, 42)
        theirs = jax_ravdess.stratified_two_stage_split(labels, strat, val, test, 42)
        for a, b in zip(ours, theirs):
            np.testing.assert_array_equal(a, b)
        assert sorted(np.concatenate(ours).tolist()) == list(range(240))
    for mod in (ravdess, jax_ravdess):
        with pytest.raises(ValueError, match="val_size"):
            mod.stratified_two_stage_split(labels, labels, 0.5, 0.5)


def _ravdess_wavs(root: Path, sr: int = 22050, seconds: float = 1.0, actors=(1, 2)):
    rng = np.random.RandomState(0)
    root.mkdir(parents=True, exist_ok=True)
    for emotion in range(1, 9):
        for rep in (1, 2):
            for actor in actors:
                stem = f"03-01-{emotion:02d}-01-01-{rep:02d}-{actor:02d}"
                write_wav(root / f"{stem}.wav", 0.3 * rng.randn(int(sr * seconds)), sr)
    return root


def test_ravdess_audio_only_matches_jax(tmp_path, jax_native_route):
    audio = _ravdess_wavs(tmp_path / "wavs")
    kw = dict(use_video=False, val_size=0.25, test_size=0.25)
    ours = ravdess.build_ravdess_multimodal_raw(str(audio), **kw)
    theirs = jax_ravdess.build_ravdess_multimodal_raw(str(audio), **kw)
    _assert_splits_equal(ours, theirs)
    assert sum(len(s["labels"]) for s in ours) == 32
    train = ours[0]
    assert train["audio"].shape[1:] == (48000, 1) and train["audio"].dtype == np.float32
    assert train["labels"].dtype == np.int64
    # 1 s of audio zero-padded to 3 s, each clip peak-normalised
    np.testing.assert_array_equal(np.abs(train["audio"]).max(axis=(1, 2)), 1.0)
    assert not train["audio"][:, 16000:].any()


def test_ravdess_cli_files_match_jax_byte_for_byte(tmp_path, jax_native_route):
    audio = _ravdess_wavs(tmp_path / "wavs", sr=48000, seconds=3.5, actors=(1, 2, 3))
    for mod, out in ((ravdess, tmp_path / "ours"), (jax_ravdess, tmp_path / "theirs")):
        mod.main(["--audio_root", str(audio), "--out_root", str(out), "--no_video"])
    _assert_trees_equal_bytes(tmp_path / "ours", tmp_path / "theirs")
    a = np.load(tmp_path / "ours" / "train" / "audio.npy")
    assert a.shape[1:] == (48000, 1)
    assert not (tmp_path / "ours" / "train" / "video.npy").exists()
    sizes = [len(np.load(tmp_path / "ours" / s / "labels.npy")) for s in ("train", "val", "test")]
    assert sum(sizes) == 48


def _manifest_corpus(root: Path, sr: int = 16000, n_per: int = 3):
    rng = np.random.RandomState(0)
    rows = ["label,strat_key,audio,mocap"]
    (root / "clips").mkdir(parents=True)
    (root / "feats").mkdir()
    for session in ("Ses01", "Ses02"):
        for emotion in range(8):
            for utt in range(n_per):
                stem = f"{session}_e{emotion}_u{utt}"
                write_wav(root / "clips" / f"{stem}.wav", 0.4 * rng.randn(int(0.6 * sr)), sr)
                np.save(root / "feats" / f"{stem}.npy",
                        rng.randn(rng.randint(4, 9), 16).astype(np.float32))
                rows.append(f"{emotion},{session},clips/{stem}.wav,feats/{stem}.npy")
    (root / "manifest.csv").write_text("\n".join(rows) + "\n")
    return root / "manifest.csv"


def test_manifest_etl_matches_jax(tmp_path, jax_native_route):
    path = _manifest_corpus(tmp_path / "corpus", sr=22050)
    kw = dict(audio_seconds=1.0, feature_len=6, val_size=0.25, test_size=0.25)
    ours = manifest.build_manifest_multimodal(path, tmp_path / "ours", **kw)
    theirs = jax_manifest.build_manifest_multimodal(path, tmp_path / "theirs", **kw)
    _assert_splits_equal([ours[s] for s in ("train", "val", "test")],
                         [theirs[s] for s in ("train", "val", "test")])
    _assert_trees_equal_bytes(tmp_path / "ours", tmp_path / "theirs")
    assert ours["train"]["audio"].shape[1:] == (16000, 1)
    assert ours["train"]["mocap"].shape[1:] == (6, 16)  # padded / truncated
    assert sum(len(s["labels"]) for s in ours.values()) == 48
    # the errors
    (tmp_path / "bad.csv").write_text("foo,bar\n1,2\n")
    (tmp_path / "missing.csv").write_text("label,audio\n0,nope.wav\n")
    (tmp_path / "empty.csv").write_text("label,audio\n")
    for mod in (manifest, jax_manifest):
        with pytest.raises(ValueError, match="label"):
            mod.read_manifest(tmp_path / "bad.csv")
        with pytest.raises(ValueError, match="Empty manifest"):
            mod.read_manifest(tmp_path / "empty.csv")
        with pytest.raises(FileNotFoundError, match="audio"):
            mod.build_manifest_multimodal(tmp_path / "missing.csv", tmp_path / "o")


def test_manifest_cli_files_match_jax_byte_for_byte(tmp_path, jax_native_route, capsys):
    path = _manifest_corpus(tmp_path / "corpus", sr=48000)
    for mod, out in ((manifest, "ours"), (jax_manifest, "theirs")):
        mod.main(["--manifest", str(path), "--out_root", str(tmp_path / out),
                  "--feature_len", "5", "--audio_seconds", "0.5", "--seed", "7"])
    printed = capsys.readouterr().out
    assert printed.count("train: ") == 2
    _assert_trees_equal_bytes(tmp_path / "ours", tmp_path / "theirs")


def test_video_decode_matches_jax(tmp_path):
    cv2 = pytest.importorskip("cv2")
    rng = np.random.RandomState(4)
    clips = {}
    for n_frames in (30, 10):  # more frames than sampled, and fewer (padded)
        path = tmp_path / f"01-01-03-01-01-01-{n_frames:02d}.mp4"
        writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 30, (80, 96))
        assert writer.isOpened()
        for _ in range(n_frames):
            writer.write(rng.randint(0, 256, (96, 80, 3), dtype=np.uint8))
        writer.release()
        clips[n_frames] = path
    for n_frames, path in clips.items():
        ours = ravdess.load_raw_video_frames(path)
        theirs = jax_ravdess.load_raw_video_frames(path)
        assert ours.shape == (24, 4096) and ours.dtype == np.float32
        np.testing.assert_array_equal(ours, theirs)
        assert ours.min() >= 0 and ours.max() <= 1
        if n_frames < 24:
            assert not ours[n_frames:].any() and ours[:n_frames].any()
    for mod in (ravdess, jax_ravdess):
        with pytest.raises(IOError, match="Failed to open"):
            mod.load_raw_video_frames(tmp_path / "none.mp4")


def test_train_cli_over_the_manifest_etl(tmp_path, jax_native_route):
    path = _manifest_corpus(tmp_path / "corpus")
    manifest.main(["--manifest", str(path), "--out_root", str(tmp_path / "ds"),
                   "--audio_seconds", "1.0", "--feature_len", "6",
                   "--modalities", "audio", "mocap"])
    # the manifest's feature track serves as the video modality's frames
    for split in ("train", "val", "test"):
        (tmp_path / "ds" / split / "mocap.npy").rename(tmp_path / "ds" / split / "video.npy")
    results = port_train.main([
        "--config", str(ROOT / "configs" / "base.yaml"),
        "model.frontend.audio=logmel", "model.encoders.audio.hidden_dim=32",
        "model.encoders.video.input_dim=16", "model.encoders.video.hidden_dim=16",
        "model.output_dim=16", "model.hidden_dim=16", "dataset.batch_size=8",
        "training.max_epochs=2", "runtime.platform=cpu",
        f"dataset.data_dir={tmp_path / 'ds'}", f"experiment.save_dir={tmp_path}",
        "experiment.name=etl"])
    assert results and all(np.isfinite(v) for v in results.values())
    assert (tmp_path / "etl" / "best.ckpt").exists()
    assert (tmp_path / "etl" / "results.json").exists()
