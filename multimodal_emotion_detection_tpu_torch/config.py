"""Config system: dataclass tree + YAML + ``a.b.c=value`` CLI overrides.

The port's own copy of the JAX package's schema, so both packages read the
same ``configs/*.yaml`` files and reject the same unknown keys:

* one YAML tree ``seed / experiment / dataset / model / training /
  evaluation / outputs`` plus ``parallel`` and ``runtime``;
* dotted CLI overrides (``training.learning_rate=5e-4``) with YAML-typed
  values;
* struct-mode behaviour: unknown keys are rejected with a clear error.

Keys that choose a route on the TPU (``model.frontend.use_pallas``,
``model.encoders.*.inference_kernel``, ``scan_unroll``,
``runtime.lstm_kernels`` and the like) are accepted for schema parity.  In
the port the route is chosen by the tensor's device instead: the
hand-written CUDA kernels on the card, their plain PyTorch versions on the
CPU.

Per-modality encoder configs stay open dictionaries because their keys
depend on the encoder type; the encoder factory validates them.
"""

from __future__ import annotations

import copy
import dataclasses
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional

import yaml


class ConfigError(ValueError):
    """Raised for unknown keys or malformed override strings."""


# ---------------------------------------------------------------------------
# Schema
# ---------------------------------------------------------------------------


@dataclass
class ExperimentConfig:
    name: str = "ravdess_audio_video_baseline"
    save_dir: str = "./outputs"
    save_top_k: int = 1
    log_every_n_steps: int = 50


@dataclass
class DatasetConfig:
    name: str = "ravdess"  # anything != 'synthetic' -> on-disk .npy dataset
    data_dir: str = "../multimodal-dataset"
    modalities: List[str] = field(default_factory=lambda: ["audio", "video"])
    batch_size: int = 32
    num_workers: int = 4
    num_classes: int = 8
    # synthetic-dataset knobs
    num_samples: int = 10000
    num_samples_eval: int = 2000
    modality_dim: int = 32
    sequence_length: int = 100
    device_resident: bool = True
    mmap: bool = False


@dataclass
class FrontendConfig:
    """Audio feature frontend.

    ``audio="raw"`` feeds the raw ``(B, 48000, 1)`` waveform to the
    encoder; ``"logmel"`` / ``"mfcc"`` run the fused frame + window + DFT +
    mel + log frontend first (~372 frames at the defaults).
    """

    audio: str = "raw"  # 'raw' | 'logmel' | 'mfcc'
    sample_rate: int = 16000
    n_fft: int = 512
    hop_length: int = 128
    win_length: int = 400
    n_mels: int = 64
    fmin: float = 0.0
    fmax: Optional[float] = None  # None -> sample_rate / 2
    log_epsilon: float = 1e-6
    n_mfcc: int = 40  # only for audio='mfcc'
    video: str = "none"  # 'none' | 'resize'
    video_height: int = 64
    video_width: int = 64
    use_pallas: bool = True  # schema parity; the device picks the route
    cache: bool = False


@dataclass
class ModelConfig:
    output_dim: int = 128
    fusion_type: str = "early"
    hidden_dim: int = 256
    num_heads: int = 4
    dropout: float = 0.3
    train_fusion: str = "concat"  # 'concat' | 'library'
    use_modality_mask: bool = False
    encoders: Dict[str, Dict[str, Any]] = field(
        default_factory=lambda: {
            "audio": {
                "type": "sequence",
                "input_dim": 1,
                "encoder_type": "lstm",
                "hidden_dim": 256,
                "output_dim": 128,
                "num_layers": 2,
                "dropout": 0.1,
            },
            "video": {
                "type": "frame",
                "input_dim": 4096,
                "temporal_pooling": "attention",
                "hidden_dim": 256,
                "output_dim": 128,
                "dropout": 0.1,
            },
        }
    )
    frontend: FrontendConfig = field(default_factory=FrontendConfig)


@dataclass
class AugmentationConfig:
    modality_dropout: float = 0.1


@dataclass
class TrainingConfig:
    optimizer: str = "adamw"
    learning_rate: float = 1.0e-3
    weight_decay: float = 1.0e-4
    scheduler: str = "none"
    warmup_steps: int = 0
    scheduler_step_size: int = 30
    scheduler_gamma: float = 0.1
    max_epochs: int = 50
    early_stopping_patience: int = 10
    val_every_n_epochs: int = 1
    gradient_clip_norm: float = 1.0
    augmentation: AugmentationConfig = field(default_factory=AugmentationConfig)


@dataclass
class EvaluationConfig:
    num_calibration_bins: int = 15
    mc_dropout_samples: int = 10


@dataclass
class OutputsConfig:
    experiments_dir: str = "./experiments"


@dataclass
class ParallelConfig:
    data_parallel: int = -1
    model_parallel: int = 1
    min_shard_dim: int = 256
    strategy: str = "gspmd"
    shard_data_rows: bool = False


# runtime.compute_dtype's values: the model's compute dtype, the parameters
# float32 under either
COMPUTE_DTYPES = ("float32", "bfloat16")


@dataclass
class RuntimeConfig:
    # None, 'gpu' or 'cuda' -> the CUDA card (an error if there is none);
    # 'cpu' -> the CPU (the plain PyTorch versions of the kernels)
    platform: Optional[str] = None
    compute_dtype: str = "float32"  # COMPUTE_DTYPES
    matmul_precision: str = "default"
    deterministic: bool = True
    debug_nans: bool = False
    profile_dir: Optional[str] = None
    donate_state: bool = True
    lstm_kernels: str = "auto"
    lstm_residual_dtype: str = "float32"
    lstm_remat_gates: bool = False
    checkpoint_backend: str = "auto"
    prng_impl: str = "threefry2x32"
    epoch_scan: str = "auto"
    epoch_pregather: bool = False


@dataclass
class Config:
    seed: int = 42
    experiment: ExperimentConfig = field(default_factory=ExperimentConfig)
    dataset: DatasetConfig = field(default_factory=DatasetConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    training: TrainingConfig = field(default_factory=TrainingConfig)
    evaluation: EvaluationConfig = field(default_factory=EvaluationConfig)
    outputs: OutputsConfig = field(default_factory=OutputsConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)
    runtime: RuntimeConfig = field(default_factory=RuntimeConfig)


# Fields that are open dictionaries: merge freely, no unknown-key rejection.
_OPEN_DICT_FIELDS = {("model", "encoders")}


# ---------------------------------------------------------------------------
# Merge / override machinery
# ---------------------------------------------------------------------------


def _merge_into_dataclass(obj: Any, data: Dict[str, Any], path: str = "") -> Any:
    """Recursively merge a dict into a dataclass, rejecting unknown keys."""
    if not dataclasses.is_dataclass(obj):
        raise ConfigError(f"Internal error: {path or '<root>'} is not a config node")
    names = {f.name: f for f in dataclasses.fields(obj)}
    for key, value in data.items():
        here = f"{path}.{key}" if path else key
        if key not in names:
            valid = ", ".join(sorted(names))
            raise ConfigError(
                f"Unknown config key '{here}'. Valid keys at this level: {valid}"
            )
        current = getattr(obj, key)
        if dataclasses.is_dataclass(current) and isinstance(value, dict):
            _merge_into_dataclass(current, value, here)
        elif _is_open_dict(here) and isinstance(value, dict):
            merged = copy.deepcopy(current) if isinstance(current, dict) else {}
            for sub_key, sub_val in value.items():
                if (
                    isinstance(sub_val, dict)
                    and isinstance(merged.get(sub_key), dict)
                ):
                    merged[sub_key] = {**merged[sub_key], **sub_val}
                else:
                    merged[sub_key] = sub_val
            setattr(obj, key, merged)
        else:
            setattr(obj, key, _coerce(value, current, here))
    return obj


def _is_open_dict(dotted: str) -> bool:
    parts = tuple(dotted.split("."))
    return any(parts[: len(open_path)] == open_path for open_path in _OPEN_DICT_FIELDS)


def _coerce(value: Any, current: Any, path: str) -> Any:
    """Light type coercion so YAML scalars land with the schema's type."""
    if value is None or current is None:
        return value
    if isinstance(current, bool):
        if isinstance(value, bool):
            return value
        raise ConfigError(f"Config key '{path}' expects a bool, got {value!r}")
    if isinstance(current, str) and isinstance(value, bool):
        # YAML 1.1 parses on/off (and yes/no/true/false) as bools before
        # we see the raw token; string-typed switches take them back
        return "on" if value else "off"
    if isinstance(current, int) and not isinstance(current, bool):
        if isinstance(value, int):
            return value
        if isinstance(value, float) and value.is_integer():
            return int(value)
        raise ConfigError(f"Config key '{path}' expects an int, got {value!r}")
    if isinstance(current, float):
        if isinstance(value, (int, float)):
            return float(value)
        if isinstance(value, str):
            # YAML 1.1 reads '5e-4' as a string
            try:
                return float(value)
            except ValueError:
                pass
        raise ConfigError(f"Config key '{path}' expects a float, got {value!r}")
    return value


def _set_dotted(config: Config, dotted_key: str, value: Any) -> None:
    parts = dotted_key.split(".")
    nested: Dict[str, Any] = {}
    cursor = nested
    for part in parts[:-1]:
        cursor[part] = {}
        cursor = cursor[part]
    cursor[parts[-1]] = value
    _merge_into_dataclass(config, nested)


def apply_overrides(config: Config, overrides: List[str]) -> Config:
    """Apply ``key.path=value`` overrides (values parsed as YAML scalars)."""
    for item in overrides:
        if "=" not in item:
            raise ConfigError(
                f"Override '{item}' is not of the form key.path=value"
            )
        key, _, raw = item.partition("=")
        key = key.strip()
        if not key:
            raise ConfigError(f"Override '{item}' has an empty key")
        try:
            value = yaml.safe_load(raw)
        except yaml.YAMLError as exc:
            raise ConfigError(f"Could not parse value in override '{item}': {exc}")
        _set_dotted(config, key, value)
    return config


def load_config(
    path: Optional[str] = None,
    overrides: Optional[List[str]] = None,
) -> Config:
    """Load YAML config (defaults if ``path`` is None) then apply overrides."""
    config = Config()
    if path is not None:
        with open(path) as f:
            data = yaml.safe_load(f) or {}
        if not isinstance(data, dict):
            raise ConfigError(f"Config file {path} must contain a mapping")
        _merge_into_dataclass(config, data)
    if overrides:
        apply_overrides(config, overrides)
    if config.runtime.compute_dtype not in COMPUTE_DTYPES:
        raise ConfigError(f"runtime.compute_dtype={config.runtime.compute_dtype!r}: "
                          f"neither of {COMPUTE_DTYPES}")
    return config


# ---------------------------------------------------------------------------
# Serialization / snapshot
# ---------------------------------------------------------------------------


def config_to_dict(config: Any) -> Dict[str, Any]:
    return dataclasses.asdict(config)


def config_to_yaml(config: Config) -> str:
    return yaml.safe_dump(config_to_dict(config), sort_keys=False)


def snapshot_config(config: Config, run_dir: Path,
                    overrides: Optional[List[str]] = None) -> Path:
    """Write the resolved config and the overrides under
    ``run_dir/config_snapshot``."""
    snap_dir = Path(run_dir) / "config_snapshot"
    snap_dir.mkdir(parents=True, exist_ok=True)
    (snap_dir / "config.yaml").write_text(config_to_yaml(config))
    (snap_dir / "overrides.yaml").write_text(
        yaml.safe_dump(list(overrides or []), sort_keys=False))
    return snap_dir
