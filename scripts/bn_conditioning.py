"""How well a float32 train step of the unimodal audio configs can agree
with another: the float32 gradient's distance from the float64 one, and
the float64 gradient's jump under input noise (ReLU kinks after
BatchNorm over every (clip, step) element).

    python scripts/bn_conditioning.py [--device cpu] [--seed 10]

Builds ``configs/audio_only.yaml`` (the CNN) and its MLP form at full
width with seeded weights, computes the log-mel features of 32 seeded
3 s clips once, and runs one ``train_step`` (dropout masks drawn once and
replayed) in float32 and float64; prints each one's largest gradient
error as a fraction of the largest float64 gradient, the running
statistics' error as a fraction of each buffer's largest entry, and the
same step in float64 on features with Gaussian noise of 1e-7, 1e-6 and
1e-5 of their spread.  Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import copy
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from multimodal_emotion_detection_tpu_torch.config import load_config  # noqa: E402
from multimodal_emotion_detection_tpu_torch.models.classifier import (  # noqa: E402
    classifier_from_config,
    init_weights,
    logmel_params_from_config,
)
from multimodal_emotion_detection_tpu_torch.models.noise import Noise  # noqa: E402
from multimodal_emotion_detection_tpu_torch.ops.logmel import (  # noqa: E402
    log_mel_spectrogram,
)
from multimodal_emotion_detection_tpu_torch.training.optim import (  # noqa: E402
    build_optimizer,
)
from multimodal_emotion_detection_tpu_torch.training.steps import train_step  # noqa: E402


def step(model, cfg, feats, labels, dtype, noise):
    """Gradients and buffers (float64, on the CPU) after one train step."""
    m = copy.deepcopy(model).to(feats.device, dtype)
    opt, _ = build_optimizer(cfg.training, m.parameters(), 3)
    b = feats.shape[0]
    valid = torch.ones(b, device=feats.device)
    train_step(m, opt, {"audio": feats.to(dtype)}, labels, torch.arange(b, device=feats.device),
               valid, lr=cfg.training.learning_rate, clip_norm=cfg.training.gradient_clip_norm,
               modality_dropout=0.0, noise=noise)
    return ({k: p.grad.detach().cpu().double() for k, p in m.named_parameters()},
            {k: v.detach().cpu().double() for k, v in m.named_buffers()})


def grad_err(grads, ref):
    top = max(float(g.abs().max()) for g in ref.values())
    errs = {k: float((grads[k] - g).abs().max()) / top for k, g in ref.items()}
    worst = max(errs, key=errs.get)
    return f"{errs[worst]:.3e} ({worst})"


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    parser.add_argument("--seed", type=int, default=10)
    args = parser.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        sys.exit("bn_conditioning: torch sees no CUDA card; pass --device cpu")
    dev = torch.device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    config = str(ROOT / "configs" / "audio_only.yaml")
    rng = np.random.RandomState(args.seed)
    wave = torch.from_numpy(rng.randn(32, 48000).astype(np.float32)).to(dev)
    labels = torch.from_numpy(rng.randint(0, 8, 32).astype(np.int64)).to(dev)
    for name, extra in (("cnn", []), ("mlp", ["model.encoders.audio.type=mlp"])):
        cfg = load_config(config, extra)
        cfg.model.frontend.cache = True  # the features go in: one log-mel for all
        feats = log_mel_spectrogram(wave, logmel_params_from_config(cfg.model.frontend))
        model = init_weights(classifier_from_config(cfg), torch.Generator().manual_seed(0))
        noise = Noise(torch.Generator(device=dev).manual_seed(0))
        g32, b32 = step(model, cfg, feats, labels, torch.float32, noise)
        g64, b64 = step(model, cfg, feats, labels, torch.float64, Noise(replay=noise.drawn))
        buf = max(float((b32[k] - b).abs().max()) / float(b.abs().max()) for k, b in b64.items())
        print(f"[{name}] float32 vs float64: gradients {grad_err(g32, g64)} of the largest; "
              f"running statistics {buf:.3e} of a buffer's largest entry")
        spread = float(feats.std())
        for scale in (1e-7, 1e-6, 1e-5):
            gen = torch.Generator(device=dev).manual_seed(1)
            noisy = feats.double() + scale * spread * torch.randn(
                feats.shape, generator=gen, device=dev, dtype=torch.float64)
            gn, _ = step(model, cfg, noisy, labels, torch.float64, Noise(replay=noise.drawn))
            print(f"[{name}] float64 with input noise {scale:.0e} of the features' spread: "
                  f"gradients move {grad_err(gn, g64)} of the largest")


if __name__ == "__main__":
    main()
