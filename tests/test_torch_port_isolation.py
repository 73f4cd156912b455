"""PyTorch port: it imports nothing of JAX or the JAX package, and its
kernel wrappers take the plain path only for CPU tensors."""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from multimodal_emotion_detection_tpu_torch.models.recurrent import FusedStackedRNN
from multimodal_emotion_detection_tpu_torch.ops import flash_attention as fa
from multimodal_emotion_detection_tpu_torch.ops import logmel, lstm_kernel
from multimodal_emotion_detection_tpu_torch.ops.lstm_vjp import (
    fused_gru_final,
    fused_lstm_final,
)

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "multimodal_emotion_detection_tpu"}


def _imported_top_levels(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]


def test_port_and_chip_smoke_import_no_jax():
    files = sorted((ROOT / "multimodal_emotion_detection_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 15
    bad = {
        str(f.relative_to(ROOT)): sorted(set(_imported_top_levels(f)) & FORBIDDEN)
        for f in files
    }
    assert not {f: mods for f, mods in bad.items() if mods}


# the reference checkpoint import, the ETL and its native core, the video
# resize and the flop counts: host code beside the kernels, JAX-free too;
# and the image encoder's ResNet backbone, cuDNN's convolutions
HOST_MODULES = ("utils.torch_import", "utils.wav", "utils.native", "utils.flops",
                "ops.resize", "data.ravdess", "data.manifest", "models.resnet")


@pytest.mark.parametrize("module", HOST_MODULES)
def test_host_modules_load_no_jax(module):
    path = ROOT / "multimodal_emotion_detection_tpu_torch" / (module.replace(".", "/") + ".py")
    assert not set(_imported_top_levels(path)) & FORBIDDEN
    # imported alone in a fresh interpreter, nothing of JAX comes with it
    code = (f"import sys, multimodal_emotion_detection_tpu_torch.{module}\n"
            f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {sorted(FORBIDDEN)!r})\n"
            "print(bad)\nsys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True)
    assert proc.returncode == 0, proc.stdout + proc.stderr


COUNTERS = (logmel.LOGMEL, lstm_kernel.LSTM2_INFER, lstm_kernel.LSTM2_TRAIN_FWD,
            lstm_kernel.LSTM2_BWD_CHAIN, lstm_kernel.LSTM1_TRAIN_FWD,
            lstm_kernel.LSTM1_INFER, lstm_kernel.LSTM_BWD_CHAIN,
            lstm_kernel.GRU2_INFER, lstm_kernel.GRU2_TRAIN_FWD,
            lstm_kernel.GRU2_BWD_CHAIN, lstm_kernel.GRU1_TRAIN_FWD,
            lstm_kernel.GRU1_INFER, lstm_kernel.GRU_BWD_CHAIN, fa.FLASH_FWD, fa.FLASH_BWD_FUSED,
            fa.FLASH_BWD_DKV, fa.FLASH_BWD_DQ)


def test_cpu_tensors_take_the_plain_versions_and_launch_nothing():
    for counter in COUNTERS:
        counter.launches = 0
    rng = np.random.RandomState(0)
    wave = torch.from_numpy(rng.randn(2, 2048).astype(np.float32))
    p = logmel.LogMelParams()
    torch.testing.assert_close(logmel.logmel_cuda(wave, p),
                               logmel.logmel_frames(wave, p), rtol=0, atol=0)
    x = torch.from_numpy(rng.randn(2, 5, 3).astype(np.float32))
    g = torch.Generator().manual_seed(0)
    l0, l1 = ({"w_ih": torch.randn(d, 32, generator=g),
               "w_hh": torch.randn(8, 32, generator=g),
               "b": torch.randn(32, generator=g)} for d in (3, 8))
    torch.testing.assert_close(lstm_kernel.lstm2_infer(x, l0, l1),
                               lstm_kernel.lstm2_infer_reference(x, l0, l1),
                               rtol=0, atol=0)
    # the training pair, through the autograd Function
    keep = torch.ones(5, 2, 8)
    p0 = {k: v.clone().requires_grad_() for k, v in l0.items()}
    p1 = {k: v.clone().requires_grad_() for k, v in l1.items()}
    fused_lstm_final(x, keep[:, None], (p0, p1)).sum().backward()
    assert all(p.grad is not None for p in (*p0.values(), *p1.values()))
    # the layered route (3 layers), training and eval
    p2 = {k: v.detach().clone().requires_grad_() for k, v in p1.items()}
    fused_lstm_final(x, torch.ones(5, 2, 2, 8), (p0, p1, p2)).sum().backward()
    assert p2["w_hh"].grad is not None
    rnn = FusedStackedRNN(3, 8, num_layers=3).eval()
    with torch.no_grad():
        assert rnn(x).shape == (2, 8)
    # the 2-layer GRU, training and eval
    gru = FusedStackedRNN(3, 8, cell_type="gru")
    gru(x).sum().backward()
    assert all(p.grad is not None for p in gru.parameters())
    with torch.no_grad():
        assert gru.eval()(x).shape == (2, 8)
    # the layered GRU (3 layers), training and eval
    g3 = [{k: torch.randn(d if k == "w_ih" else 8, 24, generator=g).requires_grad_()
           if k.startswith("w") else torch.randn(24, generator=g).requires_grad_()
           for k in ("w_ih", "w_hh", "b_ih", "b_hh")} for d in (3, 8, 8)]
    fused_gru_final(x, torch.ones(5, 2, 2, 8), g3).sum().backward()
    assert all(p.grad is not None for layer in g3 for p in layer.values())
    with torch.no_grad():
        assert FusedStackedRNN(3, 8, num_layers=3, cell_type="gru").eval()(x).shape == (2, 8)
    # flash attention, both backward routes
    q = torch.from_numpy(rng.randn(2, 2, 5, 4).astype(np.float32)).requires_grad_()
    seed = torch.tensor([7], dtype=torch.int64)
    fa.flash_attention(q, q, q, dropout_rate=0.1, dropout_seed=seed).sum().backward()
    args = (q.detach(), q.detach(), q.detach(), None, seed, 0.1, q.detach(),
            torch.zeros(2, 2, 5), torch.zeros(2, 2, 5))
    assert fa.flash_bwd_dkv(*args)[0].shape == fa.flash_bwd_dq(*args).shape
    assert [c.launches for c in COUNTERS] == [0] * len(COUNTERS)
