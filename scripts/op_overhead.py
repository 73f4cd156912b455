"""What the serving kernels' custom-op dispatch costs on the card.

    python3 scripts/op_overhead.py [--reps 110]

The six serving wrappers (``logmel_cuda``, ``lstm2_infer``, ``gru2_infer``,
``lstm1_infer``, ``gru1_infer``, ``flash_fwd``) call ``med_torch`` custom
ops whose CUDA kernels launch the ``csrc/`` kernels.  For the flagship,
the GRU, the big, the big GRU and the transformer configs
(``chip_smoke.py``'s overrides, seeded weights, raw clips in), in one
process and in turns, this prints:

* the b32 and b1 ``training.steps.forward`` p50 / p90 (host clock around
  synchronize) through the ops, and with every wrapper's op call replaced
  by a direct call of the op's CUDA kernel (the launch function, what the
  wrappers called before the ops), whose logits must be the ops' bit for
  bit; op, direct, direct, op;
* each op's host time for one call (an empty queue: synchronized before,
  not after; median of ``--reps``) through the op and directly, on the
  shapes of the flagship's and the transformer's b32 forward.

Needs a CUDA card; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def _smoke():
    """This checkout's chip_smoke.py, for its configs and timing."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@contextlib.contextmanager
def direct_launches():
    """Every serving wrapper's op call replaced by its CUDA kernel."""
    from multimodal_emotion_detection_tpu_torch.models import classifier, recurrent
    from multimodal_emotion_detection_tpu_torch.ops import flash_attention as fa
    from multimodal_emotion_detection_tpu_torch.ops import logmel
    from multimodal_emotion_detection_tpu_torch.ops import lstm_kernel as lk

    patched = [(classifier, "log_mel_spectrogram", logmel._launch),
               (recurrent, "lstm2_infer", lk._lstm2_infer_launch),
               (recurrent, "gru2_infer", lk._gru2_infer_launch),
               (recurrent, "lstm1_infer", lk._lstm1_infer_launch),
               (recurrent, "gru1_infer", lk._gru1_infer_launch),
               (fa, "flash_fwd", fa._fwd_launch)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in patched]
    try:
        for mod, name, fn in patched:
            setattr(mod, name, fn)
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def one_call_ms(fn, reps: int) -> float:
    """Median host time of one call of ``fn`` on an empty queue, in ms."""
    times = []
    for _ in range(reps + 5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append(1e3 * (time.perf_counter() - t0))
    torch.cuda.synchronize()
    return statistics.median(times[5:])


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=110)
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("op_overhead: torch sees no CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(f"[op_overhead] card: {smi.stdout.strip()}, torch {torch.__version__}", flush=True)
    smoke = _smoke()
    from multimodal_emotion_detection_tpu_torch.config import load_config
    from multimodal_emotion_detection_tpu_torch.models.classifier import (
        classifier_from_config,
        init_weights,
        logmel_params_from_config,
    )
    from multimodal_emotion_detection_tpu_torch.ops import flash_attention as fa
    from multimodal_emotion_detection_tpu_torch.ops import logmel
    from multimodal_emotion_detection_tpu_torch.ops import lstm_kernel as lk
    from multimodal_emotion_detection_tpu_torch.training.steps import forward

    dev = torch.device("cuda")
    rng = np.random.RandomState(2)
    clips = {"audio": torch.from_numpy(rng.randn(32, 48000, 1).astype(np.float32)).to(dev),
             "video": torch.from_numpy(rng.rand(32, 24, 4096).astype(np.float32)).to(dev)}
    base = str(ROOT / "configs" / "base.yaml")
    flagship = ["model.frontend.audio=logmel"]
    for tag, overrides in (("serve", flagship), ("serve_gru", smoke.GRU),
                           ("serve_big", smoke.BIG), ("serve_big_gru", smoke.BIG_GRU),
                           ("serve_tf", smoke.TRANSFORMER)):
        cfg = load_config(base, [*overrides, "model.frontend.cache=false"])
        model = init_weights(classifier_from_config(cfg),
                             torch.Generator().manual_seed(0)).to(dev).eval()
        for label, batch in (("b32", clips), ("b1", {k: v[:1].contiguous()
                                                      for k, v in clips.items()})):
            via_op = forward(model, batch)
            with direct_launches():
                direct = forward(model, batch)
            if not torch.equal(via_op, direct):
                sys.exit(f"op_overhead: [{tag}] {label}: the direct launches' logits "
                         "differ from the ops'")
            p50s = {"op": [], "direct": []}
            for how in ("op", "direct", "direct", "op"):
                with direct_launches() if how == "direct" else contextlib.nullcontext():
                    p50, p90 = smoke.host_ms(lambda: forward(model, batch), reps=opts.reps)
                p50s[how].append(f"{p50:.4f} / {p90:.4f}")
            print(f"[op_overhead] [{tag}] {label} forward p50 / p90 ms (op, direct, "
                  f"direct, op): through the ops {', '.join(p50s['op'])}; direct "
                  f"{', '.join(p50s['direct'])}; logits bit for bit", flush=True)

    # one call of each op on the flagship's and the transformer's b32 shapes
    params = logmel_params_from_config(load_config(base, flagship).model.frontend)
    g = torch.Generator(device=dev).manual_seed(0)

    def rand(*shape):
        return 0.05 * torch.randn(*shape, generator=g, device=dev)

    layer = [{"w_ih": rand(64, 1024), "w_hh": rand(256, 1024), "b": rand(1024)},
             {"w_ih": rand(256, 1024), "w_hh": rand(256, 1024), "b": rand(1024)}]
    gru = [{"w_ih": rand(64, 768), "w_hh": rand(256, 768), "b_ih": rand(768),
            "b_hh": rand(768)},
           {"w_ih": rand(256, 768), "w_hh": rand(256, 768), "b_ih": rand(768),
            "b_hh": rand(768)}]
    x, ih4, ih3 = rand(32, 372, 64), rand(372, 32, 2048), rand(372, 32, 1536)
    w4, w3, b3 = rand(512, 2048), rand(512, 1536), rand(1536)
    q, k, v = (rand(32, 4, 372, 64) for _ in range(3))
    wave = clips["audio"]
    for name, via_op, direct in (
            ("logmel", lambda: logmel.logmel_cuda(wave, params),
             lambda: logmel._launch(wave, params)),
            ("lstm2_infer", lambda: lk.lstm2_infer(x, *layer),
             lambda: lk._lstm2_infer_launch(x, *layer)),
            ("gru2_infer", lambda: lk.gru2_infer(x, *gru),
             lambda: lk._gru2_infer_launch(x, *gru)),
            ("lstm1_infer", lambda: lk.lstm1_infer(ih4, w4, True),
             lambda: lk._lstm1_infer_launch(ih4, w4, True)),
            ("gru1_infer", lambda: lk.gru1_infer(ih3, w3, b3, True),
             lambda: lk._gru1_infer_launch(ih3, w3, b3, True)),
            ("flash_fwd", lambda: fa.flash_fwd(q, k, v, None, None, 0.0),
             lambda: fa._fwd_launch(q, k, v, None, None, 0.0))):
        with torch.inference_mode():
            times = [one_call_ms(fn, opts.reps) for fn in (via_op, direct, direct, via_op)]
        print(f"[op_overhead] {name}: one call's host time (op, direct, direct, op) "
              + ", ".join(f"{t:.4f}" for t in times) + " ms", flush=True)


if __name__ == "__main__":
    main()
