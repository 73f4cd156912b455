"""Training-curve plotter from a metrics.csv log (the port's copy of
the JAX package's, which reads the same CSV columns).

    python -m multimodal_emotion_detection_tpu_torch.tools.plot_curves \
        outputs/<run>/csv_logs/version_0/metrics.csv [-o curves.png]

Loss and accuracy per epoch, train and val, side by side; needs matplotlib.
"""

from __future__ import annotations

import argparse
import csv
from pathlib import Path


def plot_curves(csv_path: str, out_path: str | None = None) -> str:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    rows = list(csv.DictReader(open(csv_path)))
    if not rows:
        raise ValueError(f"No rows in {csv_path}")

    def series(col):
        xs, ys = [], []
        for r in rows:
            v = r.get(col, "")
            if v not in ("", None):
                xs.append(float(r.get("epoch", len(xs))))
                ys.append(float(v))
        return xs, ys

    fig, axes = plt.subplots(1, 2, figsize=(11, 4))
    for col, label in (("train/loss", "train"), ("val/loss", "val")):
        xs, ys = series(col)
        if ys:
            axes[0].plot(xs, ys, label=label)
    axes[0].set_xlabel("epoch")
    axes[0].set_ylabel("loss")
    axes[0].set_title("Loss")
    axes[0].legend()
    axes[0].grid(True, linestyle=":", linewidth=0.5)

    for col, label in (("train/acc", "train"), ("val/acc", "val")):
        xs, ys = series(col)
        if ys:
            axes[1].plot(xs, ys, label=label)
    axes[1].set_xlabel("epoch")
    axes[1].set_ylabel("accuracy")
    axes[1].set_title("Accuracy")
    axes[1].legend()
    axes[1].grid(True, linestyle=":", linewidth=0.5)

    fig.tight_layout()
    out = out_path or str(Path(csv_path).with_name("curves.png"))
    fig.savefig(out, dpi=150)
    plt.close(fig)
    print(f"Saved curves to {out}")
    return out


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("csv_path")
    parser.add_argument("-o", "--out", default=None)
    args = parser.parse_args(argv)
    return plot_curves(args.csv_path, args.out)


if __name__ == "__main__":
    main()
