"""Process-level PyTorch runtime setup shared by the entry points."""

from __future__ import annotations

import torch

_CARD = (None, "gpu", "cuda")


def device_from_config(config) -> torch.device:
    """Resolve ``runtime.platform`` to a device and set the float32 rules.

    ``None``, ``'gpu'`` and ``'cuda'`` mean the CUDA card; without one this
    raises instead of running somewhere else.  ``'cpu'`` means the CPU,
    where every kernel wrapper runs its plain PyTorch version.

    TF32 is switched off for matrix products and cuDNN: the model computes
    in float32, and the frontend it is held against runs its products at
    full float32 precision.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    platform = config.runtime.platform
    if platform == "cpu":
        return torch.device("cpu")
    if platform not in _CARD:
        raise ValueError(
            f"runtime.platform={platform!r}: the PyTorch port runs on "
            "'gpu'/'cuda' (the default) or 'cpu'"
        )
    if not torch.cuda.is_available():
        raise RuntimeError(
            "runtime.platform asks for the CUDA card but torch sees none; "
            "pass runtime.platform=cpu to run on the CPU"
        )
    return torch.device("cuda")
