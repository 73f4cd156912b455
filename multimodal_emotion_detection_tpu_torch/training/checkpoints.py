"""The port's checkpoint: ``torch.save({"state_dict", "meta"})``.

``meta`` holds plain values (numbers, strings, lists, dicts), so the file
loads with ``weights_only=True`` and unpickles no arbitrary objects.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Tuple

import torch


def save_checkpoint(path: Path, state_dict: Dict[str, torch.Tensor],
                    meta: Dict[str, Any]) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    cpu_state = {k: v.detach().cpu() for k, v in state_dict.items()}
    torch.save({"state_dict": cpu_state, "meta": dict(meta)}, path)


def load_checkpoint(path: Path) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
    blob = torch.load(Path(path), map_location="cpu", weights_only=True)
    return blob["state_dict"], blob["meta"]
