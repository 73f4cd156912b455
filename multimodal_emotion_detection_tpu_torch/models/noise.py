"""Where a training step's random masks come from.

The JAX package threads an explicit PRNG key through the train step; the
port threads a ``Noise``: every dropout mask and the modality-dropout mask
of one step are drawn from its ``torch.Generator`` (on the device the
tensors live on), in a fixed order.  ``drawn`` keeps what was drawn, and
``Noise(replay=drawn)`` hands the same masks back in the same order, so
one step can be repeated on another device with identical masks.  An
L-layer LSTM draws its L-1 inter-layer keep masks as one (T, L-1, B, H)
mask, so the draw order of a step does not depend on the depth.  A
transformer block draws one Philox seed for its attention-probability
dropout (``Noise.seed``), then its feed-forward keep mask.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch


class Noise:
    def __init__(self, generator: Optional[torch.Generator] = None,
                 replay: Optional[Sequence[torch.Tensor]] = None):
        if (generator is None) == (replay is None):
            raise ValueError("Noise takes exactly one of a generator and masks to replay")
        self.generator = generator
        self.drawn: List[torch.Tensor] = []
        self._replay = list(replay) if replay is not None else None

    def draw(self, fn: Callable[[torch.Generator], torch.Tensor],
             device: torch.device) -> torch.Tensor:
        """``fn(generator)``, or the next recorded mask moved to ``device``."""
        if self._replay is not None:
            if not self._replay:
                raise RuntimeError("Noise: more masks asked for than were recorded")
            mask = self._replay.pop(0).to(device)
        else:
            mask = fn(self.generator)
        self.drawn.append(mask)
        return mask

    def keep_mask(self, shape, p: float, device: torch.device) -> torch.Tensor:
        """Inverted-dropout mask: Bernoulli(1 - p) / (1 - p), float32."""
        def fn(g):
            probs = torch.full(tuple(shape), 1.0 - p, dtype=torch.float32,
                               device=device)
            return torch.bernoulli(probs, generator=g) / (1.0 - p)

        return self.draw(fn, device)

    def seed(self, device: torch.device) -> torch.Tensor:
        """One int64 in [0, 2**62) (a (1,) tensor on ``device``): the key
        of a kernel that draws its own mask, as the flash-attention
        kernels do from Philox; replayed like a mask, so a CPU replay
        regenerates the kernel's mask exactly."""
        return self.draw(lambda g: torch.randint(
            0, 2**62, (1,), generator=g, dtype=torch.int64, device=device), device)


def keep_mask(noise: Optional[Noise], shape, p: float,
              device: torch.device) -> torch.Tensor:
    """``noise``'s keep mask at rate ``p``, or all ones at ``p == 0``.  A
    training forward with ``p > 0`` needs a ``noise``."""
    if p <= 0.0:
        return torch.ones(tuple(shape), dtype=torch.float32, device=device)
    if noise is None:
        raise ValueError("a training forward with dropout needs a Noise source")
    return noise.keep_mask(shape, p, device)


def dropout(x: torch.Tensor, p: float, noise: Optional[Noise]) -> torch.Tensor:
    """Dropout at rate ``p`` with a mask from ``noise``; ``p == 0`` is the
    identity.  A bf16 ``x`` stays bf16: its kept values are x / (1 - p)
    with 1 - p rounded to bf16 first, as flax's ``inputs / keep_prob``
    does with a bf16 input."""
    if p <= 0.0:
        return x
    mask = keep_mask(noise, x.shape, p, x.device)
    if x.dtype != torch.bfloat16:
        return x * mask
    keep = torch.tensor(1.0 - p, dtype=x.dtype, device=x.device)
    return torch.where(mask > 0, x / keep, torch.zeros_like(x))
