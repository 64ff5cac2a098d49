"""Seeding and the sources of random draws.

``cm3_tpu.core.prng`` folds one root key by purpose and step with
``jax.random.fold_in``.  Here a key is a 64-bit Python int and a fold
is a splitmix64 mix of (key, data): the same root/purpose/step
discipline, so any slice of a run is reproducible in isolation.  The
streams are not JAX's (threefry cannot be reproduced in PyTorch).

A draw source is what the JAX code's ``key`` argument becomes: the
driver asks it for random actions, Gumbel noise, uniform draws (the
roadway reset's branch), normal draws (the roadway reset's depart
noise) and replay indices in a fixed order; the dual buffer's indices
are drawn below a per-seed bound that lives on the device
(``randint_below``).
``GeneratorDraws`` makes them on the device from a ``torch.Generator``.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

# stable purpose tags (same numbers as cm3_tpu.core.prng)
ROLLOUT = 0
RESET = 1
GOALS = 2
PARAMS = 3
SAMPLE = 4
EVAL = 5
ENV = 6

_MASK = (1 << 64) - 1


def _mix(z: int) -> int:
    """splitmix64 finaliser."""
    z = (z + 0x9E3779B97F4A7C15) & _MASK
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK
    return z ^ (z >> 31)


def root_key(seed: int) -> int:
    return _mix(seed & _MASK)


def fold_in(key: int, data: int) -> int:
    return _mix(key ^ _mix(data & _MASK))


def for_purpose(key: int, purpose: int) -> int:
    return fold_in(key, purpose)


def generator(key: int, device) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded from ``key``."""
    g = torch.Generator(device=device)
    g.manual_seed(key & ((1 << 63) - 1))
    return g


# float32 tiny, the lower bound jax.random.gumbel draws its uniforms from
_TINY = float(np.finfo(np.float32).tiny)


def gumbel_from_uniform(u: torch.Tensor) -> torch.Tensor:
    """-log(-log(u)) with u clamped to [tiny, 1) (``jax.random.gumbel``)."""
    return -torch.log(-torch.log(u.clamp_min(_TINY)))


class GeneratorDraws:
    """Draws made on the generator's device."""

    def __init__(self, gen: torch.Generator):
        self.gen = gen
        self.device = gen.device

    def randint(self, shape: Sequence[int], high: int) -> torch.Tensor:
        return torch.randint(0, high, tuple(shape), generator=self.gen,
                             device=self.device)

    def randint_below(self, shape: Sequence[int],
                      high: torch.Tensor) -> torch.Tensor:
        """int64 in [0, high) with ``high`` a device tensor of the draw's
        leading shape (``shape[:-1]``, each >= 1): a 62-bit draw modulo
        the bound (bias below 2^-30), so the bound never reaches the
        host."""
        x = torch.randint(0, 1 << 62, tuple(shape), generator=self.gen,
                          device=self.device)
        return torch.remainder(x, high[..., None])

    def gumbel(self, shape: Sequence[int]) -> torch.Tensor:
        return gumbel_from_uniform(self.uniform(shape))

    def uniform(self, shape: Sequence[int], low: float = 0.0,
                high: float = 1.0) -> torch.Tensor:
        """float32 in [low, high): u * (high - low) + low for u in
        [0, 1), as ``jax.random.uniform`` scales."""
        u = torch.rand(tuple(shape), generator=self.gen, device=self.device)
        if (low, high) == (0.0, 1.0):
            return u
        return torch.clamp_min(u * (high - low) + low, low)

    def normal(self, shape: Sequence[int]) -> torch.Tensor:
        """Standard normal float32."""
        return torch.randn(tuple(shape), generator=self.gen,
                           device=self.device)


