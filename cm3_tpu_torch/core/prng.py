"""Seeding and the sources of random draws.

``cm3_tpu.core.prng`` folds one root key by purpose and step with
``jax.random.fold_in``.  Here a key is a 64-bit Python int and a fold
is a splitmix64 mix of (key, data): the same root/purpose/step
discipline, so any slice of a run is reproducible in isolation.  The
streams are not JAX's (threefry cannot be reproduced in PyTorch); the
parity tests feed JAX's draws in through ``FedDraws`` instead.

A draw source is what the JAX code's ``key`` argument becomes: the
driver asks it for random actions, Gumbel noise, uniform draws (QMIX's
epsilon override, the particle reset's branch and positions), normal
draws (the particle reset's start noise, the roadway reset's depart
noise) and replay indices in a fixed order; the dual buffer's indices
are drawn below a per-seed bound that lives on the device
(``randint_below``).
``GeneratorDraws`` makes them on the device from a ``torch.Generator``;
``FedDraws`` hands out given arrays.  ``BlockDraws`` serves one rank of a
multi-process run (``parallel/``): it draws the whole run's tensor from
the source it wraps and hands out the rank's block, so that W ranks
together consume exactly the draws of the single-process run of the
same global program.
"""

from __future__ import annotations

import collections
from typing import Dict, Iterable, Optional, Sequence

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


def for_step(key: int, purpose: int, step: int) -> int:
    return fold_in(fold_in(key, purpose), step)


def for_host(key: int, host_id: int) -> int:
    """The key of process ``host_id`` (``prng.py:38-39``)."""
    return fold_in(key, host_id)


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


class FedDraws:
    """Hands out given arrays, per kind in the order given.

    ``randint`` and ``randint_below`` return the next array of
    ``randints`` (random actions, the roadway reset's lanes and goal
    lanes, replay indices, in the order the driver asks for them),
    ``gumbel`` the next of ``gumbels``, ``uniform`` the next of
    ``uniforms`` and ``normal`` the next of ``normals``.  Each array
    must have the shape asked for, a randint array must lie in
    [0, high) and a uniform array in [low, high).  ``uniforms`` and
    ``normals`` are given only where something draws them (QMIX, the
    particle reset); ``remaining`` counts them only then.
    """

    def __init__(self, randints: Iterable = (), gumbels: Iterable = (),
                 device="cuda", uniforms: Optional[Iterable] = None,
                 normals: Optional[Iterable] = None):
        self.device = torch.device(device)
        self._q: Dict[str, collections.deque] = {
            "randint": collections.deque(randints),
            "gumbel": collections.deque(gumbels)}
        if uniforms is not None:
            self._q["uniform"] = collections.deque(uniforms)
        if normals is not None:
            self._q["normal"] = collections.deque(normals)

    def _next(self, kind: str, shape, dtype) -> torch.Tensor:
        if not self._q.get(kind):
            raise IndexError(f"FedDraws: no {kind} draw left")
        x = torch.tensor(np.asarray(self._q[kind].popleft()), dtype=dtype)
        if tuple(x.shape) != tuple(shape):
            raise ValueError(f"FedDraws: {kind} draw has shape "
                             f"{tuple(x.shape)}, asked for {tuple(shape)}")
        return x

    def randint(self, shape: Sequence[int], high: int) -> torch.Tensor:
        x = self._next("randint", shape, torch.int64)
        if x.numel() and (int(x.min()) < 0 or int(x.max()) >= high):
            raise ValueError(f"FedDraws: randint draw outside [0, {high})")
        return x.to(self.device)

    def randint_below(self, shape: Sequence[int],
                      high: torch.Tensor) -> torch.Tensor:
        x = self._next("randint", shape, torch.int64)
        bound = high.detach().cpu()[..., None]
        if x.numel() and bool(((x < 0) | (x >= bound)).any()):
            raise ValueError("FedDraws: randint draw outside [0, high)")
        return x.to(self.device)

    def gumbel(self, shape: Sequence[int]) -> torch.Tensor:
        return self._next("gumbel", shape, torch.float32).to(self.device)

    def uniform(self, shape: Sequence[int], low: float = 0.0,
                high: float = 1.0) -> torch.Tensor:
        x = self._next("uniform", shape, torch.float32)
        if x.numel() and (float(x.min()) < low or float(x.max()) >= high):
            raise ValueError(f"FedDraws: uniform draw outside [{low}, "
                             f"{high})")
        return x.to(self.device)

    def normal(self, shape: Sequence[int]) -> torch.Tensor:
        return self._next("normal", shape, torch.float32).to(self.device)

    def remaining(self) -> Dict[str, int]:
        return {k: len(v) for k, v in self._q.items()}


class BlockDraws:
    """Block ``index`` of ``count`` along dim 0 of every draw of
    ``source``: a draw of shape ``shape`` asks ``source`` for the global
    shape (``shape[0]`` x ``count``) and returns the block, so the ranks
    of a run split each draw of the single-process run of the same
    global program between them (the data axis: instances and minibatch
    rows; the seed axis: seeds; both lead every draw).  ``randint_below`` takes the global
    62-bit draw ``GeneratorDraws.randint_below`` takes (through
    ``source.randint``) and reduces the block by this rank's own bounds;
    from a ``FedDraws`` that returns the fed indices, which lie below
    their bounds already."""

    def __init__(self, source, index: int, count: int):
        if not 0 <= index < count:
            raise ValueError(f"block {index} of {count}")
        self.source = source
        self.index, self.count = index, count

    def _draw(self, fn, shape, *args) -> torch.Tensor:
        n = shape[0]
        x = fn((n * self.count,) + tuple(shape[1:]), *args)
        return x[self.index * n:(self.index + 1) * n]

    def randint(self, shape: Sequence[int], high: int) -> torch.Tensor:
        return self._draw(self.source.randint, shape, high)

    def randint_below(self, shape: Sequence[int],
                      high: torch.Tensor) -> torch.Tensor:
        x = self._draw(self.source.randint, shape, 1 << 62)
        return torch.remainder(x, high[..., None])

    def gumbel(self, shape: Sequence[int]) -> torch.Tensor:
        return self._draw(self.source.gumbel, shape)

    def uniform(self, shape: Sequence[int], low: float = 0.0,
                high: float = 1.0) -> torch.Tensor:
        return self._draw(self.source.uniform, shape, low, high)

    def normal(self, shape: Sequence[int]) -> torch.Tensor:
        return self._draw(self.source.normal, shape)

    def remaining(self) -> Dict[str, int]:
        return self.source.remaining()
