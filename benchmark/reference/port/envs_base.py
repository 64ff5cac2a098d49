"""Uniform environment interface (``cm3_tpu.envs.base``).

The JAX engines are pure functions of one instance, batched with
``vmap``.  Here an engine is batched by hand: every tensor carries a
leading env dimension [E, ...], and ``reset``/``step`` return a new
state and a ``TimeStep`` of batched tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch


@dataclasses.dataclass
class TimeStep:
    """One observation bundle, batched over E env instances.

    obs: env-specific dict of per-agent observation tensors [E, N, ...].
    state: env-specific dict of global-state tensors [E, ...].
    reward: [E] global reward (sum of locals).
    reward_local: [E, N] per-agent rewards.
    done: [E] bool, episode terminal.
    """

    obs: Dict[str, Any]
    state: Dict[str, Any]
    reward: torch.Tensor
    reward_local: torch.Tensor
    done: torch.Tensor


def sum_agents(x, dim=-1):
    """Sum over an agent (car) axis in index order, as XLA's reduce
    accumulates a short axis, so that an engine's sums round as the JAX
    engine's do."""
    x = x.movedim(dim, -1)
    out = x[..., 0]
    for i in range(1, x.shape[-1]):
        out = out + x[..., i]
    return out


class Env:
    """Base class; concrete engines define ``spec``, ``reset`` and
    ``step`` over batched state."""

    def spec(self) -> Dict[str, int]:
        raise NotImplementedError

    def reset(self, goals):
        raise NotImplementedError

    def step(self, state, actions):
        raise NotImplementedError
