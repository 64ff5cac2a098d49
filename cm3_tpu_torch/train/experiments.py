"""Per-experiment episode hooks (``cm3_tpu.train.experiments``): the
env, per-episode goals, and what the driver stores.  Checkers only.

Instances are laid out on a leading ``shape``: (E,) for one seed, or
(S, E) for S seeds in lockstep, whose S x E instances the engine steps
as one batch of S*E (``flat_call``)."""

from __future__ import annotations

from typing import Sequence, Union

import torch

from cm3_tpu_torch.core.tree import tree_map
from cm3_tpu_torch.envs import base


def flat_call(fn, shape, *trees):
    """``fn`` over the instances of ``trees`` (dicts, dataclasses or
    tensors with the leading ``shape``) as one batch of prod(shape);
    its outputs are unflattened back to ``shape``."""
    k = len(shape)
    if k == 1:
        return fn(*trees)
    flat = lambda x: x.reshape((-1,) + tuple(x.shape[k:]))
    unflat = lambda x: x.reshape(tuple(shape) + tuple(x.shape[1:]))
    return tree_map(unflat, fn(*(tree_map(flat, t) for t in trees)))


class Hooks:
    """Experiment adapter consumed by the drivers."""

    experiment: str
    env: base.Env
    n_agents: int
    l_goal: int
    has_a_prev: bool = False

    def episode_init(self, shape: Union[int, Sequence[int]], draws=None):
        """-> (env_state, timestep, goals [*shape, N, l_goal]) for fresh
        episodes in ``shape`` instances, with their random goals (if
        any) from the draw source ``draws``."""
        raise NotImplementedError

    # eval-time auxiliary metrics (the JAX package's roadway traffic
    # metrics); Checkers has none

    def eval_metrics_init(self, shape):
        return {}

    def eval_metrics_step(self, acc, env_state, ts, alive):
        return acc

    def eval_metrics_final(self, acc, n_eval: int):
        return {}


class CheckersHooks(Hooks):
    """Goals: a random green/orange one-hot per instance for n = 1 (one
    randint in [0, 2) per instance from the draw source), identity for
    n > 1 (train_offpolicy.py:291-298; ``experiments.py:76-86``)."""

    experiment = "checkers"
    has_a_prev = True

    def __init__(self, env):
        self.env = env
        self.n_agents = env.cfg.n_agents
        self.l_goal = 2

    def episode_init(self, shape, draws=None):
        shape = (shape,) if isinstance(shape, int) else tuple(shape)
        dev = self.env.device
        if self.n_agents == 1:
            if draws is None:
                raise ValueError("single-agent Checkers draws its goals: "
                                 "pass a draw source")
            idx = draws.randint(shape, 2).to(dev)
            goals = (idx[..., None, None]
                     == torch.arange(2, device=dev)).float()
        else:
            goals = torch.eye(self.n_agents, 2, device=dev)
            goals = goals.expand(shape + goals.shape).contiguous()
        state, ts = flat_call(self.env.reset, shape, goals)
        return state, ts, goals


def make_hooks(experiment: str, env) -> Hooks:
    if experiment != "checkers":
        raise NotImplementedError(
            f"only Checkers hooks are ported, not {experiment!r}")
    return CheckersHooks(env)
