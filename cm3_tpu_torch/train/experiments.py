"""Per-experiment episode hooks (``cm3_tpu.train.experiments``): the
env, per-episode goals, and what the driver stores.  Checkers only."""

from __future__ import annotations

import torch

from cm3_tpu_torch.envs import base


class Hooks:
    """Experiment adapter consumed by the drivers."""

    experiment: str
    env: base.Env
    n_agents: int
    l_goal: int
    has_a_prev: bool = False

    def episode_init(self, n: int):
        """-> (env_state, timestep, goals [n, N, l_goal]) for n fresh
        episodes."""
        raise NotImplementedError


class CheckersHooks(Hooks):
    """Goals: identity for n > 1 (train_offpolicy.py:291-298)."""

    experiment = "checkers"
    has_a_prev = True

    def __init__(self, env):
        self.env = env
        self.n_agents = env.cfg.n_agents
        self.l_goal = 2

    def episode_init(self, n: int):
        goals = torch.eye(self.n_agents, 2, device=self.env.device)
        goals = goals.expand(n, -1, -1).contiguous()
        state, ts = self.env.reset(goals)
        return state, ts, goals


def make_hooks(experiment: str, env) -> Hooks:
    if experiment != "checkers":
        raise NotImplementedError(
            f"only Checkers hooks are ported, not {experiment!r}")
    return CheckersHooks(env)
