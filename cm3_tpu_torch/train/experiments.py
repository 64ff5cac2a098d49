"""Per-experiment episode hooks (``cm3_tpu.train.experiments``): the
env, per-episode goals, what the driver stores, the dual buffer's
routing predicate and the evaluation's extra metrics, for Checkers and
particle (roadway: ROADMAP A11b).

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

    def is_bad_episode(self, env_state, ep_return_local):
        """The dual buffer's routing predicate per instance, on the
        post-step env state and the episode's local returns
        (``experiments.py:36-45``): False unless the experiment says."""
        return torch.zeros(ep_return_local.shape[:-1], dtype=torch.bool,
                           device=ep_return_local.device)

    # eval-time auxiliary metrics: accumulators [*shape] per seed shape
    # (() or (S,)); Checkers has none

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


class ParticleHooks(Hooks):
    """Goals are the landmarks the reset places (train_offpolicy.py:
    286-290; ``experiments.py:88-123``); the reset's draws come from the
    draw source (``Particle.draw_reset``)."""

    experiment = "particle"

    def __init__(self, env):
        self.env = env
        self.n_agents = env.cfg.n_agents
        self.l_goal = 2

    def episode_init(self, shape, draws=None):
        shape = (shape,) if isinstance(shape, int) else tuple(shape)
        if draws is None:
            raise ValueError("the particle reset draws its positions: "
                             "pass a draw source")
        state, ts = flat_call(self.env.reset, shape,
                              self.env.draw_reset(shape, draws))
        return state, ts, state.landmarks

    def is_bad_episode(self, env_state, ep_return_local):
        # the scenario's collision count != 0 (train_offpolicy.py:373-374)
        return env_state.collisions != 0

    def eval_metrics_init(self, shape):
        z = torch.zeros(tuple(shape), device=self.env.device)
        return dict(reached=z, episodes=z)

    def eval_metrics_step(self, acc, env_state, ts, alive):
        """The goal-reach rate at episode end (multi-goal_spread.py:
        126-129): each instance whose episode ends this step adds its
        share of agents within reach."""
        done_now = (alive & ts.done).float()
        frac = env_state.reached.float().mean(dim=-1)
        return dict(reached=acc["reached"] + torch.sum(frac * done_now, -1),
                    episodes=acc["episodes"] + torch.sum(done_now, -1))

    def eval_metrics_final(self, acc, n_eval: int):
        return {"eval_reach_rate": acc["reached"]
                / torch.clamp_min(acc["episodes"], 1.0)}


HOOKS = {"checkers": CheckersHooks, "particle": ParticleHooks}


def make_hooks(experiment: str, env) -> Hooks:
    if experiment not in HOOKS:
        raise NotImplementedError(
            f"the {experiment} hooks are not ported (ROADMAP A11b)")
    return HOOKS[experiment](env)
