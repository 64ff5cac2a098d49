"""Per-experiment episode hooks (``cm3_tpu.train.experiments``): the
env, per-episode goals and the dual buffer's routing predicate, for
Checkers, particle and roadway (the evaluation's metrics left out).

Instances are laid out on a leading ``shape``: (E,) for one seed, or
(S, E) for S seeds in lockstep, whose S x E instances the engine steps
as one batch of S*E (``flat_call``)."""

from __future__ import annotations

from typing import Sequence, Union

import torch

from . import common
from .tree import tree_map
from . import envs_base as base


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
    # the dual buffer's routing threshold (the master's "threshold"; only
    # the roadway predicate reads it)
    threshold: float = 16.0

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


class RoadwayHooks(Hooks):
    """Goals are the goal lanes, one-hot over 4; with probability
    ``prob_random`` an episode's start lanes and goal lanes are uniform
    (train_offpolicy.py:252-277; ``experiments.py:126-185``).  Each
    instance draws, in the JAX hooks' order, the branch uniform, the
    lanes [N] in [0, n_lanes), the goal lanes [N] in [0, 4) and the
    reset's depart normals [N]."""

    experiment = "roadway"

    def __init__(self, env):
        self.env = env
        self.n_agents = env.cfg.n_agents
        self.l_goal = 4

    def episode_init(self, shape, draws=None):
        shape = (shape,) if isinstance(shape, int) else tuple(shape)
        if draws is None:
            raise ValueError("the roadway reset draws its lanes and "
                             "departs: pass a draw source")
        env, c = self.env, self.env.cfg
        cars = shape + (self.n_agents,)
        use_random = draws.uniform(shape).to(env.device) < c.prob_random
        lanes_rand = draws.randint(cars, c.n_lanes).to(env.device)
        goal_rand = draws.randint(cars, self.l_goal).to(env.device)
        noise = draws.normal(cars)
        lanes = torch.where(use_random[..., None], lanes_rand, env.lane0)
        goal_lanes = torch.where(use_random[..., None], goal_rand,
                                 env.goal_lane0)
        state, ts = env.reset(dict(lanes=lanes, goal_lanes=goal_lanes),
                              noise)
        return state, ts, common.one_hot(goal_lanes, self.l_goal)

    def is_bad_episode(self, env_state, ep_return_local):
        # sum(r_local) < threshold (train_offpolicy.py:372)
        return base.sum_agents(ep_return_local) < self.threshold


HOOKS = {"checkers": CheckersHooks, "particle": ParticleHooks,
         "roadway": RoadwayHooks}


def make_hooks(experiment: str, env, threshold: float = 16.0) -> Hooks:
    """The experiment's hooks; ``threshold`` is the dual buffer's
    routing threshold, which only roadway's predicate reads
    (``experiments.py:188-191``)."""
    hooks = HOOKS[experiment](env)
    hooks.threshold = threshold
    return hooks
