"""Off-policy trainer: the training chunk (``cm3_tpu.train.offpolicy``).

The driver steps ``n_envs`` instances in lockstep.  One chunk
(``OffPolicyDriver._chunk``, ``offpolicy.py:345-385``) runs
``steps_per_train`` env steps, each with its replay add and the
auto-reset of finished instances, then ``updates_per_chunk`` learning
updates on replay minibatches.  The order is the JAX package's: the
chunk's transitions go into replay before the updates sample it.

Where the JAX chunk splits a key, this one asks a draw source
(``core.prng``) in a fixed order: per env step, random actions or the
[E, N, A] Gumbel noise of the policy's sample; per update, the replay
indices and the Gumbel noise of a'.  Feeding JAX's draws through
``prng.FedDraws`` replays a JAX chunk exactly.

Not ported yet (ROADMAP.md): the K-chunk on-device schedule, the dual
and shard-local replay, the episode-log ring, evaluation and ``run``.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from cm3_tpu_torch.core.config import TrainConfig
from cm3_tpu_torch.core.tree import tree_map
from cm3_tpu_torch.replay import buffer as replay
from cm3_tpu_torch.train.experiments import Hooks


@dataclasses.dataclass
class RolloutState:
    env_state: Any
    obs: Any
    state: Any
    goals: torch.Tensor          # [E, N, G]
    a_prev: torch.Tensor         # [E, N]
    ep_ret_local: torch.Tensor   # [E, N]
    ep_ret_global: torch.Tensor  # [E]
    # running accumulators over completed episodes
    acc_ret_local: torch.Tensor  # [N]
    acc_ret_global: torch.Tensor  # scalar
    episodes: torch.Tensor       # scalar i64, completed episodes


def init_rollout(hooks: Hooks, n_envs: int) -> RolloutState:
    """Fresh episodes in ``n_envs`` instances, on the env's device."""
    env_state, ts, goals = hooks.episode_init(n_envs)
    n = hooks.n_agents
    dev = hooks.env.device
    return RolloutState(
        env_state=env_state, obs=ts.obs, state=ts.state, goals=goals,
        a_prev=torch.zeros((n_envs, n), dtype=torch.int64, device=dev),
        ep_ret_local=torch.zeros((n_envs, n), device=dev),
        ep_ret_global=torch.zeros(n_envs, device=dev),
        acc_ret_local=torch.zeros(n, device=dev),
        acc_ret_global=torch.zeros((), device=dev),
        episodes=torch.zeros((), dtype=torch.int64, device=dev))


def _where(done: torch.Tensor, new: torch.Tensor, old: torch.Tensor):
    """Per-instance select: rows of ``new`` where ``done`` [E]."""
    return torch.where(done.view((-1,) + (1,) * (old.dim() - 1)), new, old)


class OffPolicyDriver:

    def __init__(self, hooks: Hooks, alg, cfg: TrainConfig):
        self.hooks = hooks
        self.alg = alg
        self.cfg = cfg
        self.n_envs = cfg.n_envs

    # ---- replay ---- #

    def _replay_init(self, example):
        return replay.init(example, self.cfg.buffer_size)

    def _replay_add(self, buf, tr):
        return replay.add_batch(buf, tr)

    def _replay_sample(self, buf, draws):
        idx = draws.randint((self.cfg.batch_size,), max(buf.size, 1))
        return replay.sample(buf, idx)

    # -------------------------------------------------------------- #

    def _transition(self, rs: RolloutState, actions, ts_next):
        tr = {
            "obs": rs.obs, "state": rs.state,
            "a": actions, "a_prev": rs.a_prev,
            "r": ts_next.reward, "rl": ts_next.reward_local,
            "obs_next": ts_next.obs, "state_next": ts_next.state,
            "done": ts_next.done, "goals": rs.goals,
        }
        if not self.hooks.has_a_prev:
            tr.pop("a_prev")
        return tr

    @torch.no_grad()
    def _step_once(self, ts_alg, rs: RolloutState, buf, epsilon, draws,
                   random_actions: bool):
        """One lockstep env transition for all instances + buffer add +
        auto-reset."""
        hooks, env = self.hooks, self.hooks.env
        e = self.n_envs
        n = hooks.n_agents
        n_act = self.alg.n_actions
        if random_actions:
            actions = draws.randint((e, n), n_act)
        else:
            actions = self.alg.act(ts_alg, rs.obs, rs.goals, rs.a_prev,
                                   epsilon, draws.gumbel((e, n, n_act)))
        env_state2, ts2 = env.step(rs.env_state, actions)
        buf = self._replay_add(buf, self._transition(rs, actions, ts2))
        done = ts2.done
        ep_ret_local = rs.ep_ret_local + ts2.reward_local
        ep_ret_global = rs.ep_ret_global + ts2.reward

        # auto-reset finished instances with fresh goals
        new_state, new_ts, new_goals = hooks.episode_init(e)
        sel = lambda a, b: _where(done, a, b)
        env_state3 = type(env_state2)(**{
            f.name: sel(getattr(new_state, f.name),
                        getattr(env_state2, f.name))
            for f in dataclasses.fields(env_state2)})
        d = done.float()
        rs2 = RolloutState(
            env_state=env_state3,
            obs=tree_map(sel, new_ts.obs, ts2.obs),
            state=tree_map(sel, new_ts.state, ts2.state),
            goals=sel(new_goals, rs.goals),
            a_prev=torch.where(done[:, None], 0, actions),
            ep_ret_local=ep_ret_local * (1.0 - d[:, None]),
            ep_ret_global=ep_ret_global * (1.0 - d),
            acc_ret_local=rs.acc_ret_local
            + torch.sum(ep_ret_local * d[:, None], dim=0),
            acc_ret_global=rs.acc_ret_global + torch.sum(ep_ret_global * d),
            episodes=rs.episodes + done.sum())
        return rs2, buf

    def _chunk(self, ts_alg, buf, rs, epsilon, draws, do_train: bool,
               random_actions: bool):
        """steps_per_train lockstep env steps, then (``do_train``)
        updates_per_chunk learning updates.  Returns
        (ts_alg, buf, rs, metrics of the last update)."""
        for _ in range(self.cfg.steps_per_train):
            rs, buf = self._step_once(ts_alg, rs, buf, epsilon, draws,
                                      random_actions)
        metrics = {}
        if do_train:
            n_upd = self.cfg.updates_per_chunk or self.n_envs
            shape = (self.cfg.batch_size, self.hooks.n_agents,
                     self.alg.n_actions)
            for _ in range(n_upd):
                batch = self._replay_sample(buf, draws)
                ts_alg, metrics = self.alg.update(ts_alg, batch, epsilon,
                                                  draws.gumbel(shape))
        return ts_alg, buf, rs, metrics
