"""What CM3 builds on: one seed's parameter layout in flattened modules,
empty states, the optax-path step, and the draws an update asks of the
driver.  A subclass names its networks with ``_makers()`` (a list of
module constructors, None for a network the configuration leaves out)
and builds its state from their (main, target) pairs in ``_state``.

The update's Gumbel noise [*lead, N, A] samples the target policy's a'
(``update_draws``)."""

from __future__ import annotations

import warnings
from typing import Dict, Sequence

import torch

from . import common
from .config import AlgConfig, NNConfig
from . import nets

EXPERIMENTS = ("checkers", "particle", "roadway")


class StepCounted:
    """Base of the algorithms' state dataclasses: ``step`` (the updates
    taken) is a 0-dim int32 tensor on the device of the state's first
    network, one for every seed, which the update advances on the
    device (by its gate, when it has one) into a new tensor, as JAX's
    state carries its traced step.  An int assigned to it becomes one."""

    def __setattr__(self, name, value):
        if name == "step":
            first = getattr(self, next(iter(self.__dataclass_fields__)))
            value = common.counter(value, first.flat.device)
        object.__setattr__(self, name, value)


class SeededAlgorithm:
    """Runs one seed in flattened modules on ``device``: the reference
    recomputes a sweep a seed at a time (the port also trains seeds in
    lockstep in seed stacks, which this copy leaves out)."""

    def __init__(self, experiment: str, spec: Dict[str, int], alg: AlgConfig,
                 nn_cfg: NNConfig = NNConfig(), device="cuda"):
        if experiment not in EXPERIMENTS:
            raise ValueError(f"unknown experiment {experiment!r}")
        self.experiment = experiment
        self.spec = dict(spec, n_agents=alg.n_agents)
        self.cfg = alg
        self.nn_cfg = nn_cfg
        self.n_agents = alg.n_agents
        self.n_actions = spec["l_action"]
        self.stage = alg.stage
        self.device = torch.device(device)

    # ---- networks and states ---- #

    def _pair(self, make):
        """(main, target) on the device, each flattened, their values to
        be loaded."""
        main = nets.flatten_parameters(make().to(self.device))
        tgt = nets.flatten_parameters(make().to(self.device),
                                      with_grad=False)
        tgt.flat.copy_(main.flat)
        return main, tgt

    def empty_state(self):
        """A state of the right shapes whose values are to be loaded."""
        return self._state(*(make and self._pair(make)
                             for make in self._makers()))

    def _adam(self, net):
        return common.adam_init(net.flat, bool(self.cfg.grad_clip))

    # ---- a network argument is a flattened module ---- #

    @staticmethod
    def _call(make, net, *args):
        return net(*args)

    def _backward(self, loss, *nets_):
        """Backward into the flat gradient buffers of the networks
        ``nets_``."""
        with warnings.catch_warnings():
            warnings.filterwarnings(
                "ignore", message="grad and param do not obey")
            loss.backward()

    def _optax_step(self, *steps, lr_scale=None, apply=None):
        """The optax-order Adam step (``common.adam_apply``, with the
        global-norm clip ``grad_clip``) and the soft target update for
        each (opt_state, net, tgt, lr) of ``steps``: one call per
        network, as JAX makes one optax update per network.  Where the
        0-dim device predicate ``apply`` is false nothing changes."""
        for opt, net, tgt, lr in steps:
            common.adam_apply(opt, net.flat, net.flat_grad, lr,
                              self.cfg.grad_clip, lr_scale, apply)
            common.soft_update(tgt.flat, net.flat, self.cfg.tau, apply)

    @staticmethod
    def _count_update(ts, gate):
        """``ts.step`` advanced on the device: by one, or by the gate."""
        ts.step = ts.step + (1 if gate is None else gate)

    def update_draws(self, draws, lead: Sequence[int]):
        """What ``update`` consumes for a batch of the leading shape
        ``lead``: Gumbel noise [*lead, N, A] for the target policy's
        a'."""
        return draws.gumbel(tuple(lead) + (self.n_agents, self.n_actions))


class ActorCritic(SeededAlgorithm):
    """An algorithm with CM3's actor (CM3 and the baselines)."""

    def _actor_module(self):
        c = self.nn_cfg
        if self.experiment == "particle":
            return nets.ActorParticle(
                self.spec, n_h1_others=c.Actor_n_others, n_h2=c.Actor_n_h2,
                stage=self.stage)
        if self.experiment == "roadway":
            return nets.ActorRoadway(self.spec, stage=self.stage)
        return nets.ActorCheckers(
            self.spec, conv_f=c.A_conv_f, conv_k=tuple(c.A_conv_k),
            n_h1=c.A_n_h1, n_h2=c.A_n_h2, stage=self.stage)

    def actor_probs(self, actor, obs, goals, a_prev, epsilon):
        """eps-mixed policy probabilities, [B, N, A]; ``a_prev`` feeds
        only the Checkers actor (particle and roadway have none: pass
        None)."""
        b, n = goals.shape[0], goals.shape[1]
        f = common.flatten_bn
        if self.experiment == "particle":
            probs = self._call(self._actor_module, actor, f(obs["others"]),
                               f(obs["self_v"]), f(goals))
        elif self.experiment == "roadway":
            probs = self._call(self._actor_module, actor, f(obs["self_t"]),
                               f(obs["self_v"]), f(goals))
        else:
            probs = self._call(
                self._actor_module, actor,
                f(common.one_hot(a_prev, self.n_actions)),
                f(obs["self_t"]), f(obs["self_v"]), f(obs["others"]),
                f(goals))
        probs = probs.reshape(b, n, self.n_actions)
        return common.epsilon_probs(probs, epsilon, self.n_actions)

    @torch.no_grad()
    @nets.full_float32()
    def act(self, ts, obs, goals, a_prev, epsilon, gumbel):
        """Sample actions for all agents as one batch, [B, N]; ``gumbel`` is [B, N, A] standard Gumbel noise."""
        probs = self.actor_probs(ts.actor, obs, goals, a_prev, epsilon)
        return common.sample_actions(probs, gumbel)
