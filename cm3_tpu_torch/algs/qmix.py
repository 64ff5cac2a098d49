"""QMIX on Checkers, particle and roadway (``cm3_tpu.algs.qmix``):
per-agent Q networks and a monotonic hypernetwork mixer, trained
jointly; on particle the agent net (``nets.QmixSingleParticle``) and the
mixer (``nets.QmixMixer``) are dense, with no state grid and no previous
action; roadway's agent net (``nets.QmixSingleRoadway``) adds a
convolutional branch over the egocentric grid, and its mixer is
particle's.

  * ``act``: the argmax of each agent's action values (the first maximum,
    as ``jnp.argmax``), then the per-agent epsilon override OUTSIDE the
    network: a random action in [0, A) where a uniform draw is below
    epsilon (``qmix.py:107-116``).  The draws come from the driver:
    ``act_draws`` asks the draw source for the random actions [.., N],
    then the uniforms [.., N], in the order JAX splits its key.
  * ``update`` (``qmix.py:152-219``) takes no draw.  Double-Q: a* is the
    argmax of the TARGET agent nets on obs' with a_prev' = the taken
    action; the target mixer gets the target nets' q at a*, or under
    ``qmix_ref_bug`` the MAIN nets' q at a* (the reference's wiring,
    ``alg_qmix_checkers.py:106``); y = sum_n rl + gamma Q_tot' (1 -
    done); one squared-error loss over agent nets and mixer.  Metric:
    ``loss_mixer``.
  * One Adam over (agent, mixer) jointly, as JAX's ``optax.flatten``
    over the pair: the agent net and the mixer are one network
    (``nets.QmixJoint``) in one flat buffer, agent leaves first, so the
    Adam count is shared and the global-norm clip (``grad_clip``) is one
    norm over both networks' gradients (per seed with seeds), and one
    soft update moves both targets.

The state's one network is ``qmix`` (with ``qmix_tgt`` and
``opt_qmix``), where JAX's ``QmixState`` has ``agent``, ``mixer``,
their targets and ``opt``; ``convert.state_from_jax`` joins them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Sequence

import torch

from cm3_tpu_torch.algs import base, common
from cm3_tpu_torch.models import nets


@dataclasses.dataclass
class QmixState(base.StepCounted):
    """``qmix``: the agent net and the mixer in one flat buffer (a
    flattened ``nets.QmixJoint``, or with seeds its ``SeedStack``);
    ``step`` counts updates on the device (``base.StepCounted``)."""

    qmix: Any
    qmix_tgt: Any
    opt_qmix: common.AdamState
    step: torch.Tensor = 0


class QMIX(base.SeededAlgorithm):
    """QMIX on Checkers, particle or roadway, one seed or ``n_seeds`` in
    lockstep
    (``algs/base.py``)."""

    def _joint_module(self):
        c = self.nn_cfg
        if self.experiment == "particle":
            return nets.QmixJoint(nets.QmixSingleParticle(self.spec),
                                  nets.QmixMixer(self.spec))
        if self.experiment == "roadway":
            return nets.QmixJoint(nets.QmixSingleRoadway(self.spec),
                                  nets.QmixMixer(self.spec))
        return nets.QmixJoint(
            nets.QmixSingleCheckers(self.spec, conv_f=c.A_conv_f,
                                    conv_k=tuple(c.A_conv_k)),
            nets.QmixMixerCheckers(self.spec))

    def _makers(self):
        return [self._joint_module]

    def net_names(self):
        """The state's one network (``qmix``, ``qmix_tgt``,
        ``opt_qmix``)."""
        return ("qmix",)

    def _state(self, joint) -> QmixState:
        return QmixState(qmix=joint[0], qmix_tgt=joint[1],
                         opt_qmix=self._adam(joint[0]))

    # ---- one seed's forwards ---- #

    def _agent_qs(self, net, obs, goals, a_prev):
        """Per-agent action values, [B, N, A]."""
        b, n = goals.shape[0], goals.shape[1]
        f = common.flatten_bn
        if self.experiment == "particle":
            args = [f(obs["others"]), f(obs["self_v"]), f(goals)]
        elif self.experiment == "roadway":
            args = [f(obs["self_t"]), f(obs["self_v"]), f(goals)]
        else:
            args = [f(common.one_hot(a_prev, self.n_actions)),
                    f(obs["self_t"]), f(obs["self_v"]), f(obs["others"]),
                    f(goals)]
        q = self._call(self._joint_module, net, "agent", *args)
        return q.reshape(b, n, self.n_actions)

    def _mix(self, net, agent_q, state, goals):
        """Q_tot [B] of the agents' chosen values ``agent_q`` [B, N]."""
        b = goals.shape[0]
        args = [state["vec"].reshape(b, -1), goals.reshape(b, -1)]
        if self.experiment == "checkers":
            args = [state["grid"]] + args
        return self._call(self._joint_module, net, "mixer", agent_q,
                          *args)[:, 0]

    # ---- acting ---- #

    def act_draws(self, draws, lead: Sequence[int]):
        """The override's random actions, then its uniforms, each
        [*lead, N] (``qmix.py:113-115``)."""
        shape = tuple(lead) + (self.n_agents,)
        rand_a = draws.randint(shape, self.n_actions)
        return rand_a, draws.uniform(shape)

    def update_draws(self, draws, lead: Sequence[int]):
        """The update draws nothing."""
        return None

    @torch.no_grad()
    @nets.full_float32()
    def act(self, ts: QmixState, obs, goals, a_prev, epsilon, draws):
        """Greedy actions with the per-agent epsilon override, [B, N]
        ([S, B, N] with seeds); ``draws`` is ``act_draws``' pair."""
        def one(net, obs, goals, a_prev, eps, rand_a, u):
            q = self._agent_qs(net, obs, goals, a_prev)
            return torch.where(u < eps, rand_a, torch.argmax(q, dim=-1))
        return self._map(one, self._handle(ts.qmix), obs, goals, a_prev,
                         self._epsilon(epsilon), *draws)

    # ---- one seed's steps of the update ---- #

    def _target(self, tgt, net, batch):
        """y [B] from the target nets: the double-Q a* of the target
        agent nets, their q at a* (the main nets' under
        ``qmix_ref_bug``) through the target mixer."""
        obs_next, goals = batch["obs_next"], batch["goals"]
        q_next = self._agent_qs(tgt, obs_next, goals, batch["a"])
        a_star = torch.argmax(q_next, dim=-1, keepdim=True)
        if self.cfg.qmix_ref_bug:
            q_next = self._agent_qs(net, obs_next, goals, batch["a"])
        q_sel = torch.gather(q_next, -1, a_star)[..., 0]            # [B, N]
        q_tot = self._mix(tgt, q_sel, batch["state_next"], goals)
        done_mult = 1.0 - batch["done"].float()
        return torch.sum(batch["rl"], dim=1) + (self.cfg.gamma * q_tot
                                                * done_mult)

    def _loss(self, net, batch, y):
        a_1h = common.one_hot(batch["a"], self.n_actions)
        q = self._agent_qs(net, batch["obs"], batch["goals"],
                           batch.get("a_prev"))
        q_tot = self._mix(net, torch.sum(q * a_1h, dim=-1), batch["state"],
                          batch["goals"])
        return torch.mean(torch.square(y - q_tot))

    @nets.full_float32()
    def update(self, ts: QmixState, batch: Dict[str, Any], epsilon,
               draws, gate=None, with_grads: bool = False) -> tuple:
        """One QMIX learning step, in place on ``ts``'s buffers.

        batch fields are [B, ...] ([S, B, ...] with seeds): state/obs
        (dicts), a [B, N] int, rl [B, N], state_next, obs_next, done
        [B], goals [B, N, G], a_prev [B, N] (Checkers).  ``epsilon``
        and ``draws`` are unused (the driver's interface).  ``gate`` (a
        0-dim bool tensor, optional) applies the step only where it
        holds: the agent nets and the mixer, as one network, keep their
        parameters, targets, Adam state and the step where it is false,
        as JAX's driver drops a gated-off update.  Returns (ts,
        metrics); the metrics are device scalars ([S] with seeds).
        ``with_grads`` adds ``metrics["grads"]``: the joint network's raw
        gradient split into ``Agent`` and ``Mixer`` (``qmix.py:221-222``;
        the agent nets' leaves come first in the flat buffer), cloned
        before the optimizer reads it."""
        h = self._handle
        with torch.no_grad():
            y = self._map(self._target, h(ts.qmix_tgt), h(ts.qmix), batch)
        ts.qmix.flat_grad.zero_()
        loss = self._map(self._loss, h(ts.qmix), batch, y)
        self._backward(loss.sum(), ts.qmix)
        grads = None
        if with_grads:
            g = ts.qmix.flat_grad.clone()
            joint = ts.qmix if self.n_seeds is None else ts.qmix.module
            n_agent = joint.agent_size()
            grads = {"Agent": g[..., :n_agent], "Mixer": g[..., n_agent:]}
        with torch.no_grad():
            self._optax_step((ts.opt_qmix, ts.qmix, ts.qmix_tgt,
                              self.cfg.lr_Q), apply=gate)
        self._count_update(ts, gate)
        metrics = {"loss_mixer": loss.detach()}
        if with_grads:
            metrics["grads"] = grads
        return ts, metrics
