"""COMA, IAC, central-V and the alpha-blend on Checkers, particle and
roadway (``cm3_tpu.algs.baseline``).

One class, as in the JAX package, whose critics the flags of
``AlgConfig`` select:

  * COMA (``use_Q``, n_agents > 1): the centralized critic
    Q(s, a^{-n}, g^n, g^{-n}, label_n, o^n) over every action
    (``nets.QComaCheckers``, particle and roadway ``nets.QComa``);
    advantage
    Q[a_n] - sum_a pi(a) Q[a];
  * IAC (``use_V`` with ``IAC``): the per-agent local critic
    V(o^n, g^n) (``nets.VCheckersLocal``, particle
    ``nets.VParticleLocal``, roadway ``nets.VRoadwayLocal``, whose grid
    branch is ``V_n_others`` wide), TD-error advantage per agent row;
  * central-V (``use_V`` without ``IAC``): V(s, g^n)
    (``nets.VCheckersGlobal`` at its own default widths, as the JAX
    package builds it; particle ``nets.VParticleGlobal`` and roadway
    ``nets.VRoadwayGlobal`` at the master's ``V_n_others``/``V_n_h2``);
    the policy loss couples the sums over
    agents of the log-probabilities and of the TD errors;
  * the blend (``use_Q`` and ``use_V``): alpha * local + (1 - alpha) *
    global.

The update keeps the JAX package's semantics (``baseline.py:1-19``,
``update`` :270-388):

  * the Q TD target uses the GLOBAL reward ``r``, V's the local ``rl``;
    both bootstrap from the target critics, Q's at a' sampled from the
    eps-mixed TARGET actor conditioned on the taken action;
  * V's advantage rl + gamma V(s') (1 - done) - V(s) takes both values
    from the MAIN V before its step;
  * COMA's advantage takes the POST-update critic, and pi the
    pre-update main actor, eps-mixed;
  * the log floor is 1e-15;
  * V and Q each take their own optax-order Adam step (never the fused
    kernel: JAX's ``Baseline`` does not read ``fused_opt``), then the
    actor; every target moves by a soft update.

The critics' losses have disjoint parameters, so one backward pass over
their sum gives each its own gradient, as in ``algs/cm3.py``.  The
update's one random draw, a', comes in as Gumbel noise, so a test can
feed JAX's.  Metrics: ``loss_V``, ``loss_Q``, ``policy_loss``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from cm3_tpu_torch.algs import base, common
from cm3_tpu_torch.models import nets


@dataclasses.dataclass
class BaselineState(base.StepCounted):
    """The JAX ``BaselineState``'s fields; ``v``, ``v_tgt`` and
    ``opt_v`` are None without ``use_V``, ``q``, ``q_tgt`` and ``opt_q``
    without COMA.  ``step`` counts updates on the device
    (``base.StepCounted``)."""

    actor: Any
    actor_tgt: Any
    v: Any
    v_tgt: Any
    q: Any
    q_tgt: Any
    opt_actor: common.AdamState
    opt_v: Optional[common.AdamState]
    opt_q: Optional[common.AdamState]
    step: torch.Tensor = 0


class Baseline(base.ActorCritic):
    """The baselines on Checkers, particle or roadway, one seed or
    ``n_seeds``
    in lockstep (``algs/base.py``)."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.use_q = self.n_agents > 1 and self.cfg.use_Q
        self.use_v = self.cfg.use_V
        self.iac = self.cfg.IAC

    # ---- networks ---- #

    def _v_module(self):
        c = self.nn_cfg
        if self.experiment == "particle":
            cls = nets.VParticleLocal if self.iac else nets.VParticleGlobal
            return cls(self.spec, n_h1_2=c.V_n_others, n_h2=c.V_n_h2,
                       stage=self.stage)
        if self.experiment == "roadway":
            if self.iac:
                return nets.VRoadwayLocal(
                    self.spec, n_conv_reduced=c.V_n_others, n_h2=c.V_n_h2,
                    stage=self.stage)
            return nets.VRoadwayGlobal(self.spec, n_h1_2=c.V_n_others,
                                       n_h2=c.V_n_h2, stage=self.stage)
        if self.iac:
            return nets.VCheckersLocal(
                self.spec, conv_f=c.V_conv_f, conv_k=tuple(c.V_conv_k),
                n_h1_1=c.V_n_h1_1, n_h1_2=c.V_n_h1_2, n_h2=c.V_n_h2,
                stage=self.stage)
        return nets.VCheckersGlobal(self.spec, stage=self.stage)

    def _q_module(self):
        if self.experiment == "checkers":
            return nets.QComaCheckers(self.spec, units=self.nn_cfg.Q_units)
        return nets.QComa(self.spec, units=self.nn_cfg.Q_units)

    def _makers(self):
        return [self._actor_module,
                self._v_module if self.use_v else None,
                self._q_module if self.use_q else None]

    def net_names(self):
        """The names of the state's networks, in the order of the JAX
        state's fields: each has ``<name>_tgt`` and ``opt_<name>``."""
        return (("actor",) + (("v",) if self.use_v else ())
                + (("q",) if self.use_q else ()))

    def _state(self, actor, v, q) -> BaselineState:
        return BaselineState(
            actor=actor[0], actor_tgt=actor[1],
            v=v and v[0], v_tgt=v and v[1], q=q and q[0], q_tgt=q and q[1],
            opt_actor=self._adam(actor[0]), opt_v=v and self._adam(v[0]),
            opt_q=q and self._adam(q[0]))

    # ---- one seed's forwards ([B, N, ...] in) ---- #

    def _v_forward(self, v, state, obs, goals):
        """V per agent, [B, N] (the local or the global critic)."""
        b, n = goals.shape[0], goals.shape[1]
        f = common.flatten_bn
        vec = state["vec"]
        if self.experiment != "checkers":
            own = obs["others"] if self.experiment == "particle" else \
                obs["self_t"]
            args = ([f(own), f(obs["self_v"]), f(goals)] if self.iac else
                    [f(vec), f(goals), f(common.others_concat(vec)),
                     f(common.others_concat(goals))])
        elif self.iac:
            args = [f(obs["self_t"]), f(obs["self_v"]), f(obs["others"]),
                    f(goals)]
        else:
            grid = state["grid"][:, None].expand(
                (b, n) + state["grid"].shape[1:])
            args = [f(grid), f(vec), f(goals), f(common.others_concat(vec))]
        return self._call(self._v_module, v, *args).reshape(b, n)

    def _q_forward(self, q, state, obs, goals, a_others):
        """COMA's critic over every action, [B, N, A]; ``a_others`` is
        the others' one-hot actions [B, N, N-1, A]."""
        b, n = goals.shape[0], goals.shape[1]
        f = common.flatten_bn
        vec = state["vec"]
        state_all = vec.reshape(b, 1, -1).expand(b, n, vec.shape[1]
                                                 * vec.shape[2])
        labels = torch.eye(n, device=vec.device).expand(b, n, n)
        args = [f(state_all), f(a_others), f(goals),
                f(common.others_concat(goals)), f(labels)]
        if self.experiment != "checkers":
            args = args + [f(obs["self_v"])]
        else:
            grid = state["grid"][:, None].expand(
                (b, n) + state["grid"].shape[1:])
            args = [f(grid)] + args + [f(obs["self_t"]), f(obs["self_v"])]
        return self._call(self._q_module, q, *args).reshape(
            b, n, self.n_actions)

    # ---- one seed's steps of the update ---- #

    def _td_targets(self, actor_tgt, v_tgt, q_tgt, v, batch, eps, gumbel):
        """(y_v, the main V's pre-update V(s') for the advantage, y_q),
        each [B, N]; an absent critic's are 0."""
        cfg = self.cfg
        obs_next, state_next = batch["obs_next"], batch["state_next"]
        goals = batch["goals"]
        done_mult = (1.0 - batch["done"].float())[:, None]
        y_v = v_next = y_q = done_mult.new_zeros(())
        if self.use_v:
            y_v = batch["rl"] + cfg.gamma * self._v_forward(
                v_tgt, state_next, obs_next, goals) * done_mult
            v_next = self._v_forward(v, state_next, obs_next, goals)
        if self.use_q:
            probs = self.actor_probs(actor_tgt, obs_next, goals, batch["a"],
                                     eps)
            a_next_1h = common.one_hot(common.sample_actions(probs, gumbel),
                                       self.n_actions)
            q_next = self._q_forward(q_tgt, state_next, obs_next, goals,
                                     common.others_stack(a_next_1h))
            y_q = (batch["r"][:, None] + cfg.gamma
                   * torch.sum(q_next * a_next_1h, dim=-1) * done_mult)
        return y_v, v_next, y_q

    def _critic_losses(self, v, q, batch, y_v, v_next, y_q):
        """(loss_v, loss_q, V's TD error [B, N] from the PRE-update V(s)
        and V(s') (``baseline.py:333-336``), a constant); an absent
        critic's are 0."""
        obs, state, goals = batch["obs"], batch["state"], batch["goals"]
        loss_v = loss_q = v_adv = y_v.new_zeros(())
        if self.use_v:
            v_s = self._v_forward(v, state, obs, goals)
            loss_v = torch.mean(torch.square(y_v - v_s))
            done_mult = (1.0 - batch["done"].float())[:, None]
            v_adv = (batch["rl"] + self.cfg.gamma * v_next * done_mult
                     - v_s).detach()
        if self.use_q:
            a_1h = common.one_hot(batch["a"], self.n_actions)
            q_all = self._q_forward(q, state, obs, goals,
                                    common.others_stack(a_1h))
            loss_q = torch.mean(torch.square(
                y_q - torch.sum(q_all * a_1h, dim=-1)))
        return loss_v, loss_q, v_adv

    def _policy_loss(self, actor, q, batch, v_adv, eps):
        """The policy-gradient loss (``baseline.py:347-368``); ``q`` is
        the POST-update critic, ``v_adv`` V's TD error [B, N] (a
        constant); the actor is still pre-update here."""
        cfg = self.cfg
        obs, state, goals = batch["obs"], batch["state"], batch["goals"]
        a_1h = common.one_hot(batch["a"], self.n_actions)
        probs = self.actor_probs(actor, obs, goals, batch.get("a_prev"),
                                 eps)
        log_pi = torch.log(torch.sum(probs * a_1h, dim=-1) + 1e-15)  # [B, N]
        loss_g = loss_l = None
        if self.use_q:
            with torch.no_grad():
                q_res = self._q_forward(q, state, obs, goals,
                                        common.others_stack(a_1h))
                coma = (torch.sum(q_res * a_1h, dim=-1)
                        - torch.sum(q_res * probs.detach(), dim=-1))
            loss_g = -torch.mean(torch.sum(log_pi * coma, dim=1))
        if self.use_v:
            if self.iac:
                loss_l = -torch.mean(log_pi * v_adv)
            else:
                loss_l = -torch.mean(torch.sum(log_pi, dim=1)
                                     * torch.sum(v_adv, dim=1))
        if loss_g is not None and loss_l is not None:
            return cfg.alpha * loss_l + (1 - cfg.alpha) * loss_g
        return loss_g if loss_l is None else loss_l

    # ---- the learning update ---- #

    @nets.full_float32()
    def update(self, ts: BaselineState, batch: Dict[str, Any], epsilon,
               gumbel, gate=None, with_grads: bool = False) -> tuple:
        """One baseline learning step, in place on ``ts``'s buffers.

        batch fields are [B, ...] ([S, B, ...] with seeds): state/obs
        (dicts), a [B, N] int, r [B], rl [B, N], state_next, obs_next,
        done [B], goals [B, N, G], a_prev [B, N] (Checkers).  ``gumbel``
        is the [B, N, A] noise that samples the target policy's a'
        (COMA).  ``gate`` (a 0-dim bool tensor, optional) applies every
        network's step only where it holds, the step count's too.
        Returns (ts, metrics); the metrics are device scalars ([S] with
        seeds).  ``with_grads`` adds ``metrics["grads"]``: the raw
        gradients of ``Policy``, ``V`` and ``Q`` (``baseline.py:371-377``),
        flat, cloned before the optimizer reads them."""
        if not (self.use_v or self.use_q):
            raise ValueError("a baseline without a critic: COMA needs "
                             "n_agents > 1, or set use_V")
        cfg = self.cfg
        h = self._handle
        eps = self._epsilon(epsilon)
        with torch.no_grad():
            y_v, v_next, y_q = self._map(
                self._td_targets, h(ts.actor_tgt), h(ts.v_tgt), h(ts.q_tgt),
                h(ts.v), batch, eps, gumbel)

        # ---- V and Q critic steps, one backward ----
        critics = []
        if self.use_v:
            critics.append((ts.opt_v, ts.v, ts.v_tgt, cfg.lr_V))
        if self.use_q:
            critics.append((ts.opt_q, ts.q, ts.q_tgt, cfg.lr_Q))
        for _, net, _, _ in critics:
            net.flat_grad.zero_()
        loss_v, loss_q, v_adv = self._map(self._critic_losses, h(ts.v),
                                          h(ts.q), batch, y_v, v_next, y_q)
        self._backward(loss_v.sum() + loss_q.sum(),
                       *(net for _, net, _, _ in critics))
        grads = {}
        if with_grads:
            if self.use_v:
                grads["V"] = ts.v.flat_grad.clone()
            if self.use_q:
                grads["Q"] = ts.q.flat_grad.clone()
        with torch.no_grad():
            self._optax_step(*critics, apply=gate)

        # ---- policy gradient with the POST-update critic ----
        ts.actor.flat_grad.zero_()
        loss_pi = self._map(self._policy_loss, h(ts.actor), h(ts.q), batch,
                            v_adv, eps)
        self._backward(loss_pi.sum(), ts.actor)
        if with_grads:
            grads["Policy"] = ts.actor.flat_grad.clone()
        with torch.no_grad():
            self._optax_step((ts.opt_actor, ts.actor, ts.actor_tgt,
                              cfg.lr_actor), apply=gate)
        self._count_update(ts, gate)
        metrics = {}
        if self.use_v:
            metrics["loss_V"] = loss_v.detach()
        if self.use_q:
            metrics["loss_Q"] = loss_q.detach()
        metrics["policy_loss"] = loss_pi.detach()
        if with_grads:
            metrics["grads"] = grads
        return ts, metrics
