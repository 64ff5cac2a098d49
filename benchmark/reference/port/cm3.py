"""CM3: multi-goal actor-critic with a counterfactual credit function.

Port of ``cm3_tpu.algs.cm3`` for Checkers, particle and roadway at
stage 2 (n_agents > 1) with the Q_credit critic, on the optax path, one
seed in flattened modules (the networks and their inputs per
experiment, ``cm3.py:76-87, 155-318``; the particle and roadway nets
take no global grid and no previous action, so particle's critics take
the plain inputs of the ``_q_*`` helpers, and roadway's critics also
take the others' goals, which they do not use).  The port's V ablation
critic, stage 1 and its counterfactual, the actor freeze, the fused
optimizer kernels, the data mesh and the seed stacks are left out of
this copy: the benchmark's configurations run none of them, and the
constructor refuses them.  The update keeps the JAX package's order:

  * target-policy actions a' from the slow target actor with the
    eps-mixed policy, conditioned on the taken action as previous
    action (alg_credit.py:579-583);
  * the Q_global and Q_credit TD targets from the target critics; one
    backward pass over the sum of the TD losses (disjoint parameters,
    so the gradients are those of separate passes);
  * Q_actual for the policy gradient is the PRE-update Q_global
    forward; the counterfactual baseline uses the POST-update Q_credit
    (alg_credit.py:720,750; ``cm3.py:538-549``); advantages are
    constants of the policy loss;
  * the opt-in corrections, in JAX's order (``cm3.py:559-608``): the
    batch standardization of the advantages (``adv_norm``), the clipped
    importance weight on the stored behavior probability ``bp``
    (``pg_is_clip``) and the entropy bonus of the pure softmax
    (``pg_ent_coef``);
  * each network's Adam step (``common.adam_apply``, optax's Adam in
    plain PyTorch ops over its flat buffer, with the actor's optional
    lr anneal) and soft target update, one call per network, as JAX
    makes one optax update per network.

``update(..., gate=...)`` applies the whole update only where the 0-dim
device predicate ``gate`` holds, by selects.  The update's one random
draw, a' (``cm3.py:465``), comes in as Gumbel noise.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from . import base, common
from .config import AlgConfig, NNConfig
from . import nets


@dataclasses.dataclass
class CM3State(base.StepCounted):
    """Each network is an ``nn.Module`` whose parameters are views into
    its flat buffer ``module.flat`` (``nets.flatten_parameters``).
    ``step`` counts updates on the device (``base.StepCounted``)."""

    actor: Any
    actor_tgt: Any
    qg: Any
    qg_tgt: Any
    qc: Any
    qc_tgt: Any
    opt_actor: common.AdamState
    opt_qg: common.AdamState
    opt_qc: Optional[common.AdamState]
    step: torch.Tensor = 0


class CM3(base.ActorCritic):
    """CM3 on Checkers or roadway, one seed in flattened modules, on
    ``device`` (``cuda`` unless told)."""

    def __init__(self, experiment: str, spec: Dict[str, int], alg: AlgConfig,
                 nn_cfg: NNConfig = NNConfig(), device="cuda"):
        super().__init__(experiment, spec, alg, nn_cfg, device)
        left_out = {"n_agents == 1": alg.n_agents == 1,
                    "stage 1": alg.stage != 2,
                    "use_Q_credit off": not alg.use_Q_credit,
                    "use_V": alg.use_V, "fused_opt": alg.fused_opt,
                    "grad_clip": alg.grad_clip,
                    "actor_freeze_updates": alg.actor_freeze_updates}
        found = [k for k, v in left_out.items() if v]
        if found:
            raise ValueError(f"the reference leaves out {found}")

    # ---- networks ---- #

    def _qg_module(self):
        c = self.nn_cfg
        if self.experiment == "particle":
            return nets.QGlobalParticle(self.spec, stage=self.stage)
        if self.experiment == "roadway":
            return nets.QGlobalRoadway(self.spec, stage=self.stage)
        return nets.QGlobalCheckers(
            self.spec, conv_f1=c.Q_conv_f, conv_k1=tuple(c.Q_conv_k),
            n_h1_1=c.Q_n_h1_1, n_h1_2=c.Q_n_h1_2, n_h2=c.Q_n_h2,
            stage=self.stage)

    def _qc_module(self):
        c = self.nn_cfg
        if self.experiment == "particle":
            return nets.QCreditParticle(self.spec, stage=self.stage)
        if self.experiment == "roadway":
            return nets.QCreditRoadway(self.spec, stage=self.stage)
        return nets.QCreditCheckers(
            self.spec, conv_f1=c.Q_conv_f, conv_k1=tuple(c.Q_conv_k),
            n_h1_1=c.Q_n_h1_1, n_h1_2=c.Q_n_h1_2, n_h2=c.Q_n_h2,
            stage=self.stage)

    def _makers(self):
        return [self._actor_module, self._qg_module,
                self._qc_module]

    def net_names(self):
        """The names of the state's networks, in the order of the JAX
        state's fields: each has ``<name>_tgt`` and ``opt_<name>``."""
        return ("actor", "qg", "qc")

    def _state(self, actor, qg, qc) -> CM3State:
        return CM3State(
            actor=actor[0], actor_tgt=actor[1], qg=qg[0], qg_tgt=qg[1],
            qc=qc[0], qc_tgt=qc[1],
            opt_actor=self._adam(actor[0]), opt_qg=self._adam(qg[0]),
            opt_qc=self._adam(qc[0]))

    # ---- forward helpers ([B, N, ...] in, [B, N, ...] out) ---- #

    def _q_global(self, qg, state, obs, goals, a_1h):
        """Q_n(s, a_all) for every agent, [B, N]."""
        b, n = goals.shape[0], goals.shape[1]
        f = common.flatten_bn
        vec = state["vec"]
        args = [f(vec), f(goals), f(a_1h), f(common.others_concat(vec)),
                f(common.others_stack(a_1h))]
        if self.experiment == "roadway":
            args.append(f(common.others_concat(goals)))
        if self.experiment == "checkers":
            grid = state["grid"][:, None].expand(
                (b, n) + state["grid"].shape[1:])
            args = [f(grid)] + args + [f(obs["self_t"]), f(obs["self_v"])]
        return self._call(self._qg_module, qg, *args).reshape(b, n)

    def _q_credit_pairs(self, qc, state, obs, goals, a_m_1h):
        """Q_n(s, a^m) for all (m, n) pairs, [B, M, N]; m is the outer
        and n the inner index (alg_credit.py:619-658)."""
        b, n = goals.shape[0], goals.shape[1]
        vec = state["vec"]
        s_others = common.others_concat(vec)
        pn = lambda x: x[:, None].expand((b, n) + x.shape[1:])
        pm = lambda x: x[:, :, None].expand((b, n, n) + x.shape[2:])
        flat = lambda x: x.reshape((b * n * n,) + x.shape[3:])
        args = [flat(pn(vec)), flat(pn(goals)), flat(pm(a_m_1h)),
                flat(pm(vec)), flat(pn(s_others))]
        if self.experiment == "roadway":
            args.append(flat(pn(common.others_concat(goals))))
        if self.experiment == "checkers":
            grid = state["grid"]
            grid_p = grid[:, None, None].expand((b, n, n) + grid.shape[1:])
            args = ([flat(grid_p)] + args + [flat(pm(obs["self_t"])),
                                             flat(pm(obs["self_v"]))])
        return self._call(self._qc_module, qc, *args).reshape(b, n, n)

    def _q_credit_cf(self, qc, state, obs, goals):
        """Counterfactual Q_n(s, a^m = each action): [B, M, N, A]."""
        b, n = goals.shape[0], goals.shape[1]
        a_dim = self.n_actions
        vec = state["vec"]
        s_others = common.others_concat(vec)
        shape4 = (b, n, n, a_dim)
        pn = lambda x: x[:, None, :, None].expand(shape4 + x.shape[2:])
        pm = lambda x: x[:, :, None, None].expand(shape4 + x.shape[2:])
        flat = lambda x: x.reshape((b * n * n * a_dim,) + x.shape[4:])
        eye = torch.eye(a_dim, device=vec.device).expand(shape4 + (a_dim,))
        args = [flat(pn(vec)), flat(pn(goals)), flat(eye), flat(pm(vec)),
                flat(pn(s_others))]
        if self.experiment == "roadway":
            args.append(flat(pn(common.others_concat(goals))))
        if self.experiment == "checkers":
            grid = state["grid"]
            grid_p = grid[:, None, None, None].expand(shape4
                                                      + grid.shape[1:])
            args = ([flat(grid_p)] + args + [flat(pm(obs["self_t"])),
                                             flat(pm(obs["self_v"]))])
        return self._call(self._qc_module, qc, *args).reshape(shape4)

    # ---- one seed's steps of the update ---- #

    def _td_targets(self, actor_tgt, qg_tgt, qc_tgt, batch, eps, gumbel):
        """The TD targets y_g [B, N], y_c [B, M, N] (with Q_credit) and
        y_v [B, N] (with V) from the target nets and the target policy's
        a' (:579-596, :619-658, :675-684); an absent one is 0."""
        cfg = self.cfg
        obs_next, state_next = batch["obs_next"], batch["state_next"]
        goals = batch["goals"]
        tclip = ((lambda y: y.clamp(-cfg.target_clip, cfg.target_clip))
                 if cfg.target_clip else (lambda y: y))
        done_mult = 1.0 - batch["done"].float()
        rl = batch["rl"]
        probs_tgt = self.actor_probs(actor_tgt, obs_next, goals, batch["a"],
                                     eps)
        a_next_1h = common.one_hot(common.sample_actions(probs_tgt, gumbel),
                                   self.n_actions)
        q_next = self._q_global(qg_tgt, state_next, obs_next, goals,
                                a_next_1h)
        y_g = tclip(rl + cfg.gamma * q_next * done_mult[:, None])
        qc_next = self._q_credit_pairs(qc_tgt, state_next, obs_next, goals,
                                       a_next_1h)
        y_c = tclip(rl[:, None, :] + cfg.gamma * qc_next
                    * done_mult[:, None, None])
        return y_g, y_c

    def _critic_losses(self, qg, qc, batch, y_g, y_c):
        """(loss_qg, loss_qc, Q_actual [B, N])."""
        obs, state, goals = batch["obs"], batch["state"], batch["goals"]
        a_1h = common.one_hot(batch["a"], self.n_actions)
        q = self._q_global(qg, state, obs, goals, a_1h)
        loss_qg = torch.mean(torch.square(y_g - q))
        qcv = self._q_credit_pairs(qc, state, obs, goals, a_1h)
        loss_qc = torch.mean(torch.square(y_c - qcv))
        return loss_qg, loss_qc, q

    def _advantages(self, p, q_cf_net, batch, q_actual):
        """The policy gradient's weights sum_a [B, M] (:538-581), a
        constant of the loss, and the mean importance weight (0 when
        ``pg_is_clip`` is off).  ``q_cf_net`` is the POST-update
        Q_credit; ``p`` the current policy's eps-mixed probs."""
        cfg = self.cfg
        obs, state, goals = batch["obs"], batch["state"], batch["goals"]
        q_cf = self._q_credit_cf(q_cf_net, state, obs, goals)
        cf = torch.einsum("bma,bmna->bmn", p, q_cf)
        sum_a = torch.sum(q_actual[:, None, :] - cf, dim=2)          # [B, M]
        if cfg.adv_norm:
            sd = torch.std(sum_a, correction=0)     # jnp.std: population
            sum_a = (sum_a - torch.mean(sum_a)) / (sd + 1e-8)
        w_mean = sum_a.new_zeros(())
        if cfg.pg_is_clip and "bp" in batch:
            a_1h = common.one_hot(batch["a"], self.n_actions)
            taken_now = torch.sum(p * a_1h, dim=-1)                  # [B, N]
            w = torch.clamp(taken_now / torch.clamp_min(batch["bp"], 1e-8),
                            0.0, cfg.pg_is_clip)
            w_mean = torch.mean(w)
            sum_a = sum_a * w
        return sum_a, w_mean

    def _policy_loss(self, actor, q_cf_net, batch, q_actual, eps):
        """The policy-gradient loss (:699-773) -> (loss, entropy of the
        pure softmax (0 when ``pg_ent_coef`` is off), mean importance
        weight).  The current policy's probs are differentiated for the
        loss and are a constant inside the advantages (a placeholder
        feed in the reference); the actor is still pre-update here."""
        cfg = self.cfg
        obs, goals = batch["obs"], batch["goals"]
        a_1h = common.one_hot(batch["a"], self.n_actions)
        probs = self.actor_probs(actor, obs, goals, batch.get("a_prev"),
                                 eps)
        with torch.no_grad():
            sum_a, w_mean = self._advantages(probs.detach(), q_cf_net,
                                             batch, q_actual)
        taken = torch.sum(probs * a_1h, dim=-1)
        log_pi = torch.log(taken + 1e-15)                            # [B, N]
        loss = -torch.mean(torch.sum(log_pi * sum_a, dim=1))
        ent = loss.new_zeros(())
        if cfg.pg_ent_coef:
            # the entropy of the PURE softmax (an epsilon-0 forward): the
            # eps-mix floors the behavior probs and would hide a collapse
            pure = self.actor_probs(actor, obs, goals, batch.get("a_prev"),
                                    0.0)
            ent = -torch.mean(torch.sum(pure * torch.log(pure + 1e-15),
                                        dim=-1))
            loss = loss - cfg.pg_ent_coef * ent
        return loss, ent, w_mean

    # ---- the learning update ---- #

    def _actor_lr_scale(self, step: torch.Tensor):
        """clip(1 - (step - K) / N, 0, 1) in float32 on the device for
        the actor's lr anneal over N updates after a freeze of K
        (``cm3.py:611-619``), from the device's step count, or None when
        it is off."""
        n = self.cfg.actor_lr_anneal_updates
        if not n:
            return None
        lived = (step - self.cfg.actor_freeze_updates).float()
        span = torch.full((), float(n), device=step.device)
        return torch.clamp(1.0 - lived / span, 0.0, 1.0)

    @nets.full_float32()
    def update(self, ts: CM3State, batch: Dict[str, Any], epsilon,
               gumbel, gate=None, with_grads: bool = False) -> tuple:
        """One CM3 learning step, in place on ``ts``'s buffers.

        batch fields are [B, ...]: state/obs (dicts), a [B,N] int, rl
        [B,N], state_next, obs_next, done [B], goals [B,N,G], a_prev
        [B,N] (Checkers) and, for ``pg_is_clip``, bp [B,N].  ``gumbel``
        is the [B, N, A] noise that samples the target-policy actions
        a'.  ``epsilon`` is a float.  ``gate`` (a 0-dim bool tensor,
        optional) applies the update only where it holds.  Returns (ts,
        metrics), the metrics device scalars.  ``with_grads`` adds
        ``metrics["grads"]``, each network's raw gradient under JAX's
        name (``Policy``, ``Q_global``, ``Q_credit``;
        ``cm3.py:637-643``), flat, cloned before the optimizer reads
        it."""
        cfg = self.cfg
        with torch.no_grad():
            y_g, y_c = self._td_targets(ts.actor_tgt, ts.qg_tgt, ts.qc_tgt,
                                        batch, epsilon, gumbel)

        # ---- Q_global and Q_credit critic updates, one backward ----
        critics = [(ts.opt_qg, ts.qg, ts.qg_tgt, cfg.lr_Q),
                   (ts.opt_qc, ts.qc, ts.qc_tgt, cfg.lr_Q)]
        for _, net, _, _ in critics:
            net.flat_grad.zero_()
        loss_qg, loss_qc, q = self._critic_losses(ts.qg, ts.qc, batch, y_g,
                                                  y_c)
        self._backward(loss_qg + loss_qc, ts.qg, ts.qc)
        grads = {}
        if with_grads:
            grads["Q_global"] = ts.qg.flat_grad.clone()
            grads["Q_credit"] = ts.qc.flat_grad.clone()
        q_actual = q.detach()
        with torch.no_grad():
            self._optax_step(*critics, apply=gate)

        # ---- policy gradient (:699-773) ----
        ts.actor.flat_grad.zero_()
        loss_pi, ent, w_mean = self._policy_loss(ts.actor, ts.qc, batch,
                                                 q_actual, epsilon)
        self._backward(loss_pi, ts.actor)
        if with_grads:
            grads["Policy"] = ts.actor.flat_grad.clone()
        with torch.no_grad():
            self._optax_step(
                (ts.opt_actor, ts.actor, ts.actor_tgt, cfg.lr_actor),
                lr_scale=self._actor_lr_scale(ts.step), apply=gate)
        self._count_update(ts, gate)
        metrics = {"loss_Q_global": loss_qg.detach(),
                   "loss_Q_credit": loss_qc.detach()}
        if cfg.pg_is_clip and "bp" in batch:
            metrics["is_weight_mean"] = w_mean
        if cfg.pg_ent_coef:
            metrics["policy_entropy"] = ent.detach()
        metrics["policy_loss"] = loss_pi.detach()
        if with_grads:
            metrics["grads"] = grads
        return ts, metrics
