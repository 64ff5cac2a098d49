"""CM3: multi-goal actor-critic with a counterfactual credit function.

Port of ``cm3_tpu.algs.cm3`` for Checkers, particle and roadway (the
networks and their inputs per experiment, ``cm3.py:76-87, 155-318``;
the particle and roadway nets take no global grid and no previous
action, the particle actor no egocentric view; roadway's critics take
the others' goals, which they do not use, and its V ablation critic is
particle's):
stage 2 (n_agents > 1) with
the Q_credit critic (``use_Q_credit``, the default) or the V(s, g^n)
ablation critic (``use_V``) or neither, and stage 1 (n_agents == 1)
with the Q_global counterfactual.  The update keeps the JAX package's
order:

  * target-policy actions a' from the slow target actor with the
    eps-mixed policy, conditioned on the taken action as previous
    action (alg_credit.py:579-583);
  * the Q_global, Q_credit and V TD targets from the target critics;
    one backward pass over the sum of the TD losses (disjoint
    parameters, so the gradients are those of separate passes);
  * Q_actual for the policy gradient is the PRE-update Q_global
    forward; the counterfactual baseline uses the POST-update Q_credit,
    or for n == 1 the POST-update Q_global over every action
    (alg_credit.py:720,750; ``cm3.py:538-549``); with V instead of
    Q_credit the baseline is the POST-update V (``cm3.py:528,550``),
    with neither the advantage is the summed Q_actual; advantages are
    constants of the policy loss;
  * the opt-in corrections, in JAX's order (``cm3.py:559-608``): the
    batch standardization of the advantages (``adv_norm``), the clipped
    importance weight on the stored behavior probability ``bp``
    (``pg_is_clip``) and the entropy bonus of the pure softmax
    (``pg_ent_coef``);
  * each network's Adam step and soft target update; for the first
    ``actor_freeze_updates`` updates the actor and its Adam state stay
    as they are and only its target moves, toward the frozen actor
    (``cm3.py:624-635``): a predicate on the device's step count gates
    the actor's step and the target's move, so the policy loss and its
    backward run at every update, as JAX's do.

``update(..., gate=...)`` applies the whole update only where the 0-dim
device predicate ``gate`` holds (the fill chunks of a K-chunk dispatch,
``train/offpolicy.py``): every network, target, Adam state and the step
keep their values where it is false, by selects and kernel predicates,
as JAX's driver drops a gated-off update with ``jnp.where``
(``cm3_tpu/train/offpolicy.py:376-384``).  The step and the Adam counts
live on the device, so no part of an update needs a value from the
host.

Two optimizer paths, as in the JAX package (``_opt_step``,
``cm3.py:120-143``):

  * ``AlgConfig.fused_opt=False`` (the default, and what the
    reference's headline program runs): ``common.adam_apply``, optax's
    Adam in plain PyTorch ops over each network's flat buffer, with the
    optional global-norm clip (``grad_clip``) and the actor's lr anneal
    (``actor_lr_anneal_updates``), then the soft update; one call per
    network, as JAX makes one optax update per network;
  * ``fused_opt=True``: the fused Adam + Polyak kernel
    (``ops.fused_opt``), the critics (Q_global, Q_credit, V, each with
    its lr) in one launch and the actor in another: two launches per
    update for n = 2 and for n = 1 alike (the JAX package makes one
    call per network).  Like JAX's, it refuses ``grad_clip`` and the
    anneal (JAX's kernel takes a static lr; ``cm3.py:111-118``).  With
    ``actor_freeze_updates`` the actor's launch carries the predicate
    "live" and the frozen target's soft update is the Polyak kernel
    (``ops.polyak``) under the predicate "frozen": both launch at every
    update and one of them writes, where JAX selects with
    ``jnp.where``.  Without a freeze the Polyak kernel never launches.

Seeds in lockstep (``n_seeds=S``).  Each network is a
``nets.SeedStack``: one flat [S, n] buffer.  Every step of the update
is written for one seed and mapped over the seed axis with
``torch.func.vmap`` (``_map``); the backward passes run on the sum of
the S seeds' losses, which leaves each seed's gradient in its row of
the flat gradient buffer, and the optimizer works on the [S, n] buffers
at once (per-seed global norms; on the fused path one kernel segment of
S x n floats per network, since the count and the lr are the same for
every seed).  Batches, observations and draws then carry a leading [S]
axis, the epsilon is [S] (each seed its own), and the metrics are [S].

``n_seeds`` selects the parameter layout.  The single-seed API
(``n_seeds=None``) runs the same per-seed functions on plain flattened
modules, called directly, without the map.  That layout is kept beside
the seed stacks because it is the faster one for one seed: the chunk is
host-bound, and through an S = 1 stack it runs at 0.65-0.69 of the
modules' rate on an H100 (``vmap`` and ``functional_call`` cost host
time per operation, and the map adds 7% launches;
``scripts/torch_seed_layout_times.py``).

The update's one random draw, a' (``cm3.py:465``), comes in as Gumbel
noise, so a test can feed JAX's.  The seed plumbing, the states' set-up,
the actor and ``act`` are shared with the baselines
(``algs/base.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from cm3_tpu_torch.algs import base, common
from cm3_tpu_torch.core.config import AlgConfig, NNConfig
from cm3_tpu_torch.models import nets
from cm3_tpu_torch.ops import fused_opt, polyak
from cm3_tpu_torch.parallel import mesh as meshlib


@dataclasses.dataclass
class CM3State(base.StepCounted):
    """Each network is an ``nn.Module`` whose parameters are views into
    its flat buffer ``module.flat`` (``nets.flatten_parameters``), or
    with seeds a ``nets.SeedStack``.  ``qc``, ``qc_tgt`` and ``opt_qc``
    are None without Q_credit (n_agents == 1 or ``use_Q_credit`` off),
    ``v``, ``v_tgt`` and ``opt_v`` without V (n_agents == 1 or
    ``use_V`` off).  ``step`` counts updates on the device
    (``base.StepCounted``)."""

    actor: Any
    actor_tgt: Any
    qg: Any
    qg_tgt: Any
    qc: Any
    qc_tgt: Any
    opt_actor: common.AdamState
    opt_qg: common.AdamState
    opt_qc: Optional[common.AdamState]
    v: Any = None
    v_tgt: Any = None
    opt_v: Optional[common.AdamState] = None
    step: torch.Tensor = 0


class CM3(base.ActorCritic):
    """CM3 on Checkers, particle or roadway.  Runs on ``device`` (``cuda``
    unless told); with ``n_seeds`` (1 included) it trains that many
    independent seeds in lockstep in seed stacks, and without it one
    seed in flattened modules."""

    def __init__(self, experiment: str, spec: Dict[str, int], alg: AlgConfig,
                 nn_cfg: NNConfig = NNConfig(), device="cuda",
                 n_seeds: Optional[int] = None):
        super().__init__(experiment, spec, alg, nn_cfg, device, n_seeds)
        if alg.fused_opt and alg.grad_clip:
            raise ValueError(
                "fused_opt requires grad_clip == 0 (the global-norm clip "
                "is a different program shape; see AlgConfig)")
        if alg.fused_opt and alg.actor_lr_anneal_updates:
            raise ValueError(
                "fused_opt is incompatible with actor_lr_anneal_updates "
                "(the fused kernel's lr is static, as JAX's; use the optax "
                "path)")
        self.use_credit = alg.n_agents > 1 and alg.use_Q_credit
        self.use_v = alg.n_agents > 1 and alg.use_V

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

    def _v_module(self):
        if self.experiment == "checkers":
            return nets.VCheckersAblation(self.spec)
        return nets.VParticleAblation(self.spec)

    def _makers(self):
        return [self._actor_module, self._qg_module,
                self._qc_module if self.use_credit else None,
                self._v_module if self.use_v else None]

    def net_names(self):
        """The names of the state's networks, in the order of the JAX
        state's fields: each has ``<name>_tgt`` and ``opt_<name>``."""
        return (("actor", "qg") + (("qc",) if self.use_credit else ())
                + (("v",) if self.use_v else ()))

    def _state(self, actor, qg, qc, v) -> CM3State:
        return CM3State(
            actor=actor[0], actor_tgt=actor[1], qg=qg[0], qg_tgt=qg[1],
            qc=qc and qc[0], qc_tgt=qc and qc[1],
            opt_actor=self._adam(actor[0]), opt_qg=self._adam(qg[0]),
            opt_qc=qc and self._adam(qc[0]),
            v=v and v[0], v_tgt=v and v[1], opt_v=v and self._adam(v[0]))

    @torch.no_grad()
    @nets.full_float32()
    def act_bp(self, ts: CM3State, obs, goals, a_prev, epsilon, gumbel):
        """``act`` and the behavior policy it sampled from: (actions
        [B, N], eps-mixed probs [B, N, A]), with a leading [S] with
        seeds (``cm3.py:176-184``).  The driver stores the probability
        of the stored action as ``bp`` when ``pg_is_clip`` is on."""
        def one(actor, obs, goals, a_prev, eps, gumbel):
            probs = self.actor_probs(actor, obs, goals, a_prev, eps)
            return common.sample_actions(probs, gumbel), probs
        return self._map(one, self._handle(ts.actor), obs, goals, a_prev,
                         self._epsilon(epsilon), gumbel)

    # ---- one seed's forward helpers ([B, N, ...] in, [B, N, ...] out).
    # A network argument is a flattened module (single seed) or one
    # seed's parameter dict (inside ``_map``) ---- #

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

    def _q_global_cf(self, qg, state, obs, goals):
        """n_agents == 1 counterfactual: Q(s, a) for every action, [B, A]
        (``cm3.py:208-235``); the others' inputs are empty."""
        b = goals.shape[0]
        a_dim = self.n_actions
        bc = lambda x: x[:, None].expand((b, a_dim) + x.shape[1:])
        flat = lambda x: x.reshape((b * a_dim,) + x.shape[2:])
        eye = torch.eye(a_dim, device=goals.device).expand(b, a_dim, a_dim)
        vec = state["vec"][:, 0]
        args = [flat(bc(vec)), flat(bc(goals[:, 0])), flat(eye),
                vec.new_zeros(b * a_dim, 0),
                vec.new_zeros(b * a_dim, 0, a_dim)]
        if self.experiment == "roadway":
            args.append(vec.new_zeros(b * a_dim, 0))
        if self.experiment == "checkers":
            args = ([flat(bc(state["grid"]))] + args
                    + [flat(bc(obs["self_t"][:, 0])),
                       flat(bc(obs["self_v"][:, 0]))])
        return self._call(self._qg_module, qg, *args).reshape(b, a_dim)

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

    def _v_forward(self, v, state, goals):
        """V(s, g^n) ablation baseline, [B, N] (``cm3.py:305-318``)."""
        b, n = goals.shape[0], goals.shape[1]
        f = common.flatten_bn
        vec = state["vec"]
        args = [f(vec), f(goals), f(common.others_concat(vec))]
        if self.experiment == "checkers":
            grid = state["grid"][:, None].expand(
                (b, n) + state["grid"].shape[1:])
            args = [f(grid)] + args
        return self._call(self._v_module, v, *args).reshape(b, n)

    # ---- one seed's steps of the update ---- #

    def _td_targets(self, actor_tgt, qg_tgt, qc_tgt, v_tgt, batch, eps,
                    gumbel):
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
        y_c = y_v = rl.new_zeros(())
        if self.use_credit:
            qc_next = self._q_credit_pairs(qc_tgt, state_next, obs_next,
                                           goals, a_next_1h)
            y_c = tclip(rl[:, None, :] + cfg.gamma * qc_next
                        * done_mult[:, None, None])
        if self.use_v:
            v_next = self._v_forward(v_tgt, state_next, goals)
            y_v = tclip(rl + cfg.gamma * v_next * done_mult[:, None])
        return y_g, y_c, y_v

    def _critic_losses(self, qg, qc, v, batch, y_g, y_c, y_v):
        """(loss_qg, loss_qc, loss_v, Q_actual [B, N]); an absent
        critic's loss is 0."""
        obs, state, goals = batch["obs"], batch["state"], batch["goals"]
        a_1h = common.one_hot(batch["a"], self.n_actions)
        q = self._q_global(qg, state, obs, goals, a_1h)
        loss_qg = torch.mean(torch.square(y_g - q))
        loss_qc = loss_v = loss_qg.new_zeros(())
        if self.use_credit:
            qcv = self._q_credit_pairs(qc, state, obs, goals, a_1h)
            loss_qc = torch.mean(torch.square(y_c - qcv))
        if self.use_v:
            loss_v = torch.mean(torch.square(
                y_v - self._v_forward(v, state, goals)))
        return loss_qg, loss_qc, loss_v, q

    def _advantages(self, p, q_cf_net, v, batch, q_actual):
        """The policy gradient's weights sum_a [B, M] (:538-581), a
        constant of the loss, and the mean importance weight (0 when
        ``pg_is_clip`` is off).  ``q_cf_net`` is the POST-update Q_credit
        (Q_global for n = 1), ``v`` the POST-update V; ``p`` the current
        policy's eps-mixed probs."""
        cfg = self.cfg
        obs, state, goals = batch["obs"], batch["state"], batch["goals"]
        b, n = q_actual.shape
        if n == 1:
            q_cf = self._q_global_cf(q_cf_net, state, obs, goals)
            baseline = torch.sum(p[:, 0] * q_cf, dim=-1)             # [B]
            sum_a = (q_actual[:, 0] - baseline)[:, None]             # [B, 1]
        elif self.use_credit:
            q_cf = self._q_credit_cf(q_cf_net, state, obs, goals)
            cf = torch.einsum("bma,bmna->bmn", p, q_cf)
            sum_a = torch.sum(q_actual[:, None, :] - cf, dim=2)      # [B, M]
        elif self.use_v:
            v_res = self._v_forward(v, state, goals)
            sum_a = torch.sum(q_actual - v_res, dim=1,
                              keepdim=True).expand(b, n)
        else:
            sum_a = torch.sum(q_actual, dim=1, keepdim=True).expand(b, n)
        if cfg.adv_norm and self.data_mesh is not None:
            # the run's minibatch: every rank's rows
            mean, sd = meshlib.moments(sum_a, self.data_mesh)
            sum_a = (sum_a - mean) / (sd + 1e-8)
        elif cfg.adv_norm:
            sd = torch.std(sum_a, correction=0)     # jnp.std: population
            sum_a = (sum_a - torch.mean(sum_a)) / (sd + 1e-8)
        w_mean = sum_a.new_zeros(())
        if cfg.pg_is_clip and "bp" in batch:
            a_1h = common.one_hot(batch["a"], self.n_actions)
            taken_now = torch.sum(p * a_1h, dim=-1)                  # [B, N]
            w = torch.clamp(taken_now / torch.clamp_min(batch["bp"], 1e-8),
                            0.0, cfg.pg_is_clip)
            w_mean = torch.mean(w)
            sum_a = sum_a * (w[:, :1] if n == 1 else w)
        return sum_a, w_mean

    def _policy_loss(self, actor, q_cf_net, v, batch, q_actual, eps):
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
            sum_a, w_mean = self._advantages(probs.detach(), q_cf_net, v,
                                             batch, q_actual)
        taken = torch.sum(probs * a_1h, dim=-1)
        log_pi = torch.log(taken + 1e-15)                            # [B, N]
        if self.n_agents == 1:
            loss = -torch.mean(log_pi[:, 0] * sum_a[:, 0])
        else:
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

    def _opt_step(self, *steps, lr_scale=None, apply=None):
        """Adam apply + soft target update for the networks of ``steps``,
        each (opt_state, net, tgt, lr), where the 0-dim device predicate
        ``apply`` holds (always without one): one fused kernel launch
        over all their flat buffers (``ops/fused_opt.py``), or the
        optax-order update per network (``common.adam_apply``)."""
        if self.cfg.fused_opt:
            items = [(opt, net.flat, tgt.flat, net.flat_grad, lr)
                     for opt, net, tgt, lr in steps]
            # an ungated update passes (items, tau) alone, so a stand-in
            # for the wrapper that takes only those (tests/test_torch_cm3.py
            # counts the calls with one) still serves it
            if apply is None:
                fused_opt.adam_polyak_many(items, self.cfg.tau)
            else:
                fused_opt.adam_polyak_many(items, self.cfg.tau, apply=apply)
            return
        self._optax_step(*steps, lr_scale=lr_scale, apply=apply)

    def _frozen_target_step(self, tgt, net, apply):
        """The actor target's soft update toward the frozen actor where
        the 0-dim device predicate ``apply`` holds: the Polyak kernel on
        the fused path (over the [S, n] buffer viewed flat with seeds),
        ``common.soft_update`` on the optax path, as the JAX update
        computes it (``cm3.py:631``)."""
        if self.cfg.fused_opt:
            polyak.polyak_update(tgt.flat.view(-1), net.flat.view(-1),
                                 self.cfg.tau, apply)
        else:
            common.soft_update(tgt.flat, net.flat, self.cfg.tau, apply)

    @nets.full_float32()
    def update(self, ts: CM3State, batch: Dict[str, Any], epsilon,
               gumbel, gate=None, with_grads: bool = False) -> tuple:
        """One CM3 learning step, in place on ``ts``'s buffers.

        batch fields are [B, ...] ([S, B, ...] with seeds): state/obs
        (dicts), a [B,N] int, rl [B,N], state_next, obs_next, done [B],
        goals [B,N,G], a_prev [B,N] (Checkers) and, for ``pg_is_clip``,
        bp [B,N].
        ``gumbel`` is the [B, N, A] noise that samples the target-policy
        actions a'.  ``epsilon`` is a float, or a 0-dim float32 tensor on
        the device ([S] with seeds).  ``gate`` (a 0-dim bool tensor,
        optional) applies the update only where it holds.  Returns (ts,
        metrics); the metrics are device scalars ([S] with seeds;
        reading them syncs).  ``with_grads`` adds ``metrics["grads"]``,
        each network's raw gradient under JAX's name (``Policy``,
        ``Q_global``, ``Q_credit``, ``V``; ``cm3.py:637-643``), flat in
        the port's layout ([S, n] with seeds), cloned before the
        optimizer reads it."""
        cfg = self.cfg
        h = self._handle
        eps = self._epsilon(epsilon)
        with torch.no_grad():
            y_g, y_c, y_v = self._map(
                self._td_targets, h(ts.actor_tgt), h(ts.qg_tgt),
                h(ts.qc_tgt), h(ts.v_tgt), batch, eps, gumbel)

        # ---- Q_global, Q_credit and V critic updates, one backward ----
        critics = [(ts.opt_qg, ts.qg, ts.qg_tgt, cfg.lr_Q)]
        if self.use_credit:
            critics.append((ts.opt_qc, ts.qc, ts.qc_tgt, cfg.lr_Q))
        if self.use_v:
            critics.append((ts.opt_v, ts.v, ts.v_tgt, cfg.lr_V))
        for _, net, _, _ in critics:
            net.flat_grad.zero_()
        loss_qg, loss_qc, loss_v, q = self._map(
            self._critic_losses, h(ts.qg), h(ts.qc), h(ts.v), batch, y_g,
            y_c, y_v)
        self._backward(loss_qg.sum() + loss_qc.sum() + loss_v.sum(),
                       *(net for _, net, _, _ in critics))
        grads = {}
        if with_grads:
            grads["Q_global"] = ts.qg.flat_grad.clone()
            if self.use_credit:
                grads["Q_credit"] = ts.qc.flat_grad.clone()
            if self.use_v:
                grads["V"] = ts.v.flat_grad.clone()
        q_actual = q.detach()
        with torch.no_grad():
            self._opt_step(*critics, apply=gate)

        # ---- policy gradient (:699-773); the actor frozen for the
        # first actor_freeze_updates updates (:624-635) by predicates on
        # the device's step count: the actor's step where it is live,
        # its target's move toward it where it is frozen ----
        live, frozen = gate, None
        if cfg.actor_freeze_updates:
            held = ts.step >= cfg.actor_freeze_updates
            live = held if gate is None else gate & held
            frozen = ~held if gate is None else gate & ~held
        ts.actor.flat_grad.zero_()
        loss_pi, ent, w_mean = self._map(
            self._policy_loss, h(ts.actor),
            h(ts.qg if self.n_agents == 1 else ts.qc), h(ts.v), batch,
            q_actual, eps)
        self._backward(loss_pi.sum(), ts.actor)
        if with_grads:
            grads["Policy"] = ts.actor.flat_grad.clone()
        with torch.no_grad():
            self._opt_step(
                (ts.opt_actor, ts.actor, ts.actor_tgt, cfg.lr_actor),
                lr_scale=self._actor_lr_scale(ts.step), apply=live)
            if frozen is not None:
                self._frozen_target_step(ts.actor_tgt, ts.actor, frozen)
        self._count_update(ts, gate)
        metrics = {"loss_Q_global": loss_qg.detach()}
        if self.use_credit:
            metrics["loss_Q_credit"] = loss_qc.detach()
        if self.use_v:
            metrics["loss_V"] = loss_v.detach()
        if cfg.pg_is_clip and "bp" in batch:
            metrics["is_weight_mean"] = w_mean
        if cfg.pg_ent_coef:
            metrics["policy_entropy"] = ent.detach()
        metrics["policy_loss"] = loss_pi.detach()
        if with_grads:
            metrics["grads"] = grads
        return ts, metrics
