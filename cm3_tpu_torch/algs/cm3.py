"""CM3: multi-goal actor-critic with a counterfactual credit function.

Port of ``cm3_tpu.algs.cm3`` for Checkers with the Q_credit critic
(n_agents > 1), on the fused optimizer path (``AlgConfig.fused_opt``).
The update keeps the JAX package's order:

  * target-policy actions a' from the slow target actor with the
    eps-mixed policy, conditioned on the taken action as previous
    action (alg_credit.py:579-583);
  * the Q_global and Q_credit TD targets from the target critics; one
    backward pass over the sum of both TD losses (disjoint parameters,
    so the gradients are those of two passes);
  * Q_actual for the policy gradient is the PRE-update Q_global
    forward; the counterfactual baseline uses the POST-update Q_credit
    (alg_credit.py:720,750); advantages are constants of the policy
    loss;
  * each network's Adam step and soft target update run fused over its
    flat buffers (``ops.fused_opt``): the two critics, adjacent and at
    one lr, in one launch, the actor in another; two launches per
    update (the JAX package makes three calls, ``cm3.py:132-136``).

The update's one random draw, a' (``cm3.py:465``), comes in as Gumbel
noise, so a test can feed JAX's.  Not ported yet (ROADMAP.md): the
particle and roadway nets, the V critic, the n=1 counterfactual, and
the opt-in knobs ``pg_is_clip``, ``pg_ent_coef``, ``adv_norm`` and
``actor_freeze_updates``; their absence is their default.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from cm3_tpu_torch.algs import common
from cm3_tpu_torch.core import prng
from cm3_tpu_torch.core.config import AlgConfig, NNConfig
from cm3_tpu_torch.models import nets
from cm3_tpu_torch.ops import fused_opt


@dataclasses.dataclass
class CM3State:
    """Each network is an ``nn.Module`` whose parameters are views into
    its flat buffer ``module.flat`` (``nets.flatten_parameters``)."""

    actor: Any
    actor_tgt: Any
    qg: Any
    qg_tgt: Any
    qc: Any
    qc_tgt: Any
    opt_actor: common.AdamState
    opt_qg: common.AdamState
    opt_qc: common.AdamState
    step: int = 0


class CM3:
    """CM3 on Checkers.  Runs on ``device`` (``cuda`` unless told)."""

    def __init__(self, experiment: str, spec: Dict[str, int], alg: AlgConfig,
                 nn_cfg: NNConfig = NNConfig(), device="cuda"):
        if experiment != "checkers":
            raise NotImplementedError(
                f"only Checkers is ported, not {experiment!r}")
        if alg.n_agents < 2:
            raise NotImplementedError(
                "the n_agents == 1 counterfactual is not ported yet")
        if alg.fused_opt and alg.grad_clip:
            raise ValueError(
                "fused_opt requires grad_clip == 0 (the global-norm clip "
                "is a different program shape; see AlgConfig)")
        if alg.fused_opt and alg.actor_lr_anneal_updates:
            raise ValueError(
                "fused_opt is incompatible with actor_lr_anneal_updates "
                "(the fused kernel's lr is static)")
        if not alg.fused_opt:
            raise NotImplementedError(
                "the port implements the fused optimizer path: set "
                "AlgConfig.fused_opt=True")
        nets.init_scheme(alg.init_scheme)
        self.experiment = experiment
        self.spec = dict(spec, n_agents=alg.n_agents)
        self.cfg = alg
        self.nn_cfg = nn_cfg
        self.n_agents = alg.n_agents
        self.n_actions = spec["l_action"]
        self.stage = alg.stage
        self.device = torch.device(device)

    # ---- networks ---- #

    def _actor_module(self):
        c = self.nn_cfg
        return nets.ActorCheckers(
            self.spec, conv_f=c.A_conv_f, conv_k=tuple(c.A_conv_k),
            n_h1=c.A_n_h1, n_h2=c.A_n_h2, stage=self.stage)

    def _qg_module(self):
        c = self.nn_cfg
        return nets.QGlobalCheckers(
            self.spec, conv_f1=c.Q_conv_f, conv_k1=tuple(c.Q_conv_k),
            n_h1_1=c.Q_n_h1_1, n_h1_2=c.Q_n_h1_2, n_h2=c.Q_n_h2,
            stage=self.stage)

    def _qc_module(self):
        c = self.nn_cfg
        return nets.QCreditCheckers(
            self.spec, conv_f1=c.Q_conv_f, conv_k1=tuple(c.Q_conv_k),
            n_h1_1=c.Q_n_h1_1, n_h1_2=c.Q_n_h1_2, n_h2=c.Q_n_h2,
            stage=self.stage)

    def _pair(self, make, gen=None):
        """(main, target) modules on the device, each flattened; the
        target starts equal to the main.  Parameters are drawn on the
        CPU from ``gen`` (so a seed gives the same weights on every
        device), or left to be loaded when ``gen`` is None."""
        main = make()
        if gen is not None:
            nets.init_parameters(main, gen, self.cfg.init_scheme)
        main = nets.flatten_parameters(main.to(self.device))
        tgt = nets.flatten_parameters(make().to(self.device),
                                      with_grad=False)
        tgt.flat.copy_(main.flat)
        return main, tgt

    def init_state(self, key: int) -> CM3State:
        """Fresh parameters from ``key`` (a ``core.prng`` key)."""
        k = prng.for_purpose(key, prng.PARAMS)
        gen = lambda i: prng.generator(prng.fold_in(k, i), "cpu")
        return self._state(self._pair(self._actor_module, gen(0)),
                           self._pair(self._qg_module, gen(1)),
                           self._pair(self._qc_module, gen(2)))

    def empty_state(self) -> CM3State:
        """A state of the right shapes whose values are to be loaded
        (``convert.state_from_jax``)."""
        return self._state(self._pair(self._actor_module),
                           self._pair(self._qg_module),
                           self._pair(self._qc_module))

    def _state(self, actor, qg, qc) -> CM3State:
        return CM3State(
            actor=actor[0], actor_tgt=actor[1], qg=qg[0], qg_tgt=qg[1],
            qc=qc[0], qc_tgt=qc[1],
            opt_actor=common.adam_init(actor[0].flat),
            opt_qg=common.adam_init(qg[0].flat),
            opt_qc=common.adam_init(qc[0].flat))

    # ---- forward helpers (all take [B, N, ...] and return [B, N, ...]) ---- #

    def actor_probs(self, actor, obs, goals, a_prev, epsilon):
        """eps-mixed policy probabilities, [B, N, A]."""
        b, n = goals.shape[0], goals.shape[1]
        f = common.flatten_bn
        probs = actor(f(common.one_hot(a_prev, self.n_actions)),
                      f(obs["self_t"]), f(obs["self_v"]), f(obs["others"]),
                      f(goals))
        probs = probs.reshape(b, n, self.n_actions)
        return common.epsilon_probs(probs, epsilon, self.n_actions)

    @torch.no_grad()
    @nets.full_float32()
    def act(self, ts: CM3State, obs, goals, a_prev, epsilon, gumbel):
        """Sample actions for all agents as one batch, [B, N];
        ``gumbel`` is [B, N, A] standard Gumbel noise."""
        probs = self.actor_probs(ts.actor, obs, goals, a_prev, epsilon)
        return common.sample_actions(probs, gumbel)

    def _q_global(self, qg, state, obs, goals, a_1h):
        """Q_n(s, a_all) for every agent, [B, N]."""
        b, n = goals.shape[0], goals.shape[1]
        f = common.flatten_bn
        vec = state["vec"]
        grid = state["grid"][:, None].expand((b, n) + state["grid"].shape[1:])
        q = qg(f(grid), f(vec), f(goals), f(a_1h),
               f(common.others_concat(vec)), f(common.others_stack(a_1h)),
               f(obs["self_t"]), f(obs["self_v"]))
        return q.reshape(b, n)

    def _q_credit_pairs(self, qc, state, obs, goals, a_m_1h):
        """Q_n(s, a^m) for all (m, n) pairs, [B, M, N]; m is the outer
        and n the inner index (alg_credit.py:619-658)."""
        b, n = goals.shape[0], goals.shape[1]
        vec = state["vec"]
        s_others = common.others_concat(vec)
        pn = lambda x: x[:, None].expand((b, n) + x.shape[1:])
        pm = lambda x: x[:, :, None].expand((b, n, n) + x.shape[2:])
        flat = lambda x: x.reshape((b * n * n,) + x.shape[3:])
        grid = state["grid"]
        grid_p = grid[:, None, None].expand((b, n, n) + grid.shape[1:])
        q = qc(flat(grid_p), flat(pn(vec)), flat(pn(goals)), flat(pm(a_m_1h)),
               flat(pm(vec)), flat(pn(s_others)), flat(pm(obs["self_t"])),
               flat(pm(obs["self_v"])))
        return q.reshape(b, n, n)

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
        grid = state["grid"]
        grid_p = grid[:, None, None, None].expand(shape4 + grid.shape[1:])
        q = qc(flat(grid_p), flat(pn(vec)), flat(pn(goals)), flat(eye),
               flat(pm(vec)), flat(pn(s_others)), flat(pm(obs["self_t"])),
               flat(pm(obs["self_v"])))
        return q.reshape(shape4)

    # ---- the learning update ---- #

    def _opt_step(self, lr, *steps):
        """Adam apply + soft target update for the networks of ``steps``,
        each (opt_state, net, tgt), at one lr: one fused kernel launch
        over all their flat buffers (``ops/fused_opt.py``)."""
        fused_opt.adam_polyak_many(
            [(opt, net.flat, tgt.flat, net.flat_grad, lr)
             for opt, net, tgt in steps], self.cfg.tau)

    @nets.full_float32()
    def update(self, ts: CM3State, batch: Dict[str, Any], epsilon,
               gumbel) -> tuple:
        """One CM3 learning step, in place on ``ts``'s buffers.

        batch fields are [B, ...]: state/obs (dicts), a [B,N] int,
        rl [B,N], state_next, obs_next, done [B], goals [B,N,G] and
        a_prev [B,N].  ``gumbel`` is the [B, N, A] noise that samples the
        target-policy actions a'.  Returns (ts, metrics); the metrics
        are device scalars (reading them syncs)."""
        cfg = self.cfg
        a_dim = self.n_actions
        gamma = cfg.gamma
        obs, obs_next = batch["obs"], batch["obs_next"]
        state, state_next = batch["state"], batch["state_next"]
        goals = batch["goals"]
        a_1h = common.one_hot(batch["a"], a_dim)
        done_mult = 1.0 - batch["done"].float()
        rl = batch["rl"]
        tclip = ((lambda y: y.clamp(-cfg.target_clip, cfg.target_clip))
                 if cfg.target_clip else (lambda y: y))

        # ---- TD targets from the target nets (:579-596, :619-658) ----
        with torch.no_grad():
            probs_tgt = self.actor_probs(ts.actor_tgt, obs_next, goals,
                                         batch["a"], epsilon)
            a_next_1h = common.one_hot(
                common.sample_actions(probs_tgt, gumbel), a_dim)
            q_tgt_next = self._q_global(ts.qg_tgt, state_next, obs_next,
                                        goals, a_next_1h)
            y_g = tclip(rl + gamma * q_tgt_next * done_mult[:, None])
            qc_tgt_next = self._q_credit_pairs(ts.qc_tgt, state_next,
                                               obs_next, goals, a_next_1h)
            y_c = tclip(rl[:, None, :] + gamma * qc_tgt_next
                        * done_mult[:, None, None])

        # ---- Q_global + Q_credit critic updates, one backward ----
        ts.qg.flat_grad.zero_()
        ts.qc.flat_grad.zero_()
        q = self._q_global(ts.qg, state, obs, goals, a_1h)
        loss_qg = torch.mean(torch.square(y_g - q))
        qc = self._q_credit_pairs(ts.qc, state, obs, goals, a_1h)
        loss_qc = torch.mean(torch.square(y_c - qc))
        (loss_qg + loss_qc).backward()
        q_actual = q.detach()                                 # [B, N]
        with torch.no_grad():
            self._opt_step(cfg.lr_Q, (ts.opt_qg, ts.qg, ts.qg_tgt),
                           (ts.opt_qc, ts.qc, ts.qc_tgt))

        # ---- policy gradient (:699-773) ----
        # the current policy's probs, with grad for the policy loss and
        # as a constant inside the counterfactual sum (a placeholder
        # feed in the reference); the actor is still pre-update here
        ts.actor.flat_grad.zero_()
        probs = self.actor_probs(ts.actor, obs, goals, batch["a_prev"],
                                 epsilon)
        with torch.no_grad():
            q_cf = self._q_credit_cf(ts.qc, state, obs, goals)  # post-update
            cf = torch.einsum("bma,bmna->bmn", probs.detach(), q_cf)
            sum_a = torch.sum(q_actual[:, None, :] - cf, dim=2)  # [B, M]
        taken = torch.sum(probs * a_1h, dim=-1)
        log_pi = torch.log(taken + 1e-15)                        # [B, N]
        loss_pi = -torch.mean(torch.sum(log_pi * sum_a, dim=1))
        loss_pi.backward()
        with torch.no_grad():
            self._opt_step(cfg.lr_actor, (ts.opt_actor, ts.actor,
                                          ts.actor_tgt))
        ts.step += 1
        metrics = {"loss_Q_global": loss_qg.detach(),
                   "loss_Q_credit": loss_qc.detach(),
                   "policy_loss": loss_pi.detach()}
        return ts, metrics
