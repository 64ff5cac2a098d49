"""What CM3, the baselines and QMIX share: the parameter layouts (one
seed in flattened modules, or seeds in lockstep in ``nets.SeedStack``s),
the per-seed map, fresh and empty states, the optax-path step, and the
draws each algorithm asks of the driver.

A subclass names its networks with ``_makers()`` (a list of module
constructors, None for a network the configuration leaves out) and
builds its state from their (main, target) pairs in ``_state``.  Every
step of an update is written for one seed; ``_map`` runs it over the
seed axis with ``torch.func.vmap``, or as it is without seeds.

Draws.  The driver hands ``act`` what ``act_draws(draws, lead)`` makes
and ``update`` what ``update_draws(draws, lead)`` makes, ``lead`` being
the instances' leading shape ([E] or [S, E]; for an update [B] or
[S, B]).  An actor-critic samples from its policy with Gumbel noise
[*lead, N, A] in both; QMIX overrides them (``algs/qmix.py``).

Data-parallel training (``parallel/mesh.py``).  With ``data_mesh`` set
(the driver sets it to the mesh of the rollout state it steps) each
backward averages its networks' flat gradients over the ranks in one
all-reduce, before the optimizer (and its clip) reads them; the losses
are means over the rank's rows, so every rank then steps with the
global minibatch's gradient, and the replicas stay equal.  Without a
mesh, and on the seed axis, there is no collective.
"""

from __future__ import annotations

import contextlib
import dataclasses
import warnings
from typing import Dict, Optional, Sequence, Union

import torch
from torch.func import functional_call, vmap

from cm3_tpu_torch.algs import common
from cm3_tpu_torch.core import prng
from cm3_tpu_torch.core.config import AlgConfig, NNConfig
from cm3_tpu_torch.models import nets
from cm3_tpu_torch.parallel import mesh as meshlib
from cm3_tpu_torch.utils import profiling

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
    """Runs on ``device`` (``cuda`` unless told); with ``n_seeds`` (1
    included) it trains that many independent seeds in lockstep in seed
    stacks, and without it one seed in flattened modules."""

    def __init__(self, experiment: str, spec: Dict[str, int], alg: AlgConfig,
                 nn_cfg: NNConfig = NNConfig(), device="cuda",
                 n_seeds: Optional[int] = None):
        if experiment not in EXPERIMENTS:
            raise ValueError(f"unknown experiment {experiment!r}")
        nets.init_scheme(alg.init_scheme)
        self.experiment = experiment
        self.spec = dict(spec, n_agents=alg.n_agents)
        self.cfg = alg
        self.nn_cfg = nn_cfg
        self.n_agents = alg.n_agents
        self.n_actions = spec["l_action"]
        self.stage = alg.stage
        self.device = torch.device(device)
        self.n_seeds = n_seeds
        # forward templates for the seed-stacked networks
        self._tmpl = {}
        # the gradient snapshot's copy of the state, made at its first use
        self._scratch = None
        # the data mesh whose ranks' gradients each backward averages
        self.data_mesh = None

    def for_seeds(self, n_seeds: Optional[int]):
        """The same algorithm for ``n_seeds`` seeds in lockstep (None:
        one seed in flattened modules)."""
        return type(self)(self.experiment, self.spec, self.cfg, self.nn_cfg,
                          self.device, n_seeds)

    # ---- networks and states ---- #

    def _makers(self):
        """The networks' module constructors in the state's order; None
        where the configuration has no such network."""
        raise NotImplementedError

    def _state(self, *pairs):
        """The state from each network's (main, target) pair (None for
        an absent one), in the order of ``_makers``."""
        raise NotImplementedError

    def _template(self, make):
        if make not in self._tmpl:
            self._tmpl[make] = make().to(self.device)
        return self._tmpl[make]

    def _pair(self, make, gens=None):
        """(main, target) on the device, each flattened; the target
        starts equal to the main.  Parameters are drawn on the CPU from
        ``gens`` (one generator per seed, so a seed gives the same
        weights on every device and for any number of seeds), or left to
        be loaded when ``gens`` is None."""
        def drawn(gen):
            m = make()
            if gen is not None:
                nets.init_parameters(m, gen, self.cfg.init_scheme)
            return m

        if self.n_seeds is None:
            main = nets.flatten_parameters(
                drawn(gens and gens[0]).to(self.device))
            tgt = nets.flatten_parameters(make().to(self.device),
                                          with_grad=False)
        else:
            tmpl = self._template(make)
            main = nets.SeedStack(tmpl, self.n_seeds)
            tgt = nets.SeedStack(tmpl, self.n_seeds, with_grad=False)
            for s, gen in enumerate(gens or ()):
                main.flat[s] = nets.flatten_parameters(drawn(gen)).flat
        tgt.flat.copy_(main.flat)
        return main, tgt

    def init_state(self, key: Union[int, Sequence[int]]):
        """Fresh parameters from ``key`` (a ``core.prng`` key), or with
        seeds from ``key``, a sequence of one key per seed.  Network i of
        ``_makers`` draws from the key's PARAMS purpose folded with i."""
        keys = [key] if self.n_seeds is None else list(key)
        if len(keys) != (self.n_seeds or 1):
            raise ValueError(f"init_state wants {self.n_seeds} keys, got "
                             f"{len(keys)}")

        def gens(i):
            return [prng.generator(prng.fold_in(
                prng.for_purpose(k, prng.PARAMS), i), "cpu") for k in keys]
        return self._state(*(make and self._pair(make, gens(i))
                             for i, make in enumerate(self._makers())))

    def empty_state(self):
        """A state of the right shapes whose values are to be loaded
        (``convert.state_from_jax``, ``train.checkpoint.restore``)."""
        return self._state(*(make and self._pair(make)
                             for make in self._makers()))

    def _adam(self, net):
        return common.adam_init(net.flat, bool(self.cfg.grad_clip))

    # ---- the seed map.  A network argument is a flattened module
    # (single seed) or one seed's parameter dict (inside ``_map``) ---- #

    def _call(self, make, net, *args):
        if isinstance(net, torch.nn.Module):
            return net(*args)
        return functional_call(self._template(make), net, args)

    def _map(self, fn, *args):
        """``fn`` (written for one seed) over the seed axis of ``args``,
        or on them as they are without seeds."""
        if self.n_seeds is None:
            return fn(*args)
        if not self._tmpl:
            # a module draws its parameters when it is built, which vmap
            # refuses: build the templates before the first map (a state
            # loaded or made by another instance built none here)
            for make in self._makers():
                if make is not None:
                    self._template(make)
        return vmap(fn)(*args)

    @staticmethod
    def _handle(net):
        """What ``_map`` passes for a network: the module itself, the
        stacked parameter dict, or {} for an absent network."""
        if net is None:
            return {}
        return net if isinstance(net, torch.nn.Module) else net.params

    def _epsilon(self, epsilon):
        """A Python float without seeds; an [S] float32 tensor with.  A
        host value's copy to a CUDA device waits for the device (the
        evaluation's epsilon 0, at every step): ``cm3.host_sync``."""
        if self.n_seeds is None:
            return epsilon
        with (contextlib.nullcontext() if torch.is_tensor(epsilon)
              else profiling.annotate("cm3.host_sync")):
            return torch.as_tensor(epsilon, dtype=torch.float32,
                                   device=self.device).expand(self.n_seeds)

    @profiling.spanned("cm3.backward")
    def _backward(self, loss, *nets_):
        """Backward into the flat gradient buffers of the networks
        ``nets_`` (None for an absent one); on a data mesh their mean
        over the ranks then replaces them, in one all-reduce.  The seed
        stacks' gradient views are strided (a row of [S, n] each), which
        autograd notes as a layout it would not have chosen; it
        accumulates into them in place all the same."""
        with warnings.catch_warnings():
            warnings.filterwarnings(
                "ignore", message="grad and param do not obey")
            loss.backward()
        if self.data_mesh is not None:
            meshlib.mean_gradients([n.flat_grad for n in nets_
                                    if n is not None], self.data_mesh)

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

    # ---- the gradient snapshot ---- #

    @torch.no_grad()
    def _copy_into(self, dst, src):
        """``src``'s values into the state ``dst`` of the same shapes: the
        buffers by ``copy_``, the counts (0-dim tensors an update never
        writes in place) by reference."""
        for f in dataclasses.fields(src):
            name, value = f.name, getattr(src, f.name)
            if value is None or name == "step":
                continue
            if name.startswith("opt_"):
                opt = getattr(dst, name)
                opt.mu.copy_(value.mu)
                opt.nu.copy_(value.nu)
                opt.count = value.count
            else:
                getattr(dst, name).flat.copy_(value.flat)
        dst.step = src.step

    def grad_snapshot(self, ts, batch, epsilon, update_draws):
        """The raw gradients of one update of ``ts`` on ``batch``
        (``metrics["grads"]`` of ``update(..., with_grads=True)``), the
        update's result dropped, as the JAX drivers' ``_grad_snapshot``
        drops it (``offpolicy.py:181-186``).  The port's update writes
        its state in place, so it runs on a copy of ``ts`` (a scratch
        state kept between calls): ``ts`` is not written.  A gated-off
        update would not do: the policy gradient reads the critics
        AFTER their step (the post-update Q_credit / Q_global / V, and
        COMA's post-update critic), which JAX's snapshot takes."""
        if self._scratch is None:
            self._scratch = self.empty_state()
        self._copy_into(self._scratch, ts)
        _, metrics = self.update(self._scratch, batch, epsilon,
                                 update_draws, with_grads=True)
        return metrics["grads"]

    # ---- draws ---- #

    def act_draws(self, draws, lead: Sequence[int]):
        """What ``act`` consumes for instances of the leading shape
        ``lead``: Gumbel noise [*lead, N, A] for the policy's sample."""
        return draws.gumbel(tuple(lead) + (self.n_agents, self.n_actions))

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
        """Sample actions for all agents as one batch, [B, N] ([S, B, N]
        with seeds); ``gumbel`` is [B, N, A] standard Gumbel noise."""
        def one(actor, obs, goals, a_prev, eps, gumbel):
            probs = self.actor_probs(actor, obs, goals, a_prev, eps)
            return common.sample_actions(probs, gumbel)
        return self._map(one, self._handle(ts.actor), obs, goals, a_prev,
                         self._epsilon(epsilon), gumbel)
