"""Off-policy trainer (``cm3_tpu.train.offpolicy``): the training chunk,
the greedy evaluation and the single-seed host loop.

The driver steps ``n_envs`` instances in lockstep.  One chunk
(``OffPolicyDriver._chunk``, ``offpolicy.py:345-385``) runs
``steps_per_train`` env steps, each with its replay add and the
auto-reset of finished instances, then ``updates_per_chunk`` learning
updates on replay minibatches.  The order is the JAX package's: the
chunk's transitions go into replay before the updates sample it.
``evaluate`` (``:389-432``) rolls the policy out with epsilon 0 for
``max_steps`` steps over ``N_eval`` fresh episodes; ``run``
(``:434-542``) is the host loop: random-fill chunks until
``pretrain_episodes`` episodes are done (policy rollouts without
updates after a resume), training chunks after, epsilon decayed per
completed episode, and one evaluation and one history row per
``period`` episodes.

Seeds in lockstep.  With an algorithm built for S seeds
(``CM3(..., n_seeds=S)``) every per-instance tensor carries a leading
[S, E] (the engine steps the S x E instances as one batch), the
per-seed values (completed episodes, return sums, the episode-log
ring, epsilon) a leading [S], and the replay one ring per seed.  The
same code runs one seed with [E] and scalars.  ``train/multiseed.py``
drives it.

Where the JAX chunk splits a key, this one asks a draw source
(``core.prng``) in a fixed order: per env step, random actions or what
the algorithm's ``act`` consumes (``alg.act_draws``: the [E, N, A]
Gumbel noise of CM3's and the baselines' sample; QMIX's override
actions and uniforms), then (single-agent Checkers) the goals of the
auto-reset; per update, the replay indices and what ``update`` consumes
(``alg.update_draws``: the Gumbel noise of a'; nothing for QMIX).
Feeding JAX's draws through ``prng.FedDraws`` replays a JAX chunk
exactly.

An engine with a feasibility filter (roadway's ``check_actions``) has
it applied to every action before the step, in training and in the
evaluation, and the transition stores the action it returns
(``offpolicy.py:260-263, 408-409``).  With ``AlgConfig.pg_is_clip`` on,
each transition also stores ``bp``, the behavior policy's probability
of that stored action, gathered after the filter (the eps-mixed
policy's; the uniform 1/A on random-fill chunks), as the JAX driver
does (``offpolicy.py:115-118, 228-231, 265-274``).

The dual buffer (``TrainConfig.dual_buffer``, ``offpolicy.py:284-303``).
Each instance stages its episode's transitions in a slab of
``max_steps`` rows ([*L, max_steps + 1, ...]: the last row takes the
writes past the slab, JAX's ``mode="drop"``); at every step the
episodes that ended are flushed whole into the bad or the good memory
by ``hooks.is_bad_episode`` (``replay.flush_episodes``), and a period
row reads both fills (``n_bad``, ``n_good``).  The slab keeps JAX's
truncation: it holds the master's ``max_steps`` transitions (33), so
an episode longer than that (roadway's per-car cap is 40 steps) loses
its tail, its terminal transition included.

The K-chunk schedule (``TrainConfig.chunks_per_sync`` = K > 1,
``_chunks_scanned``, ``offpolicy.py:188-213``).  ``run`` then dispatches
K chunks with no host sync between them and reads the episode count
once after them.  Each chunk takes its regime from the device's live
episode count: the gate ``episodes >= pretrain_episodes`` and epsilon
(float32, JAX's formula).  Where the gate is false the chunk is a fill
chunk: the policy's actions are computed and replaced by random ones
(``bp`` the uniform 1/A), and its updates are computed and dropped (the
algorithms' ``update(..., gate=)``: selects and kernel predicates, the
step and the Adam counts kept on the device), their metrics zeroed, as
JAX's ``_chunk(gate=)`` does (``offpolicy.py:233-276, 345-385``).  Such
a chunk asks the draw source for the policy's draws, then for the
random actions, as JAX splits ``k_act`` and ``k_rand``.  A dispatch's
metrics are its last chunk's plus ``trained`` (that chunk's gate) and
``trained_chunks`` (how many of its chunks trained).  The resume
warm-up stays host-paced, and the host's epsilon is not updated after
a dispatch that began in the fill phase, as in JAX (``:472-497``).
Seeds in lockstep (``train/multiseed.py``) ignore ``chunks_per_sync``,
as JAX's ``train_vmapped_seeds`` does.

Gradient summaries (``TrainConfig.summarize``, ``offpolicy.py:140-143,
181-186, 527-530``).  Each period row after the fill carries
``_grads``: the raw gradients of one extra update on a fresh replay
sample whose result is dropped (``alg.grad_snapshot``: the update runs
on a copy of the state, so training is not changed), for the runner's
TensorBoard histograms.  Its draws (the sample's indices, then what
``update`` consumes) come from their own stream per period, the
evaluation purpose's key folded with 1,000,000 + the period's index, as
JAX's keys come from ``fold_in(k_eval, 1_000_000 + period_idx)``; so
they take nothing from the training or the evaluation draws, and a run
with summaries on gives the rows and the state of one with them off.

Shard-local replay (``TrainConfig.replay_shards`` = D > 1,
``offpolicy.py:145-180``): the replay is D rings of ``buffer_size``/D
rows with device cursors (``replay.init_sharded``; the dual buffer's
memories alike), instance i's rows go into shard i // (n_envs/D), and a
minibatch takes ``batch_size``/D rows from each shard, drawn per shard
below its own fill (``draws.randint_below`` over [*P, D, batch/D]; for
the dual buffer all shards' bad-memory indices, then all shards' good
ones).  ``n_envs``,
``batch_size`` and ``buffer_size`` must be divisible by D
(``ValueError``).  A period row's ``n_bad``/``n_good`` sum the shards.

``eval_hooks`` (``offpolicy.py:107-112``): the evaluation's episodes
come from these hooks (their engine, goals and eval metrics) when
given, else from the training hooks.

Data-parallel over processes (``parallel/mesh.py``; one seed).  A
rollout state placed by ``mesh.shard_driver_state`` carries its mesh
(``rs.mesh``), and a driver that steps it trains data-parallel, as the
JAX driver does on sharded arrays: this rank steps its n_envs/W
instances and holds its D/W replay shards (or, with one ring, the whole
ring, fed with every rank's transitions), samples its batch/W rows of
each minibatch (the shards' rows, or its block of the ring's global
index draw; a dual ring's 50/50 split is the global minibatch's), and
its algorithm averages each backward's gradients over the ranks.  Each
step gathers every instance's done flag and returns, so the episode
counts, return sums and episode log are the run's, the same on every
rank, and epsilon and the schedule with them; the last update's metrics
are averaged.  Every draw source is asked for the whole run's draw and
hands out this rank's block (``prng.BlockDraws``), so W ranks consume
the single-process run's draws.  The evaluation runs whole on every
rank with the replicated parameters and the draws as they are, so the
ranks agree.  The driver takes the mesh of the rollout state it was
last given and hands it to its algorithm (``alg.data_mesh``, the one
place it is kept; a burst and a snapshot, which take no rollout state,
train on it); ``run(..., mesh=)`` builds this rank's block itself,
only the primary process calls ``log_fn``, and the mesh is unbound when
the run ends.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from cm3_tpu_torch.algs import common
from cm3_tpu_torch.core import prng
from cm3_tpu_torch.core.config import TrainConfig
from cm3_tpu_torch.core.tree import tree_map
from cm3_tpu_torch.parallel import dist as pdist
from cm3_tpu_torch.parallel import mesh as meshlib
from cm3_tpu_torch.replay import buffer as replay
from cm3_tpu_torch.train.experiments import Hooks, flat_call


@dataclasses.dataclass
class RolloutState:
    """Instances on a leading L = [E] (one seed) or [S, E] (seeds); the
    per-seed running values on P = [] or [S]."""

    env_state: Any
    obs: Any
    state: Any
    goals: torch.Tensor          # [*L, N, G]
    a_prev: torch.Tensor         # [*L, N]
    ep_ret_local: torch.Tensor   # [*L, N]
    ep_ret_global: torch.Tensor  # [*L]
    # running accumulators over completed episodes (reset each period)
    acc_ret_local: torch.Tensor  # [*P, N]
    acc_ret_global: torch.Tensor  # [*P]
    episodes: torch.Tensor       # [*P] i64, completed episodes
    # sampled per-episode return ring: eplog [*P, K, N+1] holds
    # (r_local..., r_global) of recently completed episodes, eplog_ep
    # [*P, K] the matching episode numbers (the reference's log.csv
    # stream, train_offpolicy.py:208-218,399-403); None when off
    eplog: Optional[torch.Tensor] = None
    eplog_ep: Optional[torch.Tensor] = None
    # the dual buffer's staging slab: leaves [*L, T + 1, ...] (row T
    # takes the writes past the slab) and each instance's episode
    # length so far [*L] (at most T); None without the dual buffer
    stage: Any = None
    stage_t: Optional[torch.Tensor] = None
    # the data mesh this rank's block of instances lies on
    # (``parallel.mesh.shard_driver_state``); None on one device
    mesh: Any = None


def init_rollout(hooks: Hooks, n_envs: int, draws=None,
                 episode_log: int = 0,
                 n_seeds: Optional[int] = None) -> RolloutState:
    """Fresh episodes in ``n_envs`` instances (per seed), on the env's
    device; ``draws`` gives the goals where they are random."""
    lead = (n_envs,) if n_seeds is None else (n_seeds, n_envs)
    env_state, ts, goals = hooks.episode_init(lead, draws)
    n = hooks.n_agents
    per_seed = lead[:-1]
    dev = hooks.env.device
    zeros = lambda shape, **kw: torch.zeros(shape, device=dev, **kw)
    return RolloutState(
        env_state=env_state, obs=ts.obs, state=ts.state, goals=goals,
        a_prev=zeros(lead + (n,), dtype=torch.int64),
        ep_ret_local=zeros(lead + (n,)), ep_ret_global=zeros(lead),
        acc_ret_local=zeros(per_seed + (n,)), acc_ret_global=zeros(per_seed),
        episodes=zeros(per_seed, dtype=torch.int64),
        eplog=(zeros(per_seed + (episode_log, n + 1)) if episode_log
               else None),
        eplog_ep=(zeros(per_seed + (episode_log,), dtype=torch.int64)
                  if episode_log else None))


def init_stage(rs: RolloutState, example_transition, lead,
               max_steps: int) -> RolloutState:
    """``rs`` with an empty staging slab of ``max_steps`` transitions per
    instance of ``lead`` (``offpolicy.py:94-102``)."""
    lead = tuple(lead)
    rs.stage = tree_map(
        lambda x: torch.zeros(lead + (max_steps + 1,) + tuple(x.shape),
                              dtype=x.dtype, device=x.device),
        example_transition)
    rs.stage_t = torch.zeros(lead, dtype=torch.int64,
                             device=rs.episodes.device)
    return rs


def flush_eplog(eplog, eplog_ep, last_flushed: int, episodes_done: int):
    """One seed's completed-episode rows newer than ``last_flushed``
    from the ring (host arrays), sorted by episode number: -> (ids [M] i64, returns
    [M, N+1] = r_local..., r_global).  Episodes overwritten by the ring
    before a flush are lost: a documented sampling cap."""
    arr = np.asarray(eplog)
    ep_no = np.asarray(eplog_ep, np.int64)
    keep = (ep_no > last_flushed) & (ep_no <= episodes_done)
    order = np.argsort(ep_no[keep])
    return ep_no[keep][order], arr[keep][order]


def _where(done: torch.Tensor, new: torch.Tensor, old: torch.Tensor):
    """Per-instance select: ``new`` where ``done`` (the instance shape's
    leading dims of both)."""
    return torch.where(done.view(done.shape + (1,) * (old.dim()
                                                      - done.dim())),
                       new, old)


def _eplog_write(eplog, eplog_ep, episodes, done, rows):
    """Each completed episode's returns ``rows`` [*L, N+1] into the ring
    at (episode number - 1) mod K (``offpolicy.py:318-330``); the other
    instances write into a bin row past the ring, with episode number 0,
    which is then dropped."""
    k = eplog.shape[-2]
    rank = torch.cumsum(done.long(), dim=-1) - 1
    ep_no = episodes[..., None] + 1 + rank
    idx = torch.where(done, (ep_no - 1) % k, k)
    log = F.pad(eplog, (0, 0, 0, 1)).scatter(
        -2, idx[..., None].expand(rows.shape), rows)
    ep = F.pad(eplog_ep, (0, 1)).scatter(-1, idx,
                                         torch.where(done, ep_no, 0))
    return log[..., :k, :], ep[..., :k]


def _unbinds(run):
    """A driver's ``run`` that leaves its algorithm on no mesh when it
    returns or raises, so that a later update of the algorithm alone
    issues no collective."""
    @functools.wraps(run)
    def wrapped(self, *args, **kwargs):
        try:
            return run(self, *args, **kwargs)
        finally:
            self._bind(None)
    return wrapped


class OffPolicyDriver:

    def __init__(self, hooks: Hooks, alg, cfg: TrainConfig,
                 eval_hooks: Optional[Hooks] = None):
        if cfg.replay_shards > 1:
            replay.check_shards(cfg.replay_shards, n_envs=cfg.n_envs,
                                batch_size=cfg.batch_size,
                                buffer_size=cfg.buffer_size)
        self.hooks = hooks
        self.eval_hooks = eval_hooks or hooks
        self.alg = alg
        self.cfg = cfg
        self.n_envs = cfg.n_envs
        self.n_seeds = getattr(alg, "n_seeds", None)
        self._bind(None)
        # the clipped-IS policy gradient reads the behavior probability
        # of each stored action
        self._store_bp = (getattr(getattr(alg, "cfg", None), "pg_is_clip",
                                  0.0) > 0 and hasattr(alg, "act_bp"))

    @property
    def mesh(self):
        """The data mesh this driver trains on (None: one device), as its
        algorithm holds it for the backward's gradient mean."""
        return self.alg.data_mesh

    def _bind(self, mesh):
        """Train on ``mesh`` (a data mesh, or None for one device): this
        rank's instance lead, minibatch rows and replay shards, and the
        algorithm's gradient mean over the ranks."""
        cfg, w = self.cfg, 1 if mesh is None else mesh.size
        if mesh is not None and mesh is not self.mesh:
            if self.n_seeds is not None:
                raise ValueError("a data mesh trains one seed; seeds in "
                                 "lockstep go over a seed mesh "
                                 "(multiseed.train_vmapped_seeds(mesh=))")
            replay.check_shards(w, n_envs=cfg.n_envs,
                                batch_size=cfg.batch_size)
            if cfg.replay_shards > 1:
                replay.check_shards(w, replay_shards=cfg.replay_shards)
        self.alg.data_mesh = mesh
        e = cfg.n_envs // w
        self.lead = (e,) if self.n_seeds is None else (self.n_seeds, e)
        self.batch = cfg.batch_size // w
        self._sharded = cfg.replay_shards > 1
        self.shards = cfg.replay_shards // w if self._sharded else 1

    def _draws(self, draws):
        """``draws`` as this rank takes them: its block of each of the
        run's draws on a mesh, as they are on one device."""
        if self.mesh is None or isinstance(draws, prng.BlockDraws):
            return draws
        return prng.BlockDraws(draws, self.mesh.rank, self.mesh.size)

    def _over_shards(self, x: torch.Tensor) -> torch.Tensor:
        """``x``, a count over this rank's replay shards, summed over the
        ranks (each holds its own shards); as it is otherwise (one
        device, or every rank holding the whole ring)."""
        if self.mesh is None or not self._sharded:
            return x
        return meshlib.sum_over(x, self.mesh)

    def _seed_epsilon(self, epsilon):
        """epsilon as the algorithm takes it: the float for one seed, an
        [S] tensor on the device with seeds (made once per chunk or
        burst, not at every act and update)."""
        if self.n_seeds is None:
            return epsilon
        return torch.as_tensor(epsilon, dtype=torch.float32,
                               device=self.hooks.env.device).expand(
                                   self.n_seeds)

    # ---- replay ---- #

    def _replay_init(self, example):
        """The empty replay of this rank: its D/W shards of
        ``buffer_size``/D rows, or the whole ring."""
        cfg, d = self.cfg, self.shards
        if self._sharded:
            cap = cfg.buffer_size * d // cfg.replay_shards
            init = (replay.init_dual_sharded if cfg.dual_buffer
                    else replay.init_sharded)
            return init(example, cap, d, self.n_seeds)
        if cfg.dual_buffer:
            return replay.init_dual(example, cfg.buffer_size, self.n_seeds)
        return replay.init(example, cfg.buffer_size, self.n_seeds)

    def init_replay(self, rs: RolloutState):
        """(empty replay, ``rs``) for the rollouts ``rs``; with the dual
        buffer ``rs`` gets its staging slab."""
        self._bind(rs.mesh)
        example = self.example_transition(rs)
        buf = self._replay_init(example)
        if self.cfg.dual_buffer:
            rs = init_stage(rs, example, self.lead, self.cfg.max_steps)
        return buf, rs

    def _replay_add(self, buf, tr):
        if self._sharded:
            return replay.add_batch_sharded(buf, tr, self.shards)
        return replay.add_batch(buf, tr)

    def _replay_flush(self, buf, stage, valid, is_bad):
        if self._sharded:
            return replay.flush_episodes_sharded(buf, stage, valid, is_bad,
                                                 self.shards)
        return replay.flush_episodes(buf, stage, valid, is_bad)

    def _replay_sample(self, buf, draws):
        """A minibatch of ``batch_size`` rows (per seed); its indices
        from ``draws``, below each ring's (shard's, memory's) fill."""
        cfg, d = self.cfg, self.shards
        shape = self.lead[:-1] + ((d, self.batch // d) if self._sharded
                                  else (self.batch,))
        below = lambda ring: draws.randint_below(
            shape, torch.clamp_min(ring.size, 1))
        if cfg.dual_buffer:
            idx_bad, idx_good = below(buf.bad), below(buf.good)
            if self._sharded:
                return replay.sample_dual_sharded(buf, idx_bad, idx_good)
            # this rank's rows of the run's minibatch
            first = 0 if self.mesh is None else self.mesh.rank * self.batch
            return replay.sample_dual(buf, idx_bad, idx_good, first,
                                      cfg.batch_size)
        if self._sharded:
            return replay.sample_sharded(buf, below(buf))
        return replay.sample(buf, draws.randint(shape, max(buf.size, 1)))

    def _grad_snapshot(self, ts_alg, buf, epsilon, draws):
        """The raw gradients of one update on a fresh replay sample whose
        result is dropped (``offpolicy.py:181-186``); ``draws`` gives the
        sample's indices, then the update's draws."""
        draws = self._draws(draws)
        batch = self._replay_sample(buf, draws)
        lead = self.lead[:-1] + (self.batch,)
        return self.alg.grad_snapshot(ts_alg, batch, epsilon,
                                      self.alg.update_draws(draws, lead))

    @staticmethod
    def snapshot_source(key: int, period_idx: int, device):
        """The draw source of period ``period_idx``'s gradient snapshot:
        the evaluation purpose of ``key`` folded with 1,000,000 + the
        period's index (``offpolicy.py:528-530``)."""
        return prng.GeneratorDraws(prng.generator(prng.fold_in(
            prng.for_purpose(key, prng.EVAL), 1_000_000 + period_idx),
            device))

    def _routed(self, buf):
        """(n_bad, n_good): the dual memories' fills, summed over seeds
        and shards (a host sync)."""
        n = self._over_shards(torch.stack([buf.bad.size.sum(),
                                           buf.good.size.sum()]))
        return int(n[0]), int(n[1])

    def example_transition(self, rs: RolloutState):
        """One instance's transition (leaves without the instance dims),
        the template of the replay ring."""
        self._bind(rs.mesh)
        zeros = torch.zeros(self.lead + (self.hooks.n_agents,),
                            dtype=torch.int64, device=self.hooks.env.device)
        ts = flat_call(self.hooks.env.step, self.lead, rs.env_state,
                       zeros)[1]
        k = len(self.lead)
        return tree_map(lambda x: x[(0,) * k],
                        self._transition(rs, zeros, ts))

    # -------------------------------------------------------------- #

    def _transition(self, rs: RolloutState, actions, ts_next, bp=None):
        tr = {
            "obs": rs.obs, "state": rs.state,
            "a": actions, "a_prev": rs.a_prev,
            "r": ts_next.reward, "rl": ts_next.reward_local,
            "obs_next": ts_next.obs, "state_next": ts_next.state,
            "done": ts_next.done, "goals": rs.goals,
        }
        if not self.hooks.has_a_prev:
            tr.pop("a_prev")
        if self._store_bp:
            tr["bp"] = bp if bp is not None else torch.full(
                actions.shape, 1.0 / self.alg.n_actions,
                device=actions.device)
        return tr

    @staticmethod
    def _filter(env, env_state, actions, lead):
        """The engine's feasibility filter, where it has one."""
        if not hasattr(env, "check_actions"):
            return actions
        return flat_call(env.check_actions, lead, env_state, actions)

    def _stage_and_flush(self, buf, rs: RolloutState, tr, done,
                         env_state, ep_ret_local):
        """Stage this step's transitions at [instance, episode step] and
        flush every episode that ended, whole, into the bad or the good
        memory (``offpolicy.py:284-303``), on a mesh with one ring every
        rank's (a gather of the slabs); returns the new episode
        lengths."""
        t_max = self.cfg.max_steps
        k = len(self.lead)
        m = rs.stage_t.numel()
        at = (torch.arange(m, device=done.device), rs.stage_t.reshape(m))
        tree_map(lambda slab, x: slab.view(
            (m, t_max + 1) + slab.shape[k + 1:]).index_put_(
                at, x.reshape((m,) + x.shape[k:])), rs.stage, tr)
        stage_len = torch.clamp_max(rs.stage_t + 1, t_max)
        valid = done[..., None] & (torch.arange(t_max + 1, device=done.device)
                                   < stage_len[..., None])
        flushed = (rs.stage, valid,
                   self.hooks.is_bad_episode(env_state, ep_ret_local))
        if self.mesh is not None and not self._sharded:
            flushed = meshlib.all_gather_rows(flushed, self.mesh)
        self._replay_flush(buf, *flushed)
        return torch.where(done, 0, stage_len)

    @torch.no_grad()
    def _step_once(self, ts_alg, rs: RolloutState, buf, epsilon, draws,
                   random_actions: bool, policy_gate=None):
        """One lockstep env transition for all instances + buffer add (or
        the dual buffer's staging and flush) + auto-reset.
        ``policy_gate`` (a 0-dim bool tensor, optional): where it is
        false the policy's actions are replaced by random ones, the
        fill regime of a K-chunk dispatch (``offpolicy.py:233-276``)."""
        hooks, env = self.hooks, self.hooks.env
        lead = self.lead
        shape = lead + (hooks.n_agents,)
        probs = bp = None
        if random_actions:
            actions = draws.randint(shape, self.alg.n_actions)
        elif self._store_bp:
            actions, probs = self.alg.act_bp(
                ts_alg, rs.obs, rs.goals, rs.a_prev, epsilon,
                self.alg.act_draws(draws, lead))
        else:
            actions = self.alg.act(ts_alg, rs.obs, rs.goals, rs.a_prev,
                                   epsilon, self.alg.act_draws(draws, lead))
        if policy_gate is not None and not random_actions:
            actions = torch.where(policy_gate, actions,
                                  draws.randint(shape, self.alg.n_actions))
        # the filter's replacement is what is stepped and stored, and bp
        # is the behavior probability of that action (the uniform 1/A
        # where the gate took random actions)
        actions = self._filter(env, rs.env_state, actions, lead)
        if probs is not None:
            bp = torch.gather(probs, -1, actions[..., None])[..., 0]
            if policy_gate is not None:
                bp = torch.where(policy_gate, bp, 1.0 / self.alg.n_actions)
        env_state2, ts2 = flat_call(env.step, lead, rs.env_state, actions)
        tr = self._transition(rs, actions, ts2, bp)
        done = ts2.done
        ep_ret_local = rs.ep_ret_local + ts2.reward_local
        ep_ret_global = rs.ep_ret_global + ts2.reward
        stage_t = rs.stage_t
        if self.cfg.dual_buffer:
            stage_t = self._stage_and_flush(buf, rs, tr, done, env_state2,
                                            ep_ret_local)
        # the run's done flags and returns ([E], [E, N] and [E] on every
        # rank of a mesh: the counts, sums and log below are the run's)
        d = done.float()
        ended, e, ret_l, ret_g = done, d, ep_ret_local, ep_ret_global
        if self.mesh is not None:
            shared = {"ended": torch.cat([d[..., None], ep_ret_local,
                                          ep_ret_global[..., None]], dim=-1)}
            if not (self._sharded or self.cfg.dual_buffer):
                shared["added"] = tr    # every rank keeps the whole ring
            shared = meshlib.all_gather_rows(shared, self.mesh)
            e = shared["ended"][..., 0]
            ended = e > 0.5
            ret_l, ret_g = shared["ended"][..., 1:-1], shared["ended"][..., -1]
            tr = shared.get("added", tr)
        if not self.cfg.dual_buffer:
            buf = self._replay_add(buf, tr)

        # auto-reset finished instances with fresh goals
        new_state, new_ts, new_goals = hooks.episode_init(lead, draws)
        sel = lambda a, b: _where(done, a, b)
        eplog, eplog_ep = rs.eplog, rs.eplog_ep
        if eplog is not None:
            eplog, eplog_ep = _eplog_write(
                eplog, eplog_ep, rs.episodes, ended,
                torch.cat([ret_l, ret_g[..., None]], dim=-1))
        rs2 = RolloutState(
            env_state=tree_map(sel, new_state, env_state2),
            obs=tree_map(sel, new_ts.obs, ts2.obs),
            state=tree_map(sel, new_ts.state, ts2.state),
            goals=sel(new_goals, rs.goals),
            a_prev=torch.where(done[..., None], 0, actions),
            ep_ret_local=ep_ret_local * (1.0 - d[..., None]),
            ep_ret_global=ep_ret_global * (1.0 - d),
            acc_ret_local=rs.acc_ret_local
            + torch.sum(ret_l * e[..., None], dim=-2),
            acc_ret_global=rs.acc_ret_global
            + torch.sum(ret_g * e, dim=-1),
            episodes=rs.episodes + ended.sum(dim=-1),
            eplog=eplog, eplog_ep=eplog_ep, stage=rs.stage, stage_t=stage_t,
            mesh=rs.mesh)
        return rs2, buf

    def _chunk(self, ts_alg, buf, rs, epsilon, draws, do_train: bool,
               random_actions: bool, gate=None):
        """steps_per_train lockstep env steps, then (``do_train``)
        updates_per_chunk learning updates.  ``epsilon`` is a float, a
        0-dim device tensor, or [S] with seeds.  ``gate`` (a 0-dim bool
        tensor, optional): where it is false this is a fill chunk,
        random actions and updates computed but not applied, their
        metrics zeroed and ``trained`` (the gate as a float) added
        (``offpolicy.py:345-385``).  Returns (ts_alg, buf, rs, metrics of
        the last update)."""
        self._bind(rs.mesh)
        draws = self._draws(draws)
        epsilon = self._seed_epsilon(epsilon)
        for _ in range(self.cfg.steps_per_train):
            rs, buf = self._step_once(ts_alg, rs, buf, epsilon, draws,
                                      random_actions, policy_gate=gate)
        metrics = {}
        if do_train:
            n_upd = self.cfg.updates_per_chunk or self.n_envs
            lead = self.lead[:-1] + (self.batch,)
            for _ in range(n_upd):
                batch = self._replay_sample(buf, draws)
                ts_alg, metrics = self.alg.update(
                    ts_alg, batch, epsilon,
                    self.alg.update_draws(draws, lead), gate=gate)
            metrics = self._mean_metrics(metrics)
            if gate is not None:
                metrics = {k: torch.where(gate, v, torch.zeros_like(v))
                           for k, v in metrics.items()}
                metrics["trained"] = gate.float()
        return ts_alg, buf, rs, metrics

    def _mean_metrics(self, metrics):
        """The update's metrics (means over this rank's rows) averaged
        over the ranks of a mesh, in one all-reduce: the run's."""
        if self.mesh is None:
            return metrics
        return dict(zip(metrics, meshlib.mean_over(list(metrics.values()),
                                                   self.mesh)))

    @staticmethod
    def _device_epsilon(cfg, episodes):
        """Epsilon of the episode counts ``episodes`` (a device tensor),
        float32 in JAX's formula (``offpolicy.py:199-203``):
        max(end, start - max(0, episodes - pretrain) * step)."""
        lived = torch.clamp_min(episodes - cfg.pretrain_episodes, 0)
        return torch.clamp_min(
            cfg.epsilon_start - lived.float() * cfg.epsilon_step,
            cfg.epsilon_end)

    def _chunks_scanned(self, ts_alg, buf, rs, draws, k_chunks: int):
        """K chunks in one dispatch with the schedule on the device
        (``offpolicy.py:188-213``): each chunk's fill/train gate and
        epsilon come from the live episode count, so a dispatch that
        straddles the fill -> train boundary acts as K host-paced chunks
        would.  No host sync: nothing here reads a device value.
        Returns (ts_alg, buf, rs, the last chunk's metrics with
        ``trained_chunks``)."""
        trained = None
        for _ in range(k_chunks):
            gate = rs.episodes >= self.cfg.pretrain_episodes
            ts_alg, buf, rs, metrics = self._chunk(
                ts_alg, buf, rs, self._device_epsilon(self.cfg, rs.episodes),
                draws, True, False, gate=gate)
            trained = (metrics["trained"] if trained is None
                       else trained + metrics["trained"])
        metrics["trained_chunks"] = trained
        return ts_alg, buf, rs, metrics

    # -------------------------------------------------------------- #

    @torch.no_grad()
    def evaluate(self, ts_alg, draws, n_eval: int):
        """Policy rollouts at epsilon 0 (alg/evaluate.py) of ``n_eval``
        fresh episodes (per seed) for ``cfg.max_steps`` steps, each
        instance's returns counted until its episode ends: returns (mean
        per-agent return [N], mean global return, aux), each with a
        leading [S] with seeds.  aux carries "act_dist", the per-agent
        action distribution [N, A] (evaluate.py:193-200), and the hooks'
        eval metrics, all from ``eval_hooks``.  ``draws`` gives the goals
        where they are random, then per step what the algorithm's ``act``
        consumes (``alg.act_draws``)."""
        hooks = self.eval_hooks
        env = hooks.env
        n = hooks.n_agents
        n_act = self.alg.n_actions
        lead = self.lead[:-1] + (n_eval,)
        env_state, ts, goals = hooks.episode_init(lead, draws)
        obs = ts.obs
        dev = env.device
        a_prev = torch.zeros(lead + (n,), dtype=torch.int64, device=dev)
        alive = torch.ones(lead, dtype=torch.bool, device=dev)
        ret_l = torch.zeros(lead + (n,), device=dev)
        ret_g = torch.zeros(lead, device=dev)
        acts = torch.zeros(lead[:-1] + (n, n_act), device=dev)
        acc = hooks.eval_metrics_init(lead[:-1])
        for _ in range(self.cfg.max_steps):
            actions = self._filter(env, env_state, self.alg.act(
                ts_alg, obs, goals, a_prev, 0.0,
                self.alg.act_draws(draws, lead)), lead)
            env_state, ts2 = flat_call(env.step, lead, env_state, actions)
            m = alive.float()
            ret_l = ret_l + ts2.reward_local * m[..., None]
            ret_g = ret_g + ts2.reward * m
            acts = acts + torch.sum(common.one_hot(actions, n_act)
                                    * m[..., None, None], dim=-3)
            acc = hooks.eval_metrics_step(acc, env_state, ts2, alive)
            alive = alive & ~ts2.done
            obs, a_prev = ts2.obs, actions
        act_dist = acts / torch.clamp_min(acts.sum(-1, keepdim=True), 1.0)
        aux = dict(hooks.eval_metrics_final(acc, n_eval), act_dist=act_dist)
        return ret_l.mean(dim=-2), ret_g.mean(dim=-1), aux

    # -------------------------------------------------------------- #

    def _start(self, ts_alg, draws, mesh):
        """(ts_alg, rollout state, replay) of a run's start on this rank:
        the state replicated from rank 0 and this rank's block of the
        instances and the replay on a data mesh."""
        self._bind(mesh)
        rs = init_rollout(self.hooks, self.lead[-1], self._draws(draws),
                          self.cfg.episode_log)
        rs.mesh = mesh
        if mesh is not None:
            ts_alg = meshlib.replicate(ts_alg, mesh)
        buf, rs = self.init_replay(rs)
        return ts_alg, rs, buf

    def _log(self, log_fn, row, ts_alg):
        """``log_fn`` of a period row, on the primary process only."""
        if log_fn is not None and (self.mesh is None or pdist.is_primary()):
            log_fn(dict(row, _ts=ts_alg))

    @_unbinds
    def run(self, ts_alg, key: int = 0, n_episodes: Optional[int] = None,
            log_fn: Optional[Callable[[Dict[str, Any]], None]] = None,
            initial_episodes: int = 0, draws=None, eval_draws=None,
            snapshot_draws=None, mesh=None):
        """Host training loop of one seed until ``n_episodes`` completed
        episodes.  ``initial_episodes`` resumes the episode/epsilon
        schedule (the replay ring restarts empty and is warmed with
        policy rollouts for pretrain_episodes first).  The draws come
        from ``key`` (rollouts and evaluations from their own purposes),
        or from the draw sources ``draws`` and ``eval_draws``; with
        ``summarize`` the gradient snapshots' from ``snapshot_source``,
        or all from the draw source ``snapshot_draws``.  With
        ``chunks_per_sync`` = K > 1 the fill and training chunks go K to
        a dispatch (``_chunks_scanned``).  Returns (ts_alg, final stats
        dict); ``dispatches`` in it counts the host syncs of the episode
        count, one per dispatch.  On a data ``mesh`` this rank trains
        its block of the run (the draws are the run's, split between the
        ranks), and only the primary process calls ``log_fn``."""
        cfg = self.cfg
        if self.n_seeds is not None:
            raise ValueError("run trains one seed; seeds in lockstep train "
                             "through multiseed.train_vmapped_seeds")
        n_episodes = n_episodes or cfg.N_train
        dev = self.hooks.env.device
        source = lambda purpose: prng.GeneratorDraws(prng.generator(
            prng.for_purpose(key, purpose), dev))
        draws = draws or source(prng.ROLLOUT)
        eval_draws = eval_draws or source(prng.EVAL)
        ts_alg, rs, buf = self._start(ts_alg, draws, mesh)
        if initial_episodes:
            rs.episodes = torch.full_like(rs.episodes, initial_episodes)

        epsilon = max(cfg.epsilon_end, cfg.epsilon_start
                      - max(0, initial_episodes - cfg.pretrain_episodes)
                      * cfg.epsilon_step)
        last_logged_period = initial_episodes // cfg.period
        last_ep_flushed = initial_episodes
        history = []
        t0 = time.time()
        episodes_done = initial_episodes
        dispatches = 0
        while episodes_done < n_episodes:
            if episodes_done < cfg.pretrain_episodes:
                pretrain, train, rand = True, False, True      # random fill
            elif episodes_done < initial_episodes + cfg.pretrain_episodes:
                pretrain, train, rand = True, False, False     # warm-up
            else:
                pretrain, train, rand = False, True, False
            # K chunks with the regime on the device, from the fill phase
            # on; the resume warm-up (policy actions, no updates) stays
            # host-paced
            if cfg.chunks_per_sync > 1 and (train or rand):
                ts_alg, buf, rs, metrics = self._chunks_scanned(
                    ts_alg, buf, rs, draws, cfg.chunks_per_sync)
            else:
                ts_alg, buf, rs, metrics = self._chunk(
                    ts_alg, buf, rs, epsilon, draws, train, rand)
            dispatches += 1
            episodes_done = int(rs.episodes)  # one host sync per dispatch
            if not pretrain:
                epsilon = max(cfg.epsilon_end, cfg.epsilon_start
                              - (episodes_done - cfg.pretrain_episodes)
                              * cfg.epsilon_step)

            period_idx = episodes_done // cfg.period
            if period_idx > last_logged_period:
                last_logged_period = period_idx
                r_l, r_g, aux = self.evaluate(ts_alg, eval_draws, cfg.N_eval)
                row = {
                    "episode": episodes_done,
                    "epsilon": epsilon,
                    "r_eval_local": r_l.cpu().numpy(),
                    "r_eval_global": float(r_g),
                    "eval_action_dist": aux["act_dist"].cpu().numpy().ravel(),
                    "r_train_local": rs.acc_ret_local.cpu().numpy()
                    / max(cfg.period, 1),
                    "r_train_global": float(rs.acc_ret_global)
                    / max(cfg.period, 1),
                    "duration_s": time.time() - t0,
                }
                if cfg.episode_log:
                    row["_episodes"] = flush_eplog(
                        rs.eplog.cpu().numpy(), rs.eplog_ep.cpu().numpy(),
                        last_ep_flushed, episodes_done)
                    last_ep_flushed = episodes_done
                if cfg.dual_buffer:
                    row["n_bad"], row["n_good"] = self._routed(buf)
                if cfg.summarize and not pretrain:
                    row["_grads"] = self._grad_snapshot(
                        ts_alg, buf, epsilon, snapshot_draws
                        or self.snapshot_source(key, period_idx, dev))
                row.update({k: float(v) for k, v in aux.items()
                            if k != "act_dist"})
                # in key order, as JAX's metrics leave its jitted chunk
                row.update({k: float(v) for k, v in sorted(metrics.items())})
                history.append(row)
                self._log(log_fn, row, ts_alg)
                rs.acc_ret_local = torch.zeros_like(rs.acc_ret_local)
                rs.acc_ret_global = torch.zeros_like(rs.acc_ret_global)
                t0 = time.time()

        return ts_alg, dict(episodes=episodes_done, history=history,
                            buffer=buf, rollout=rs, epsilon=epsilon,
                            dispatches=dispatches)
