"""Seeds in lockstep: S independent training runs in one program
(``cm3_tpu.train.multiseed``).

The JAX package maps its whole training chunk over a seed axis with
``jax.vmap``.  The port keeps the seed axis explicit: the S x E env
instances step as one batch, the replay keeps one ring per seed, and
the learner keeps each network's S copies in one [S, n] buffer whose
forward and backward passes run for all seeds at once
(``algs/base.py``, ``models/nets.SeedStack``), for CM3, the baselines
and QMIX alike.  So one chunk of S seeds
costs about as many kernel launches as one seed's, each doing S times
the work.

Schedule (``multiseed.py:72-266``): off-policy, each seed keeps its
own epsilon, from its own completed-episode count (``_eps_schedule``),
while the switch from random fill to training and the periodic
evaluation fire when the slowest seed crosses the threshold.  A run
resumed from an autosave (``resume``) starts from its per-seed episode
counts with an empty replay, which policy rollouts without updates warm
until the slowest seed has ``pretrain_episodes`` more episodes
(``multiseed.py:99-102, 190-200``).

On-policy (``onpolicy=True``, ``multiseed.py:128-143, 186-200``): the
``OnPolicyDriver``'s rollout chunks (random while the slowest seed has
fewer than ``pretrain_episodes`` episodes; no warm-up after a resume),
a burst of ``epochs`` updates for every seed once the slowest seed has
``episodes_per_train`` more episodes, then every seed's ring
discarded; epsilon is one host value for all seeds, decayed once per
burst, and rebuilt on resume from the bursts the slowest seed's count
implies (``multiseed.py:169-176``).  A period row carries the metrics
of a burst run in the same iteration, else none (``multiseed.py:
234-235``).

Draws.  One draw source serves every seed (one [S, ...] draw a call,
not S calls), keyed by the first seed's key and the seed count; so a
seed's stream depends on S.  Parameters are drawn per seed from its own
key, ``root_key(base_seed + i)``, as for one seed.

The dual buffer (``dual_buffer``) keeps one pair of memories per seed
with per-seed device cursors, each seed's episodes routed into its own
(``multiseed.py:115-117, 141``); the rows carry no ``n_bad``/``n_good``,
as JAX's lockstep rows do not.

Gradient summaries (``summarize``, ``multiseed.py:159-163, 250-257``):
after the fill (on-policy: also only while the rings hold rows) a
period row carries ``_grads``, every seed's raw gradients of one
dropped update on a fresh sample ([S, n] each), the update of the seed
stack run on a copy of the state (``alg.grad_snapshot``) with each
seed's epsilon; its draws come from the evaluation purpose of the draw
key folded with 1,000,000 + the period's index, so they take nothing
from the training or the evaluation draws.

Shard-local replay (``replay_shards`` = D): each seed's replay is D
shards, the rings' leading shape [S, D] (``train/offpolicy.py``), as
JAX maps the sharded buffer over seeds (``multiseed.py:107-120``).

Seeds over processes (``mesh``, a seed mesh of ``parallel.mesh.
make_mesh(W, axis="seed")``; ``multiseed.py:54-69, 122-126``): rank r
trains seeds [r S/W, (r+1) S/W) in lockstep, with no collective in a
chunk (the seeds are independent), its state drawn from those seeds'
keys and its draws its block of the S-seed run's ([S, ...] draws split
along the seed axis, ``prng.BlockDraws``), so every seed equals its twin
in the single-process S-seed run.  The schedule reads every seed's
episode count (one all-gather a chunk), and a period row carries all S
seeds, gathered to every rank (one all-gather a row, one more for
``_grads``); only the primary process calls ``log_fn``, whose ``_ts``
and the state returned are the rank's own seeds.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from cm3_tpu_torch.core import prng
from cm3_tpu_torch.core.tree import tree_map
from cm3_tpu_torch.parallel import dist as pdist
from cm3_tpu_torch.parallel import mesh as meshlib
from cm3_tpu_torch.train import checkpoint
from cm3_tpu_torch.train.offpolicy import (OffPolicyDriver, flush_eplog,
                                           init_rollout)
from cm3_tpu_torch.train.onpolicy import OnPolicyDriver
from cm3_tpu_torch.utils import profiling


def _eps_schedule(cfg, episodes):
    e = np.maximum(0, episodes - cfg.pretrain_episodes)
    return np.maximum(cfg.epsilon_end,
                      cfg.epsilon_start - e * cfg.epsilon_step)


def _host(x):
    return x.detach().cpu().numpy()


def shard_seed_axis(tree, mesh, n_seeds: int, axis: str = "seed"):
    """This rank's block of seeds, [r S/W, (r+1) S/W), of every leaf with
    a leading seed dim ``n_seeds``; the other leaves as they are: the
    seed axis over the mesh, with no collective between seeds
    (``multiseed.py:54-69``).  An algorithm's seed-stacked state is cut
    with ``checkpoint.seed_state`` / ``stack_states``
    (``train_vmapped_seeds``' ``resume``)."""
    return meshlib.shard_leading_axis(tree, mesh, n_seeds, axis)


def _seed_block(alg, stacked, seeds):
    """Seeds ``seeds`` of the seed-stacked state ``stacked`` as a state
    of ``alg`` (built for that many seeds)."""
    one = alg.for_seeds(None)
    return checkpoint.stack_states(
        alg, [checkpoint.seed_state(one, stacked, i) for i in seeds])


def train_vmapped_seeds(hooks, alg, cfg, n_seeds: int, base_seed: int,
                        n_episodes: Optional[int] = None,
                        log_fn: Optional[Callable[[Dict], None]] = None,
                        mesh=None, onpolicy: bool = False,
                        resume: Optional[Tuple[Any, np.ndarray]] = None,
                        draws=None, eval_draws=None, snapshot_draws=None):
    """Train ``n_seeds`` independent replicas in lockstep, off-policy
    or (``onpolicy``) on-policy.  Returns (the seed-stacked state,
    per-period history).

    ``alg`` is the algorithm (CM3, Baseline or QMIX) for one seed or for
    ``n_seeds`` seeds (``alg.for_seeds``).  ``log_fn`` receives each
    period row, with per-seed arrays, plus the state under ``_ts``.
    ``resume`` is (seed-stacked state, per-seed episode counts [S]),
    e.g. from an autosave or a curriculum graft; the state is trained in
    place.
    ``draws``, ``eval_draws`` and ``snapshot_draws`` (draw sources; the
    last serves every gradient snapshot) replace the ones made from the
    seeds' keys.  ``mesh`` (a seed mesh of W processes, W dividing
    ``n_seeds``) trains this rank's block of the seeds, ``resume``'s state
    holding all of them; the rows and the draws are the S-seed run's."""
    s = n_seeds
    w, r = (1, 0) if mesh is None else (mesh.size, mesh.rank)
    if s % w:
        raise ValueError(f"{s} seeds do not split over {w} ranks")
    mine = range(r * s // w, (r + 1) * s // w)
    if alg.n_seeds != len(mine):
        alg = alg.for_seeds(len(mine))
    driver = (OnPolicyDriver if onpolicy else OffPolicyDriver)(hooks, alg,
                                                               cfg)
    n_episodes = n_episodes or cfg.N_train
    dev = hooks.env.device

    keys = [prng.root_key(base_seed + i) for i in range(s)]
    draw_key = prng.fold_in(keys[0], s)
    source = lambda purpose: prng.GeneratorDraws(prng.generator(
        prng.for_purpose(draw_key, purpose), dev))
    draws = draws or source(prng.ROLLOUT)
    eval_draws = eval_draws or source(prng.EVAL)
    rs = init_rollout(hooks, cfg.n_envs, draws, cfg.episode_log, n_seeds=s)
    if resume is not None:
        ts, initial = resume
        initial = np.asarray(initial, np.int64).reshape(s)
        rs.episodes = torch.as_tensor(initial, device=dev)
        if mesh is not None:
            ts = _seed_block(alg, ts, mine)
    else:
        ts = alg.init_state([keys[i] for i in mine])
        initial = np.zeros(s, np.int64)
    if mesh is not None:
        rs = shard_seed_axis(rs, mesh, s)
        draws, eval_draws = (prng.BlockDraws(d, r, w)
                             for d in (draws, eval_draws))
    buf, rs = driver.init_replay(rs)

    def seen(tree):
        """``tree``'s leaves of this rank's seeds [S/W, ...] as host
        arrays of all S seeds (one all-gather on a mesh)."""
        if mesh is not None:
            tree = meshlib.all_gather_rows(tree, mesh)
        return tree_map(_host, tree)

    def filled(buf) -> int:
        """The rows in every seed's ring (a collective on a mesh)."""
        n = driver.filled(buf)
        if mesh is None:
            return n
        return int(seen(torch.tensor([n], device=dev)).sum())

    history = []
    last_ep_flushed = initial.copy()
    start_min = int(initial.min())
    last_period = start_min // cfg.period
    # on-policy: one epsilon for all seeds, decayed once per burst;
    # rebuilt on resume from the bursts the slowest seed's count implies
    last_train_eps = start_min
    eps_scalar = max(cfg.epsilon_end, cfg.epsilon_start
                     - (max(0, start_min - cfg.pretrain_episodes)
                        // max(cfg.episodes_per_train, 1))
                     * cfg.epsilon_step)
    t0 = time.time()
    episodes = initial.copy()
    while episodes.min() < n_episodes:
        emin = episodes.min()
        fill = emin < cfg.pretrain_episodes
        if onpolicy:
            metrics = {}
            buf, rs = driver._rollout_chunk(ts, buf, rs, eps_scalar, draws,
                                            fill)
            episodes = seen(rs.episodes)
            if (not fill and episodes.min() - last_train_eps
                    >= cfg.episodes_per_train):
                ts, metrics = driver._train_burst(ts, buf, eps_scalar, draws)
                last_train_eps = int(episodes.min())
                buf = driver.discard(buf)
                if eps_scalar > cfg.epsilon_end:
                    eps_scalar = max(cfg.epsilon_end,
                                     eps_scalar - cfg.epsilon_step)
        else:
            warm = not fill and emin < start_min + cfg.pretrain_episodes
            with profiling.annotate("cm3.host_sync"):   # the copy waits
                eps = torch.as_tensor(_eps_schedule(cfg, episodes)[mine],
                                      dtype=torch.float32, device=dev)
            ts, buf, rs, metrics = driver._chunk(ts, buf, rs, eps, draws,
                                                 not (fill or warm), fill)
            with profiling.annotate("cm3.host_sync"):
                episodes = seen(rs.episodes)    # one sync per chunk

        period_idx = int(episodes.min()) // cfg.period
        if period_idx > last_period:
            with profiling.annotate("cm3.period"):
                last_period = period_idx
                r_local, r_global, aux = driver.evaluate(ts, eval_draws,
                                                         cfg.N_eval)
                local = dict(aux, r_local=r_local, r_global=r_global,
                             acc_local=rs.acc_ret_local,
                             acc_global=rs.acc_ret_global, metrics=metrics)
                if cfg.episode_log:
                    local.update(eplog=rs.eplog, eplog_ep=rs.eplog_ep)
                with profiling.annotate("cm3.host_sync"):
                    g = seen(local)
                row = {
                    "episode": episodes.copy(),                     # [S]
                    "epsilon": (np.full(s, eps_scalar) if onpolicy
                                else _eps_schedule(cfg, episodes)), # [S]
                    "r_eval_local": g["r_local"],                   # [S, N]
                    "r_eval_global": g["r_global"],                 # [S]
                    "eval_action_dist": g["act_dist"].reshape(s, -1),
                    "r_train_local": g["acc_local"]
                    / max(cfg.period, 1),                           # [S, N]
                    "r_train_global": g["acc_global"]
                    / max(cfg.period, 1),                           # [S]
                    "duration_s": time.time() - t0,
                }
                row.update({k: g[k] for k in aux if k != "act_dist"})
                # in key order, as JAX's metrics leave its jitted chunk
                row.update(sorted(g["metrics"].items()))
                if cfg.episode_log:
                    row["_episodes"] = [
                        flush_eplog(g["eplog"][i], g["eplog_ep"][i],
                                    int(last_ep_flushed[i]), int(episodes[i]))
                        for i in range(s)]
                    last_ep_flushed = episodes.copy()
                if cfg.summarize and not fill and (not onpolicy
                                                   or filled(buf) > 0):
                    snap = snapshot_draws or driver.snapshot_source(
                        draw_key, period_idx, dev)
                    if mesh is not None:
                        snap = prng.BlockDraws(snap, r, w)
                    grads = driver._grad_snapshot(
                        ts, buf, torch.as_tensor(row["epsilon"][mine],
                                                 dtype=torch.float32,
                                                 device=dev), snap)
                    row["_grads"] = (grads if mesh is None
                                     else meshlib.all_gather_rows(grads, mesh))
                history.append(row)
                if log_fn is not None and (mesh is None or pdist.is_primary()):
                    log_fn(dict(row, _ts=ts))
                rs.acc_ret_local = torch.zeros_like(rs.acc_ret_local)
                rs.acc_ret_global = torch.zeros_like(rs.acc_ret_global)
                t0 = time.time()

    return ts, history
