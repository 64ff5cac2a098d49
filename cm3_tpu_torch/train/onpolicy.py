"""On-policy trainer (``cm3_tpu.train.onpolicy``): the reference's
``alg/train_onpolicy.py`` schedule, which particle CM3, COMA and IAC
train with.

Transitions accumulate in the replay ring for ``episodes_per_train``
completed episodes; then ``epochs`` minibatch updates run back to back
and the ring is discarded (``train_onpolicy.py:359-378``); epsilon
decays once per burst, from ``epsilon_start``.  A rollout chunk
(``_rollout_chunk``) is ``steps_per_train`` lockstep env steps with
their replay adds and auto-resets, random actions while fewer than
``pretrain_episodes`` episodes are done; a burst (``_train_burst``)
draws, per update, the replay indices and then what the algorithm's
``update`` consumes, as the off-policy chunk's updates do.  The ring's
cursor and fill are host integers shared by the seeds, so discarding
it (``replay.reset``) is setting both to 0; with shard-local replay
(``replay_shards``) it zeroes the [*P, D] device cursors.  With the
dual buffer (``dual_buffer``; the paper's particle cells
``particle_s2_cross``,
``_merge`` and ``_dual``) the rollout stages and flushes whole
episodes as the off-policy driver does, a burst samples both memories,
and the discard zeroes their device cursors (``replay.reset_dual``);
the counts routed before each discard add up on the device, and the
period row reads them as ``n_bad``/``n_good`` (``onpolicy.py:73-75,
101-104, 136-141``).

``run`` is the single-seed host loop.  It keeps two of JAX's quirks,
which the reference's runner shows (ROADMAP.md §C, hazard 5): its
period row carries no learning metrics (JAX's ``run`` never merges
them, ``onpolicy.py:117-150``; the lockstep row does,
``multiseed.py:234-235``), and it takes no ``initial_episodes``, so a
resumed run restarts its episode count and epsilon
(``runner.py:293-295``).  The row splits the wall time into ``t_env``
(rollout chunks) and ``t_train`` (bursts), as the reference logs
(``train_onpolicy.py:304, 324, 358, 378``); both are host clocks read
after the chunk's or the burst's episode count or metrics reach the
host.

With ``summarize`` a period row carries ``_grads``, the off-policy
driver's gradient snapshot, where the ring holds rows and the episodes
are past ``pretrain_episodes`` (``onpolicy.py:139-145``).

Seeds in lockstep run through ``train/multiseed.py`` with
``onpolicy=True``.  On a data mesh (``parallel/mesh.py``) a rollout
chunk and a burst train data-parallel as the off-policy chunk does, the
burst on the mesh of the last rollout state stepped; a period row's
fills and ``n_bad``/``n_good`` are the run's.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional

import torch

from cm3_tpu_torch.core import prng
from cm3_tpu_torch.replay import buffer as replay
from cm3_tpu_torch.train.offpolicy import (OffPolicyDriver, _unbinds,
                                           flush_eplog)


class OnPolicyDriver(OffPolicyDriver):

    def discard(self, buf, routed=None):
        """Empty the replay after a burst; with the dual buffer, first
        add the rows each memory holds to ``routed`` ([2] on the device:
        bad, good) when given."""
        if not self.cfg.dual_buffer:
            return replay.reset(buf)
        if routed is not None:
            routed += torch.stack([buf.bad.size.sum(), buf.good.size.sum()])
        return replay.reset_dual(buf)

    def filled(self, buf) -> int:
        """The rows the ring holds (both memories' with the dual buffer,
        summed over seeds and shards, every rank's on a mesh; a host sync
        where they are device tensors)."""
        if self.cfg.dual_buffer:
            return sum(self._routed(buf))
        if isinstance(buf, replay.DeviceRing):
            return int(self._over_shards(buf.size.sum()))
        return buf.size

    def _rollout_chunk(self, ts_alg, buf, rs, epsilon, draws,
                       random_actions: bool):
        """``steps_per_train`` lockstep env steps with their replay adds
        and auto-resets (``onpolicy.py:41-50``); returns (buf, rs)."""
        self._bind(rs.mesh)
        draws = self._draws(draws)
        epsilon = self._seed_epsilon(epsilon)
        for _ in range(self.cfg.steps_per_train):
            rs, buf = self._step_once(ts_alg, rs, buf, epsilon, draws,
                                      random_actions)
        return buf, rs

    def _train_burst(self, ts_alg, buf, epsilon, draws):
        """``epochs`` minibatch updates back to back on the ring
        (``onpolicy.py:52-62``); returns (ts_alg, metrics of the last)."""
        draws = self._draws(draws)
        epsilon = self._seed_epsilon(epsilon)
        lead = self.lead[:-1] + (self.batch,)
        metrics = {}
        for _ in range(self.cfg.epochs):
            batch = self._replay_sample(buf, draws)
            ts_alg, metrics = self.alg.update(
                ts_alg, batch, epsilon, self.alg.update_draws(draws, lead))
        return ts_alg, self._mean_metrics(metrics)

    @_unbinds
    def run(self, ts_alg, key: int = 0, n_episodes: Optional[int] = None,
            log_fn: Optional[Callable[[Dict[str, Any]], None]] = None,
            draws=None, eval_draws=None, snapshot_draws=None, mesh=None):
        """Host training loop of one seed until ``n_episodes`` completed
        episodes (``onpolicy.py:64-158``): a rollout chunk, then a burst
        once ``episodes_per_train`` more episodes are done (after the
        random fill), then the discard and one epsilon decay; one
        evaluation and one history row per ``period`` episodes.  Draws
        and ``mesh`` as ``OffPolicyDriver.run``'s.  Returns (ts_alg, final
        stats)."""
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
        # rows routed to the bad and the good memory before each discard
        routed = torch.zeros(2, dtype=torch.int64, device=dev)

        epsilon = cfg.epsilon_start
        episodes_done = last_train_eps = last_logged_period = 0
        last_ep_flushed = 0
        history = []
        t_env = t_train = 0.0
        t0 = time.time()
        while episodes_done < n_episodes:
            pretrain = episodes_done < cfg.pretrain_episodes
            te = time.time()
            buf, rs = self._rollout_chunk(ts_alg, buf, rs, epsilon, draws,
                                          pretrain)
            episodes_done = int(rs.episodes)
            t_env += time.time() - te

            if (not pretrain and
                    episodes_done - last_train_eps >= cfg.episodes_per_train):
                tt = time.time()
                ts_alg, metrics = self._train_burst(ts_alg, buf, epsilon,
                                                    draws)
                for v in metrics.values():
                    float(v)    # waits for the burst's device work
                t_train += time.time() - tt
                last_train_eps = episodes_done
                # discard the ring (train_onpolicy.py:372-377)
                buf = self.discard(buf, routed)
                if epsilon > cfg.epsilon_end:
                    epsilon = max(cfg.epsilon_end,
                                  epsilon - cfg.epsilon_step)

            period_idx = episodes_done // cfg.period
            if period_idx > last_logged_period:
                last_logged_period = period_idx
                r_l, r_g, aux = self.evaluate(ts_alg, eval_draws, cfg.N_eval)
                row = {
                    "episode": episodes_done, "epsilon": epsilon,
                    "r_eval_local": r_l.cpu().numpy(),
                    "r_eval_global": float(r_g),
                    "eval_action_dist": aux["act_dist"].cpu().numpy().ravel(),
                    "r_train_local": rs.acc_ret_local.cpu().numpy()
                    / max(cfg.period, 1),
                    "r_train_global": float(rs.acc_ret_global)
                    / max(cfg.period, 1),
                    "t_env": t_env, "t_train": t_train,
                    "duration_s": time.time() - t0,
                }
                if cfg.episode_log:
                    row["_episodes"] = flush_eplog(
                        rs.eplog.cpu().numpy(), rs.eplog_ep.cpu().numpy(),
                        last_ep_flushed, episodes_done)
                    last_ep_flushed = episodes_done
                if cfg.dual_buffer:
                    row["n_bad"], row["n_good"] = self._over_shards(
                        routed).tolist()
                if (cfg.summarize and self.filled(buf) > 0
                        and episodes_done > cfg.pretrain_episodes):
                    row["_grads"] = self._grad_snapshot(
                        ts_alg, buf, epsilon, snapshot_draws
                        or self.snapshot_source(key, period_idx, dev))
                row.update({k: float(v) for k, v in aux.items()
                            if k != "act_dist"})
                history.append(row)
                self._log(log_fn, row, ts_alg)
                rs.acc_ret_local = torch.zeros_like(rs.acc_ret_local)
                rs.acc_ret_global = torch.zeros_like(rs.acc_ret_global)
                t0 = time.time()

        return ts_alg, dict(episodes=episodes_done, history=history,
                            epsilon=epsilon, t_env=t_env, t_train=t_train)
