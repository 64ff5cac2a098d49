"""Three seeds in lockstep through both runners' ``train_multiseed``
with ``summarize``: one TensorBoard event file per seed directory, each
equal to the JAX runner's seed's (``test_torch_summaries_runner.py``'s
comparison), from JAX's stacked start with each seed's JAX draws fed
in, stacked."""

import os

import jax
import numpy as np

from cm3_tpu.core import prng as jprng
from cm3_tpu.train import multiseed as jmultiseed
from cm3_tpu.train import runner as jrunner
from cm3_tpu.train.offpolicy import init_rollout as jax_init_rollout
from cm3_tpu_torch import convert
from cm3_tpu_torch.core import prng
from cm3_tpu_torch.train import runner
from tests import torch_parity as tp
from tests.test_torch_summaries_run import B, CAP, E, SPT, U
from tests.test_torch_summaries_runner import (  # noqa: F401 (fixture)
    S, _master, hold_events, load_events, stopped)

tp.set_torch_cpu()


def _lockstep_draws(base_seed, n_episodes=16):
    """JAX's draws of ``train_vmapped_seeds`` for each seed from its own
    keys (``multiseed.py:94-96, 205-257``), stacked [S, ...]: the
    reset's goals, then per chunk ``chunk_draws`` (fill for the first
    two); per period row the evaluation's; the snapshot's at the row
    after training."""
    rolls, evals, snaps = [], [], []
    for i in range(S):
        key = jprng.root_key(base_seed + i)
        k_reset = jprng.for_purpose(key, jprng.RESET)
        k_roll = jprng.for_purpose(key, jprng.ROLLOUT)
        r, g = [tp.goal_draws(k_reset, E)], []
        size = 0
        for c in range(n_episodes // E):
            size = min(size + SPT * E, CAP)
            fill = c < 2
            rc, gc = tp.chunk_draws(jax.random.fold_in(k_roll, c), E, 1, 5,
                                    SPT, fill, 0 if fill else U, B,
                                    [size] * U)
            r += rc
            g += gc
        rolls.append((r, g))
        ev = [tp.eval_draws(jax.random.fold_in(k_roll, 10_000 + p), 3, 1, 5,
                            5) for p in (1, 2)]
        evals.append(tuple(sum((e[j] for e in ev), []) for j in range(2)))
        d = tp.ParticleDraws(1)
        d.update(jax.random.fold_in(k_roll, 1_000_002), B, CAP)
        snaps.append((d.randints, d.gumbels))
    fed = lambda per_seed: prng.FedDraws(*tp.stack_draws(per_seed),
                                         device="cpu")
    return fed(rolls), fed(evals), fed(snaps)


def test_lockstep_events_match_jax(tmp_path, stopped):
    """Three seeds in lockstep: one event file per seed directory, each
    equal to JAX's seed's, with ``grads/`` at 16 only."""
    master = _master(vmapped_seeds=1, n_seeds=S, dir_name="ckv")
    jwd, twd = str(tmp_path / "jax"), str(tmp_path / "port")
    start = {}
    jax_tvs = jmultiseed.train_vmapped_seeds

    def jax_start(hooks, alg, cfg, n_seeds, base_seed, **kw):
        """JAX's fresh stacked start, computed as its
        ``train_vmapped_seeds`` does and passed in as a resume from 0
        episodes (the same schedule)."""
        keys = [jprng.root_key(base_seed + i) for i in range(n_seeds)]
        rs = [jax_init_rollout(hooks, jprng.for_purpose(k, jprng.RESET),
                               cfg.n_envs, cfg.episode_log) for k in keys]
        ts = jax.tree_util.tree_map(lambda *x: np.stack(x), *[
            jax.device_get(alg.init_state(jprng.for_purpose(
                k, jprng.PARAMS), r.obs, r.state, r.goals))
            for k, r in zip(keys, rs)])
        start.update(ts=ts, base_seed=base_seed)
        kw["resume"] = (ts, np.zeros(n_seeds, np.int64))
        return jax_tvs(hooks, alg, cfg, n_seeds, base_seed, **kw)

    stopped.setattr(jmultiseed, "train_vmapped_seeds", jax_start)
    jrunner.train_multiseed(master, jwd)

    stopped.setattr(runner, "vmapped_resume", lambda m, w, alg, alg_s, d: (
        convert.state_from_jax(alg_s, start["ts"]), np.zeros(S, np.int64)))
    port_tvs = runner.train_vmapped_seeds
    fed = {}

    def fed_tvs(*a, **kw):
        fed["d"], fed["e"], fed["s"] = _lockstep_draws(start["base_seed"])
        return port_tvs(*a, draws=fed["d"], eval_draws=fed["e"],
                        snapshot_draws=fed["s"], **kw)

    stopped.setattr(runner, "train_vmapped_seeds", fed_tvs)
    runner.train_multiseed(master, twd, device="cpu")
    for d in fed.values():
        assert not any(d.remaining().values())
    for i in range(1, S + 1):
        want = load_events(os.path.join(jwd, "log", f"ckv_{i}"))
        got = load_events(os.path.join(twd, "log", f"ckv_{i}"))
        assert hold_events(got, want) > 0, i
        steps = {e.step for e in got[1:]
                 if e.summary.value[0].tag.startswith("grads/")}
        assert steps == {16}
