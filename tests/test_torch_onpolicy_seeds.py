"""Seeds in lockstep, on-policy, on particle against the JAX package's
``train_vmapped_seeds(onpolicy=True)``, with JAX's draws fed in: three
seeds of CM3 stage 2 (four agents, narrow widths) from nothing to 16
episodes per seed (resumed: ``test_torch_onpolicy_resume.py``).  The
schedule and tolerances are ``test_torch_onpolicy_run.py``'s: every
episode one 5-step chunk, two fill chunks, then a burst of 2 updates per
chunk; rows at every 8 episodes.  The lockstep row carries the burst's
losses when a burst ran in the same iteration
(``multiseed.py:234-235``), one epsilon for all seeds, decayed once per
burst and rebuilt on resume from the bursts the slowest seed's count
implies (``multiseed.py:169-176``)."""

import jax
import numpy as np

from cm3_tpu.core import config as jcfg
from cm3_tpu.core import prng as jprng
from cm3_tpu.train.multiseed import train_vmapped_seeds as jax_seeds
from cm3_tpu_torch import convert
from cm3_tpu_torch.core import config as tcfg
from cm3_tpu_torch.train import multiseed
from tests import torch_parity as tp
from tests.test_torch_onpolicy_run import (EPOCHS, RUN, _draws, _hold_rows,
                                           _setup)

tp.set_torch_cpu()

S, BASE = 3, 40


def _lockstep(start, more):
    """JAX's and the port's lockstep on-policy runs from the same
    converted state at per-seed episode counts ``start`` for ``more``
    episodes."""
    je, ja, ta, jh, th = _setup(n_seeds=S)
    n_episodes = start + more
    cfg = dict(RUN, N_train=n_episodes)
    batch = tp.particle_batch(je, 2, np.random.default_rng(0))
    jts0 = jax.vmap(lambda k: ja.init_state(k, batch["obs"], batch["state"],
                                            batch["goals"]))(
        jax.random.split(jax.random.PRNGKey(5), S))
    tts = convert.state_from_jax(ta, jax.device_get(jts0))
    counts = np.full(S, start, np.int64)
    jts, jhist = jax_seeds(jh, ja, jcfg.TrainConfig(**cfg), S, BASE,
                           onpolicy=True, resume=(jts0, counts))
    per, evs = [], []
    periods = [p for p in range(1, 100) if start < 8 * p <= n_episodes]
    for i in range(S):
        key = jprng.root_key(BASE + i)
        k_roll = jprng.for_purpose(key, jprng.ROLLOUT)
        d, ev = _draws(4, jprng.for_purpose(key, jprng.RESET),
                       lambda c: jax.random.fold_in(k_roll, c),
                       [jax.random.fold_in(k_roll, 10_000 + p)
                        for p in periods], start, n_episodes)
        per.append(d)
        evs.append(ev)
    draws = tp.stacked_particle_draws(per)
    eval_draws = tp.stacked_particle_draws(evs)
    tts, thist = multiseed.train_vmapped_seeds(
        th, ta, tcfg.TrainConfig(**cfg), S, BASE, onpolicy=True,
        resume=(tts, counts), draws=draws, eval_draws=eval_draws)
    assert not any(draws.remaining().values()), draws.remaining()
    assert not any(eval_draws.remaining().values())
    return jhist, thist, jts, tts, ta


def test_lockstep_run_matches_jax():
    """Three seeds from nothing: rows at 8 and 16 per seed, the second
    with the burst's losses [S] (JAX's lockstep row merges them), the
    first without; one epsilon for all seeds; the final stacked state."""
    jhist, thist, jts, tts, ta = _lockstep(0, 16)
    _hold_rows(jhist, thist, per_seed=True)
    assert [r["episode"].tolist() for r in thist] == [[8] * S, [16] * S]
    assert "policy_loss" not in thist[0]
    assert thist[1]["policy_loss"].shape == (S,)
    assert len(set(thist[1]["epsilon"].tolist())) == 1
    tp.hold_states(tts, convert.state_from_jax(ta, jax.device_get(jts)),
                   ta.net_names())
    assert tts.step == 2 * EPOCHS
