"""The on-policy host loop of one seed on particle against the JAX
package's, with JAX's draws fed in: ``OnPolicyDriver.run`` on CM3
stage 2 with four agents at narrow widths (seeds in lockstep:
``test_torch_onpolicy_seeds.py``, with the helpers here).

Every episode lasts the engine's cap of 5 steps, one chunk (fixed
starts 1.8 apart from their landmarks: no agent reaches in 5 steps), so
the schedule is known in advance: chunks 0-1 fill (random actions; a
period row at 8 episodes, no burst yet), chunks 2 and 3 each end with a
burst of 2 updates (60 rows in the ring at the first, 20 at the second:
it is discarded after each), a row at 16.  What is held: the rows'
keys and their missing learning metrics (JAX's quirk: its single-seed
row never merges them, ``onpolicy.py:117-150``), the episode counts and
epsilons exactly (decayed once per burst), the rest at rtol 1e-5 /
atol 1e-6; the episode-log flushes; and the final state."""

import jax
import numpy as np
import pytest

from cm3_tpu.core import config as jcfg
from cm3_tpu.train.experiments import make_hooks as jax_hooks
from cm3_tpu.train.onpolicy import OnPolicyDriver as JaxOnPolicy
from cm3_tpu_torch import convert
from cm3_tpu_torch.core import config as tcfg
from cm3_tpu_torch.train.experiments import make_hooks
from cm3_tpu_torch.train.onpolicy import OnPolicyDriver
from tests import torch_parity as tp

tp.set_torch_cpu()

E, SPT, B, EPOCHS = 4, 5, 8, 2
RUN = dict(n_envs=E, steps_per_train=SPT, batch_size=B, epochs=EPOCHS,
           buffer_size=64, pretrain_episodes=8, episodes_per_train=4,
           period=8, N_train=16, N_eval=3, max_steps=5, episode_log=6)
RTOL, ATOL = 1e-5, 1e-6
SKIP = ("episode", "epsilon", "duration_s", "t_env", "t_train", "_episodes")


def _setup(n_seeds=None):
    je, te = tp.particle_envs("stage2_antipodal", prob_random=0.0,
                              max_steps=5)
    ja, ta = tp.particle_algs("cm3", je.spec(), n_seeds=n_seeds)
    jh, th = jax_hooks("particle", je), make_hooks("particle", te)
    return je, ja, ta, jh, th


def _schedule(start, n_episodes, cfg=RUN):
    """(chunk index, random fill, burst ring size or 0) of each chunk,
    every chunk completing E episodes (per seed), as the drivers decide
    (``onpolicy.py:101-118``; ``multiseed.py:186-200``)."""
    out, eps, last, size, c = [], start, start, 0, 0
    while eps < n_episodes:
        fill = eps < cfg["pretrain_episodes"]
        eps += E
        size = min(size + SPT * E, cfg["buffer_size"])
        burst = (not fill and eps - last >= cfg["episodes_per_train"])
        out.append((c, fill, size if burst else 0))
        if burst:
            last, size = eps, 0
        c += 1
    return out


def _draws(n, k_init, chunk_key, eval_keys, start, n_episodes):
    """The rollout and evaluation draws of one seed's run."""
    d = tp.ParticleDraws(n)
    d.reset(k_init, E)
    for c, fill, size in _schedule(start, n_episodes):
        k = chunk_key(c)
        d.rollout(k, E, SPT, fill)
        if size:
            d.burst(jax.random.fold_in(k, 1), EPOCHS, B, size)
    ev = tp.ParticleDraws(n)
    for k in eval_keys:
        ev.evaluate(k, RUN["N_eval"], RUN["max_steps"])
    return d, ev


def _hold_rows(jh, th, per_seed):
    assert [np.asarray(r["episode"]).tolist() for r in th] == [
        np.asarray(r["episode"]).tolist() for r in jh]
    for j, t in zip(jh, th):
        assert set(t) == set(j), set(t) ^ set(j)
        np.testing.assert_allclose(t["epsilon"], j["epsilon"], rtol=1e-12)
        for k in j:
            if k in SKIP:
                continue
            np.testing.assert_allclose(np.asarray(t[k]), np.asarray(j[k]),
                                       rtol=RTOL, atol=ATOL, err_msg=k)
        flush = [(j["_episodes"], t["_episodes"])] if not per_seed else \
            list(zip(j["_episodes"], t["_episodes"]))
        for (jid, jret), (tid, tret) in flush:
            np.testing.assert_array_equal(tid, jid)
            np.testing.assert_allclose(tret, jret, rtol=RTOL, atol=ATOL)


@pytest.fixture(scope="module")
def one_seed():
    je, ja, ta, jh, th = _setup()
    cfg = RUN
    jd = JaxOnPolicy(jh, ja, jcfg.TrainConfig(**cfg))
    td = OnPolicyDriver(th, ta, tcfg.TrainConfig(**cfg))
    batch = tp.particle_batch(je, 2, np.random.default_rng(0))
    jts = ja.init_state(jax.random.PRNGKey(3), batch["obs"], batch["state"],
                        batch["goals"])
    tts = convert.state_from_jax(ta, jax.device_get(jts))
    key = jax.random.PRNGKey(21)
    jts, jout = jd.run(jts, key)
    k_init, k_loop, k_eval = jax.random.split(key, 3)
    d, ev = _draws(4, k_init, lambda c: jax.random.fold_in(k_loop, c),
                   [jax.random.fold_in(k_eval, p) for p in (1, 2)], 0, 16)
    draws, eval_draws = d.fed(), ev.fed()
    logged = []
    tts, tout = td.run(tts, draws=draws, eval_draws=eval_draws,
                       log_fn=logged.append)
    assert not any(draws.remaining().values()), draws.remaining()
    assert not any(eval_draws.remaining().values())
    return (convert.state_from_jax(ta, jax.device_get(jts)), jout), \
        (tts, tout), logged, ta


def test_run_rows_match_jax(one_seed):
    """Rows at 8 and 16 episodes with JAX's keys (``t_env``,
    ``t_train``, the reach rate) and no learning metric in either,
    epsilon decayed once per burst (two bursts), the episode-log ring
    flushed; ``log_fn`` sees each row with the state."""
    (_, jout), (_, tout), logged, _ = one_seed
    jh, th = jout["history"], tout["history"]
    _hold_rows(jh, th, per_seed=False)
    assert [r["episode"] for r in th] == [8, 16]
    for r in th:
        assert not any(k.startswith(("loss", "policy")) for k in r)
        assert r["t_env"] > 0 and "eval_reach_rate" in r
    assert th[0]["t_train"] == 0.0 < th[1]["t_train"]
    step = tcfg.TrainConfig(**RUN).epsilon_step
    assert tout["epsilon"] == pytest.approx(0.5 - 2 * step, rel=1e-12)
    assert tout["epsilon"] == pytest.approx(jout["epsilon"], rel=1e-12)
    assert set(tout) == set(jout)
    assert [len(r) for r in logged] == [len(r) + 1 for r in th]


def test_run_final_state_matches_jax(one_seed):
    """The state after the two bursts (4 optax updates)."""
    (want, _), (got, _), _, ta = one_seed
    tp.hold_states(got, want, ta.net_names())
    assert got.step == want.step == 2 * EPOCHS
