"""The port's evaluation and single-seed host loop against the JAX
package's, with JAX's draws fed in: ``evaluate``'s returns and action
distribution for stage 2 and stage 1, and ``run``'s schedule (random
fill, then training with epsilon decayed per episode), period rows,
episode-log ring flushes and final state on a tiny stage-1 run."""

import jax
import numpy as np
import pytest

from cm3_tpu.core import config as jcfg
from cm3_tpu.train.experiments import make_hooks as jax_hooks
from cm3_tpu.train.offpolicy import OffPolicyDriver as JaxDriver
from cm3_tpu_torch import convert
from cm3_tpu_torch.core import config as tcfg
from cm3_tpu_torch.core import prng
from cm3_tpu_torch.train.experiments import make_hooks
from cm3_tpu_torch.train.offpolicy import OffPolicyDriver
from tests import torch_parity as tp

tp.set_torch_cpu()

# returns and distributions pass through the nets: float32 sums in other
# orders (see test_torch_chunk.py)
RTOL, ATOL = 1e-5, 1e-6


@pytest.mark.parametrize("n_agents", [2, 1], ids=["stage2", "stage1"])
def test_evaluate_matches_jax(n_agents):
    """12 fresh episodes for ``max_steps`` = 9 steps with the env's cap
    at 6, so returns stop counting where an episode ends: the mean
    per-agent and global returns and the per-agent action distribution
    [N, A]."""
    n_eval, max_steps = 12, 9
    je, te = tp.envs(max_steps=6, n_agents=n_agents)
    ja, ta = tp.algs(je.spec(), fused_opt=False)
    kw = dict(N_eval=n_eval, max_steps=max_steps)
    jd = JaxDriver(jax_hooks("checkers", je), ja, jcfg.TrainConfig(**kw))
    td = OffPolicyDriver(make_hooks("checkers", te), ta,
                         tcfg.TrainConfig(**kw))
    batch = tp.replay_batch(je, 2, np.random.default_rng(0))
    jts = ja.init_state(jax.random.PRNGKey(3), batch["obs"], batch["state"],
                        batch["goals"])
    tts = convert.state_from_jax(ta, jax.device_get(jts))
    key = jax.random.PRNGKey(8)
    jl, jg, jaux = jax.jit(jd.evaluate, static_argnums=(2,))(jts, key, n_eval)
    draws = prng.FedDraws(*tp.eval_draws(key, n_eval, n_agents, 5,
                                         max_steps), device="cpu")
    tl, tg, taux = td.evaluate(tts, draws, n_eval)
    assert draws.remaining() == {"randint": 0, "gumbel": 0}
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(float(tg), float(jg), rtol=RTOL, atol=ATOL)
    assert set(taux) == set(jaux) == {"act_dist"}
    assert taux["act_dist"].shape == (n_agents, 5)
    np.testing.assert_allclose(taux["act_dist"].numpy(),
                               np.asarray(jaux["act_dist"]), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(taux["act_dist"].sum(-1).numpy(), 1.0,
                               rtol=1e-6)


E, SPT, U, B, CAP, K = 4, 5, 2, 8, 64, 6
RUN = dict(n_envs=E, steps_per_train=SPT, updates_per_chunk=U, batch_size=B,
           buffer_size=CAP, pretrain_episodes=8, period=8, N_train=16,
           N_eval=3, max_steps=5, episode_log=K)


def _run_draws(key):
    """The draws of JAX's ``run`` from ``key`` in the order the port asks
    for them: every episode lasts the env's cap of 5 steps (one chunk),
    so chunks 0-1 fill (4 and 8 episodes: a period row), chunks 2-3
    train (12, 16: a row); (rollout draws, eval draws)."""
    k_init, k_loop, k_eval = jax.random.split(key, 3)
    randints, gumbels = [tp.goal_draws(k_init, E)], []
    size = 0
    for c in range(4):
        k = jax.random.fold_in(k_loop, c)
        size = min(size + SPT * E, CAP)
        r, g = tp.chunk_draws(k, E, 1, 5, SPT, c < 2, 0 if c < 2 else U, B,
                              [size] * U)
        randints += r
        gumbels += g
    ev = [tp.eval_draws(jax.random.fold_in(k_eval, p), RUN["N_eval"], 1, 5,
                        RUN["max_steps"]) for p in (1, 2)]
    return (randints, gumbels), tuple(sum((e[i] for e in ev), [])
                                      for i in range(2))


@pytest.fixture(scope="module")
def runs():
    je, te = tp.envs(max_steps=5, n_agents=1)
    ja, ta = tp.algs(je.spec(), fused_opt=False)
    jd = JaxDriver(jax_hooks("checkers", je), ja, jcfg.TrainConfig(**RUN))
    td = OffPolicyDriver(make_hooks("checkers", te), ta,
                         tcfg.TrainConfig(**RUN))
    batch = tp.replay_batch(je, 2, np.random.default_rng(0))
    jts = ja.init_state(jax.random.PRNGKey(3), batch["obs"], batch["state"],
                        batch["goals"])
    tts = convert.state_from_jax(ta, jax.device_get(jts))
    key = jax.random.PRNGKey(21)
    jts, jout = jd.run(jts, key)
    rollout, evals = _run_draws(key)
    draws = prng.FedDraws(*rollout, device="cpu")
    eval_draws = prng.FedDraws(*evals, device="cpu")
    logged = []
    tts, tout = td.run(tts, draws=draws, eval_draws=eval_draws,
                       log_fn=logged.append)
    assert draws.remaining() == eval_draws.remaining() == {"randint": 0,
                                                           "gumbel": 0}
    return (convert.state_from_jax(ta, jax.device_get(jts)), jout), \
        (tts, tout), logged


def test_run_schedule_and_rows_match_jax(runs):
    """Two period rows at 8 and 16 episodes, the first after the random
    fill (no losses), the second after training; every key of JAX's row,
    the episode counts and epsilons exactly, the rest at rtol 1e-5 /
    atol 1e-6; ``log_fn`` sees each row with the state."""
    (_, jout), (_, tout), logged = runs
    jh, th = jout["history"], tout["history"]
    assert [r["episode"] for r in th] == [r["episode"] for r in jh] == [8, 16]
    assert tout["episodes"] == jout["episodes"] == 16
    assert tout["epsilon"] == pytest.approx(jout["epsilon"], rel=1e-12)
    assert [len(r) for r in logged] == [len(r) + 1 for r in th]
    for j, t in zip(jh, th):
        assert set(t) == set(j)
        assert t["epsilon"] == pytest.approx(j["epsilon"], rel=1e-12)
        for k in j:
            if k in ("episode", "epsilon", "duration_s", "_episodes"):
                continue
            np.testing.assert_allclose(np.asarray(t[k]), np.asarray(j[k]),
                                       rtol=RTOL, atol=ATOL, err_msg=k)
    assert "policy_loss" not in th[0] and "policy_loss" in th[1]


def test_run_flushes_the_episode_log_ring(runs):
    """Each row's episodes newer than the last flush that the ring of 6
    still holds, sorted (the ring wraps: 8 episodes a period), ids
    exactly and returns at rtol 1e-5 / atol 1e-6."""
    (_, jout), (_, tout), _ = runs
    for j, t in zip(jout["history"], tout["history"]):
        (jid, jret), (tid, tret) = j["_episodes"], t["_episodes"]
        np.testing.assert_array_equal(tid, jid)
        assert len(tid) == K
        np.testing.assert_allclose(tret, jret, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(tout["history"][1]["_episodes"][0],
                                  np.arange(11, 17))


def test_run_final_state_matches_jax(runs):
    """The state after two training chunks (4 optax updates)."""
    (want, _), (got, _), _ = runs
    tp.hold_states(got, want, ("actor", "qg"))
    assert got.step == want.step == 2 * U


def test_run_resumes_with_a_warm_up():
    """``initial_episodes`` = 16: the episode and epsilon schedule resume
    there, the empty ring is warmed by policy rollouts without updates
    until 8 more episodes are done (a row at 24 with no update made),
    then training chunks run (a row at 32 after two chunks' updates),
    with epsilon decayed from the resumed count."""
    je, te = tp.envs(max_steps=5, n_agents=1)
    _, ta = tp.algs(je.spec(), fused_opt=False)
    cfg = tcfg.TrainConfig(**dict(RUN, N_train=32))
    td = OffPolicyDriver(make_hooks("checkers", te), ta, cfg)
    seen = []
    ts, out = td.run(ta.init_state(0), key=3, initial_episodes=16,
                     log_fn=lambda row: seen.append(row["_ts"].step))
    rows = out["history"]
    assert [r["episode"] for r in rows] == [24, 32]
    assert seen == [0, 2 * U] and ts.step == 2 * U
    assert "policy_loss" not in rows[0] and "policy_loss" in rows[1]
    step = cfg.epsilon_step
    assert rows[0]["epsilon"] == pytest.approx(0.5 - (16 - 8) * step)
    assert rows[1]["epsilon"] == pytest.approx(0.5 - (32 - 8) * step)
    assert np.isfinite(rows[1]["r_eval_local"]).all()
