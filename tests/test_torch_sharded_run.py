"""Shard-local replay through the off-policy host loop against the JAX
package's, with JAX's draws fed in: ``run`` on a tiny Checkers stage 1
(optax) at D = 2 and 4 (the schedule, the period rows, the final state
and the shards); and the schedules that run shards without a JAX
counterpart here: the dual buffer's period row (``n_bad``/``n_good``
summed over the shards) and ``train_vmapped_seeds`` with shards, off-
and on-policy.  The K-chunk dispatch, the on-policy burst and
``eval_hooks``: ``test_torch_sharded_kchunk.py``.

Tolerances as ``test_torch_evaluate.py``'s: the nets' float32 sums in
other orders, rtol 1e-5 / atol 1e-6; episode counts, epsilons and
replay cursors exactly."""

import jax
import numpy as np
import pytest

from cm3_tpu.core import config as jcfg
from cm3_tpu.train.experiments import make_hooks as jax_hooks
from cm3_tpu.train.offpolicy import OffPolicyDriver as JaxDriver
from cm3_tpu_torch import convert
from cm3_tpu_torch.core import config as tcfg
from cm3_tpu_torch.core import prng
from cm3_tpu_torch.train import multiseed
from cm3_tpu_torch.train.experiments import make_hooks
from cm3_tpu_torch.train.offpolicy import OffPolicyDriver
from cm3_tpu_torch.train.onpolicy import OnPolicyDriver
from tests import torch_parity as tp
from tests.test_torch_evaluate import RUN
from tests.test_torch_sharded_driver import hold_ring

tp.set_torch_cpu()

RTOL, ATOL = 1e-5, 1e-6


# --------------------------------------------------------------------- #
# run
# --------------------------------------------------------------------- #


def _run_draws(key, shards):
    """``test_torch_evaluate._run_draws`` with shards: each update's
    indices drawn as JAX's sharded sample draws them, every shard at
    the same fill (E/D rows a step each)."""
    e, spt, u, b, cap = (RUN[k] for k in ("n_envs", "steps_per_train",
                                          "updates_per_chunk", "batch_size",
                                          "buffer_size"))
    k_init, k_loop, k_eval = jax.random.split(key, 3)
    randints, gumbels = [tp.goal_draws(k_init, e)], []
    size = 0
    for c in range(4):
        size = min(size + spt * e // shards, cap // shards)
        r, g = tp.chunk_draws(jax.random.fold_in(k_loop, c), e, 1, 5, spt,
                              c < 2, 0 if c < 2 else u, b,
                              [np.full(shards, size)] * u)
        randints += r
        gumbels += g
    ev = [tp.eval_draws(jax.random.fold_in(k_eval, p), RUN["N_eval"], 1, 5,
                        RUN["max_steps"]) for p in (1, 2)]
    return (randints, gumbels), tuple(sum((x[i] for x in ev), [])
                                      for i in range(2))


@pytest.mark.parametrize("shards", [2, 4])
def test_run_matches_jax(shards):
    """``run`` of 16 episodes (two fill chunks, two training chunks of 2
    updates on 8 rows, a row every 8 episodes) with D shards: the rows'
    episodes and epsilons exactly, every other value of JAX's row, and
    the final state."""
    cfg = dict(RUN, replay_shards=shards)
    je, te = tp.envs(max_steps=5, n_agents=1)
    ja, ta = tp.algs(je.spec(), fused_opt=False)
    jd = JaxDriver(jax_hooks("checkers", je), ja, jcfg.TrainConfig(**cfg))
    td = OffPolicyDriver(make_hooks("checkers", te), ta,
                         tcfg.TrainConfig(**cfg))
    batch = tp.replay_batch(je, 2, np.random.default_rng(0))
    jts = ja.init_state(jax.random.PRNGKey(3), batch["obs"], batch["state"],
                        batch["goals"])
    tts = convert.state_from_jax(ta, jax.device_get(jts))
    key = jax.random.PRNGKey(21)
    jts, jout = jd.run(jts, key)
    (randints, gumbels), evals = _run_draws(key, shards)
    draws = prng.FedDraws(randints, gumbels, device="cpu")
    eval_draws = prng.FedDraws(*evals, device="cpu")
    tts, tout = td.run(tts, draws=draws, eval_draws=eval_draws)
    assert draws.remaining() == eval_draws.remaining() == {"randint": 0,
                                                           "gumbel": 0}
    jh, th = jout["history"], tout["history"]
    assert [r["episode"] for r in th] == [r["episode"] for r in jh] == [8, 16]
    for j, t in zip(jh, th):
        assert set(t) == set(j) and t["epsilon"] == pytest.approx(
            j["epsilon"], rel=1e-12)
        for k in j:
            if k in ("episode", "epsilon", "duration_s", "_episodes"):
                continue
            np.testing.assert_allclose(np.asarray(t[k]), np.asarray(j[k]),
                                       rtol=RTOL, atol=ATOL, err_msg=k)
    tp.hold_states(tts, convert.state_from_jax(ta, jax.device_get(jts)),
                   ("actor", "qg"))
    hold_ring(tout["buffer"], jax.device_get(jout["buffer"]), "ring")
    assert tuple(tout["buffer"].size.shape) == (shards,)


# --------------------------------------------------------------------- #
# the schedules without a JAX counterpart here
# --------------------------------------------------------------------- #


def _stage1():
    _, te = tp.envs(max_steps=5, n_agents=1)
    _, ta = tp.algs(te.spec(), fused_opt=False)
    return make_hooks("checkers", te), ta


def test_dual_row_sums_the_shards():
    """A dual run on roadway's short road with D = 2: the last period
    row's ``n_bad``/``n_good`` are both memories' fills summed over the
    shards (``offpolicy.py:522-525``), and the shards' fills differ."""
    _, te = tp.roadway_envs(2, **tp.SHORT_ROAD)
    _, ta = tp.roadway_algs("cm3", te.spec())
    cfg = tcfg.TrainConfig(n_envs=4, buffer_size=64, batch_size=8,
                           steps_per_train=5, updates_per_chunk=1,
                           pretrain_episodes=4, period=24, N_train=24,
                           N_eval=1, dual_buffer=True, max_steps=6,
                           threshold=12.0, replay_shards=2)
    td = OffPolicyDriver(make_hooks("roadway", te, threshold=12.0), ta, cfg)
    _, out = td.run(ta.init_state(0), key=4)
    row, buf = out["history"][-1], out["buffer"]
    assert (row["n_bad"], row["n_good"]) == (int(buf.bad.size.sum()),
                                             int(buf.good.size.sum()))
    assert row["n_bad"] + row["n_good"] > 0
    assert tuple(buf.bad.size.shape) == (2,)


@pytest.mark.parametrize("onpolicy", [False, True], ids=["off", "on"])
def test_seeds_in_lockstep_run_with_shards(onpolicy):
    """``train_vmapped_seeds`` with D = 2 and 2 seeds: each seed's
    replay is two shards ([S, D] device cursors), the rows come, and
    on-policy every burst discards every shard of every seed."""
    kw = dict(n_envs=4, max_steps=5, steps_per_train=5, period=8,
              N_eval=1, batch_size=8, buffer_size=32, N_train=16,
              replay_shards=2, pretrain_episodes=4)
    if onpolicy:
        _, te = tp.particle_envs("stage2_antipodal", prob_random=1.0,
                                 max_steps=5)
        _, ta = tp.particle_algs("cm3", te.spec())
        hooks = make_hooks("particle", te)
        kw.update(episodes_per_train=4, epochs=2)
    else:
        hooks, ta = _stage1()
        kw.update(updates_per_chunk=1)
    seen = []
    real = OnPolicyDriver.discard if onpolicy else OffPolicyDriver._replay_add

    def spy(self, buf, *a):
        seen.append(tuple(buf.size.shape))
        return real(self, buf, *a)
    cls = OnPolicyDriver if onpolicy else OffPolicyDriver
    name = "discard" if onpolicy else "_replay_add"
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cls, name, spy)
        ts, rows = multiseed.train_vmapped_seeds(
            hooks, ta, tcfg.TrainConfig(**kw), 2, 3, onpolicy=onpolicy)
    assert seen and set(seen) == {(2, 2)}
    assert [r["episode"].min() >= 8 for r in rows] == [True] * len(rows)
    assert np.isfinite(rows[-1]["r_eval_global"]).all()
    assert ts.step > 0
