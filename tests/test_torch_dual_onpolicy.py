"""The dual buffer in the on-policy driver on particle (the paper's
``particle_s2_cross`` scenario from uniform-random starts, where agents
collide, so both memories fill) against the JAX package's, with JAX's
draws fed in: a random-fill rollout chunk, a policy chunk and a burst of CM3 updates
that samples both memories, the discard (both cursors to 0, the routed
counts added up on the device), one more chunk and a second burst; the
same with three seeds in lockstep against ``jax.vmap``; and the run's
period rows with their cumulative ``n_bad``/``n_good``.

Episodes end at the engine's cap of 7 steps, inside the 5-step chunks.
Tolerances as ``test_torch_onpolicy.py``'s: rtol 1e-5 / atol 1e-6,
flags, counts and cursors exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cm3_tpu.core import config as jcfg
from cm3_tpu.replay import buffer as jreplay
from cm3_tpu.train.experiments import make_hooks as jax_hooks
from cm3_tpu.train.offpolicy import init_rollout as jax_init_rollout
from cm3_tpu.train.offpolicy import init_stage as jax_init_stage
from cm3_tpu.train.onpolicy import OnPolicyDriver as JaxOnPolicy
from cm3_tpu_torch import convert
from cm3_tpu_torch.core import config as tcfg
from cm3_tpu_torch.core.tree import tree_leaves
from cm3_tpu_torch.train.experiments import make_hooks
from cm3_tpu_torch.train.offpolicy import init_rollout
from cm3_tpu_torch.train.onpolicy import OnPolicyDriver
from tests import torch_parity as tp

tp.set_torch_cpu()

E, CAP, B, SPT, EPOCHS, EPS, S = 4, 64, 16, 5, 3, 0.2, 3
RTOL, ATOL = 1e-5, 1e-6
KW = dict(n_envs=E, buffer_size=CAP, batch_size=B, steps_per_train=SPT,
          epochs=EPOCHS, episode_log=16, dual_buffer=True, max_steps=7)


def _close(got, want, name):
    got, want = got.numpy(), np.asarray(want)
    if np.issubdtype(want.dtype, np.floating):
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                                   err_msg=name)
    else:
        np.testing.assert_array_equal(got, want.astype(got.dtype),
                                      err_msg=name)


def _hold(jbuf, jrs, tbuf, trs, lead=()):
    """Both memories below each seed's fill and their cursors, the
    slab, the rollout and the env state."""
    for name in ("bad", "good"):
        jr, tr = getattr(jbuf, name), getattr(tbuf, name)
        _close(tr.size, jr.size, name + ".size")
        _close(tr.insert, jr.insert, name + ".insert")
        sizes = np.asarray(jr.size).reshape(-1)
        for path, leaf in tree_leaves(tr.data):
            want = jr.data
            for k in path:
                want = want[k]
            want = np.asarray(want).reshape((-1,) + np.shape(want)[
                len(lead):])
            got = leaf.reshape((-1,) + tuple(leaf.shape[len(lead):]))
            for s, n in enumerate(sizes):
                _close(got[s, :n], want[s, :n], name + "/".join(path))
    _close(trs.stage_t, jrs.stage_t, "stage_t")
    for name in ("ep_ret_local", "episodes", "eplog", "acc_ret_local"):
        _close(getattr(trs, name), getattr(jrs, name), name)
    for name in ("pos", "vel", "collisions"):
        _close(getattr(trs.env_state, name), getattr(jrs.env_state, name),
               name)


def _drivers(n_seeds=None):
    je, te = tp.particle_envs("stage2_cross", prob_random=1.0, max_steps=7)
    ja, ta = tp.particle_algs("cm3", je.spec(), n_seeds=n_seeds)
    jd = JaxOnPolicy(jax_hooks("particle", je), ja, jcfg.TrainConfig(**KW))
    td = OnPolicyDriver(make_hooks("particle", te), ta,
                        tcfg.TrainConfig(**KW))
    return jd, td, ta


def _jax_start(jd, key):
    jrs = jax_init_rollout(jd.hooks, key, E, KW["episode_log"])
    jts = jd.alg.init_state(jax.random.PRNGKey(1), jrs.obs, jrs.state,
                            jrs.goals)
    n = jd.hooks.n_agents
    zeros = jnp.zeros((E, n), jnp.int32)
    tr = jd._transition(jrs, zeros, jax.vmap(jd.hooks.env.step)(
        jrs.env_state, zeros)[1], None)
    example = jax.tree_util.tree_map(lambda x: x[0], tr)
    return (jts, jreplay.init_dual(example, CAP),
            jax_init_stage(jrs, example, E, KW["max_steps"]))


def _sizes(jbuf, i=None):
    pick = (lambda x: int(x)) if i is None else (lambda x: int(x[i]))
    return pick(jbuf.bad.size), pick(jbuf.good.size)


def test_rollouts_bursts_and_discard_match_jax():
    """One seed: fill chunk, policy chunk, burst, discard, chunk, burst;
    the routed counts of the discards add up on the device."""
    jd, td, ta = _drivers()
    k0 = jax.random.PRNGKey(0)
    keys = [jax.random.PRNGKey(11 + i) for i in range(5)]
    jts, jbuf, jrs = _jax_start(jd, k0)
    tts = convert.state_from_jax(ta, jax.device_get(jts))
    # JAX first: the bursts' index draws need its fills
    jsteps, routed = [], [0, 0]
    jbuf, jrs = jd._rollout(jts, jbuf, jrs, keys[0], True, EPS)
    jsteps.append(jax.device_get((jbuf, jrs)))
    jbuf, jrs = jd._rollout(jts, jbuf, jrs, keys[1], False, EPS)
    jsteps.append(jax.device_get((jbuf, jrs)))
    first = _sizes(jbuf)
    jts, _ = jd._burst(jts, jbuf, EPS, keys[2])
    routed = [a + b for a, b in zip(routed, first)]
    jbuf = jreplay.reset_dual(jbuf)
    jbuf, jrs = jd._rollout(jts, jbuf, jrs, keys[3], False, EPS)
    jsteps.append(jax.device_get((jbuf, jrs)))
    second = _sizes(jbuf)
    jts, jm = jd._burst(jts, jbuf, EPS, keys[4])
    d = tp.ParticleDraws(4)
    d.reset(k0, E)
    d.rollout(keys[0], E, SPT, True)
    d.rollout(keys[1], E, SPT, False)
    d.burst(keys[2], EPOCHS, B, first)
    d.rollout(keys[3], E, SPT, False)
    d.burst(keys[4], EPOCHS, B, second)
    draws = d.fed()
    trs = init_rollout(td.hooks, E, draws, KW["episode_log"])
    tbuf, trs = td.init_replay(trs)
    total = torch.zeros(2, dtype=torch.int64)
    tbuf, trs = td._rollout_chunk(tts, tbuf, trs, EPS, draws, True)
    _hold(*jsteps[0], tbuf, trs)
    tbuf, trs = td._rollout_chunk(tts, tbuf, trs, EPS, draws, False)
    _hold(*jsteps[1], tbuf, trs)
    tts, _ = td._train_burst(tts, tbuf, EPS, draws)
    tbuf = td.discard(tbuf, total)
    assert total.tolist() == routed and min(first) > 0
    assert not (tbuf.bad.size.any() or tbuf.good.insert.any())
    tbuf, trs = td._rollout_chunk(tts, tbuf, trs, EPS, draws, False)
    _hold(*jsteps[2], tbuf, trs)
    tts, tm = td._train_burst(tts, tbuf, EPS, draws)
    assert not any(draws.remaining().values()), draws.remaining()
    tp.hold_states(tts, convert.state_from_jax(ta, jax.device_get(jts)),
                   ta.net_names())
    assert tts.step == 2 * EPOCHS
    for k in tm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=RTOL,
                                   atol=ATOL, err_msg=k)


def test_seeds_in_lockstep_match_jax_vmap():
    """Three seeds: a fill chunk, a policy chunk and a burst that samples
    each seed's memories (the seeds route different numbers of rows to
    each), against ``jax.vmap`` of JAX's; then every seed's memories
    discarded."""
    jd, td, ta = _drivers(n_seeds=S)
    eps = np.array([0.1, 0.2, 0.3], np.float32)
    k0s = [jax.random.PRNGKey(30 + i) for i in range(S)]
    starts = [_jax_start(jd, k) for k in k0s]
    jts, jbuf, jrs = jax.tree_util.tree_map(lambda *x: jnp.stack(x), *starts)
    tts = convert.state_from_jax(ta, jax.device_get(jts))
    keys = [[jax.random.PRNGKey(100 * i + c) for i in range(S)]
            for c in range(3)]
    roll = lambda rand: jax.jit(jax.vmap(
        lambda ts, buf, rs, e, k: jd._rollout_chunk(ts, buf, rs, k, rand,
                                                    e)))
    jeps = jnp.asarray(eps)
    jbuf, jrs = roll(True)(jts, jbuf, jrs, jeps, jnp.stack(keys[0]))
    fill = jax.device_get((jbuf, jrs))
    jbuf, jrs = roll(False)(jts, jbuf, jrs, jeps, jnp.stack(keys[1]))
    jts, jm = jax.jit(jax.vmap(jd._train_burst))(jts, jbuf, jeps,
                                                  jnp.stack(keys[2]))
    per = []
    for i in range(S):
        d = tp.ParticleDraws(4)
        d.reset(k0s[i], E)
        d.rollout(keys[0][i], E, SPT, True)
        d.rollout(keys[1][i], E, SPT, False)
        d.burst(keys[2][i], EPOCHS, B, _sizes(jbuf, i))
        per.append(d)
    draws = tp.stacked_particle_draws(per)
    trs = init_rollout(td.hooks, E, draws, KW["episode_log"], n_seeds=S)
    tbuf, trs = td.init_replay(trs)
    teps = torch.from_numpy(eps)
    tbuf, trs = td._rollout_chunk(tts, tbuf, trs, teps, draws, True)
    _hold(*fill, tbuf, trs, lead=(S,))
    tbuf, trs = td._rollout_chunk(tts, tbuf, trs, teps, draws, False)
    _hold(jbuf, jrs, tbuf, trs, lead=(S,))
    split = list(zip(tbuf.bad.size.tolist(), tbuf.good.size.tolist()))
    assert len(set(split)) > 1, split
    tts, tm = td._train_burst(tts, tbuf, teps, draws)
    assert not any(draws.remaining().values()), draws.remaining()
    tp.hold_states(tts, convert.state_from_jax(ta, jax.device_get(jts)),
                   ta.net_names())
    for k, v in tm.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(jm[k]), rtol=RTOL,
                                   atol=ATOL, err_msg=k)
    td.discard(tbuf)
    assert not (tbuf.bad.size.any() or tbuf.good.size.any())


RUN = dict(KW, pretrain_episodes=4, episodes_per_train=4, period=8,
           N_train=16, N_eval=2, max_steps=5)


def test_run_rows_count_the_routed_rows():
    """``OnPolicyDriver.run`` with the dual buffer: its rows carry
    ``n_bad``/``n_good`` after the eval metrics' place as JAX's do,
    cumulative over the bursts' discards, so they never decrease, and
    the last row's add up to what the bursts saw (episodes of 5 steps,
    one a chunk: every routed row is a whole episode's)."""
    je, te = tp.particle_envs("stage2_cross", prob_random=0.5, max_steps=5)
    ja, ta = tp.particle_algs("cm3", je.spec())
    jd = JaxOnPolicy(jax_hooks("particle", je), ja, jcfg.TrainConfig(**RUN))
    td = OnPolicyDriver(make_hooks("particle", te), ta,
                        tcfg.TrainConfig(**RUN))
    batch = tp.particle_batch(je, 2, np.random.default_rng(0))
    jts = ja.init_state(jax.random.PRNGKey(3), batch["obs"], batch["state"],
                        batch["goals"])
    _, jout = jd.run(jts, jax.random.PRNGKey(5))
    tts = convert.state_from_jax(ta, jax.device_get(jts))
    _, tout = td.run(tts, key=5)
    jrows, trows = jout["history"], tout["history"]
    assert [list(r) for r in trows] == [list(r) for r in jrows]
    assert [r["episode"] for r in trows] == [r["episode"] for r in jrows]
    for rows in (jrows, trows):
        counts = [r["n_bad"] + r["n_good"] for r in rows]
        assert counts == sorted(counts) and counts[-1] > 0
        assert all(c % 5 == 0 for c in counts)
