"""The on-policy driver's pieces on particle against the JAX package's,
with JAX's draws fed in (``torch_parity.ParticleDraws``): a random-fill
rollout chunk, a policy chunk and a burst of CM3 updates
(``OnPolicyDriver._rollout_chunk``, ``_train_burst``), then the ring
discarded (``replay.reset``), one more chunk and a second burst that
samples only it; the same with three seeds in lockstep against
``jax.vmap``; QMIX's off-policy chunk on particle (QMIX trains
off-policy everywhere); and the evaluation with its reach rate.

Episodes end every 7 steps in 5-step chunks, so auto-resets (with the
reset's four fed draws) fall inside chunks; half the starts are
uniform-random.  Tolerances: the engine's floats through compiled XLA
are a few ulps apart (``test_torch_particle.py``), the nets' float32
sums in other orders: rtol 1e-5 / atol 1e-6, flags, counts and indices
exactly; QMIX's state at ``torch_parity.QMIX_TOL``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cm3_tpu.core import config as jcfg
from cm3_tpu.replay import buffer as jreplay
from cm3_tpu.train.experiments import make_hooks as jax_hooks
from cm3_tpu.train.offpolicy import OffPolicyDriver as JaxOffPolicy
from cm3_tpu.train.offpolicy import init_rollout as jax_init_rollout
from cm3_tpu.train.onpolicy import OnPolicyDriver as JaxOnPolicy
from cm3_tpu_torch import convert
from cm3_tpu_torch.core import config as tcfg
from cm3_tpu_torch.core.tree import tree_leaves
from cm3_tpu_torch.replay import buffer as treplay
from cm3_tpu_torch.train.experiments import make_hooks
from cm3_tpu_torch.train.offpolicy import OffPolicyDriver, init_rollout
from cm3_tpu_torch.train.onpolicy import OnPolicyDriver
from tests import torch_parity as tp

tp.set_torch_cpu()

E, CAP, B, SPT, EPOCHS, EPS = 4, 64, 16, 5, 3, 0.2
RTOL, ATOL = 1e-5, 1e-6
KW = dict(n_envs=E, buffer_size=CAP, batch_size=B, steps_per_train=SPT,
          epochs=EPOCHS, updates_per_chunk=2, episode_log=16)


def _close(got, want, name, **tol):
    got, want = got.numpy(), np.asarray(want)
    if np.issubdtype(want.dtype, np.floating):
        np.testing.assert_allclose(got, want, err_msg=name,
                                   **(tol or dict(rtol=RTOL, atol=ATOL)))
    else:
        np.testing.assert_array_equal(got, want.astype(got.dtype),
                                      err_msg=name)


def _hold_rollout(jbuf, jrs, tbuf, trs, lead=()):
    """Replay ring, rollout state and env state equal."""
    ring = len(lead)
    first = lambda x: int(np.asarray(x).ravel()[0])
    assert (tbuf.insert, tbuf.size) == (first(jbuf.insert),
                                        first(jbuf.size))
    for path, leaf in tree_leaves(tbuf.data):
        want = jbuf.data
        for k in path:
            want = want[k]
        n = tbuf.size
        sl = (slice(None),) * ring + (slice(0, n),)
        _close(leaf[sl], np.asarray(want)[sl], "replay " + "/".join(path))
    for name in ("goals", "ep_ret_local", "ep_ret_global", "acc_ret_local",
                 "acc_ret_global", "episodes", "eplog", "eplog_ep"):
        _close(getattr(trs, name), getattr(jrs, name), name)
    for name in ("pos", "vel", "landmarks", "reached", "steps",
                 "collisions"):
        _close(getattr(trs.env_state, name), getattr(jrs.env_state, name),
               name)
    for k in ("others", "self_v"):
        _close(trs.obs[k], jrs.obs[k], "obs " + k)


def _drivers(kind="cm3", n_seeds=None, **alg):
    je, te = tp.particle_envs("stage2_antipodal", prob_random=0.5,
                              max_steps=7)
    ja, ta = tp.particle_algs(kind, je.spec(), n_seeds=n_seeds, **alg)
    jcls, tcls = ((JaxOffPolicy, OffPolicyDriver) if kind == "qmix"
                  else (JaxOnPolicy, OnPolicyDriver))
    jd = jcls(jax_hooks("particle", je), ja, jcfg.TrainConfig(**KW))
    td = tcls(make_hooks("particle", te), ta, tcfg.TrainConfig(**KW))
    return je, jd, td, ta


def _jax_start(jd, ja_init, key):
    jrs = jax_init_rollout(jd.hooks, key, E, KW["episode_log"])
    jts = ja_init(jax.random.PRNGKey(1), jrs.obs, jrs.state, jrs.goals)
    zeros = jnp.zeros((E, 4), jnp.int32)
    tr = jd._transition(jrs, zeros, jax.vmap(jd.hooks.env.step)(
        jrs.env_state, zeros)[1], None)
    jbuf = jreplay.init(jax.tree_util.tree_map(lambda x: x[0], tr), CAP)
    return jts, jbuf, jrs


@pytest.fixture(scope="module")
def one_seed():
    """Fill chunk, policy chunk, burst, discard, chunk, burst."""
    je, jd, td, ta = _drivers()
    k0 = jax.random.PRNGKey(0)
    jts, jbuf, jrs = _jax_start(jd, jd.alg.init_state, k0)
    tts = convert.state_from_jax(ta, jax.device_get(jts))
    d = tp.ParticleDraws(4)
    d.reset(k0, E)
    keys = [jax.random.PRNGKey(11 + i) for i in range(5)]
    d.rollout(keys[0], E, SPT, True)
    d.rollout(keys[1], E, SPT, False)
    d.burst(keys[2], EPOCHS, B, 2 * SPT * E)
    d.rollout(keys[3], E, SPT, False)
    d.burst(keys[4], EPOCHS, B, SPT * E)
    draws = d.fed()
    trs = init_rollout(td.hooks, E, draws, KW["episode_log"])
    tbuf = td._replay_init(td.example_transition(trs))
    out = {}
    jbuf, jrs = jd._rollout(jts, jbuf, jrs, keys[0], True, EPS)
    tbuf, trs = td._rollout_chunk(tts, tbuf, trs, EPS, draws, True)
    out["fill"] = jax.device_get((jbuf, jrs)), (tbuf.insert, tbuf.size)
    _hold_rollout(jbuf, jrs, tbuf, trs)
    jbuf, jrs = jd._rollout(jts, jbuf, jrs, keys[1], False, EPS)
    tbuf, trs = td._rollout_chunk(tts, tbuf, trs, EPS, draws, False)
    _hold_rollout(jbuf, jrs, tbuf, trs)
    out["policy"] = int(trs.episodes)
    jts, jm = jd._burst(jts, jbuf, EPS, keys[2])
    tts, tm = td._train_burst(tts, tbuf, EPS, draws)
    out["burst1"] = (convert.state_from_jax(ta, jax.device_get(jts)),
                     tp.copy_state(ta, tts), jax.device_get(jm),
                     {k: float(v) for k, v in tm.items()})
    jbuf = jbuf.replace(insert=jnp.zeros_like(jbuf.insert),
                        size=jnp.zeros_like(jbuf.size))
    tbuf = treplay.reset(tbuf)
    assert (tbuf.insert, tbuf.size) == (0, 0)
    jbuf, jrs = jd._rollout(jts, jbuf, jrs, keys[3], False, EPS)
    tbuf, trs = td._rollout_chunk(tts, tbuf, trs, EPS, draws, False)
    _hold_rollout(jbuf, jrs, tbuf, trs)
    jts, jm = jd._burst(jts, jbuf, EPS, keys[4])
    tts, tm = td._train_burst(tts, tbuf, EPS, draws)
    assert not any(draws.remaining().values()), draws.remaining()
    out["burst2"] = (convert.state_from_jax(ta, jax.device_get(jts)), tts,
                     jax.device_get(jm), {k: float(v) for k, v in tm.items()})
    out["alg"] = ta
    return out


@pytest.mark.parametrize("burst", ["burst1", "burst2"])
def test_burst_matches_jax(one_seed, burst):
    """After each burst of 3 updates (the second on the discarded and
    refilled ring, whose fill is one chunk's 20 rows): networks,
    targets, Adam moments and counts, and the last update's metrics."""
    want, got, jm, tm = one_seed[burst]
    tp.hold_states(got, want, one_seed["alg"].net_names())
    assert got.step == want.step == EPOCHS * (1 + (burst == "burst2"))
    assert set(tm) == set(jm) == {"loss_Q_global", "loss_Q_credit",
                                  "policy_loss"}
    for k in tm:
        np.testing.assert_allclose(tm[k], float(jm[k]), rtol=RTOL, atol=ATOL,
                                   err_msg=k)


def test_rollout_chunks_reset_episodes(one_seed):
    """The fill chunk wrote 20 rows; episodes of 7 steps ended inside
    the chunks (the auto-reset's fed draws consumed in order)."""
    (jbuf, _), (insert, size) = one_seed["fill"]
    assert (insert, size) == (SPT * E, SPT * E) == (int(jbuf.insert),
                                                    int(jbuf.size))
    assert one_seed["policy"] == E


S = 3


def test_seeds_in_lockstep_match_jax_vmap():
    """Three seeds: a fill chunk, a policy chunk and a burst of CM3
    updates against ``jax.vmap`` of JAX's, each seed with its own
    keys; the epsilon [S]."""
    je, jd, td, ta = _drivers(n_seeds=S)
    eps = np.array([0.1, 0.2, 0.3], np.float32)
    k0s = [jax.random.PRNGKey(30 + i) for i in range(S)]
    starts = [_jax_start(jd, jd.alg.init_state, k) for k in k0s]
    jts, jbuf, jrs = jax.tree_util.tree_map(lambda *x: jnp.stack(x), *starts)
    tts = convert.state_from_jax(ta, jax.device_get(jts))
    keys = [[jax.random.PRNGKey(100 * i + c) for i in range(S)]
            for c in range(3)]
    per = []
    for i in range(S):
        d = tp.ParticleDraws(4)
        d.reset(k0s[i], E)
        d.rollout(keys[0][i], E, SPT, True)
        d.rollout(keys[1][i], E, SPT, False)
        d.burst(keys[2][i], EPOCHS, B, 2 * SPT * E)
        per.append(d)
    draws = tp.stacked_particle_draws(per)
    trs = init_rollout(td.hooks, E, draws, KW["episode_log"], n_seeds=S)
    tbuf = td._replay_init(td.example_transition(trs))
    roll = lambda rand: jax.jit(jax.vmap(
        lambda ts, buf, rs, e, k: jd._rollout_chunk(ts, buf, rs, k, rand,
                                                    e)))
    jeps = jnp.asarray(eps)
    jbuf, jrs = roll(True)(jts, jbuf, jrs, jeps, jnp.stack(keys[0]))
    tbuf, trs = td._rollout_chunk(tts, tbuf, trs, torch.from_numpy(eps),
                                  draws, True)
    jbuf, jrs = roll(False)(jts, jbuf, jrs, jeps, jnp.stack(keys[1]))
    tbuf, trs = td._rollout_chunk(tts, tbuf, trs, torch.from_numpy(eps),
                                  draws, False)
    _hold_rollout(jbuf, jrs, tbuf, trs, lead=(S,))
    jts, jm = jax.jit(jax.vmap(jd._train_burst))(jts, jbuf, jeps,
                                                  jnp.stack(keys[2]))
    tts, tm = td._train_burst(tts, tbuf, torch.from_numpy(eps), draws)
    assert not any(draws.remaining().values()), draws.remaining()
    tp.hold_states(tts, convert.state_from_jax(ta, jax.device_get(jts)),
                   ta.net_names())
    for k, v in tm.items():
        assert v.shape == (S,)
        np.testing.assert_allclose(v.numpy(), np.asarray(jm[k]), rtol=RTOL,
                                   atol=ATOL, err_msg=k)


def test_qmix_offpolicy_chunk_matches_jax():
    """QMIX on particle: a random-fill chunk and a training chunk of
    ``_chunk`` (2 updates) with QMIX's override draws (a random action
    and a uniform per agent, then the reset's draws, per step)."""
    je, jd, td, ta = _drivers("qmix")
    k0 = jax.random.PRNGKey(2)
    jts, jbuf, jrs = _jax_start(jd, jd.alg.init_state, k0)
    tts = convert.state_from_jax(ta, jax.device_get(jts))
    d = tp.ParticleDraws(4, qmix=True)
    d.reset(k0, E)
    k1, k2 = jax.random.PRNGKey(21), jax.random.PRNGKey(22)
    d.rollout(k1, E, SPT, True)
    d.rollout(k2, E, SPT, False)
    for k in jax.random.split(jax.random.fold_in(k2, 7), 2):
        d.update(k, B, 2 * SPT * E)
    draws = d.fed()
    trs = init_rollout(td.hooks, E, draws, KW["episode_log"])
    tbuf = td._replay_init(td.example_transition(trs))
    jts, jbuf, jrs, _ = jd._chunk_fill(jts, jbuf, jrs, EPS, k1)
    tts, tbuf, trs, _ = td._chunk(tts, tbuf, trs, EPS, draws, False, True)
    jts, jbuf, jrs, jm = jd._chunk_train(jts, jbuf, jrs, EPS, k2)
    tts, tbuf, trs, tm = td._chunk(tts, tbuf, trs, EPS, draws, True, False)
    assert not any(draws.remaining().values()), draws.remaining()
    _hold_rollout(jbuf, jrs, tbuf, trs)
    tp.hold_states(tts, convert.state_from_jax(ta, jax.device_get(jts)),
                   ta.net_names(), **tp.QMIX_TOL)
    assert tts.step == 2
    np.testing.assert_allclose(float(tm["loss_mixer"]),
                               float(jm["loss_mixer"]), rtol=RTOL)


def test_evaluate_matches_jax_with_the_reach_rate():
    """Greedy evaluation of 12 episodes on a two-agent scenario whose
    landmarks are the agents' starts (so some episodes end reached):
    per-agent and global returns, the action distribution and the
    reach rate."""
    cfg = dict(n_agents=2, agents_x=(-0.5, 0.5), agents_y=(0.0, 0.0),
               landmarks_x=(-0.5, 0.5), landmarks_y=(0.0, 0.0),
               prob_random=0.0, max_steps=6)
    from cm3_tpu.envs.particle import Particle as JaxParticle
    from cm3_tpu_torch.envs.particle import Particle as TorchParticle
    je = JaxParticle(jcfg.ParticleEnvConfig(**cfg))
    te = TorchParticle(tcfg.ParticleEnvConfig(**cfg), device="cpu")
    ja, ta = tp.particle_algs("cm3", je.spec())
    kw = dict(N_eval=12, max_steps=6)
    jd = JaxOnPolicy(jax_hooks("particle", je), ja, jcfg.TrainConfig(**kw))
    td = OnPolicyDriver(make_hooks("particle", te), ta,
                        tcfg.TrainConfig(**kw))
    batch = tp.particle_batch(je, 2, np.random.default_rng(0))
    jts = ja.init_state(jax.random.PRNGKey(3), batch["obs"], batch["state"],
                        batch["goals"])
    tts = convert.state_from_jax(ta, jax.device_get(jts))
    key = jax.random.PRNGKey(8)
    jl, jg, jaux = jax.jit(jd.evaluate, static_argnums=(2,))(jts, key, 12)
    d = tp.ParticleDraws(2)
    d.evaluate(key, 12, 6)
    draws = d.fed()
    tl, tg, taux = td.evaluate(tts, draws, 12)
    assert not any(draws.remaining().values())
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(float(tg), float(jg), rtol=RTOL, atol=ATOL)
    assert set(taux) == set(jaux) == {"act_dist", "eval_reach_rate"}
    np.testing.assert_allclose(taux["act_dist"].numpy(),
                               np.asarray(jaux["act_dist"]), rtol=RTOL,
                               atol=ATOL)
    assert float(taux["eval_reach_rate"]) == float(jaux["eval_reach_rate"])
    assert float(taux["eval_reach_rate"]) > 0.0
