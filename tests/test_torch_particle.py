"""The port's particle engine (``cm3_tpu_torch.envs.particle``) and hooks
against ``cm3_tpu``: the configs, the reset from JAX's draws (the
branch, the uniform positions, the start noise) and every step after it
for the three shipped scenarios, the auto-reset through the hooks, the
routing predicate and the evaluation's reach rate; and the engine
against the port's own struct-of-arrays step (``envs/particle_soa.py``),
as ``tests/test_particle_rollout_kernel.py`` holds JAX's engines.

Tolerances.  Run op by op (``jax.disable_jit``), JAX rounds every
operation as the port does, and the engine is held to it at atol 1e-20:
measured equal but for the contact terms of pairs far outside the
margin, which are below 1e-18 and can be an ulp apart (XLA's CPU exp
and log1p are other implementations than PyTorch's, and XLA flushes
subnormals to zero; measured 1.3e-26 on one velocity of ~1e-19).
Compiled XLA contracts ``a*b + c`` into fused multiply-adds, so against
the jitted engine the floats are held at atol 1e-5 over 40 steps
(measured up to 1.5e-6), the flags and counters exactly.  The SoA step
sums the contact force in another order (its scale ``c * pen / dist``
first), so it is held at JAX's own tolerance between its two engines,
atol 2e-5."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cm3_tpu.core import config as jcfg
from cm3_tpu.train.experiments import make_hooks as jax_hooks
from cm3_tpu_torch.core import config as tcfg
from cm3_tpu_torch.core import prng
from cm3_tpu_torch.envs import particle_soa as tps
from cm3_tpu_torch.train.experiments import make_hooks
from tests import torch_parity as tp

tp.set_torch_cpu()

SCENARIOS = ["stage1", "stage2_antipodal", "stage2_merge", "stage2_cross"]
E, T = 16, 40
OP_ATOL, JIT_ATOL = 1e-20, 1e-5


def test_configs_match_jax():
    """``particle_env_config`` of every shipped scenario and the generic
    ``NNConfig`` widths equal JAX's."""
    for name in SCENARIOS:
        for kw in ({}, dict(prob_random=0.5, max_steps=7)):
            assert dataclasses.asdict(tcfg.particle_env_config(name, **kw)) \
                == dataclasses.asdict(jcfg.particle_env_config(name, **kw))
    assert dataclasses.asdict(tcfg.NNConfig()) == dataclasses.asdict(
        jcfg.NNConfig())


def _trajectories(name, jit, steps=T, seed=0):
    """E instances reset from JAX's draws, then ``steps`` steps of the
    same random actions in both engines; per step (JAX's, the port's)
    (state, timestep)."""
    je, te = tp.particle_envs(name, prob_random=0.5, max_steps=100)
    n = te.cfg.n_agents
    key = jax.random.PRNGKey(seed)
    keys = jax.vmap(lambda i: jax.random.fold_in(key, i))(jnp.arange(E))
    reset, step = jax.vmap(je.reset), jax.vmap(je.step)
    if jit:
        reset, step = jax.jit(reset), jax.jit(step)
    js, jts = reset(keys)
    u, z = tp.particle_reset_draws(key, E, n)
    draws = prng.FedDraws(device="cpu", uniforms=u, normals=z)
    ts_, tts = te.reset(te.draw_reset((E,), draws))
    assert draws.remaining() == {"randint": 0, "gumbel": 0, "uniform": 0,
                                 "normal": 0}
    out = [((js, jts), (ts_, tts))]
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        a = rng.integers(0, 5, (E, n))
        js, jts = step(js, jnp.asarray(a, jnp.int32))
        ts_, tts = te.step(ts_, torch.from_numpy(a))
        out.append(((js, jts), (ts_, tts)))
    return out


def _hold(want, got, atol):
    (js, jts), (ts_, tts) = want, got
    for f in ("pos", "vel", "landmarks"):
        np.testing.assert_allclose(getattr(ts_, f).numpy(),
                                   np.asarray(getattr(js, f)), rtol=0,
                                   atol=atol, err_msg=f)
    for f in ("reached", "steps", "collisions"):
        np.testing.assert_array_equal(getattr(ts_, f).numpy(),
                                      np.asarray(getattr(js, f)), f)
    for part in ("obs", "state"):
        for k, v in getattr(jts, part).items():
            np.testing.assert_allclose(getattr(tts, part)[k].numpy(),
                                       np.asarray(v), rtol=0, atol=atol,
                                       err_msg=f"{part}.{k}")
    for f in ("reward", "reward_local"):
        np.testing.assert_allclose(getattr(tts, f).numpy(),
                                   np.asarray(getattr(jts, f)), rtol=0,
                                   atol=atol, err_msg=f)
    np.testing.assert_array_equal(tts.done.numpy(), np.asarray(jts.done))


@pytest.mark.parametrize("name", SCENARIOS)
def test_engine_matches_jax_op_by_op(name):
    """Reset and 40 steps equal JAX's engine run op by op (atol 1e-20):
    positions, velocities, landmarks, reach flags, step and collision
    counts, observations, global state, rewards and done.  Half the
    instances start uniform-random (prob_random 0.5), so starts in
    contact range occur; stage2_merge adds start noise (std 0.05)."""
    with jax.disable_jit():
        traj = _trajectories(name, jit=False)
    for want, got in traj:
        _hold(want, got, atol=OP_ATOL)
    coll = traj[-1][1][0].collisions
    assert int(coll.sum()) > 0 or name == "stage1"


@pytest.mark.parametrize("name", ["stage1", "stage2_antipodal"])
def test_engine_matches_jitted_jax(name):
    """The same against JAX's compiled engine, at atol 1e-5 (fused
    multiply-adds move the floats by ulps); flags and counts exactly."""
    for want, got in _trajectories(name, jit=True, seed=1):
        _hold(want, got, atol=JIT_ATOL)


def test_reset_branches_and_noise():
    """The branch draw picks uniform starts below prob_random, else the
    config's positions plus initial_std times the noise (stage2_merge);
    zero velocity, nothing reached, counters 0."""
    _, te = tp.particle_envs("stage2_merge", prob_random=0.5)
    b = torch.tensor([0.2, 0.7])
    pts = torch.full((2, 2, 2), 0.25)
    noise = torch.ones((2, 2, 2))
    s, ts = te.reset(dict(branch=b, agents=pts, landmarks=-pts, noise=noise))
    assert torch.equal(s.pos[0], pts[0]) and torch.equal(s.landmarks[0],
                                                         -pts[0])
    cfg = te.cfg
    want = torch.tensor(list(zip(cfg.agents_x, cfg.agents_y))) + 0.05
    assert torch.allclose(s.pos[1], want)
    assert torch.equal(s.landmarks[1], torch.tensor(
        list(zip(cfg.landmarks_x, cfg.landmarks_y))))
    assert not s.vel.any() and not s.reached.any() and not s.steps.any()
    assert ts.obs["self_v"].shape == (2, 2, 4)
    assert ts.obs["others"].shape == (2, 2, 4)


@pytest.mark.parametrize("name", ["stage1", "stage2_antipodal"])
def test_engine_matches_soa_step(name):
    """The engine against ``particle_soa.soa_step`` on the same actions
    from the configured start: rewards at atol 2e-5, done and the
    collision counts exactly."""
    _, te = tp.particle_envs(name, prob_random=0.0, max_steps=100)
    cfg = dataclasses.replace(te.cfg, initial_std=0.0)
    n, b = cfg.n_agents, 64
    zeros = torch.zeros((b, n, 2))
    s, _ = te.reset(dict(branch=torch.ones(b), agents=zeros,
                         landmarks=zeros, noise=zeros))
    soa = tps.soa_init(cfg, (b,), device="cpu")
    rng = np.random.default_rng(3)
    for _ in range(T):
        a = torch.from_numpy(rng.integers(0, 5, (b, n)))
        s, ts = te.step(s, a)
        soa, rews, done = tps.soa_step(cfg, soa, tuple(a[:, i]
                                                       for i in range(n)))
        np.testing.assert_allclose(ts.reward_local.numpy(),
                                   torch.stack(rews, -1).numpy(), rtol=0,
                                   atol=2e-5)
        assert torch.equal(ts.done, done)
        assert torch.equal(s.collisions, soa.coll[0].long())


def test_hooks_match_jax():
    """``ParticleHooks``: goals are the reset's landmarks, fresh episodes
    for an (S, E) shape, the routing predicate (collisions != 0) and the
    evaluation's reach-rate accumulators against JAX's hooks."""
    je, te = tp.particle_envs("stage2_antipodal", prob_random=0.5)
    jh, th = jax_hooks("particle", je), make_hooks("particle", te)
    assert not th.has_a_prev
    key = jax.random.PRNGKey(4)
    keys = jax.vmap(lambda i: jax.random.fold_in(key, i))(jnp.arange(E))
    js, jts, jg = jax.vmap(jh.episode_init)(keys)
    u, z = tp.particle_reset_draws(key, E, 4)
    s, ts, g = th.episode_init(E, prng.FedDraws(device="cpu", uniforms=u,
                                                normals=z))
    np.testing.assert_array_equal(g.numpy(), np.asarray(jg))
    assert torch.equal(g, s.landmarks)
    # push the instances together so that some collide, then compare
    rng = np.random.default_rng(0)
    acc_j, acc_t = jh.eval_metrics_init(), th.eval_metrics_init(())
    alive = np.ones(E, bool)
    for _ in range(12):
        a = rng.integers(0, 5, (E, 4))
        js, jts = jax.vmap(je.step)(js, jnp.asarray(a, jnp.int32))
        s, ts = te.step(s, torch.from_numpy(a))
        np.testing.assert_array_equal(
            th.is_bad_episode(s, ts.reward_local).numpy(),
            np.asarray(jax.vmap(jh.is_bad_episode)(js, jts.reward_local)))
        acc_j = jh.eval_metrics_step(acc_j, js, jts, jnp.asarray(alive))
        acc_t = th.eval_metrics_step(acc_t, s, ts, torch.from_numpy(alive))
        alive = alive & ~np.asarray(jts.done)
    assert bool(th.is_bad_episode(s, ts.reward_local).any())
    fin_j, fin_t = jh.eval_metrics_final(acc_j, E), th.eval_metrics_final(
        acc_t, E)
    assert set(fin_t) == set(fin_j) == {"eval_reach_rate"}
    np.testing.assert_allclose(float(fin_t["eval_reach_rate"]),
                               float(fin_j["eval_reach_rate"]), rtol=1e-6)
    # seeds: an (S, E) shape of fresh episodes
    draws = prng.GeneratorDraws(prng.generator(0, "cpu"))
    s2, ts2, g2 = th.episode_init((3, 5), draws)
    assert g2.shape == (3, 5, 4, 2) and ts2.obs["others"].shape == (3, 5, 4,
                                                                   12)
    assert s2.pos.shape == (3, 5, 4, 2) and s2.steps.shape == (3, 5)


def test_reset_needs_a_draw_source():
    _, te = tp.particle_envs("stage1")
    with pytest.raises(ValueError, match="draw source"):
        make_hooks("particle", te).episode_init(4)
