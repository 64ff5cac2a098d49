"""The port's particle struct-of-arrays engine and fused rollout (plain
versions on the CPU) against ``cm3_tpu``: ``soa_step`` and ``soa_init``
against the JAX module run op by op, the plain rollout against the
Pallas kernel in interpret mode, the Philox variant against JAX in
distribution.  The CUDA kernel itself is held against the plain version
on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).

Tolerances.  Op by op, JAX and the port round every operation alike
(correctly rounded square roots; the same exp/log1p results on these
inputs), so ``soa_step`` is held to atol 2e-5 (JAX's own tolerance
between its SoA engine and its grid engine) and comes out equal.
Compiled XLA (the Pallas kernel in interpret mode) contracts ``a*b + c``
into fused multiply-adds and divides by a constant as a product with
its reciprocal, so the plain rollout is held to it at rtol 1e-5,
atol 1e-3, as JAX holds its kernel to its own scan."""

import dataclasses
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity
from cm3_tpu.core import config as jcfg
from cm3_tpu.envs import particle_soa as jps
from cm3_tpu.ops import particle_rollout as jpr
from cm3_tpu_torch import bench
from cm3_tpu_torch.core import config as tcfg
from cm3_tpu_torch.envs import particle_soa as tps
from cm3_tpu_torch.ops import _nvcc, philox
from cm3_tpu_torch.ops import particle_rollout as tpr

CFGS = {
    "n2": dict(n_agents=2, agents_x=(-0.9, 0.9), agents_y=(-0.9, 0.9),
               landmarks_x=(0.9, -0.9), landmarks_y=(0.9, -0.9),
               prob_random=0.0, initial_std=0.0),
    "n4": dict(prob_random=0.0, initial_std=0.0),
}
SOA_ATOL = 2e-5
KERNEL_RTOL, KERNEL_ATOL = 1e-5, 1e-3
# configs for the kernel's squared-distance thresholds: the default and
# the extremes of agent size and contact margin
THRESHOLD_CFGS = {
    "default": {}, "small_agents": dict(agent_size=0.05),
    "large_agents": dict(agent_size=0.3),
    "sharp_contact": dict(contact_margin=1e-4),
    "soft_contact": dict(contact_margin=1e-2),
}
WALK = 4096         # neighbouring float32 values on each side of a threshold


@pytest.fixture(autouse=True)
def _cpu():
    torch_parity.set_torch_cpu()


def _cfgs(name):
    return jcfg.ParticleEnvConfig(**CFGS[name]), \
        tcfg.ParticleEnvConfig(**CFGS[name])


def _close(jax_x, torch_x, atol):
    got, want = torch_x.numpy(), np.asarray(jax_x)
    assert got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


def test_config_matches_jax():
    """The port's ``ParticleEnvConfig`` has JAX's fields and defaults."""
    j, t = jcfg.ParticleEnvConfig(), tcfg.ParticleEnvConfig()
    assert dataclasses.asdict(t) == dataclasses.asdict(j)


@pytest.mark.parametrize("name", sorted(CFGS))
def test_soa_init_matches_jax(name):
    jc, tc = _cfgs(name)
    js, ts = jps.soa_init(jc, (3,)), tps.soa_init(tc, (3,), device="cpu")
    for field in jps.SoaState._fields:
        for a, b in zip(getattr(js, field), getattr(ts, field),
                        strict=True):
            _close(a, b, 0)


@pytest.mark.parametrize("name", sorted(CFGS))
def test_soa_step_matches_jax_op_by_op(name):
    """B = 256 instances, T = 80 fed steps (two episodes of 33 and part
    of a third, reset where done): done exactly, rewards and the state
    to SOA_ATOL, step by step."""
    jc, tc = _cfgs(name)
    n, b, t = jc.n_agents, 256, 80
    actions = np.random.default_rng(n).integers(0, 5, (t, n, b),
                                                dtype=np.int32)
    j0, t0 = jps.soa_init(jc, (b,)), tps.soa_init(tc, (b,), device="cpu")
    js, ts = j0, t0
    episodes = 0
    for k in range(t):
        js, jr, jd = jps.soa_step(jc, js, tuple(jnp.asarray(actions[k, i])
                                                for i in range(n)))
        ts, tr, td = tps.soa_step(tc, ts, tuple(torch.from_numpy(
            actions[k, i]) for i in range(n)))
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        for a, c in zip(jr, tr, strict=True):
            _close(a, c, SOA_ATOL)
        for field in ("px", "py", "vx", "vy"):
            for a, c in zip(getattr(js, field), getattr(ts, field)):
                _close(a, c, SOA_ATOL)
        done = np.asarray(jd)
        episodes += int(done.sum())
        js = jax.tree_util.tree_map(lambda i, c: jnp.where(done, i, c), j0, js)
        ts = tps.select(td, t0, ts)
    assert episodes == 2 * b


def test_rollout_actions_plain_matches_jax_kernel():
    """B = 1024, T = 70 fed actions, four agents, through JAX's Pallas
    kernel (interpret mode) and the port's plain version: episodes
    exactly, reward sums at rtol 1e-5, atol 1e-3."""
    jc, tc = _cfgs("n4")
    actions = np.random.default_rng(0).integers(0, 5, (70, 4, 1024),
                                                dtype=np.int32)
    j_rew, j_ep = jpr.rollout_actions(jc, jnp.asarray(actions), sub=8,
                                      interpret=True)
    t_rew, t_ep = tpr.rollout_actions(tc, torch.from_numpy(actions))
    assert t_rew.dtype == torch.float32 and t_ep.dtype == torch.int32
    np.testing.assert_array_equal(t_ep.numpy(), np.asarray(j_ep))
    np.testing.assert_allclose(t_rew.numpy(), np.asarray(j_rew),
                               rtol=KERNEL_RTOL, atol=KERNEL_ATOL)


def test_prng_actions_of_four_agents_are_uniform():
    """About 2 x 10^6 draws (B = 4096, T = 128, four agents: all four
    Philox words): each action's share lies within 0.005 of 0.2, for
    every agent."""
    counts = torch.zeros(4, 5, dtype=torch.int64)
    for t in range(128):
        for i, a in enumerate(philox.random_actions(99, t, 4096, 4, "cpu")):
            counts[i] += torch.bincount(a, minlength=5)
    share = counts.double() / counts.sum(1, keepdim=True)
    assert int(counts.sum()) == 4 * 4096 * 128
    assert float((share - 0.2).abs().max()) < 0.005, share


def test_prng_rollout_matches_jax_in_distribution():
    """The Philox variant (plain) against JAX's kernel fed numpy-uniform
    actions at the same B = 2048 and T = 70: the means of the reward
    sum and of the episode count per instance lie within 4 standard
    errors of each other (at T = 70 every instance ends 2 episodes at
    the cap of 33, so the episode means must be equal)."""
    b, t = 2048, 70
    jc, tc = _cfgs("n4")
    t_rew, t_ep = tpr.rollout_prng(tc, b, t, seed=5, device="cpu")
    actions = np.random.default_rng(5).integers(0, 5, (t, 4, b),
                                                dtype=np.int32)
    j_rew, j_ep = jpr.rollout_actions(jc, jnp.asarray(actions), sub=8,
                                      interpret=True)
    for mine, ref in ((t_rew.numpy(), np.asarray(j_rew)),
                      (t_ep.numpy(), np.asarray(j_ep))):
        mine, ref = mine.astype(np.float64), ref.astype(np.float64)
        se = np.sqrt(mine.var() / b + ref.var() / b)
        assert abs(mine.mean() - ref.mean()) <= 4 * se, (mine.mean(),
                                                        ref.mean(), se)


def test_wrappers_on_cpu_are_the_plain_versions():
    _, tc = _cfgs("n2")
    rew, ep = tpr.rollout_prng(tc, 100, 40, seed=3, device="cpu")
    p_rew, p_ep = tpr.rollout_prng_plain(tc, 100, 40, 3, device="cpu")
    assert torch.equal(rew, p_rew) and torch.equal(ep, p_ep)
    assert bool((ep == 1).all())               # 40 steps, cap 33
    acts = torch.randint(0, 5, (40, 2, 100), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(0))
    rew, ep = tpr.rollout_actions(tc, acts)
    p_rew, p_ep = tpr.rollout_actions_plain(tc, acts)
    assert torch.equal(rew, p_rew) and torch.equal(ep, p_ep)


def test_observe_sees_every_step_and_changes_nothing():
    """The plain version's observer sees the state before each step,
    the reset state first, and leaves the outputs as they were."""
    _, tc = _cfgs("n4")
    seen = []
    rew, ep = tpr.rollout_prng_plain(tc, 50, 40, 3, device="cpu",
                                     observe=seen.append)
    p_rew, p_ep = tpr.rollout_prng_plain(tc, 50, 40, 3, device="cpu")
    assert torch.equal(rew, p_rew) and torch.equal(ep, p_ep)
    assert len(seen) == 40
    s0 = tps.soa_init(tc, (50,), device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(seen[0].px, s0.px))
    assert not torch.equal(seen[1].px[0], s0.px[0])


def test_meta_device_raises():
    _, tc = _cfgs("n4")
    before = (tpr.rollout_prng.launches, tpr.rollout_actions.launches)
    with pytest.raises(RuntimeError, match="no kernel"):
        tpr.rollout_prng(tc, 8, 4, seed=0, device="meta")
    acts = torch.zeros((4, 4, 8), dtype=torch.int32, device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        tpr.rollout_actions(tc, acts)
    assert (tpr.rollout_prng.launches,
            tpr.rollout_actions.launches) == before


def test_agent_counts_outside_the_kernel_raise():
    tc = tcfg.ParticleEnvConfig(n_agents=3)
    with pytest.raises(ValueError, match="agents"):
        tpr.rollout_prng(tc, 8, 4, seed=0, device="cpu")
    with pytest.raises(ValueError, match="agents"):
        tpr.rollout_actions(tc, torch.zeros((4, 3, 8), dtype=torch.int32))
    with pytest.raises(ValueError, match="agents"):
        tpr.params(tc)


@pytest.mark.parametrize("name", sorted(CFGS))
def test_params_follow_the_source_enum(name):
    """The wrapper packs the parameters in the order of
    ``ParticleParam`` in ``csrc/particle_rollout.cu``, which the C entry
    reads by index, with the reset state of ``soa_init``."""
    src = open(os.path.join(_nvcc.CSRC, "particle_rollout.cu")).read()
    enum = re.search(r"enum ParticleParam \{([^}]*)\}", src).group(1)
    names = [w.split("=")[0].strip() for w in enum.split(",") if w.strip()]
    assert names[-1] == "kNumParams"
    _, tc = _cfgs(name)
    got = tpr.params(tc)
    m, n = tpr.MAX_AGENTS, tc.n_agents
    scalars = names[:names.index("kInitPx")]
    want = dict(kDt=tc.dt, kKeep=1.0 - tc.damping, kAccel=tc.accel,
                kContactForce=tc.contact_force, kMargin=tc.contact_margin,
                kDmin=2 * tc.agent_size, kReach=tps.REACH,
                kFarD2=float(tpr.far_d2(tc)),
                kHitD2=float(tpr.hit_d2(2 * tc.agent_size)))
    assert list(got[:len(scalars)]) == [want[k] for k in scalars]
    fields = names[len(scalars):-1]
    assert fields == ["kInitPx", "kInitPy", "kInitVx", "kInitVy", "kLx",
                      "kLy"]
    assert len(got) == len(scalars) + len(fields) * m
    init = dict(kInitPx=tc.agents_x, kInitPy=tc.agents_y,
                kInitVx=(0.0,) * n, kInitVy=(0.0,) * n,
                kLx=tc.landmarks_x, kLy=tc.landmarks_y)
    for f, field in enumerate(fields):
        block = got[len(scalars) + f * m:len(scalars) + (f + 1) * m]
        assert list(block) == [float(np.float32(v))
                               for v in init[field][:n]] \
            + [0.0] * (m - n)


def test_bench_function_runs_small_on_cpu():
    assert bench.bench_particle_fused(batch=64, steps=40, reps=1,
                                      device="cpu") > 0



def _walk(threshold):
    """The 2 x WALK float32 values around ``threshold`` (WALK below it,
    the threshold and WALK - 1 above), through their bit patterns."""
    bits = int(np.float32(threshold).view(np.int32))
    return torch.arange(bits - WALK, bits + WALK,
                        dtype=torch.int32).view(torch.float32)


@pytest.mark.parametrize("name", sorted(THRESHOLD_CFGS))
def test_hit_d2_is_the_collision_test_without_its_root(name):
    """``d2 < hit_d2`` <=> ``sqrt(d2) < dmin`` (the plain version's
    test) on the floats around the threshold, and at 0 and +inf."""
    tc = tcfg.ParticleEnvConfig(**THRESHOLD_CFGS[name])
    dmin = 2 * tc.agent_size
    t = tpr.hit_d2(dmin)
    d2 = torch.cat([_walk(t), torch.tensor([0.0, float("inf")])])
    assert torch.equal(d2 < float(t), tps.sqrt(d2) < dmin)
    assert bool((d2[:WALK] < float(t)).all())
    assert not bool((d2[WALK:2 * WALK] < float(t)).any())


@pytest.mark.parametrize("name", sorted(THRESHOLD_CFGS))
def test_far_d2_leaves_no_contact_force(name):
    """From ``far_d2`` on, the plain contact formula (``soa_step``'s,
    with ``particle_soa.logaddexp0``) gives ``pen == 0`` and force terms
    ``dx * scale == 0`` exactly, for dx up to the distance itself: on the
    floats above the threshold and on a sweep to d2 = 1e4.  Just below
    it, z is still above ``FAR_Z``: the threshold is the least such."""
    tc = tcfg.ParticleEnvConfig(**THRESHOLD_CFGS[name])
    k = torch.full((), tc.contact_margin, dtype=torch.float32)
    dmin = 2 * tc.agent_size
    t = tpr.far_d2(tc)
    walk = _walk(t)
    far = torch.cat([walk[WALK:], torch.logspace(
        np.log10(float(t)), 4, 2000, dtype=torch.float32)])
    far = far[far >= float(t)]
    dist = tps.sqrt(far)
    pen = tps.logaddexp0(-(dist - dmin) / k) * tc.contact_margin
    scale = tc.contact_force * pen / dist
    assert bool((pen == 0).all())
    for dx in (dist, -dist, 0.5 * dist):
        assert bool((dx * scale == 0).all())
    near = walk[:WALK]
    assert bool((-(tps.sqrt(near) - dmin) / k > tpr.FAR_Z).all())
