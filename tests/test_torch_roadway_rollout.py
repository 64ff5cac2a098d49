"""The port's roadway struct-of-arrays engine and fused rollout (plain
versions on the CPU) against ``cm3_tpu``: ``soa_check_actions``,
``soa_step`` and ``soa_init`` against the JAX module run op by op, the
plain rollout against the same functions' rollout and against the
Pallas kernel in interpret mode, the Philox variant against JAX in
distribution.  The CUDA kernel itself is held against the plain version
on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).

Tolerances.  The step has no transcendental, and op by op JAX rounds
every operation as the port does, so everything is held exactly.
Compiled XLA (the Pallas kernel in interpret mode, or the JAX step
under ``jit``) contracts ``a*b + c`` into fused multiply-adds (``x +
v*dt``, ``vel + dt*acc``, the lateral position) and divides by a
constant as a product with its reciprocal.  A position then differs by
an ulp, and where it sits on a threshold (ttc <= 2 s, the goal line) an
instance's trajectory changes: the kernel in interpret mode differs
from JAX's own op-by-op rollout on a few instances of a thousand.  So
the port is held to the Pallas kernel exactly on every instance where
the kernel agrees with JAX's op-by-op rollout, and those are at least
99% of the instances."""

import dataclasses
import functools
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity
from cm3_tpu.core import config as jcfg
from cm3_tpu.envs import roadway_soa as jrs
from cm3_tpu.ops import roadway_rollout as jrr
from cm3_tpu_torch import bench
from cm3_tpu_torch.core import config as tcfg
from cm3_tpu_torch.envs import roadway_soa as trs
from cm3_tpu_torch.ops import _nvcc
from cm3_tpu_torch.ops import roadway_rollout as trr

CFGS = {
    "flat": dict(depart_stdev=0.0),
    "stagger": dict(depart_stdev=0.0, depart_mean=(0.0, 1.0),
                    speed=(30.0, 25.0)),
    "one_car": dict(n_agents=1, goal_lane=(3,), goal_pos=(190.0,),
                    speed=(30.0,), lane=(1,), init_position=(0.0,),
                    depart_mean=(0.0,), depart_stdev=0.0),
}
B, T = 1024, 80


@pytest.fixture(autouse=True)
def _cpu():
    torch_parity.set_torch_cpu()


def _cfgs(name):
    return jcfg.RoadwayEnvConfig(**CFGS[name]), \
        tcfg.RoadwayEnvConfig(**CFGS[name])


def _equal(jax_x, torch_x):
    got, want = torch_x.numpy(), np.asarray(jax_x)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def _actions(seed, t, n, b):
    return np.random.default_rng(seed).integers(0, 5, (t, n, b),
                                                dtype=np.int32)


@pytest.mark.parametrize("name", sorted(CFGS))
def test_config_matches_jax(name):
    """The port's ``RoadwayEnvConfig`` has JAX's fields, defaults and
    derived sizes."""
    j, t = _cfgs(name)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    for prop in ("n_sublanes", "max_step", "obs_rows", "obs_cols", "n_rows",
                 "n_cols"):
        assert getattr(t, prop) == getattr(j, prop), prop


@pytest.mark.parametrize("name", sorted(CFGS))
def test_soa_init_matches_jax(name):
    """Field by field, with the populating NOOP step: exactly."""
    jc, tc = _cfgs(name)
    js, ts = jrs.soa_init(jc, (3,)), trs.soa_init(tc, (3,), device="cpu")
    for field in jrs.SoaState._fields:
        for a, b in zip(getattr(js, field), getattr(ts, field),
                        strict=True):
            _equal(a, b)


@pytest.mark.parametrize("name", ["flat", "stagger"])
def test_soa_step_matches_jax_op_by_op(name):
    """B = 256 instances, T = 100 fed steps (several episodes, reset
    where done): the checked actions, rewards, done and every state
    field exactly, step by step."""
    jc, tc = _cfgs(name)
    b, t = 256, 100
    actions = _actions(1, t, 2, b)
    j0, t0 = jrs.soa_init(jc, (b,)), trs.soa_init(tc, (b,), device="cpu")
    js, ts = j0, t0
    episodes = 0
    for k in range(t):
        ja = jrs.soa_check_actions(jc, js, (jnp.asarray(actions[k, 0]),
                                            jnp.asarray(actions[k, 1])))
        ta = trs.soa_check_actions(tc, ts, (torch.from_numpy(actions[k, 0]),
                                            torch.from_numpy(actions[k, 1])))
        for a, c in zip(ja, ta, strict=True):
            _equal(a, c)
        js, jr, jd = jrs.soa_step(jc, js, ja)
        ts, tr, td = trs.soa_step(tc, ts, ta)
        _equal(jd, td)
        for a, c in zip(jr, tr, strict=True):
            _equal(a, c)
        for field in jrs.SoaState._fields:
            for a, c in zip(getattr(js, field), getattr(ts, field)):
                _equal(a, c)
        done = np.asarray(jd)
        episodes += int(done.sum())
        js = jax.tree_util.tree_map(lambda i, c: jnp.where(done, i, c), j0, js)
        ts = trs.select(td, t0, ts)
    assert episodes >= 2 * b


@functools.cache
def _jax_rollouts(seed):
    """JAX's rollout of the fed actions of ``seed`` (default config,
    B x T), twice: op by op (eager ``soa_check_actions`` + ``soa_step``
    + the done select), and through the Pallas kernel in interpret
    mode.  Returns numpy (eager_rew, eager_ep, kernel_rew, kernel_ep)."""
    jc, _ = _cfgs("flat")
    actions = _actions(seed, T, 2, B)
    s0 = jrs.soa_init(jc, (B,))
    s, rew, ep = s0, jnp.zeros(B, jnp.float32), jnp.zeros(B, jnp.int32)
    for k in range(T):
        acts = jrs.soa_check_actions(jc, s, (jnp.asarray(actions[k, 0]),
                                             jnp.asarray(actions[k, 1])))
        s, rws, done = jrs.soa_step(jc, s, acts)
        rew = rew + functools.reduce(jnp.add, rws)
        s = jax.tree_util.tree_map(lambda i, c: jnp.where(done, i, c), s0, s)
        ep = ep + done.astype(jnp.int32)
    k_rew, k_ep = jrr.rollout_actions(jc, jnp.asarray(actions), sub=8,
                                      interpret=True)
    return tuple(np.asarray(x) for x in (rew, ep, k_rew, k_ep))


@pytest.mark.parametrize("seed", [0, 3])
def test_rollout_actions_plain_matches_jax_op_by_op(seed):
    """B = 1024, T = 80 fed actions: the port's plain rollout equals
    JAX's op-by-op rollout exactly, reward sums and episodes."""
    _, tc = _cfgs("flat")
    t_rew, t_ep = trr.rollout_actions(tc, torch.from_numpy(
        _actions(seed, T, 2, B)))
    e_rew, e_ep, _, _ = _jax_rollouts(seed)
    assert t_rew.dtype == torch.float32 and t_ep.dtype == torch.int32
    np.testing.assert_array_equal(t_ep.numpy(), e_ep)
    np.testing.assert_array_equal(t_rew.numpy(), e_rew)
    assert int(e_ep.sum()) > B


@pytest.mark.parametrize("seed", [0, 3])
def test_rollout_actions_plain_matches_jax_kernel(seed):
    """The same actions through JAX's Pallas kernel (interpret mode):
    reward sums and episodes equal exactly on every instance where the
    kernel agrees with JAX's op-by-op rollout (the others differ by
    XLA's fused multiply-adds, see the module note), and those are at
    least 99% of the instances."""
    _, tc = _cfgs("flat")
    t_rew, t_ep = trr.rollout_actions(tc, torch.from_numpy(
        _actions(seed, T, 2, B)))
    e_rew, e_ep, k_rew, k_ep = _jax_rollouts(seed)
    same = (k_rew == e_rew) & (k_ep == e_ep)
    assert same.mean() >= 0.99, int((~same).sum())
    np.testing.assert_array_equal(t_ep.numpy()[same], k_ep[same])
    np.testing.assert_array_equal(t_rew.numpy()[same], k_rew[same])


def test_prng_rollout_matches_jax_in_distribution():
    """The Philox variant (plain) against JAX's kernel fed numpy-uniform
    actions at the same B = 2048 and T = 80: the means of the reward
    sum and of the episode count per instance lie within 4 standard
    errors of each other."""
    b = 2048
    jc, tc = _cfgs("flat")
    t_rew, t_ep = trr.rollout_prng(tc, b, T, seed=5, device="cpu")
    j_rew, j_ep = jrr.rollout_actions(jc, jnp.asarray(_actions(5, T, 2, b)),
                                      sub=8, interpret=True)
    for mine, ref in ((t_rew.numpy(), np.asarray(j_rew)),
                      (t_ep.numpy(), np.asarray(j_ep))):
        mine, ref = mine.astype(np.float64), ref.astype(np.float64)
        se = np.sqrt(mine.var() / b + ref.var() / b)
        assert abs(mine.mean() - ref.mean()) <= 4 * se, (mine.mean(),
                                                        ref.mean(), se)


def test_wrappers_on_cpu_are_the_plain_versions():
    _, tc = _cfgs("stagger")
    rew, ep = trr.rollout_prng(tc, 100, 90, seed=3, device="cpu")
    p_rew, p_ep = trr.rollout_prng_plain(tc, 100, 90, 3, device="cpu")
    assert torch.equal(rew, p_rew) and torch.equal(ep, p_ep)
    assert bool((ep >= 2).all())               # 90 steps, max_step 40
    acts = torch.randint(0, 5, (90, 2, 100), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(0))
    rew, ep = trr.rollout_actions(tc, acts)
    p_rew, p_ep = trr.rollout_actions_plain(tc, acts)
    assert torch.equal(rew, p_rew) and torch.equal(ep, p_ep)


def test_observe_sees_every_step_and_changes_nothing():
    """The plain version's observer sees every step: the state before
    it, the drawn and the filtered actions, and the state after it
    before the reset; the outputs stay as they were."""
    _, tc = _cfgs("stagger")
    seen = []
    rew, ep = trr.rollout_prng_plain(
        tc, 50, 90, 3, device="cpu",
        observe=lambda *args: seen.append(args))
    p_rew, p_ep = trr.rollout_prng_plain(tc, 50, 90, 3, device="cpu")
    assert torch.equal(rew, p_rew) and torch.equal(ep, p_ep)
    assert len(seen) == 90
    for s, drawn, taken, s2 in seen[:5]:
        want = trs.soa_check_actions(tc, s, drawn)
        assert all(torch.equal(a, b) for a, b in zip(taken, want))
        nxt, _, _ = trs.soa_step(tc, s, taken)
        assert all(torch.equal(a, b) for a, b in zip(s2.x, nxt.x))


def test_meta_device_raises():
    _, tc = _cfgs("flat")
    before = (trr.rollout_prng.launches, trr.rollout_actions.launches)
    with pytest.raises(RuntimeError, match="no kernel"):
        trr.rollout_prng(tc, 8, 4, seed=0, device="meta")
    acts = torch.zeros((4, 2, 8), dtype=torch.int32, device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        trr.rollout_actions(tc, acts)
    assert (trr.rollout_prng.launches,
            trr.rollout_actions.launches) == before


def test_car_counts_outside_the_kernel_raise():
    tc = tcfg.RoadwayEnvConfig(n_agents=3, goal_lane=(3, 0, 1),
                               goal_pos=(190.0,) * 3, speed=(30.0,) * 3,
                               lane=(1, 2, 3), init_position=(0.0,) * 3,
                               depart_mean=(0.0,) * 3, depart_stdev=0.0)
    with pytest.raises(ValueError, match="cars"):
        trr.rollout_prng(tc, 8, 4, seed=0, device="cpu")
    with pytest.raises(ValueError, match="cars"):
        trr.rollout_actions(tc, torch.zeros((4, 3, 8), dtype=torch.int32))
    with pytest.raises(ValueError, match="cars"):
        trr.params(tc)


def _enum(src, name):
    body = re.search(r"enum " + name + r" \{([^}]*)\}", src).group(1)
    return [w.split("=")[0].strip() for w in body.split(",") if w.strip()]


@pytest.mark.parametrize("name", ["stagger", "one_car"])
def test_params_follow_the_source_enums(name):
    """The wrapper packs floats and ints in the order of ``RoadwayFloat``
    and ``RoadwayInt`` in ``csrc/roadway_rollout.cu``, which the C entry
    reads by index, with the reset state of ``soa_init``."""
    src = open(os.path.join(_nvcc.CSRC, "roadway_rollout.cu")).read()
    fnames, inames = _enum(src, "RoadwayFloat"), _enum(src, "RoadwayInt")
    _, tc = _cfgs(name)
    floats, ints = trr.params(tc)
    s0 = trs.soa_init(tc, (), device="cpu")
    m, n = trr.MAX_CARS, tc.n_agents
    per_car = lambda xs: [xs[i] for i in range(n)] + [0] * (m - n)
    f32 = lambda xs: [float(np.float32(float(x))) for x in xs]
    want_f = dict(
        kDt=[tc.dt], kAccVal=[tc.acc_val], kDecVal=[tc.dec_val],
        kVMax=[tc.v_max], kVMin=[tc.v_min], kCarLength=[tc.car_length],
        kCarWidth=[tc.car_width], kTtcThres=[tc.ttc_thres],
        kSublaneRes=[tc.sublane_res], kTotalWidth=[tc.total_width],
        kTotalLength=[tc.total_length], kNearLo=[-tc.res_forward / 2],
        kNearHi=[1.5 * tc.res_forward], kOverspeed=[tc.overspeed],
        kNSublanesF=[float(tc.n_sublanes)], kGoalPos=per_car(tc.goal_pos),
        kInitX=f32(per_car(s0.x)), kInitVel=f32(per_car(s0.vel)))
    goal_sub = [tc.goal_lane[i] * tc.sublanes_per_lane
                + tc.sublanes_per_lane // 2 for i in range(n)]
    want_i = dict(kNSublanes=[tc.n_sublanes], kMaxStep=[tc.max_step],
                  kGoalSub=per_car(goal_sub),
                  kInitSub=[int(x) for x in per_car(s0.sub)],
                  kInitSteps=[int(x) for x in per_car(s0.steps)],
                  kInitRem=[int(x) for x in per_car(s0.rem)])
    for names, got, want, last in ((fnames, floats, want_f, "kNumFloats"),
                                   (inames, ints, want_i, "kNumInts")):
        assert names[-1] == last and sorted(names[:-1]) == sorted(want)
        assert list(got) == [v for k in names[:-1] for v in want[k]]


def test_bench_function_runs_small_on_cpu():
    assert bench.bench_roadway_fused(batch=64, steps=50, reps=1,
                                     device="cpu") > 0

