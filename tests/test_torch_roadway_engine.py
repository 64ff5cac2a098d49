"""The port's batched roadway engine (``cm3_tpu_torch.envs.roadway``) and
``RoadwayHooks`` against ``cm3_tpu``: the configs, the reset from JAX's
depart noise and every filtered step after it, at one and two cars;
the filter and the step against the port's struct-of-arrays engine
(``envs/roadway_soa.py``) and the C++ golden engine
(``native/libroadway_golden.so``, loaded with ctypes, not rebuilt); the
hooks' reset from JAX's draws, the routing predicate and the traffic
metrics.

Tolerances.  Run op by op (``jax.disable_jit``), JAX rounds every
operation as the port does, and the engine is held to it exactly:
positions, speeds, observations, global state, rewards, flags.  Compiled
XLA divides by a constant as a product with its reciprocal and contracts
``x + v*dt``, so against the jitted engine each float may be off by a
few ulps (counted: every difference is held to 2 ulps of the larger of
the two values and the quantity's unit, 1 for the normalized
observations and global state, whose coordinates are differences
scaled to [-1, 1], and 10 for rewards); a grid cell or a head-start step whose ``round()`` argument sits
on a half-integer could flip, and each such cell is traced to its
argument (none occurs at these seeds).  The golden engine computes in
float64: held at its own test's tolerances (``tests/test_roadway.py``).
"""

import ctypes
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cm3_tpu.core import config as jcfg
from cm3_tpu.envs.base import TimeStep as JaxTimeStep
from cm3_tpu.train.experiments import make_hooks as jax_hooks
from cm3_tpu_torch.core import config as tcfg
from cm3_tpu_torch.core import prng
from cm3_tpu_torch.envs import roadway_soa as soa
from cm3_tpu_torch.envs.roadway import Roadway, RoadwayState
from cm3_tpu_torch.train.experiments import make_hooks
from tests import torch_parity as tp

tp.set_torch_cpu()

E, T = 16, 42
FLOATS = ("x", "vel")
FLAGS = ("sublane", "steps", "goal_lane", "terminal", "collided", "removed")
LIB = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "native", "libroadway_golden.so")


def test_configs_match_jax():
    """``roadway_env_config`` of both stages (``save_threshold`` from
    the JSON) equals JAX's, and the spec is JAX's."""
    for stage in (1, 2):
        for p in (0.2, 1.0):
            assert dataclasses.asdict(tcfg.roadway_env_config(stage, p)) \
                == dataclasses.asdict(jcfg.roadway_env_config(stage, p))
        je, te = tp.roadway_envs(stage)
        assert te.spec() == je.spec()
    assert tcfg.roadway_env_config(1).save_threshold == 9.5


def _trajectories(stage, jit, seed=0):
    """E instances reset from random lanes and goal lanes and JAX's
    depart noise, then T steps of the same random actions through each
    engine's filter; per step (JAX's, the port's) (state, timestep,
    filtered actions)."""
    je, te = tp.roadway_envs(stage)
    n = te.cfg.n_agents
    rng = np.random.default_rng(seed)
    lanes, goal_lanes = (rng.integers(0, 4, (E, n)) for _ in range(2))
    keys = jax.random.split(jax.random.PRNGKey(seed), E)
    noise = np.asarray(jax.vmap(lambda k: jax.random.normal(k, (n,)))(keys))
    reset, step = jax.vmap(je.reset), jax.vmap(je.step)
    check = jax.vmap(je.check_actions)
    if jit:
        reset, step, check = jax.jit(reset), jax.jit(step), jax.jit(check)
    js, jts = reset(keys, dict(lanes=jnp.asarray(lanes, jnp.int32),
                               goal_lanes=jnp.asarray(goal_lanes,
                                                      jnp.int32)))
    ts_, tts = te.reset(dict(lanes=torch.from_numpy(lanes),
                             goal_lanes=torch.from_numpy(goal_lanes)),
                        torch.from_numpy(noise))
    out = [((js, jts, None), (ts_, tts, None))]
    for _ in range(T):
        raw = rng.integers(0, 5, (E, n))
        ja = check(js, jnp.asarray(raw, jnp.int32))
        ta = te.check_actions(ts_, torch.from_numpy(raw))
        js, jts = step(js, ja)
        ts_, tts = te.step(ts_, ta)
        out.append(((js, jts, ja), (ts_, tts, ta)))
    return out


def _pairs(want, got):
    """(name, port's array, JAX's array) of every output."""
    (js, jts, ja), (ts_, tts, ta) = want, got
    out = [(f, getattr(ts_, f).numpy(), np.asarray(getattr(js, f)))
           for f in FLOATS + FLAGS]
    out += [(f"obs.{k}", v.numpy(), np.asarray(jts.obs[k]))
            for k, v in tts.obs.items()]
    out += [("state.vec", tts.state["vec"].numpy(),
             np.asarray(jts.state["vec"]))]
    out += [(f, getattr(tts, f).numpy(), np.asarray(getattr(jts, f)))
            for f in ("reward", "reward_local", "done")]
    if ja is not None:
        out.append(("actions", ta.numpy(), np.asarray(ja)))
    return out


@pytest.mark.parametrize("stage", [1, 2])
def test_engine_matches_jax_op_by_op(stage):
    """Reset and 42 filtered steps (past the 40-step cap) equal JAX's
    engine run op by op exactly, at one car and at two."""
    with jax.disable_jit():
        traj = _trajectories(stage, jit=False)
    for t, (want, got) in enumerate(traj):
        for name, g, w in _pairs(want, got):
            np.testing.assert_array_equal(g, w.astype(g.dtype),
                                          err_msg=f"{name} at step {t}")
    final = traj[-1][1][0]
    assert final.removed.all()
    if stage == 2:
        assert final.collided.any() and (final.steps.min() > 1)


def _trace_grid(ts_, tts, jts, te):
    """The occupancy cells that differ between the port and jitted JAX:
    each must come from a ``round()`` of a position quotient that sits
    within 4 ulps of a half-integer.  Returns their count."""
    occ_t = tts.obs["self_t"][..., 0].numpy()
    occ_j = np.asarray(jts.obs["self_t"])[..., 0]
    flips = np.argwhere(occ_t != occ_j)
    c = te.cfg
    for e, ego, *_ in flips:
        x = ts_.x[e].numpy().astype(np.float64)
        y = (0.8 * ts_.sublane[e].numpy() - c.total_width).astype(np.float64)
        q = np.concatenate([(x - x[ego]) / c.res_forward,
                            (y[ego] - y) / c.sublane_res])
        near = np.abs(np.abs(q - np.floor(q)) - 0.5) <= 4 * np.spacing(
            np.abs(q).astype(np.float32) + 1).astype(np.float64)
        assert near.any(), (e, ego)
    return len(flips)


@pytest.mark.parametrize("stage", [1, 2])
def test_engine_matches_jitted_jax(stage):
    """The same against JAX's compiled engine: every float within 2 ulps
    (of the larger value or its unit), the flags, counters and filtered actions
    exactly, and every flipped grid cell traced to a rounding tie."""
    _, te = tp.roadway_envs(stage)
    diffs = flips = 0
    for t, (want, got) in enumerate(_trajectories(stage, jit=True,
                                                  seed=1)):
        for name, g, w in _pairs(want, got):
            if name == "obs.self_t":
                flips += _trace_grid(got[0], got[1], want[1], te)
                occ = g[..., 0] == w[..., 0]
                g, w = g[..., 1][occ], w[..., 1][occ]
            if not np.issubdtype(g.dtype, np.floating):
                np.testing.assert_array_equal(g, w.astype(g.dtype),
                                              err_msg=f"{name} at {t}")
                continue
            unit = 0.0 if name in FLOATS else 10.0 if "reward" in name \
                else 1.0
            ulp = np.spacing(np.maximum(np.maximum(np.abs(g), np.abs(w)),
                                        unit).astype(np.float32))
            off = np.abs(g - w) > 2 * ulp
            assert not off.any(), (name, t, np.abs(g - w).max())
            diffs += int((g != w).sum())
    assert flips == 0
    assert diffs > 0     # compiled XLA does round apart: the test sees it


# --------------------------------------------------------------------- #
# the filter and the step against the SoA engine and the golden engine
# --------------------------------------------------------------------- #


def _to_soa(s: RoadwayState):
    n = s.x.shape[-1]
    i32 = lambda t: tuple(t[..., i].int() for i in range(n))
    return soa.SoaState(
        x=tuple(s.x[..., i] for i in range(n)), sub=i32(s.sublane),
        vel=tuple(s.vel[..., i] for i in range(n)), steps=i32(s.steps),
        term=i32(s.terminal), coll=i32(s.collided), rem=i32(s.removed))


def test_filter_and_step_match_soa_engine():
    """``check_actions`` + ``step`` equal ``soa_check_actions`` +
    ``soa_step`` bit for bit over 42 steps of 256 instances at the
    config's lanes and goals (the SoA engine's), from a staggered
    start."""
    _, te = tp.roadway_envs(2)
    n, b = 2, 256
    gen = torch.Generator().manual_seed(0)
    s, _ = te.reset(None, torch.randn((b, n), generator=gen))
    for _ in range(T):
        raw = torch.randint(0, 5, (b, n), generator=gen)
        ss = _to_soa(s)
        want_a = soa.soa_check_actions(te.cfg, ss, tuple(raw.int().T))
        a = te.check_actions(s, raw)
        assert torch.equal(a, torch.stack(want_a, -1).long())
        ss2, rewards, done = soa.soa_step(te.cfg, ss, tuple(a.int().T))
        s, ts = te.step(s, a)
        got = _to_soa(s)
        for f in soa.SoaState._fields:
            for i in range(n):
                assert torch.equal(getattr(got, f)[i], getattr(ss2, f)[i]), f
        assert torch.equal(ts.reward_local, torch.stack(rewards, -1))
        assert torch.equal(ts.done, done)


class _Golden:
    """The C++ golden engine (``native/roadway_golden.cc``) through
    ctypes, one instance, without a rebuild."""

    def __init__(self, lib, n, lanes, goal_lanes, cfg, lead):
        self.lib, self.n = lib, n
        self.state = ctypes.create_string_buffer(lib.roadway_state_size())
        i32 = lambda v: (ctypes.c_int * n)(*[int(a) for a in v])
        f64 = lambda v: (ctypes.c_double * n)(*[float(a) for a in v])
        lib.roadway_reset(self.state, n, i32(lanes), i32(goal_lanes),
                          f64(cfg.goal_pos), f64(cfg.speed), f64(lead))

    def check_actions(self, a):
        buf = (ctypes.c_int * self.n)(*[int(v) for v in a])
        self.lib.roadway_check_actions(self.state, buf)
        return np.array(buf[:])

    def step(self, a):
        r = (ctypes.c_double * self.n)()
        done = ctypes.c_int()
        self.lib.roadway_step(self.state, (ctypes.c_int * self.n)(
            *[int(v) for v in a]), r, ctypes.byref(done))
        return np.array(r[:]), bool(done.value)

    def get(self):
        n = self.n
        x, vel = (ctypes.c_double * n)(), (ctypes.c_double * n)()
        ints = [(ctypes.c_int * n)() for _ in range(5)]
        self.lib.roadway_get(self.state, x, ints[0], vel, *ints[1:])
        return np.array(x[:]), np.array(ints[0][:]), np.array(vel[:])


@pytest.mark.skipif(not os.path.exists(LIB), reason="no golden library")
def test_filter_and_step_match_golden_engine():
    """20 random episodes at two cars (random lanes and goal lanes, no
    depart stagger) of the port's filter and step against the golden
    engine: filtered actions, sublanes and done exactly, positions,
    speeds and rewards at ``tests/test_roadway.py``'s tolerances."""
    lib = ctypes.CDLL(LIB)
    _, te = tp.roadway_envs(2, depart_stdev=0.0)
    rng = np.random.RandomState(0)
    for trial in range(20):
        lanes, goal_lanes = rng.randint(0, 4, 2), rng.randint(0, 4, 2)
        g = _Golden(lib, 2, lanes, goal_lanes, te.cfg, [0.0, 0.0])
        g.step([0, 0])          # the golden engine has no populating step
        s, _ = te.reset(dict(lanes=torch.tensor(lanes[None]),
                             goal_lanes=torch.tensor(goal_lanes[None])),
                        torch.zeros((1, 2)))
        done, t = False, 0
        while not done and t < te.cfg.max_step + 2:
            raw = rng.randint(0, 5, 2)
            a = te.check_actions(s, torch.tensor(raw[None]))[0].numpy()
            np.testing.assert_array_equal(a, g.check_actions(raw),
                                          err_msg=f"{trial} {t}")
            s, ts = te.step(s, torch.tensor(a[None]))
            r, done = g.step(a)
            x, sub, vel = g.get()
            np.testing.assert_allclose(s.x[0].numpy(), x, rtol=1e-6,
                                       atol=1e-4)
            np.testing.assert_array_equal(s.sublane[0].numpy(), sub)
            np.testing.assert_allclose(s.vel[0].numpy(), vel, rtol=1e-6)
            np.testing.assert_allclose(ts.reward_local[0].numpy(), r,
                                       rtol=1e-6, atol=1e-6)
            assert bool(ts.done[0]) == done
            t += 1
        assert done


def test_occlusion_runs():
    """``occlusion=True`` (once refused, ROADMAP A15) shadows the grid:
    a car straight ahead of another hides the cells behind it, which
    read -1 with a relative speed of 0 (parity with JAX's:
    ``test_torch_roadway_extras.py``)."""
    cfg = dataclasses.replace(tcfg.roadway_env_config(2), occlusion=True)
    env = Roadway(cfg, device="cpu")
    i64 = lambda *v: torch.tensor([v])
    flags = torch.zeros((1, 2), dtype=torch.bool)
    st = RoadwayState(x=torch.tensor([[50.0, 60.0]]), sublane=i64(6, 6),
                      vel=torch.tensor([[20.0, 20.0]]), steps=i64(0, 0),
                      goal_lane=i64(1, 1), terminal=flags, collided=flags,
                      removed=flags)
    _, ts = env.step(st, i64(0, 0))
    grid = ts.obs["self_t"][0, 0]                    # the car behind
    shadow = grid[..., 0] == -1.0
    assert shadow.any() and (grid[..., 1][shadow] == 0.0).all()
    plain = Roadway(tcfg.roadway_env_config(2), device="cpu")
    assert not (plain.step(st, i64(0, 0))[1].obs["self_t"][..., 0]
                == -1.0).any()


# --------------------------------------------------------------------- #
# the hooks
# --------------------------------------------------------------------- #


def test_hooks_reset_from_jax_draws():
    """``RoadwayHooks.episode_init`` of 16 instances from JAX's draws
    (branch, lanes, goal lanes, depart noise; prob_random 0.5) equals
    JAX's hooks vmapped over the instance keys: state, observations,
    goals; the draws are used up in that order."""
    je, te = tp.roadway_envs(2, prob_random=0.5)
    jh, th = jax_hooks("roadway", je), make_hooks("roadway", te)
    key = jax.random.PRNGKey(3)
    keys = jax.vmap(lambda i: jax.random.fold_in(key, i))(jnp.arange(E))
    with jax.disable_jit():
        js, jts, jg = jax.vmap(jh.episode_init)(keys)
    u, r, z = tp.roadway_reset_draws(key, E, 2)
    draws = prng.FedDraws(r, device="cpu", uniforms=u, normals=z)
    ts_, tts, tg = th.episode_init(E, draws)
    assert not any(draws.remaining().values())
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    for name, g, w in _pairs((js, jts, None), (ts_, tts, None)):
        np.testing.assert_array_equal(g, w.astype(g.dtype), err_msg=name)
    used = (u[0] < 0.5)
    assert used.any() and not used.all()


def _jax_state(s: RoadwayState):
    from cm3_tpu.envs.roadway import RoadwayState as JaxState
    i32 = lambda t: jnp.asarray(t.numpy(), jnp.int32)
    return JaxState(x=jnp.asarray(s.x.numpy()), sublane=i32(s.sublane),
                    vel=jnp.asarray(s.vel.numpy()), steps=i32(s.steps),
                    goal_lane=i32(s.goal_lane),
                    terminal=jnp.asarray(s.terminal.numpy()),
                    collided=jnp.asarray(s.collided.numpy()),
                    removed=jnp.asarray(s.removed.numpy()))


def test_hooks_routing_and_traffic_metrics():
    """``is_bad_episode`` (sum of the local returns below the threshold)
    and the evaluation's traffic metrics (average speed, close
    followers, merge successes at episode end) over 42 steps of the
    port's engine, against JAX's hooks on the same states, op by op,
    exactly.  (Compiled XLA fuses ``0.8 * sublane - 12.8`` and so can
    put two cars 2 sublanes apart at 1.6 m or an ulp past it, flipping
    the close-follower test: measured at step 6 of this run.)"""
    je, te = tp.roadway_envs(2)
    jh = jax_hooks("roadway", je, threshold=12.0)
    th = make_hooks("roadway", te, threshold=12.0)
    rets = np.random.default_rng(0).uniform(0, 12, (E, 2)).astype(np.float32)
    np.testing.assert_array_equal(
        th.is_bad_episode(None, torch.from_numpy(rets)).numpy(),
        np.asarray(jax.vmap(jh.is_bad_episode)(None, jnp.asarray(rets))))
    metrics = {f: jax.vmap(getattr(je, f))
               for f in ("avg_speed", "count_close", "count_success")}
    rng = np.random.default_rng(4)
    gen = torch.Generator().manual_seed(4)
    s, ts = te.reset(dict(lanes=torch.from_numpy(rng.integers(0, 4, (E, 2))),
                          goal_lanes=torch.from_numpy(
                              rng.integers(0, 4, (E, 2)))),
                     torch.randn((E, 2), generator=gen))
    jacc, tacc = jh.eval_metrics_init(), th.eval_metrics_init(())
    alive = torch.ones(E, dtype=torch.bool)
    for _ in range(T):
        a = te.check_actions(s, torch.from_numpy(rng.integers(0, 5, (E, 2))))
        s, ts = te.step(s, a)
        js = _jax_state(s)
        with jax.disable_jit():
            for f, fn in metrics.items():
                np.testing.assert_array_equal(getattr(te, f)(s).numpy(),
                                              np.asarray(fn(js)), err_msg=f)
            jacc = jh.eval_metrics_step(jacc, js, JaxTimeStep(
                obs={}, state={}, reward=jnp.zeros(E),
                reward_local=jnp.zeros(E),
                done=jnp.asarray(ts.done.numpy())),
                jnp.asarray(alive.numpy()))
        tacc = th.eval_metrics_step(tacc, s, ts, alive)
        alive = alive & ~ts.done
    jm = jh.eval_metrics_final(jacc, E)
    tm = th.eval_metrics_final(tacc, E)
    assert set(tm) == set(jm)
    for k in tm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-6,
                                   err_msg=k)
    assert float(tm["eval_avg_speed"]) > 0
