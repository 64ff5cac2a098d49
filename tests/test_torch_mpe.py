"""The port's MPE suite (``cm3_tpu_torch.envs.mpe``) against
``cm3_tpu.envs.mpe``: for each of the five scenarios without contact
forces (the other four: ``test_torch_mpe_contact.py``), the reset from
JAX's draws and 11 steps that alternate the index path (``step``: move
and comm symbols) and the multi-head path (``step_multihead``: soft
force vectors and continuous comm vectors), the state, observations,
rewards and done at every step, for 6 instances; then the upstream
quirks, the multi-head composition and the wrapper over any leading
shape.

Tolerances.  Run op by op (``jax.disable_jit``), JAX rounds every
operation as the port does: with XLA's own ``logaddexp(0, z)`` and
``_bound_penalty`` fed into the port's two places that call an
exponential or a logarithm, and with subnormals flushed to zero as
XLA's CPU kernels do (``torch.set_flush_denormal``), every value equals
JAX's to the bit (``test_op_by_op_bit_for_bit``).  PyTorch's CPU
``exp`` and ``log1p`` are other implementations than XLA's (an ulp
apart on 9-21% of inputs, ``test_transcendentals_within_two_ulps``),
so with the port's own functions the trajectories are held at
``OWN_TOL``, the integers and flags exactly.  The compiled engine:
``test_torch_mpe_jit.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cm3_tpu.envs import mpe as jmpe
from cm3_tpu_torch.core import prng
from cm3_tpu_torch.envs import mpe as tmpe
from tests import torch_parity as tp

tp.set_torch_cpu()

NAMES = sorted(jmpe.SCENARIOS)
B, T, MAX_STEPS = 6, 11, 10
# with the port's own exp / log1p: an ulp of a contact force or of the
# boundary penalty, carried through at most 11 steps (measured: every
# value of 56,952 equal but 4 subnormal floats of simple_push, 2.7e-44
# apart; a contact at another draw moved one velocity by 2.3e-13)
OWN_TOL = dict(rtol=1e-6, atol=1e-9)
# the index path's direction pairs as the multi-head path's one-hots
# (environment.py:194-197 against :205-207: swapped upstream)
SWAP = np.array([0, 2, 1, 4, 3])


def _reset_draws(env, keys):
    """What JAX's ``Scenario.reset`` draws from each key
    (``mpe.py:205-222``), in the port's order: ([agents, landmarks]
    uniforms, [goals] randints or none).  Op by op, as the reset they
    feed: compiled, ``uniform``'s u * (hi - lo) + lo is a fused
    multiply-add."""
    sc, w = env.scenario, env.scenario.world

    def one(k):
        k_a, k_l, k_g = jax.random.split(k, 3)
        r = sc.landmark_range
        return (jax.random.uniform(k_a, (w.n_agents, 2), minval=-1.0,
                                   maxval=1.0),
                jax.random.uniform(k_l, (w.n_landmarks, 2), minval=-r,
                                   maxval=r),
                jax.random.randint(k_g, (max(sc.n_goals, 1),), 0,
                                   w.n_landmarks))
    a, l, g = (np.asarray(x) for x in jax.vmap(one)(keys))
    return [a, l], ([g] if sc.n_goals else [])


def _actions(rng, w, t):
    """Step t's actions: even steps the index path's (move, comm),
    odd steps the multi-head path's (soft [N, 5] force vectors, comm
    vectors or None)."""
    n = w.n_agents
    if t % 2 == 0:
        return ("index", rng.integers(0, 5, (B, n)),
                rng.integers(0, max(w.dim_c, 1), (B, n)))
    hot = rng.random((B, n, 5)).astype(np.float32)
    comm = (rng.random((B, n, w.dim_c)).astype(np.float32) if w.dim_c
            else None)
    return ("multihead", hot, comm)


def _jax_step(env, path, fn=lambda f: f):
    if path == "index":
        return fn(jax.vmap(env.step))
    return fn(jax.vmap(lambda s, h, c: env.step_multihead(s, h, c)))


def _jax_args(act):
    path, x, y = act
    if path == "index":
        return jnp.asarray(x, jnp.int32), jnp.asarray(y, jnp.int32)
    return jnp.asarray(x), None if y is None else jnp.asarray(y)


def _port_step(env, state, act):
    path, x, y = act
    y = None if y is None else torch.from_numpy(np.asarray(y))
    if path == "index":
        return env.step(state, torch.from_numpy(x), y)
    return env.step_multihead(state, torch.from_numpy(x), y)


def _record(state, out):
    obs, rew, done = out
    return dict(pos=state.pos, vel=state.vel, c=state.c, goal=state.goal,
                steps=state.steps, obs=obs, reward=rew, done=done)


def _jax_record(state, out):
    return {k: np.asarray(v) for k, v in _record(state, out).items()}


def _port_record(state, out):
    return {k: v.numpy() for k, v in _record(state, out).items()}


def _state_from(rec):
    st = {k: torch.from_numpy(np.array(rec[k]))
          for k in ("pos", "vel", "c", "goal", "steps")}
    st["goal"] = st["goal"].long()
    return tmpe.MPEState(**st)


def jax_trajectory(name, jitted=False):
    """One scenario's JAX trajectory, op by op or compiled: the records
    of the reset and each step, the fed reset draws (op by op) and the
    actions."""
    je = jmpe.MPEEnv(name, max_steps=MAX_STEPS)
    w = je.scenario.world
    keys = jax.random.split(jax.random.PRNGKey(NAMES.index(name)), B)
    rng = np.random.default_rng(NAMES.index(name))
    acts = [_actions(rng, w, t) for t in range(T)]
    out = {"name": name, "acts": acts}
    if jitted:
        s, o = jax.jit(jax.vmap(je.reset))(keys)
        recs = [_jax_record(s, o)]
        steps = {p: _jax_step(je, p, jax.jit) for p in ("index",
                                                       "multihead")}
        for a in acts:
            s, o = steps[a[0]](s, *_jax_args(a))
            recs.append(_jax_record(s, o))
        out["recs"] = recs
        return out
    with jax.disable_jit():
        out["draws"] = _reset_draws(je, keys)
        s, o = jax.vmap(je.reset)(keys)
        recs = [_jax_record(s, o)]
        for a in acts:
            s, o = _jax_step(je, a[0])(s, *_jax_args(a))
            recs.append(_jax_record(s, o))
    out["recs"] = recs
    return out


# the scenarios with contact forces (colliding entities) are held in
# test_torch_mpe_contact.py
CONTACT = ["simple_push", "simple_spread", "simple_tag",
           "simple_world_comm"]


@pytest.fixture(scope="module",
                params=[n for n in NAMES if n not in CONTACT])
def traj(request):
    return jax_trajectory(request.param)


def _port_trajectory(traj):
    te = tmpe.MPEEnv(traj["name"], max_steps=MAX_STEPS, device="cpu")
    uniforms, randints = traj["draws"]
    draws = prng.FedDraws(randints, device="cpu", uniforms=uniforms)
    s, o = te.reset(te.draw_reset((B,), draws))
    assert not any(draws.remaining().values())
    recs = [_port_record(s, o)]
    for a in traj["acts"]:
        s, o = _port_step(te, s, a)
        recs.append(_port_record(s, o))
    return recs


def _hold(got, want, what, **tol):
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape, (what, k, g.shape, w.shape)
        if np.issubdtype(w.dtype, np.floating) and tol:
            np.testing.assert_allclose(g, w, err_msg=f"{what} {k}", **tol)
        else:
            np.testing.assert_array_equal(g, w.astype(g.dtype),
                                          err_msg=f"{what} {k}")


@pytest.fixture
def xla_rounding(monkeypatch):
    """XLA's exp / log1p in the port's two transcendental terms, and
    subnormals flushed to zero as XLA's CPU kernels do."""
    def logaddexp0(z):
        with jax.disable_jit():
            return torch.from_numpy(np.array(jnp.logaddexp(
                0.0, jnp.asarray(z.numpy()))))

    def bound_penalty(x):
        with jax.disable_jit():
            return torch.from_numpy(np.array(jmpe._bound_penalty(
                jnp.asarray(x.numpy()))))
    monkeypatch.setattr(tmpe, "logaddexp0", logaddexp0)
    monkeypatch.setattr(tmpe, "_bound_penalty", bound_penalty)
    assert torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)


def test_op_by_op_bit_for_bit(traj, xla_rounding):
    hold_bit_for_bit(traj)


def test_own_functions_within_tolerance(traj):
    hold_own_functions(traj)


def hold_bit_for_bit(traj):
    """The reset from JAX's draws and 11 steps, both paths, equal JAX's
    run op by op to the bit: positions, velocities, comm state, goals,
    step counts, observations (padded), rewards and done."""
    for t, (got, want) in enumerate(zip(_port_trajectory(traj),
                                        traj["recs"])):
        _hold(got, want, f"{traj['name']} t={t}")
    assert [bool(r["done"].any()) for r in traj["recs"]] == [
        t >= MAX_STEPS for t in range(T + 1)]


def hold_own_functions(traj):
    """With PyTorch's own exp and log1p (and subnormals kept), the same
    trajectories at ``OWN_TOL``; integers and flags exactly."""
    for t, (got, want) in enumerate(zip(_port_trajectory(traj),
                                        traj["recs"])):
        _hold(got, want, f"{traj['name']} t={t}", **OWN_TOL)


def test_transcendentals_within_two_ulps():
    """The port's two transcendental terms against XLA's on 20,000
    inputs each: ``logaddexp(0, z)`` over the contact range and the
    boundary penalty over [0, 2.5): within 2 ulps; the penalty exactly
    where it takes no exponential (x < 1)."""
    rng = np.random.default_rng(0)
    z = rng.uniform(-80.0, 5.0, 20000).astype(np.float32)
    x = rng.uniform(0.0, 2.5, 20000).astype(np.float32)
    with jax.disable_jit():
        jz = np.asarray(jnp.logaddexp(0.0, jnp.asarray(z)))
        jx = np.asarray(jmpe._bound_penalty(jnp.asarray(x)))
    tz = tmpe.logaddexp0(torch.from_numpy(z)).numpy()
    tx = tmpe._bound_penalty(torch.from_numpy(x)).numpy()
    np.testing.assert_array_max_ulp(tz, jz, maxulp=2)
    np.testing.assert_array_max_ulp(tx, jx, maxulp=2)
    np.testing.assert_array_equal(tx[x < 1.0], jx[x < 1.0])


# --------------------------------------------------------------------- #
# the upstream quirks and the multi-head composition
# --------------------------------------------------------------------- #


def _far_state(sc, pos, lead=(1,)):
    pos = torch.tensor(pos, dtype=torch.float32).expand(lead + (len(pos), 2))
    w = sc.world
    return tmpe.MPEState(
        pos=pos.clone(), vel=torch.zeros_like(pos),
        c=torch.zeros(lead + (w.n_agents, max(w.dim_c, 1))),
        goal=torch.zeros(lead + (sc.n_goals,), dtype=torch.int64),
        steps=torch.zeros(lead, dtype=torch.int32))


def _jax_state(st):
    return jmpe.MPEState(pos=jnp.asarray(st.pos[0].numpy()),
                         vel=jnp.asarray(st.vel[0].numpy()),
                         c=jnp.asarray(st.c[0].numpy()),
                         goal=jnp.asarray(st.goal[0].numpy(), jnp.int32),
                         steps=jnp.int32(0))


def test_simple_spread_counts_the_self_collision():
    """``simple_spread``'s ``is_collision`` has no identity exclusion
    (``mpe.py:230-235, 282-287``): agents far from each other each pay
    -1 every step, and the diagonal of the collision matrix holds."""
    sc = tmpe.SCENARIOS["simple_spread"]("cpu")
    st = _far_state(sc, [(-0.8, 0.0), (0.0, 0.0), (0.8, 0.0),
                         (-0.8, 0.5), (0.0, 0.5), (0.8, 0.5)])
    coll = sc._collide_mat(st)[0]
    assert coll.diagonal().all() and not (coll[:3, :3] & ~torch.eye(
        3, dtype=torch.bool)).any()
    r = sc.reward(st)[0]
    np.testing.assert_allclose(r.numpy(), -1.5 - 1.0, rtol=1e-6)
    want = jmpe.SCENARIOS["simple_spread"]().reward(_jax_state(st))
    np.testing.assert_array_equal(r.numpy(), np.asarray(want))


def test_simple_world_comm_rewards_distance_from_food():
    """``simple_world_comm``'s good agents earn +0.05 x the distance to
    the nearest food (``mpe.py:545-546``): moving a lone good agent away
    from both food cells raises its reward by 0.05 x the distance
    gained."""
    sc = tmpe.SCENARIOS["simple_world_comm"]("cpu")
    base = [(-0.5, -0.5), (-0.5, -0.3), (-0.3, -0.5), (-0.3, -0.3),
            (0.3, 0.0), (0.5, 0.5),
            (-0.6, 0.6), (0.0, 0.0), (0.0, 0.1), (-0.9, -0.9), (0.9, -0.9)]
    near = _far_state(sc, base)
    far = _far_state(sc, base[:4] + [(0.6, 0.0)] + base[5:])
    r_near, r_far = sc.reward(near)[0, 4], sc.reward(far)[0, 4]
    # nearest food (0, 0): 0.3 away, then 0.6; no hit, no boundary
    np.testing.assert_allclose(float(r_far - r_near), 0.05 * 0.3,
                               rtol=1e-5)
    for st, r in ((near, r_near), (far, r_far)):
        want = jmpe.SCENARIOS["simple_world_comm"]().reward(_jax_state(st))
        assert float(r) == float(want[4])


@pytest.mark.parametrize("name", ["simple_spread", "simple_tag",
                                  "simple_speaker_listener"])
def test_onehot_multihead_matches_index_path(name):
    """``tests/test_mpe_multihead.py``: an exact one-hot with the
    direction pairs swapped, and the comm symbol as a one-hot vector,
    give the index path's state bit for bit (upstream's swapped
    pairs, ``mpe.py:147-171``)."""
    env = tmpe.MPEEnv(name, device="cpu")
    w = env.scenario.world
    draws = prng.GeneratorDraws(prng.generator(7, "cpu"))
    s_idx, _ = env.reset(env.draw_reset((4,), draws))
    s_hot = s_idx
    for _ in range(6):
        move = draws.randint((4, w.n_agents), 5)
        comm = draws.randint((4, w.n_agents), max(w.dim_c, 1))
        hot = tmpe._one_hot(torch.from_numpy(SWAP)[move], 5)
        vec = tmpe._one_hot(comm, w.dim_c) if w.dim_c else None
        s_idx, _ = env.step(s_idx, move, comm)
        s_hot, _ = env.step_multihead(s_hot, hot, vec)
        for k in ("pos", "vel", "c"):
            assert torch.equal(getattr(s_idx, k), getattr(s_hot, k)), k


def test_soft_vector_blends_forces():
    """``tests/test_mpe_multihead.py``: half a +x one-hot gives half the
    velocity change of a whole one."""
    env = tmpe.MPEEnv("simple_spread", device="cpu")
    draws = prng.GeneratorDraws(prng.generator(1, "cpu"))
    s0, _ = env.reset(env.draw_reset((), draws))
    n = env.scenario.world.n_agents
    vel = {}
    for scale in (0.0, 0.5, 1.0):
        hot = torch.zeros(n, 5)
        hot[:, 1] = scale
        vel[scale] = tmpe.mpe_step_multihead(env.scenario.world, s0,
                                             hot).vel[:n, 0]
    dv_half, dv_full = vel[0.5] - vel[0.0], vel[1.0] - vel[0.0]
    np.testing.assert_allclose(dv_full.numpy(), 2.0 * dv_half.numpy(),
                               rtol=1e-6)
    assert (dv_full > 0).all()


def test_step_multihead_ends_at_max_steps():
    env = tmpe.MPEEnv("simple_spread", max_steps=4, device="cpu")
    draws = prng.GeneratorDraws(prng.generator(2, "cpu"))
    s, _ = env.reset(env.draw_reset((), draws))
    n = env.scenario.world.n_agents
    for i in range(4):
        s, (_, _, done) = env.step_multihead(s, torch.zeros(n, 5))
        assert bool(done) == (i == 3)


@pytest.mark.parametrize("name", NAMES)
def test_env_wrapper_vectorized(name):
    """``tests/test_mpe_scenarios.py:145``: every scenario drives
    batched; a [2, 4] batch equals the same 8 instances as [8], and one
    instance alone ([]) equals its row: the observation widths, reward
    and done shapes, and values bit for bit."""
    env = tmpe.MPEEnv(name, max_steps=3, device="cpu")
    w = env.scenario.world
    n, width = w.n_agents, max(env.scenario.obs_dims)
    d = env.draw_reset((8,), prng.GeneratorDraws(prng.generator(3, "cpu")))
    move = torch.randint(0, 5, (8, n), generator=torch.Generator().manual_seed(
        0))
    outs = {}
    for lead in ((8,), (2, 4), ()):
        k = 1 if lead == () else 8
        dd = {key: v[:k].reshape(lead + v.shape[1:]) for key, v in d.items()}
        s, _ = env.reset(dd)
        mv = move[:k].reshape(lead + (n,))
        for _ in range(3):
            s, (obs, rew, done) = env.step(s, mv, mv % max(w.dim_c, 1))
        assert obs.shape == lead + (n, width) and rew.shape == lead + (n,)
        assert done.shape == lead and bool(done.all())
        outs[lead] = [x.reshape((-1,) + x.shape[len(lead):])
                      for x in (s.pos, s.vel, obs, rew)]
    for a, b, c in zip(outs[(8,)], outs[(2, 4)], outs[()]):
        assert torch.equal(a, b) and torch.equal(a[:1], c)
