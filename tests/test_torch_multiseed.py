"""Seeds in lockstep: the port's seed-batched chunk (S = 3) against the
JAX package's ``jax.vmap(driver._chunk)`` from the same converted state
with JAX's draws fed in, for stage 2 (two agents, Q_credit) and stage 1
(one agent, random goals), on the optax path; and the same chunk
against three one-seed chunks of the port.  ``train_vmapped_seeds`` and
the stacked conversion are in ``test_torch_multiseed_run.py`` (apart,
so that the test workers run the two files' JAX compilations side by
side)."""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cm3_tpu.core import config as jcfg
from cm3_tpu.replay import buffer as jreplay
from cm3_tpu.train.experiments import make_hooks as jax_hooks
from cm3_tpu.train.offpolicy import OffPolicyDriver as JaxDriver
from cm3_tpu.train.offpolicy import init_rollout as jax_init_rollout
from cm3_tpu_torch import convert
from cm3_tpu_torch.core import config as tcfg
from cm3_tpu_torch.core import prng
from cm3_tpu_torch.core.tree import tree_leaves, tree_map
from cm3_tpu_torch.replay import buffer as replay
from cm3_tpu_torch.train.experiments import make_hooks
from cm3_tpu_torch.train.offpolicy import OffPolicyDriver, init_rollout
from tests import torch_parity as tp

tp.set_torch_cpu()

S, E, CAP, B, U, SPT, K = 3, 8, 64, 16, 3, 10, 16
# each seed its own epsilon, as train_vmapped_seeds gives them
EPS = np.array([0.2, 0.35, 0.5], np.float32)
NETS = ("actor", "actor_tgt", "qg", "qg_tgt", "qc", "qc_tgt")


def _train_cfg(mod, **kw):
    return mod.TrainConfig(n_envs=E, buffer_size=CAP, batch_size=B,
                           steps_per_train=SPT, updates_per_chunk=U,
                           episode_log=K, **kw)


def _jax_start(n_agents):
    """JAX: S seeds' rollout, CM3 state and replay rings, stacked, as
    ``train_vmapped_seeds`` builds them; and the matching port objects."""
    je, te = tp.envs(max_steps=7, n_agents=n_agents)
    ja, ta = tp.algs(je.spec(), n_seeds=S, fused_opt=False)
    jd = JaxDriver(jax_hooks("checkers", je), ja, _train_cfg(jcfg))
    td = OffPolicyDriver(make_hooks("checkers", te), ta, _train_cfg(tcfg))
    k_reset = jax.random.split(jax.random.PRNGKey(0), S)
    jrs = jax.vmap(lambda k: jax_init_rollout(jd.hooks, k, E, K))(k_reset)
    jts = jax.vmap(ja.init_state)(jax.random.split(jax.random.PRNGKey(1), S),
                                  jrs.obs, jrs.state, jrs.goals)
    rs0 = jax.tree_util.tree_map(lambda x: x[0], jrs)
    zeros = jnp.zeros((E, n_agents), jnp.int32)
    tr = jd._transition(rs0, zeros, jax.vmap(je.step)(rs0.env_state,
                                                      zeros)[1], None)
    buf1 = jreplay.init(jax.tree_util.tree_map(lambda x: x[0], tr), CAP)
    jbuf = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x[None], (S,) + x.shape).copy(), buf1)
    goals = ([np.stack([tp.goal_draws(k, E) for k in k_reset])]
             if n_agents == 1 else [])
    trs = init_rollout(td.hooks, E, prng.FedDraws(goals, device="cpu"), K,
                       n_seeds=S)
    tts = convert.state_from_jax(ta, jax.device_get(jts))
    tbuf = td._replay_init(td.example_transition(trs))
    return (jd, jts, jbuf, jrs), (td, tts, tbuf, trs)


def _chunks(n_agents):
    """A fill chunk, then a training chunk, in both packages, with the
    port fed JAX's per-seed draws stacked; snapshots after each."""
    (jd, jts, jbuf, jrs), (td, tts, tbuf, trs) = _jax_start(n_agents)
    fill = jax.jit(jax.vmap(lambda t, b, r, e, k: jd._chunk(
        t, b, r, e, k, False, True)))
    train = jax.jit(jax.vmap(lambda t, b, r, e, k: jd._chunk(
        t, b, r, e, k, True, False)))
    out = {"start": copy.deepcopy(tts)}
    eps = torch.from_numpy(EPS)
    keys = jax.random.split(jax.random.PRNGKey(11), S)
    jts, jbuf, jrs, _ = fill(jts, jbuf, jrs, jnp.asarray(EPS), keys)
    draws = tp.stack_draws([tp.chunk_draws(k, E, n_agents, 5, SPT, True)
                            for k in keys])
    out["fill_draws"] = draws
    fed = prng.FedDraws(*draws, device="cpu")
    tts, tbuf, trs, _ = td._chunk(tts, tbuf, trs, eps, fed, False, True)
    assert fed.remaining() == {"randint": 0, "gumbel": 0}
    out["fill"] = (jax.device_get((jrs, jbuf)), copy.deepcopy((trs, tbuf)))
    keys = jax.random.split(jax.random.PRNGKey(12), S)
    size = min(tbuf.size + SPT * E, CAP)
    jts, jbuf, jrs, jm = train(jts, jbuf, jrs, jnp.asarray(EPS), keys)
    draws = tp.stack_draws([tp.chunk_draws(k, E, n_agents, 5, SPT, False, U,
                                           B, [size] * U) for k in keys])
    out["train_draws"] = draws
    fed = prng.FedDraws(*draws, device="cpu")
    tts, tbuf, trs, tm = td._chunk(tts, tbuf, trs, eps, fed, True, False)
    assert fed.remaining() == {"randint": 0, "gumbel": 0}
    out["train"] = (jax.device_get((jrs, jbuf)), (trs, tbuf))
    out["alg"] = (convert.state_from_jax(td.alg, jax.device_get(jts)), tts,
                  jax.device_get(jm), tm)
    out["td"] = td
    return out


@functools.lru_cache(maxsize=None)
def _chunks_of(n_agents):
    return _chunks(n_agents)


@pytest.fixture(params=[2, 1], ids=["stage2", "stage1"])
def runs(request):
    """Each stage's chunks, built once for the whole module whatever
    order the tests run in."""
    return request.param, _chunks_of(request.param)


# one-ulp differences of the engine's normalized coordinates (compiled
# XLA multiplies by the reciprocal) carried through the nets and three
# Adam steps; measured differences are ~1e-7
RTOL, ATOL = 1e-5, 1e-6


def _close(got, want, name, rtol=RTOL, atol=ATOL):
    got, want = got.numpy(), np.asarray(want)
    if np.issubdtype(want.dtype, np.floating):
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                                   err_msg=name)
    else:
        np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("phase", ["fill", "train"])
def test_seed_batched_chunk_matches_jax_vmap(runs, phase):
    """Replay rings, rollout state, per-seed counters and the episode-log
    ring after each chunk, at rtol 1e-5 / atol 1e-6."""
    n, out = runs
    (jrs, jbuf), (trs, tbuf) = out[phase]
    assert (tbuf.insert, tbuf.size) == (int(jbuf.insert[0]),
                                        int(jbuf.size[0]))
    for path, leaf in tree_leaves(tbuf.data):
        want = jbuf.data
        for k in path:
            want = want[k]
        _close(leaf, want, "replay " + "/".join(path))
    for name in ("goals", "a_prev", "ep_ret_local", "ep_ret_global",
                 "acc_ret_local", "acc_ret_global", "episodes", "eplog",
                 "eplog_ep"):
        _close(getattr(trs, name), getattr(jrs, name), name)
    for name in ("world", "loc", "collected", "steps"):
        _close(getattr(trs.env_state, name), getattr(jrs.env_state, name),
               name)
    tree_map(lambda a, b: _close(a, b, "obs"), trs.obs, jrs.obs)
    assert trs.episodes.shape == (S,) and int(trs.episodes.min()) > 0
    assert (trs.eplog_ep > 0).any()


def test_seed_batched_update_matches_jax_vmap(runs):
    """Every seed's networks, targets and Adam moments after the
    training chunk's U optax updates, and the [S] losses."""
    n, out = runs
    want, got, jm, tm = out["alg"]
    nets = NETS if n > 1 else NETS[:4]
    for name in nets:
        assert getattr(got, name).flat.shape[0] == S
        _close(getattr(got, name).flat, getattr(want, name).flat.numpy(),
               name)
    for name in ("opt_actor", "opt_qg") + (("opt_qc",) if n > 1 else ()):
        g, w = getattr(got, name), getattr(want, name)
        assert g.count == w.count == U
        _close(g.mu, w.mu.numpy(), name + ".mu")
        _close(g.nu, w.nu.numpy(), name + ".nu", atol=1e-9)
    assert got.step == want.step == U
    assert set(tm) == set(jm)
    for k in tm:
        assert tm[k].shape == (S,)
        np.testing.assert_allclose(tm[k].numpy(), np.asarray(jm[k]),
                                   rtol=RTOL, err_msg=k)


def _load(alg, start, s=slice(None)):
    """A fresh state of ``alg`` holding row ``s`` (or every row) of the
    seed-batched start state."""
    st = alg.empty_state()
    for name in NETS + ("opt_actor", "opt_qg", "opt_qc"):
        src, dst = getattr(start, name), getattr(st, name)
        if src is None:
            continue
        if name.startswith("opt"):
            dst.mu.copy_(src.mu[s])
            dst.nu.copy_(src.nu[s])
            dst.count = src.count
        else:
            dst.flat.copy_(src.flat[s])
    return st


def _one_seed(out, n, s):
    """Seed ``s`` alone through the port's one-seed driver: the fill and
    the training chunk from its slice of the start state, on its slice
    of the draws, at its epsilon."""
    td = out["td"]
    je, te = tp.envs(max_steps=7, n_agents=n)
    _, ta = tp.algs(je.spec(), fused_opt=False)
    d1 = OffPolicyDriver(make_hooks("checkers", te), ta, _train_cfg(tcfg))
    st = _load(ta, out["start"], s)
    pick = lambda draws: tuple([x[s] for x in xs] for xs in draws)
    goals0 = prng.FedDraws(
        [tp.goal_draws(jax.random.split(jax.random.PRNGKey(0), S)[s], E)]
        if n == 1 else [], device="cpu")
    rs = init_rollout(d1.hooks, E, goals0, K)
    buf = d1._replay_init(d1.example_transition(rs))
    fed = prng.FedDraws(*pick(out["fill_draws"]), device="cpu")
    st, buf, rs, _ = d1._chunk(st, buf, rs, float(EPS[s]), fed, False, True)
    fed = prng.FedDraws(*pick(out["train_draws"]), device="cpu")
    st, buf, rs, m = d1._chunk(st, buf, rs, float(EPS[s]), fed, True, False)
    assert td.n_seeds == S and d1.n_seeds is None
    return st, buf, rs, m


def test_seed_batched_chunk_equals_one_seed_chunks(runs):
    """The S = 3 chunk equals three one-seed chunks of the port, seed by
    seed.  The grouped convolutions and batched products of the seed
    axis sum in other orders than one seed's, ulps apart: the rollout,
    the replay rings, the episode-log ring and the losses are held at
    rtol 1e-6 / atol 1e-6.  The networks and moments pass through U
    Adam steps, whose m / sqrt(v) turns an ulp of a gradient that nearly
    cancels into a relative change of the step: 99.9% of their floats
    are held at atol 1e-7 and every float at atol 3e-6 (measured: one
    float of 4,223 of one seed's Q_credit 1.09e-6 apart, every other
    within 9e-8).  The seed axis' own arithmetic, before Adam, is held
    at 1e-6 by ``test_seed_batched_gradients_equal_one_seed_gradients``."""
    n, out = runs
    (trs, tbuf) = out["train"][1]
    _, got, _, tm = out["alg"]
    for s in range(S):
        st, buf, rs, m = _one_seed(out, n, s)
        for name in (NETS if n > 1 else NETS[:4]):
            got_s, want = getattr(got, name).flat[s], getattr(st, name).flat
            diff = (got_s - want).abs()
            assert float((diff <= 1e-7).float().mean()) >= 0.999, name
            _close(got_s, want, name, rtol=0, atol=3e-6)
        tree_map(lambda a, b: _close(a[s], b, "replay", 1e-6, 1e-6),
                 tbuf.data, buf.data)
        for name in ("ep_ret_local", "acc_ret_local", "acc_ret_global",
                     "episodes", "eplog", "eplog_ep", "goals"):
            _close(getattr(trs, name)[s], getattr(rs, name), name, 1e-6,
                   1e-6)
        for k in m:
            np.testing.assert_allclose(float(tm[k][s]), float(m[k]),
                                       rtol=1e-6, atol=1e-6, err_msg=k)


def test_seed_batched_gradients_equal_one_seed_gradients(runs):
    """What the seed axis itself computes, before Adam: one update of the
    S = 3 state on a minibatch of the filled replay against three
    one-seed updates on each seed's rows of it.  Each network's row of
    ``flat_grad`` [S, n] and each seed's losses are held at rtol 1e-6 /
    atol 1e-6 (the actor's gradient is taken after the critics' Adam
    step, through the post-update baseline)."""
    n, out = runs
    td = out["td"]
    tbuf = out["fill"][1][1]
    rng = np.random.default_rng(5)
    idx = torch.from_numpy(rng.integers(0, tbuf.size, (S, B)))
    gumbel = torch.from_numpy(rng.gumbel(
        size=(S, B, n, td.alg.n_actions)).astype(np.float32))
    batch = replay.sample(tbuf, idx)
    got = _load(td.alg, out["start"])
    got, tm = td.alg.update(got, batch, torch.from_numpy(EPS), gumbel)
    je, _ = tp.envs(max_steps=7, n_agents=n)
    _, ta = tp.algs(je.spec(), fused_opt=False)
    nets = ("actor", "qg") + (("qc",) if n > 1 else ())
    for s in range(S):
        st = _load(ta, out["start"], s)
        st, m = ta.update(st, tree_map(lambda x: x[s], batch), float(EPS[s]),
                          gumbel[s])
        for name in nets:
            _close(getattr(got, name).flat_grad[s],
                   getattr(st, name).flat_grad.numpy(), name + " grad",
                   1e-6, 1e-6)
        assert set(m) == set(tm)
        for k in m:
            np.testing.assert_allclose(float(tm[k][s]), float(m[k]),
                                       rtol=1e-6, atol=1e-6, err_msg=k)
