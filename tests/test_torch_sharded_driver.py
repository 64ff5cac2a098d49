"""The off-policy chunk with shard-local replay (``replay_shards`` = D)
against the JAX package's, with JAX's draws fed in: a random-fill and a
training chunk, for the plain ring on Checkers stage 2 (CM3, fused
optimizer; 10 env steps of 8 instances, episodes of 7 steps, rings of
64/D rows that wrap, 3 updates on 16 rows) and for the dual buffer on
roadway's short road (CM3, a slab of 3 transitions;
``test_torch_sharded_dual.py``), each at D = 2 for one seed and at
D = 4 for three seeds in lockstep against ``jax.vmap(_chunk)``.

After each chunk: every shard's rows below its fill and its cursors,
the rollout and env state, and after the training chunk the state and
the metrics.  The updates' indices are JAX's: ``jax.random.split`` of
the sample key into D, then batch/D indices per shard below the shard's
fill (``torch_parity.sharded_indices``; for the dual buffer per shard
the bad memory's, then the good one's).  Tolerances as
``test_torch_chunk.py``'s and ``test_torch_roadway_chunk.py``'s: rows
and integers exactly, the engines' and nets' floats at rtol 1e-5 / atol
1e-6, roadway CM3's state at ``torch_parity.ROADWAY_QC_TOL``."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cm3_tpu.core import config as jcfg
from cm3_tpu.train.experiments import make_hooks as jax_hooks
from cm3_tpu.train.offpolicy import OffPolicyDriver as JaxDriver
from cm3_tpu.train.offpolicy import init_rollout as jax_init_rollout
from cm3_tpu_torch import convert
from cm3_tpu_torch.core import config as tcfg
from cm3_tpu_torch.core import prng
from cm3_tpu_torch.core.tree import tree_leaves
from cm3_tpu_torch.replay import buffer as treplay
from cm3_tpu_torch.train.experiments import make_hooks
from cm3_tpu_torch.train.offpolicy import OffPolicyDriver, init_rollout
from tests import test_torch_roadway_chunk as rc
from tests.test_torch_dual_buffer import DUAL
from tests import torch_parity as tp

tp.set_torch_cpu()

E, CAP, B, U, SPT, EPS = 8, 64, 16, 3, 10, 0.2
S = 3
RTOL, ATOL = 1e-5, 1e-6


def _close(got, want, name, **tol):
    got, want = got.numpy(), np.asarray(want)
    if np.issubdtype(want.dtype, np.floating):
        np.testing.assert_allclose(got, want, err_msg=name,
                                   **(tol or dict(rtol=RTOL, atol=ATOL)))
    else:
        np.testing.assert_array_equal(got, want.astype(got.dtype),
                                      err_msg=name)


def hold_ring(tring, jring, name):
    """Every ring's (shard's, seed's) cursors and its rows below its
    fill."""
    _close(tring.size, jring.size, name + " size")
    _close(tring.insert, jring.insert, name + " insert")
    k = tring.insert.dim()
    sizes = np.asarray(jring.size).reshape(-1)
    for path, leaf in tree_leaves(tring.data):
        want = jring.data
        for p in path:
            want = want[p]
        want = np.asarray(want).reshape((-1,) + np.shape(want)[k:])
        got = leaf.reshape((-1,) + tuple(leaf.shape[k:]))
        for i, n in enumerate(sizes):
            _close(got[i, :n], want[i, :n], f"{name} {'/'.join(path)}")


def hold_replay(tbuf, jbuf):
    if isinstance(tbuf, treplay.DualReplayState):
        hold_ring(tbuf.bad, jbuf.bad, "bad")
        hold_ring(tbuf.good, jbuf.good, "good")
    else:
        hold_ring(tbuf, jbuf, "ring")


def hold_checkers_rollout(jrs, trs):
    for name in ("goals", "a_prev", "ep_ret_local", "ep_ret_global",
                 "acc_ret_local", "acc_ret_global", "episodes", "eplog",
                 "eplog_ep"):
        _close(getattr(trs, name), getattr(jrs, name), name)
    for path, leaf in tree_leaves(trs.obs):
        want = jrs.obs
        for p in path:
            want = want[p]
        _close(leaf, want, "obs " + "/".join(path))


def checkers_drivers(shards, n_seeds=None):
    je, te = tp.envs(max_steps=7)
    ja, ta = tp.algs(je.spec(), n_seeds=n_seeds)
    kw = dict(n_envs=E, buffer_size=CAP, batch_size=B, steps_per_train=SPT,
              updates_per_chunk=U, episode_log=16, replay_shards=shards)
    jd = JaxDriver(jax_hooks("checkers", je), ja, jcfg.TrainConfig(**kw))
    td = OffPolicyDriver(make_hooks("checkers", te), ta,
                         tcfg.TrainConfig(**kw))
    return jd, td, ta


def checkers_start(jd, key):
    jrs = jax_init_rollout(jd.hooks, key, E, 16)
    jts = jd.alg.init_state(jax.random.PRNGKey(1), jrs.obs, jrs.state,
                            jrs.goals)
    zeros = jnp.zeros((E, 2), jnp.int32)
    tr = jd._transition(jrs, zeros, jax.vmap(jd.hooks.env.step)(
        jrs.env_state, zeros)[1], None)
    return jts, jd._replay_init(jax.tree_util.tree_map(lambda x: x[0], tr)), \
        jrs


def _stack(*trees):
    return jax.tree_util.tree_map(lambda *x: jnp.stack(x), *trees)


def _jax_chunks(jd, start, keys, eps, seeds):
    """JAX's fill and training chunk (vmapped over seeds): -> (the
    state, replay and rollout after the fill, after the training
    chunk, its metrics)."""
    jts, jbuf, jrs = start
    if seeds:
        chunk = lambda train, rand: jax.jit(jax.vmap(
            lambda t, b, r, e, k: jd._chunk(t, b, r, e, k, train, rand)))
        fill, train = chunk(False, True), chunk(True, False)
    else:
        fill, train = jd._chunk_fill, jd._chunk_train
    jts, jbuf, jrs, _ = fill(jts, jbuf, jrs, eps, keys[0])
    after_fill = jax.device_get((jbuf, jrs))
    jts, jbuf, jrs, jm = train(jts, jbuf, jrs, eps, keys[1])
    return after_fill, jax.device_get((jts, jbuf, jrs)), jax.device_get(jm)


def case_id(c):
    return f"{c[0]}-D{c[1]}" + ("-seeds" if c[2] else "")


def chunk_runs(kind, shards, n_seeds):
    """One case's JAX chunks and the port's from the same state and
    draws: ``kind`` "plain" (Checkers) or "dual" (roadway), D shards,
    one seed (None) or S in lockstep."""
    lead = () if n_seeds is None else (n_seeds,)
    if kind == "plain":
        jd, td, ta = checkers_drivers(shards, n_seeds)
        start_fn = checkers_start
    else:
        _, _, jd, td, ta = rc.drivers(n_seeds=n_seeds, train=dict(
            DUAL, replay_shards=shards))
        start_fn = rc.jax_start
    k0s = [jax.random.PRNGKey(40 + i) for i in range(n_seeds or 1)]
    starts = [start_fn(jd, k) for k in k0s]
    start = _stack(*starts) if lead else starts[0]
    keys = [[jax.random.PRNGKey(100 * i + c) for i in range(n_seeds or 1)]
            for c in (1, 2)]
    eps = np.array([0.1, 0.3, 0.5], np.float32)[:n_seeds] if lead else EPS
    jkeys = [jnp.stack(k) if lead else k[0] for k in keys]
    fill, (jts, jbuf, jrs), jm = _jax_chunks(jd, start, jkeys,
                                             jnp.asarray(eps), bool(lead))
    per = []
    for i in range(n_seeds or 1):
        pick = (lambda x: np.asarray(x)[i]) if lead else np.asarray
        if kind == "plain":
            sizes = pick(jbuf.size)
            per.append(tp.chunk_draws(keys[0][i], E, 2, 5, SPT, True))
            per[-1] = tuple(a + b for a, b in zip(per[-1], tp.chunk_draws(
                keys[1][i], E, 2, 5, SPT, False, U, B, [sizes] * U)))
        else:
            d = tp.RoadwayDraws(2)
            d.reset(k0s[i], E)
            d.chunk(keys[0][i], E, SPT, True)
            d.chunk(keys[1][i], E, SPT, False, U, B,
                    (pick(jbuf.bad.size), pick(jbuf.good.size)))
            per.append(d)
    if kind == "plain":
        draws = prng.FedDraws(*(tp.stack_draws(per) if lead else per[0]),
                              device="cpu")
    else:
        draws = tp.stacked_particle_draws(per) if lead else per[0].fed()
    tts = convert.state_from_jax(ta, jax.device_get(start[0]))
    trs = init_rollout(td.hooks, E, draws, 16, n_seeds=n_seeds)
    tbuf, trs = td.init_replay(trs)
    teps = torch.from_numpy(eps) if lead else EPS
    tts, tbuf, trs, _ = td._chunk(tts, tbuf, trs, teps, draws, False, True)
    out = {"kind": kind, "shards": shards, "lead": lead, "alg": ta,
           "fill": (fill, copy.deepcopy((tbuf, trs)))}
    tts, tbuf, trs, tm = td._chunk(tts, tbuf, trs, teps, draws, True, False)
    assert not any(draws.remaining().values()), draws.remaining()
    out["train"] = ((jts, jbuf, jrs, jm), (tts, tbuf, trs, tm))
    out["driver"] = td
    return out


def _hold_rollout(c, jrs, trs):
    if c["kind"] == "plain":
        hold_checkers_rollout(jrs, trs)
    else:
        rc.hold_rollout(jrs, trs)
        _close(trs.stage_t, jrs.stage_t, "stage_t")


# the plain ring at D = 2 for one seed and at D = 4 for three seeds;
# the dual buffer: test_torch_sharded_dual.py
CASES = [("plain", 2, None), ("plain", 4, S)]


@pytest.fixture(scope="module", params=CASES, ids=case_id)
def chunks(request):
    return chunk_runs(*request.param)


def test_fill_chunk_matches_jax(chunks):
    check_fill(chunks)


def test_training_chunk_matches_jax(chunks):
    check_training(chunks)


def check_fill(chunks):
    """After the random-fill chunk: every shard's rows and cursors (the
    shards' own fills: the dual memories' differ between shards), the
    rollout and the env state."""
    (jbuf, jrs), (tbuf, trs) = chunks["fill"]
    hold_replay(tbuf, jbuf)
    _hold_rollout(chunks, jrs, trs)
    lead = chunks["lead"] + (chunks["shards"],)
    ring = tbuf.bad if chunks["kind"] == "dual" else tbuf
    assert tuple(ring.size.shape) == lead


def check_training(chunks):
    """After the training chunk: the replay, the rollout, every network,
    target and Adam moment, and the last update's metrics; each update
    sampled batch/D rows from every shard."""
    (jts, jbuf, jrs, jm), (tts, tbuf, trs, tm) = chunks["train"]
    ta = chunks["alg"]
    hold_replay(tbuf, jbuf)
    _hold_rollout(chunks, jrs, trs)
    tol = tp.ROADWAY_QC_TOL if chunks["kind"] == "dual" else {}
    tp.hold_states(tts, convert.state_from_jax(ta, jts), ta.net_names(),
                   **tol)
    assert tts.step == U
    for k, v in tm.items():
        np.testing.assert_allclose(np.asarray(v), np.asarray(jm[k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)
    if chunks["kind"] == "dual" and not chunks["lead"]:
        bad, good = (int(np.sum(jbuf.bad.size)), int(np.sum(jbuf.good.size)))
        assert chunks["driver"]._routed(tbuf) == (bad, good)
        assert min(bad, good) > 0
