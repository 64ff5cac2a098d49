"""A roadway training chunk and evaluation against the JAX package's,
with JAX's draws fed in (``torch_parity.RoadwayDraws``: per env step the
actions, then the reset's branch, lanes, goal lanes and depart noise for
every instance): CM3 on two cars with the clipped-IS policy gradient
(``pg_is_clip``), a random-fill chunk then a training chunk of 10 env
steps, with the feasibility filter before each step, replay adds and
auto-resets, and 3 updates; then the greedy evaluation with its traffic
metrics.

The filter replaces actions in the policy chunk (counted), and the
stored ``bp`` is the behavior probability of the stored, filtered
action, as JAX gathers it.  Cars start 40 m
before the goal (``torch_parity.SHORT_ROAD``), so episodes end inside
chunks.  Tolerances: the engine's floats through compiled XLA are ulps
apart (``test_torch_roadway_engine.py``), the nets' sums in another
order: rtol 1e-5 / atol 1e-6, the state at
``torch_parity.ROADWAY_QC_TOL``; flags, counts, actions exactly."""

import copy

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
from cm3_tpu_torch.core.tree import tree_leaves
from cm3_tpu_torch.train.experiments import make_hooks
from cm3_tpu_torch.train.offpolicy import OffPolicyDriver, init_rollout
from tests import torch_parity as tp

tp.set_torch_cpu()

E, CAP, B, U, SPT, EPS, N_EVAL = 8, 256, 16, 3, 10, 0.3, 6
RTOL, ATOL = 1e-5, 1e-6


def close(got, want, name, **tol):
    got, want = got.numpy(), np.asarray(want)
    if np.issubdtype(want.dtype, np.floating):
        np.testing.assert_allclose(got, want, err_msg=name,
                                   **(tol or dict(rtol=RTOL, atol=ATOL)))
    else:
        np.testing.assert_array_equal(got, want.astype(got.dtype),
                                      err_msg=name)


def hold_rollout(jrs, trs, lead=()):
    """Rollout state, env state and observations equal."""
    for name in ("goals", "ep_ret_local", "ep_ret_global", "acc_ret_local",
                 "acc_ret_global", "episodes", "eplog", "eplog_ep"):
        close(getattr(trs, name), getattr(jrs, name), name)
    for name in ("x", "vel", "sublane", "steps", "goal_lane", "terminal",
                 "collided", "removed"):
        close(getattr(trs.env_state, name), getattr(jrs.env_state, name),
              name, rtol=0, atol=1e-4)
    for k in ("self_t", "self_v"):
        close(trs.obs[k], jrs.obs[k], "obs " + k)


def drivers(kind="cm3", n_seeds=None, train=None, **alg):
    """JAX's and the port's off-policy drivers on the short road's two
    cars (prob_random 0.5)."""
    je, te = tp.roadway_envs(2, **tp.SHORT_ROAD)
    ja, ta = tp.roadway_algs(kind, je.spec(), n_seeds=n_seeds, **alg)
    kw = dict(n_envs=E, buffer_size=CAP, batch_size=B, steps_per_train=SPT,
              updates_per_chunk=U, episode_log=16)
    kw.update(train or {})
    jd = JaxDriver(jax_hooks("roadway", je, threshold=kw.get("threshold",
                                                             16.0)),
                   ja, jcfg.TrainConfig(**kw))
    td = OffPolicyDriver(make_hooks("roadway", te,
                                    threshold=kw.get("threshold", 16.0)),
                         ta, tcfg.TrainConfig(**kw))
    return je, te, jd, td, ta


def jax_start(jd, key):
    """JAX's rollout, state and empty replay (plain or dual) from
    ``key``."""
    jrs = jax_init_rollout(jd.hooks, key, E, 16)
    jts = jd.alg.init_state(jax.random.PRNGKey(1), jrs.obs, jrs.state,
                            jrs.goals)
    zeros = jnp.zeros((E, 2), jnp.int32)
    tr = jd._transition(jrs, zeros, jax.vmap(jd.hooks.env.step)(
        jrs.env_state, zeros)[1], None)
    example = jax.tree_util.tree_map(lambda x: x[0], tr)
    jbuf = jd._replay_init(example)
    if jd.cfg.dual_buffer:
        from cm3_tpu.train.offpolicy import init_stage
        jrs = init_stage(jrs, example, E, jd.cfg.max_steps)
    return jts, jbuf, jrs


def counting_filter(te):
    """Wrap the port's filter to count the actions it replaces."""
    seen = {"calls": 0, "replaced": 0}
    check = te.check_actions

    def wrapped(state, actions):
        out = check(state, actions)
        seen["calls"] += 1
        seen["replaced"] += int((out != actions).sum())
        return out
    te.check_actions = wrapped
    return seen


@pytest.fixture(scope="module")
def chunk():
    je, te, jd, td, ta = drivers(pg_is_clip=1.0)
    assert td._store_bp and jd._store_bp
    k0, k1, k2 = (jax.random.PRNGKey(i) for i in (0, 11, 12))
    jts, jbuf, jrs = jax_start(jd, k0)
    tts = convert.state_from_jax(ta, jax.device_get(jts))
    d = tp.RoadwayDraws(2)
    d.reset(k0, E)
    d.chunk(k1, E, SPT, True)
    d.chunk(k2, E, SPT, False, U, B, 2 * SPT * E)
    draws = d.fed()
    trs = init_rollout(td.hooks, E, draws, 16)
    tbuf, trs = td.init_replay(trs)
    seen = counting_filter(te)
    out = {"alg": ta}
    jts, jbuf, jrs, _ = jd._chunk_fill(jts, jbuf, jrs, EPS, k1)
    tts, tbuf, trs, _ = td._chunk(tts, tbuf, trs, EPS, draws, False, True)
    out["fill"] = (jax.device_get((jbuf, jrs)), copy.deepcopy((tbuf, trs)))
    out["fill_replaced"] = seen["replaced"]
    jts, jbuf, jrs, jm = jd._chunk_train(jts, jbuf, jrs, EPS, k2)
    tts, tbuf, trs, tm = td._chunk(tts, tbuf, trs, EPS, draws, True, False)
    assert not any(draws.remaining().values()), draws.remaining()
    out["train"] = (jax.device_get((jbuf, jrs)), (tbuf, trs))
    out["replaced"] = seen["replaced"] - out["fill_replaced"]
    out["calls"] = seen["calls"]
    out["state"] = (convert.state_from_jax(ta, jax.device_get(jts)), tts,
                    jax.device_get(jm), {k: float(v) for k, v in tm.items()})
    out["drivers"] = (jd, td, je, te)
    out["jts"] = jts
    return out


@pytest.mark.parametrize("which", ["fill", "train"])
def test_chunk_replay_and_rollout_match_jax(chunk, which):
    """After each chunk: the replay ring's rows (the filtered actions
    and ``bp`` among them), its cursor and fill, the rollout and the
    env state."""
    (jbuf, jrs), (tbuf, trs) = chunk[which]
    assert (tbuf.insert, tbuf.size) == (int(jbuf.insert), int(jbuf.size))
    for path, leaf in tree_leaves(tbuf.data):
        want = jbuf.data
        for k in path:
            want = want[k]
        close(leaf[:tbuf.size], np.asarray(want)[:tbuf.size],
              "replay " + "/".join(path))
    hold_rollout(jrs, trs)
    assert int(trs.episodes) > 0


def test_chunk_update_matches_jax(chunk):
    """The 3 updates of the training chunk (clipped-IS on the stored
    ``bp``): networks, targets, Adam state, metrics."""
    want, got, jm, tm = chunk["state"]
    tp.hold_states(got, want, chunk["alg"].net_names(), **tp.ROADWAY_QC_TOL)
    assert got.step == want.step == U
    assert set(tm) == set(jm) and "is_weight_mean" in tm
    for k in tm:
        np.testing.assert_allclose(tm[k], float(jm[k]), rtol=RTOL, atol=ATOL,
                                   err_msg=k)


def test_filter_runs_before_every_step_and_bp_follows_it(chunk):
    """The filter ran at each of the 20 steps, and replaced actions in
    both chunks; random-fill rows store the uniform 1/5, policy rows the
    probability of the stored action, which equals JAX's at the
    replaced rows too."""
    assert chunk["calls"] == 2 * SPT
    assert chunk["fill_replaced"] > 0 and chunk["replaced"] > 0
    (_, _), (tbuf, _) = chunk["train"]
    bp = tbuf.data["bp"]
    assert torch.all(bp[:SPT * E] == 0.2)
    assert not torch.all(bp[SPT * E:tbuf.size] == 0.2)


def test_evaluation_matches_jax(chunk):
    """The greedy evaluation of the trained state (6 episodes of at most
    ``max_steps``, the filter before each step): per-agent and global
    returns, the action distribution and the traffic metrics."""
    jd, td, _, _ = chunk["drivers"]
    tts = chunk["state"][1]
    key = jax.random.PRNGKey(21)
    d = tp.RoadwayDraws(2)
    d.evaluate(key, N_EVAL, jd.cfg.max_steps)
    draws = d.fed()
    r_l, r_g, aux = jd._eval(chunk["jts"], key, N_EVAL)
    t_l, t_g, t_aux = td.evaluate(tts, draws, N_EVAL)
    assert not any(draws.remaining().values())
    close(t_l, r_l, "r_eval_local")
    close(t_g, r_g, "r_eval_global")
    assert set(t_aux) == set(aux) == {"act_dist", "eval_avg_speed",
                                      "eval_count_close",
                                      "eval_count_success"}
    for k in aux:
        close(t_aux[k], aux[k], k)
    assert float(t_aux["eval_avg_speed"]) > 0

