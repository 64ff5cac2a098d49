"""Data-parallel training over two gloo ranks on the CPU
(``parallel/mesh.py``, ``parallel/dist.py``): the port's mirror of
``tests/test_multihost.py``.

``tests/multihost_worker.py``'s program (Checkers stage 2 on 4 columns,
16 envs, CM3 with nets 32/16, B 32, buffer 256) placed with
``mesh.shard_driver_state`` on a data mesh of two processes: a fill and
a training chunk from JAX's start state with JAX's draws fed (the whole
run's; each rank takes its block, ``prng.BlockDraws``), with the replay
in 2 shards (one a rank) and in one ring (every rank keeps it), on the
fused and the optax paths.  For each: the ranks agree bit for bit; the
run put together from their blocks equals the port's single-process run
of the same program (rtol 1e-5 / atol 1e-6) and JAX's single-device
run (the same tolerance; rows and integers exactly); each backward
issued one gradient all-reduce.  Then the mirror of
``test_two_process_short_training_run_matches_single_process``: ~120
episodes through ``OffPolicyDriver.run(..., mesh=)`` and a greedy
evaluation, equal on both ranks and to the single-process run at rtol
1e-4 / atol 1e-5, with the period rows and their episode log.

One spawn of the two ranks serves every case (``torch_dist_cases``);
JAX's side runs here."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cm3_tpu.algs.cm3 import CM3 as JaxCM3
from cm3_tpu.core import config as jcfg
from cm3_tpu.envs.checkers import Checkers as JaxCheckers
from cm3_tpu.train.experiments import make_hooks as jax_hooks
from cm3_tpu.train.offpolicy import OffPolicyDriver as JaxDriver
from cm3_tpu.train.offpolicy import init_rollout as jax_init_rollout
from cm3_tpu_torch import convert
from cm3_tpu_torch.train import checkpoint
from tests import torch_dist_cases as dc
from tests import torch_parity as tp

tp.set_torch_cpu()

E, B, U, SPT, CAP = 16, 32, 2, 5, 256
EPS = 0.3
EPISODES = 120
# (replay shards, fused optimizer)
CASES = [(2, True), (1, True), (2, False), (1, False)]


def case_id(c):
    return f"D{c[0]}-{'fused' if c[1] else 'optax'}"


def jax_checkers(shards, **alg):
    """JAX's driver of the worker's program with ``replay_shards`` and
    CM3's options ``alg``; its algorithm and the port's twin."""
    env = JaxCheckers(jcfg.CheckersEnvConfig(**dataclasses.asdict(
        dc.checkers_env_config())))
    ja = JaxCM3("checkers", env.spec(), jcfg.AlgConfig(
        n_agents=2, stage=2, **alg), jcfg.NNConfig(**dc.WORKER_NN))
    cfg = jcfg.TrainConfig(**dc.WORKER_TRAIN, replay_shards=shards,
                           episode_log=16)
    _, ta, _ = dc.program("checkers", alg)
    return JaxDriver(jax_hooks("checkers", env), ja, cfg), ta


def jax_start(jd, key):
    """JAX's rollout, state and empty replay, built under ``jax.jit``
    (op by op, the first build in a process takes ~20 s)."""
    def start(key):
        jrs = jax_init_rollout(jd.hooks, key, E, 16)
        jts = jd.alg.init_state(jax.random.PRNGKey(1), jrs.obs, jrs.state,
                                jrs.goals)
        zeros = jnp.zeros((E, 2), jnp.int32)
        tr = jd._transition(jrs, zeros, jax.vmap(jd.hooks.env.step)(
            jrs.env_state, zeros)[1], None)
        return jts, jd._replay_init(jax.tree_util.tree_map(lambda x: x[0],
                                                           tr)), jrs
    return jax.jit(start)(key)


def jax_host(jd, ta, jts, jbuf, jrs, jm=None):
    """JAX's state, replay and rollout as the port's cases report them."""
    out = {"rs": jax.device_get(jrs), "buf": jax.device_get(jbuf)}
    if jm is not None:
        out["ts"] = dc.state_arrays(ta, convert.state_from_jax(
            ta, jax.device_get(jts)))
        out["metrics"] = {k: np.asarray(v) for k, v in jm.items()}
    return out


def checkers_case(tmp, shards, fused, **opts):
    """One case's JAX driver and start, its draws (the fill chunk's,
    then the training chunk's), and the port case's arguments."""
    jd, ta = jax_checkers(shards, fused_opt=fused, **opts)
    k0, k1, k2 = (jax.random.PRNGKey(i) for i in (40, 41, 42))
    start = jax_start(jd, k0)
    size = min(2 * SPT * E, CAP)
    sizes = [np.full(shards, size // shards)] * U if shards > 1 \
        else [size] * U
    d = tuple(a + b for a, b in zip(
        tp.chunk_draws(k1, E, 2, 5, SPT, True),
        tp.chunk_draws(k2, E, 2, 5, SPT, False, U, B, sizes)))
    path = os.path.join(tmp, f"start-{shards}-{fused}-{sorted(opts)}")
    checkpoint.save(path, convert.state_from_jax(ta, jax.device_get(
        start[0])))
    args = dict(kind="checkers", alg=dict(fused_opt=fused, **opts),
                train=dict(replay_shards=shards, episode_log=16),
                start=path, draws=[d[0], d[1], [], []], eps=EPS,
                steps=[("chunk", False, True), ("chunk", True, False)])
    return args, (jd, ta, start, (k1, k2))


def jax_chunks(jd, ta, start, keys, fill_cache):
    """JAX's fill and training chunk (the fill shared by the cases of
    one ``replay_shards``, the optimizer not being read in it)."""
    jts, jbuf, jrs = start
    shards = jd.cfg.replay_shards
    if shards not in fill_cache:
        _, jbuf1, jrs1, _ = jd._chunk_fill(jts, jbuf, jrs, EPS, keys[0])
        fill_cache[shards] = jax.device_get((jbuf1, jrs1))
    jbuf1, jrs1 = fill_cache[shards]
    jts2, jbuf2, jrs2, jm = jd._chunk_train(
        jts, jax.tree_util.tree_map(jnp.asarray, jbuf1), jrs1, EPS, keys[1])
    return [jax_host(jd, ta, None, jbuf1, jrs1),
            jax_host(jd, ta, jts2, jbuf2, jrs2, jm)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The two ranks run every case while JAX's chunks run here."""
    tmp = str(tmp_path_factory.mktemp("multiprocess"))
    cases, jax_cases = {}, {}
    for c in CASES:
        args, jax_cases[case_id(c)] = checkers_case(tmp, *c)
        cases[case_id(c)] = ("chunks", args, "data")
    cases["run"] = ("run_eval", dict(episodes=EPISODES, train=dict(
        episode_log=128, period=40)), "data")
    launched = dc.launch(cases, tmp)
    fills = {}
    jax_out = {name: jax_chunks(*c, fills) for name, c in jax_cases.items()}
    single = {name: dc.CASES[case](args, None)
              for name, (case, args, _) in cases.items()}
    return {"cases": cases, "ranks": dc.collect(launched), "single": single,
            "jax": jax_out}


def _joined(runs, name):
    return dc.joined_steps(runs["cases"], runs["ranks"], name)


def _single(runs, name):
    return [dict(s, buf=dc.ring_rows(s["buf"]))
            for s in runs["single"][name]["steps"]]


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_ranks_agree_bit_for_bit(runs, case):
    """The learner, the metrics, the run's counts, return sums and
    episode log, and a ring every rank keeps: the same bytes on both
    ranks after each chunk; every fed draw consumed."""
    name = case_id(case)
    _joined(runs, name)
    for r in runs["ranks"][name]:
        assert not any(r["remaining"].values()), r["remaining"]


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_ranks_equal_the_single_process_run(runs, case):
    """The run from the ranks' blocks equals the port's single-process
    run of the same program and draws: rows, cursors and integers
    exactly, floats at rtol 1e-5 / atol 1e-6 (the mean of two half
    batches' gradients rounds otherwise than one mean)."""
    name = case_id(case)
    for i, (got, want) in enumerate(zip(_joined(runs, name),
                                        _single(runs, name))):
        dc.close(got, want, f"{name} chunk {i} ")


def _jax_rows(buf):
    buf = jax.tree_util.tree_map(np.asarray, buf)
    if hasattr(buf, "bad"):
        return {"bad": _jax_rows(buf.bad), "good": _jax_rows(buf.good)}
    data = buf.data
    if np.ndim(buf.size) == 0:
        n = int(buf.size)
        return {"size": buf.size, "insert": buf.insert,
                "data": jax.tree_util.tree_map(lambda x: x[:n], data)}
    flat = np.asarray(buf.size).reshape(-1)
    k = np.ndim(buf.size)
    return {"size": buf.size, "insert": buf.insert,
            "data": jax.tree_util.tree_map(
                lambda x: [x.reshape((-1,) + x.shape[k:])[i, :n]
                           for i, n in enumerate(flat)], data)}


def hold_jax(got, want, what, rollout_fields, **tol):
    """The ranks' run against JAX's: the replay's rows and cursors, the
    rollout's fields ``rollout_fields`` and, after training, the state
    and metrics."""
    dc.close(got["buf"], _jax_rows(want["buf"]), what + " replay")
    for name in rollout_fields:
        dc.close(got["rs"][name], np.asarray(getattr(want["rs"], name)),
                 f"{what} {name}")
    if "ts" in want:
        dc.close(got["ts"], want["ts"], what + " ", **tol)
        dc.close({k: got["metrics"][k] for k in want["metrics"]},
                 want["metrics"], what + " metrics ", **tol)


CHECKERS_ROLLOUT = ("goals", "a_prev", "ep_ret_local", "ep_ret_global",
                    "acc_ret_local", "acc_ret_global", "episodes", "eplog",
                    "eplog_ep")


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_ranks_equal_jax(runs, case):
    """The run from the ranks' blocks equals JAX's single-device run of
    the same global program, JAX's draws fed to the ranks in blocks:
    after the fill (every shard's rows and cursors, the rollout) and
    after the training chunk (also every network, target and Adam
    moment, and the metrics), at ``test_torch_chunk.py``'s
    tolerances."""
    name = case_id(case)
    for i, (got, want) in enumerate(zip(_joined(runs, name),
                                        runs["jax"][name])):
        hold_jax(got, want, f"{name} chunk {i}", CHECKERS_ROLLOUT)


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_one_gradient_all_reduce_per_backward(runs, case):
    """CM3's two backwards an update: 2 x U gradient all-reduces on each
    rank in the training chunk, none in the fill and none on one
    process; one gather a lockstep env step, one metric mean a chunk."""
    name = case_id(case)
    for r in runs["ranks"][name]:
        assert r["counts"]["grad"] == 2 * U
        assert r["counts"]["all_gather"] == 2 * SPT
        assert r["counts"]["all_reduce"] == 1
    assert runs["single"][name]["counts"] == {}


def test_two_process_short_training_run_matches_single_process(runs):
    """~120 episodes of the worker's program through
    ``OffPolicyDriver.run(..., mesh=)`` (random fill, then training; the
    port's own draw streams): the greedy evaluation is the same on both
    ranks and equals the single-process run of the same global program
    at rtol 1e-4 / atol 1e-5 (``test_multihost.py:56-92``); only the
    primary process logged."""
    ranks, single = runs["ranks"]["run"], runs["single"]["run"]
    assert [r["logged"] for r in ranks] == [len(single["rows"]), 0]
    assert single["episodes"] >= EPISODES
    for key in ("r_global", "r_local", "episodes", "ts"):
        dc.equal_on_ranks([r[key] for r in ranks], key)
    dc.close(ranks[0]["r_global"], single["r_global"], "r_global",
             rtol=1e-4, atol=1e-5)
    dc.close(ranks[0]["r_local"], single["r_local"], "r_local",
             rtol=1e-4, atol=1e-5)
    assert ranks[0]["episodes"] == single["episodes"]
    assert ranks[0]["counts"]["grad"] == 2 * ranks[0]["ts"]["step"]
    assert ranks[0]["counts"]["broadcast"] == 1


def test_period_rows_and_episode_log_match_single_process(runs):
    """The run's period rows, their episode log (``_episodes``: every
    completed episode's number and returns) among them, equal on both
    ranks and to the single-process run's."""
    ranks, single = runs["ranks"]["run"], runs["single"]["run"]
    dc.equal_on_ranks([r["rows"] for r in ranks], "rows")
    assert len(single["rows"]) == 3
    dc.close(ranks[0]["rows"], single["rows"], "rows", rtol=1e-4, atol=1e-5)
    ids, rets = ranks[0]["rows"][-1]["_episodes"]
    assert len(ids) > 0 and np.all(np.diff(ids) == 1)
