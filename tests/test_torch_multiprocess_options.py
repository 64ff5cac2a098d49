"""Data-parallel training over two gloo ranks on the CPU with CM3's
``adv_norm`` (the advantages' mean and standard deviation over every
rank's rows: one all-reduce of their moments an update) on the worker's
Checkers program in 2 shards, and particle CM3's on-policy rollout
chunks and burst in 2 shards (the dual buffer:
``test_torch_multiprocess_dual.py``).  As ``test_torch_multiprocess.py``:
the ranks agree bit for bit, and the run put together from their blocks
equals the port's single-process run and JAX's single-device run with
JAX's draws fed in blocks, at the tolerances of the single-device tests
(``adv_norm``'s policy loss, a cancelling sum, at atol 1e-5:
``torch_parity.metric_tol``)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cm3_tpu.core import config as jcfg
from cm3_tpu.train.experiments import make_hooks as jax_hooks
from cm3_tpu.train.offpolicy import init_rollout as jax_init_rollout
from cm3_tpu.train.onpolicy import OnPolicyDriver as JaxOnPolicy
from cm3_tpu_torch import convert
from cm3_tpu_torch.train import checkpoint
from tests import torch_dist_cases as dc
from tests import torch_parity as tp
from tests.test_torch_multiprocess import (CHECKERS_ROLLOUT, EPS,
                                           checkers_case, hold_jax,
                                           jax_chunks, jax_host)

tp.set_torch_cpu()

RUNNING = ("ep_ret_local", "ep_ret_global", "acc_ret_local",
           "acc_ret_global", "episodes", "eplog", "eplog_ep")
# particle on-policy: 4 envs, rings of 64 rows in 2 shards, bursts of 3
# updates on 16 rows (test_torch_sharded_onpolicy.py's sizes)
PE, PCAP, PB, PSPT, PEPOCHS, PD = 4, 64, 16, 5, 3, 2


def particle_case(tmp):
    """Particle CM3 on-policy in 2 shards (``stage2_antipodal``): a fill
    chunk, a policy chunk, a burst; JAX's runs and the port case."""
    train = dict(n_envs=PE, buffer_size=PCAP, batch_size=PB,
                 steps_per_train=PSPT, epochs=PEPOCHS, episode_log=16,
                 replay_shards=PD)
    je, _ = tp.particle_envs("stage2_antipodal", prob_random=0.5,
                             max_steps=7)
    ja, ta = tp.particle_algs("cm3", je.spec())
    jd = JaxOnPolicy(jax_hooks("particle", je), ja, jcfg.TrainConfig(**train))
    k0 = jax.random.PRNGKey(0)

    def start(k0):
        jrs = jax_init_rollout(jd.hooks, k0, PE, 16)
        jts = ja.init_state(jax.random.PRNGKey(1), jrs.obs, jrs.state,
                            jrs.goals)
        zeros = jnp.zeros((PE, 4), jnp.int32)
        tr = jd._transition(jrs, zeros, jax.vmap(je.step)(jrs.env_state,
                                                          zeros)[1], None)
        return jts, jd._replay_init(jax.tree_util.tree_map(lambda x: x[0],
                                                           tr)), jrs
    jts, jbuf, jrs = jax.jit(start)(k0)
    keys = [jax.random.PRNGKey(11 + i) for i in range(3)]
    d = tp.ParticleDraws(4)
    d.reset(k0, PE)
    d.rollout(keys[0], PE, PSPT, True)
    d.rollout(keys[1], PE, PSPT, False)
    d.burst(keys[2], PEPOCHS, PB, np.full(PD, 2 * PSPT * PE // PD))
    path = os.path.join(tmp, "start-particle")
    checkpoint.save(path, convert.state_from_jax(ta, jax.device_get(jts)))
    args = dict(kind="particle", start=path, eps=EPS, train=train,
                draws=list(d.lists()),
                steps=[("rollout", True), ("rollout", False), ("burst",)])
    return args, (jd, ta, (jts, jbuf, jrs), keys)


def particle_jax(jd, ta, start, keys):
    jts, jbuf, jrs = start
    out = []
    for k, rand in zip(keys[:2], (True, False)):
        jbuf, jrs = jd._rollout(jts, jbuf, jrs, k, rand, EPS)
        out.append(jax_host(jd, ta, None, jbuf, jrs))
    jts, jm = jd._burst(jts, jbuf, EPS, keys[2])
    out.append(jax_host(jd, ta, jts, jbuf, jrs, jm))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The two ranks run both cases while JAX's run here."""
    tmp = str(tmp_path_factory.mktemp("multiprocess_options"))
    adv_args, adv_jax = checkers_case(tmp, 2, False, adv_norm=1)
    part_args, part_jax = particle_case(tmp)
    cases = {"adv_norm": ("chunks", adv_args, "data"),
             "onpolicy": ("chunks", part_args, "data")}
    launched = dc.launch(cases, tmp)
    jax_out = {"adv_norm": jax_chunks(*adv_jax, {}),
               "onpolicy": particle_jax(*part_jax)}
    single = {name: dc.chunks(args, None)
              for name, (_, args, _) in cases.items()}
    return {"cases": cases, "ranks": dc.collect(launched), "single": single,
            "jax": jax_out}


def check_agree(runs, name):
    """The learner and metrics, the run's running values and its replay
    counts the same on both ranks; every fed draw consumed."""
    dc.joined_steps(runs["cases"], runs["ranks"], name)
    ranks = runs["ranks"][name]
    for r in ranks:
        assert not any(r["remaining"].values()), r["remaining"]
    for key in ("routed", "filled"):
        if key in ranks[0]:
            assert ranks[0][key] == ranks[1][key], key


def check_single(runs, name, ts_tol=(), m_tol=()):
    """The run from the ranks' blocks against the single-process run's,
    after each step; the replay counts equal."""
    steps = dc.joined_steps(runs["cases"], runs["ranks"], name)
    for i, (got, want) in enumerate(zip(steps,
                                        runs["single"][name]["steps"])):
        what = f"{name} step {i} "
        dc.close(got["rs"], want["rs"], what)
        dc.close(got["buf"], dc.ring_rows(want["buf"]), what)
        if "ts" in want:
            dc.close(got["ts"], want["ts"], what, **dict(ts_tol))
            dc.close(got["metrics"], want["metrics"], what, **dict(m_tol))
    for key in ("routed", "filled"):
        if key in runs["single"][name]:
            assert runs["ranks"][name][0][key] == runs["single"][name][key]


def check_jax(runs, name, fields, tol=()):
    """After each step: the replay's rows and cursors (both memories,
    every shard), the rollout's ``fields`` and, after training, the
    state and metrics, against JAX's run with its draws fed in
    blocks."""
    steps = dc.joined_steps(runs["cases"], runs["ranks"], name)
    for i, (got, want) in enumerate(zip(steps, runs["jax"][name])):
        hold_jax(got, want, f"{name} step {i}", fields, **dict(tol))


def check_counts(runs, name, updates, steps, reduces):
    """``updates`` CM3 updates (2 gradient all-reduces each, one a
    backward), one gather a lockstep env step of ``steps``, ``reduces``
    all-reduces; none on one process."""
    for r in runs["ranks"][name]:
        assert r["counts"] == {"grad": 2 * updates, "all_gather": steps,
                               "all_reduce": reduces}, r["counts"]
    assert runs["single"][name]["counts"] == {}


NAMES = ["adv_norm", "onpolicy"]


@pytest.mark.parametrize("name", NAMES)
def test_ranks_agree_bit_for_bit(runs, name):
    check_agree(runs, name)


@pytest.mark.parametrize("name", NAMES)
def test_ranks_equal_the_single_process_run(runs, name):
    check_single(runs, name, m_tol=dict(atol=1e-5) if name == "adv_norm"
                 else ())


@pytest.mark.parametrize("name", NAMES)
def test_ranks_equal_jax(runs, name):
    """The on-policy ring holds every rank's rows before the burst."""
    if name == "adv_norm":
        check_jax(runs, name, CHECKERS_ROLLOUT, dict(atol=1e-5))
    else:
        check_jax(runs, name, RUNNING)
        assert runs["ranks"]["onpolicy"][0]["filled"] == 2 * PSPT * PE


@pytest.mark.parametrize("name", NAMES)
def test_collectives_per_step_and_backward(runs, name):
    """The metric mean of the chunk or burst, and ``adv_norm``'s moments
    once an update."""
    if name == "adv_norm":
        check_counts(runs, name, 2, 2 * 5, 1 + 2)
    else:
        check_counts(runs, name, PEPOCHS, 2 * PSPT, 1)
