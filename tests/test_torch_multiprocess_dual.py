"""Data-parallel training over two gloo ranks on the CPU with the dual
buffer: roadway CM3 on the short road's two cars with both memories in
2 shards, one a rank (a fill and a training chunk; each shard mixes its
own rows 50/50).  As ``test_torch_multiprocess.py``: the ranks agree bit
for bit, the run put together from their blocks equals the port's
single-process run and JAX's single-device run with JAX's draws fed in
blocks, roadway CM3's state at ``torch_parity.ROADWAY_QC_TOL``, and the
dual buffer's ``n_bad``/``n_good`` are the run's.  Also both memories in
one ring (every rank keeps them whole, fed with every rank's ended
episodes; a rank's rows of the minibatch mix 50/50 as the run's
minibatch does), from the port's own draw stream, against the
single-process run."""

import os

import jax
import numpy as np
import pytest

from cm3_tpu_torch import convert
from cm3_tpu_torch.train import checkpoint
from tests import test_torch_roadway_chunk as rc
from tests import torch_dist_cases as dc
from tests import torch_parity as tp
from tests.test_torch_dual_buffer import DUAL
from tests.test_torch_multiprocess import EPS, jax_host
from tests.test_torch_multiprocess_options import (RUNNING, check_agree,
                                                   check_counts, check_jax,
                                                   check_single)

tp.set_torch_cpu()

def roadway_case(tmp):
    """The dual buffer on the short road in 2 shards: JAX's driver and
    start, the fed draws of a fill and a training chunk and the port
    case's arguments (``test_torch_sharded_driver.chunk_runs``)."""
    train = dict(DUAL, replay_shards=2)
    _, _, jd, _, ta = rc.drivers(train=train)
    k0, k1, k2 = (jax.random.PRNGKey(i) for i in (40, 1, 2))
    start = jax.jit(lambda k: rc.jax_start(jd, k))(k0)
    path = os.path.join(tmp, "start-roadway")
    checkpoint.save(path, convert.state_from_jax(ta, jax.device_get(
        start[0])))
    args = dict(kind="roadway", start=path, eps=EPS, routed=True,
                train=dict(n_envs=rc.E, buffer_size=rc.CAP,
                           batch_size=rc.B, steps_per_train=rc.SPT,
                           updates_per_chunk=rc.U, episode_log=16, **train),
                steps=[("chunk", False, True), ("chunk", True, False)])
    return args, (jd, ta, start, (k0, k1, k2))


def roadway_jax(args, jd, ta, start, keys):
    """JAX's two chunks; then the draws they took, fed to the port."""
    k0, k1, k2 = keys
    jts, jbuf, jrs = start
    jts, jbuf, jrs, _ = jd._chunk_fill(jts, jbuf, jrs, EPS, k1)
    out = [jax_host(jd, ta, None, jbuf, jrs)]
    jts, jbuf, jrs, jm = jd._chunk_train(jts, jbuf, jrs, EPS, k2)
    out.append(jax_host(jd, ta, jts, jbuf, jrs, jm))
    bad, good = (np.asarray(jbuf.bad.size), np.asarray(jbuf.good.size))
    d = tp.RoadwayDraws(2)
    d.reset(k0, rc.E)
    d.chunk(k1, rc.E, rc.SPT, True)
    d.chunk(k2, rc.E, rc.SPT, False, rc.U, rc.B, (bad, good))
    args["draws"] = list(d.lists())
    return out, (int(bad.sum()), int(good.sum()))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's chunks first (the port's draws follow from its fills), then
    the two ranks."""
    tmp = str(tmp_path_factory.mktemp("multiprocess_dual"))
    args, jax_case = roadway_case(tmp)
    jax_out, routed = roadway_jax(args, *jax_case)
    ring = dict(args, train=dict(args["train"], replay_shards=1),
                routed=True)
    del ring["draws"], ring["start"]
    cases = {"dual": ("chunks", args, "data"),
             "dual_ring": ("chunks", ring, "data")}
    launched = dc.launch(cases, tmp)
    single = {name: dc.chunks(a, None) for name, (_, a, _) in cases.items()}
    return {"cases": cases, "ranks": dc.collect(launched), "single": single,
            "jax": {"dual": jax_out}, "routed": routed}


def test_ranks_agree_bit_for_bit(runs):
    check_agree(runs, "dual")


def test_ranks_equal_the_single_process_run(runs):
    check_single(runs, "dual", tp.ROADWAY_QC_TOL)


def test_ranks_equal_jax(runs):
    """Also the slab's episode lengths; ``n_bad``/``n_good`` (summed
    over the ranks' shards) are JAX's sums, both memories filled."""
    check_jax(runs, "dual", RUNNING + ("stage_t",), tp.ROADWAY_QC_TOL)
    assert tuple(runs["ranks"]["dual"][0]["routed"]) == runs["routed"]
    assert min(runs["routed"]) > 0


def test_collectives_per_step_and_backward(runs):
    check_counts(runs, "dual", rc.U, 2 * rc.SPT, 1)


def test_one_dual_ring_over_two_ranks_equals_the_single_process_run(runs):
    """Both memories in one ring on every rank: the ranks agree, the run
    equals the single-process run (the memories' rows and fills, the
    state, ``n_bad``/``n_good``), and a step gathers twice (the slabs and
    the returns)."""
    check_agree(runs, "dual_ring")
    check_single(runs, "dual_ring", tp.ROADWAY_QC_TOL)
    assert min(runs["ranks"]["dual_ring"][0]["routed"]) > 0
    check_counts(runs, "dual_ring", rc.U, 2 * 2 * rc.SPT, 1)
