"""One whole ``OffPolicyDriver._chunk`` of the port against the JAX
chunk, with JAX's draws fed in: a random-fill chunk, then a training
chunk (10 env steps with replay adds and auto-resets, then 3 CM3
updates, fused optimizer).  The ring is smaller than the chunk's 80
rows and episodes end every 7 steps, so both wrap and reset run."""

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
from cm3_tpu_torch.core import prng
from cm3_tpu_torch.core.tree import tree_leaves, tree_map
from cm3_tpu_torch.train.experiments import make_hooks
from cm3_tpu_torch.train.offpolicy import OffPolicyDriver, init_rollout
from tests import torch_parity as tp

tp.set_torch_cpu()

E, CAP, B, U, SPT, EPS = 8, 64, 16, 3, 10, 0.2


@pytest.fixture(scope="module")
def runs():
    je, te = tp.envs(max_steps=7)
    ja, ta = tp.algs(je.spec())
    kw = dict(n_envs=E, buffer_size=CAP, batch_size=B, steps_per_train=SPT,
              updates_per_chunk=U)
    jd = JaxDriver(jax_hooks("checkers", je), ja, jcfg.TrainConfig(**kw))
    td = OffPolicyDriver(make_hooks("checkers", te), ta,
                         tcfg.TrainConfig(**kw))
    jrs = jax_init_rollout(jd.hooks, jax.random.PRNGKey(0), E)
    jts = ja.init_state(jax.random.PRNGKey(1), jrs.obs, jrs.state, jrs.goals)
    zeros = jnp.zeros((E, 2), jnp.int32)
    tr = jd._transition(jrs, zeros,
                        jax.vmap(je.step)(jrs.env_state, zeros)[1], None)
    jbuf = jreplay.init(jax.tree_util.tree_map(lambda x: x[0], tr), CAP)
    trs = init_rollout(td.hooks, E)
    tts = convert.state_from_jax(ta, jax.device_get(jts))
    tzeros = torch.zeros((E, 2), dtype=torch.int64)
    ttr = td._transition(trs, tzeros, te.step(trs.env_state, tzeros)[1])
    tbuf = td._replay_init(tree_map(lambda x: x[0], ttr))

    out = {}
    # random-fill chunk
    key = jax.random.PRNGKey(11)
    jts, jbuf, jrs, _ = jd._chunk_fill(jts, jbuf, jrs, EPS, key)
    draws = prng.FedDraws(*tp.chunk_draws(key, E, 2, 5, SPT, True),
                           device="cpu")
    tts, tbuf, trs, _ = td._chunk(tts, tbuf, trs, EPS, draws, False, True)
    assert draws.remaining() == {"randint": 0, "gumbel": 0}
    out["fill"] = (jax.device_get((jrs, jbuf)), copy.deepcopy((trs, tbuf)))
    # training chunk: policy actions, then U updates
    key = jax.random.PRNGKey(12)
    size = min(int(jbuf.size) + SPT * E, CAP)
    jts, jbuf, jrs, jm = jd._chunk_train(jts, jbuf, jrs, EPS, key)
    draws = prng.FedDraws(*tp.chunk_draws(key, E, 2, 5, SPT, False, U, B,
                                          [size] * U), device="cpu")
    tts, tbuf, trs, tm = td._chunk(tts, tbuf, trs, EPS, draws, True, False)
    assert draws.remaining() == {"randint": 0, "gumbel": 0}
    out["train"] = (jax.device_get((jrs, jbuf)), (trs, tbuf))
    out["alg"] = (convert.state_from_jax(ta, jax.device_get(jts)), tts,
                  jax.device_get(jm), tm)
    return out


# floats carry one-ulp differences from the engine's normalized
# coordinates (compiled XLA multiplies by the reciprocal) through the
# nets; measured differences are <= 1.2e-7
RTOL, ATOL = 1e-5, 1e-6


def _close(got, want, name):
    got, want = got.numpy(), np.asarray(want)
    if np.issubdtype(want.dtype, np.floating):
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                                   err_msg=name)
    else:
        np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("phase", ["fill", "train"])
def test_rollout_and_replay_match(runs, phase):
    (jrs, jbuf), (trs, tbuf) = runs[phase]
    assert (tbuf.insert, tbuf.size) == (int(jbuf.insert), int(jbuf.size))
    for path, leaf in tree_leaves(tbuf.data):
        want = jbuf.data
        for k in path:
            want = want[k]
        _close(leaf, want, "replay " + "/".join(path))
    for name in ("goals", "a_prev", "ep_ret_local", "ep_ret_global",
                 "acc_ret_local", "acc_ret_global", "episodes"):
        _close(getattr(trs, name), getattr(jrs, name), name)
    for name in ("world", "loc", "collected", "steps"):
        _close(getattr(trs.env_state, name), getattr(jrs.env_state, name),
               name)
    tree_map(lambda a, b: _close(a, b, "obs"), trs.obs, jrs.obs)
    assert int(trs.episodes) > 0


def test_training_chunk_matches(runs):
    want, got, jm, tm = runs["alg"]
    for name in ("actor", "actor_tgt", "qg", "qg_tgt", "qc", "qc_tgt"):
        _close(getattr(got, name).flat, getattr(want, name).flat.numpy(),
               name)
    for name in ("opt_actor", "opt_qg", "opt_qc"):
        g, w = getattr(got, name), getattr(want, name)
        assert g.count == w.count == U
        _close(g.mu, w.mu.numpy(), name + ".mu")
        _close(g.nu, w.nu.numpy(), name + ".nu")
    assert got.step == want.step == U
    for k in ("loss_Q_global", "loss_Q_credit", "policy_loss"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=RTOL,
                                   err_msg=k)
