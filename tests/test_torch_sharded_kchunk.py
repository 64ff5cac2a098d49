"""Shard-local replay in the K-chunk dispatch, and ``eval_hooks``,
against the JAX package's, with JAX's draws fed in: two K = 2
dispatches (``_chunks_scanned``, the fill -> train boundary inside the
second) at D = 2; ``evaluate`` with evaluation hooks other than the
training hooks, off- and on-policy.  The on-policy burst with shards:
``test_torch_sharded_onpolicy.py``.

Tolerances as ``test_torch_kchunk.py``'s: the nets' float32 sums in
other orders, rtol 1e-5 / atol 1e-6; episode counts and replay cursors
exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cm3_tpu.core import config as jcfg
from cm3_tpu.train.experiments import make_hooks as jax_hooks
from cm3_tpu.train.offpolicy import OffPolicyDriver as JaxDriver
from cm3_tpu.train.offpolicy import init_rollout as jax_init_rollout
from cm3_tpu.train.onpolicy import OnPolicyDriver as JaxOnPolicy
from cm3_tpu_torch import convert
from cm3_tpu_torch.core import config as tcfg
from cm3_tpu_torch.core import prng
from cm3_tpu_torch.train.experiments import make_hooks
from cm3_tpu_torch.train.offpolicy import OffPolicyDriver, init_rollout
from cm3_tpu_torch.train.onpolicy import OnPolicyDriver
from tests import torch_parity as tp
from tests.test_torch_sharded_driver import hold_ring

tp.set_torch_cpu()

RTOL, ATOL = 1e-5, 1e-6


# --------------------------------------------------------------------- #
# the K-chunk dispatch
# --------------------------------------------------------------------- #

KE, KCAP, KB, KU, KSPT, KP, K, KD = 2, 64, 8, 2, 5, 3, 2, 2


def test_kchunk_dispatches_match_jax():
    """Two K = 2 dispatches (``_chunks_scanned`` against JAX's jitted
    ``_chunk_train_k``) of 2 instances with episodes of one chunk, D = 2
    (one instance a shard; 2 episodes a chunk against a fill of 5): the
    first all fill, the second straddling the fill -> train boundary
    (its first chunk at 4 episodes fills, its second at 6 trains: the
    gate reads the device count); after each the state, the replay
    shards, the metrics and ``trained_chunks``."""
    train = dict(n_envs=KE, buffer_size=KCAP, batch_size=KB,
                 steps_per_train=KSPT, updates_per_chunk=KU,
                 pretrain_episodes=5, chunks_per_sync=K, replay_shards=KD,
                 epsilon_start=0.4, epsilon_end=0.05, epsilon_div=2.0)
    je, te = tp.envs(max_steps=KSPT)
    ja, ta = tp.algs(je.spec(), fused_opt=False)
    jd = JaxDriver(jax_hooks("checkers", je), ja, jcfg.TrainConfig(**train))
    td = OffPolicyDriver(make_hooks("checkers", te), ta,
                         tcfg.TrainConfig(**train))
    jrs = jax_init_rollout(jd.hooks, jax.random.PRNGKey(0), KE)
    jts = ja.init_state(jax.random.PRNGKey(1), jrs.obs, jrs.state, jrs.goals)
    zeros = jnp.zeros((KE, 2), jnp.int32)
    tr = jd._transition(jrs, zeros,
                        jax.vmap(je.step)(jrs.env_state, zeros)[1], None)
    jbuf = jd._replay_init(jax.tree_util.tree_map(lambda x: x[0], tr))
    trs = init_rollout(td.hooks, KE)
    tts = convert.state_from_jax(ta, jax.device_get(jts))
    tbuf = td._replay_init(td.example_transition(trs))
    size = 0
    for d, trained in ((0, 0.0), (1, 1.0)):
        key = jax.random.PRNGKey(30 + d)
        jts, jbuf, jrs, jm = jd._chunk_train_k(jts, jbuf, jrs, key, K)
        randints, gumbels = [], []
        for k in jax.random.split(key, K):
            size = min(size + KSPT * KE // KD, KCAP // KD)
            r, g = tp.chunk_draws(k, KE, 2, 5, KSPT, False, KU, KB,
                                  [np.full(KD, size)] * KU, gated=True)
            randints += r
            gumbels += g
        fed = prng.FedDraws(randints, gumbels, device="cpu")
        tts, tbuf, trs, tm = td._chunks_scanned(tts, tbuf, trs, fed, K)
        assert not any(fed.remaining().values())
        tp.hold_states(tts, convert.state_from_jax(ta, jax.device_get(jts)),
                       ta.net_names())
        hold_ring(tbuf, jax.device_get(jbuf), "ring")
        assert sorted(tm) == sorted(jm)
        assert float(tm["trained_chunks"]) == float(jm["trained_chunks"]) \
            == trained
        for k in tm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=RTOL,
                                       atol=ATOL, err_msg=k)
    assert tts.step == KU


# --------------------------------------------------------------------- #
# eval_hooks
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("driver", ["offpolicy", "onpolicy"])
def test_evaluate_reads_eval_hooks(driver):
    """A driver given evaluation hooks (``offpolicy.py:107-112``,
    ``onpolicy.py:30-31``) evaluates their engine: Checkers stage 2
    trains on episodes capped at 7 steps and evaluates 8 steps of
    episodes capped at 3; JAX's ``evaluate`` with the same hooks, fed
    the same draws, gives the same returns and action distribution,
    which differ from the training hooks' evaluation."""
    n_eval, max_steps = 6, 8
    je, te = tp.envs(max_steps=7)
    je3, te3 = tp.envs(max_steps=3)
    ja, ta = tp.algs(je.spec(), fused_opt=False)
    kw = dict(N_eval=n_eval, max_steps=max_steps)
    jcls, tcls = ((JaxDriver, OffPolicyDriver) if driver == "offpolicy"
                  else (JaxOnPolicy, OnPolicyDriver))
    jd = jcls(jax_hooks("checkers", je), ja, jcfg.TrainConfig(**kw),
              eval_hooks=jax_hooks("checkers", je3))
    td = tcls(make_hooks("checkers", te), ta, tcfg.TrainConfig(**kw),
              eval_hooks=make_hooks("checkers", te3))
    plain = tcls(make_hooks("checkers", te), ta, tcfg.TrainConfig(**kw))
    assert td.eval_hooks.env is te3 and plain.eval_hooks is plain.hooks
    batch = tp.replay_batch(je, 2, np.random.default_rng(0))
    jts = ja.init_state(jax.random.PRNGKey(3), batch["obs"], batch["state"],
                        batch["goals"])
    tts = convert.state_from_jax(ta, jax.device_get(jts))
    key = jax.random.PRNGKey(8)
    jl, jg, jaux = jax.jit(jd.evaluate, static_argnums=(2,))(jts, key, n_eval)
    fed = lambda: prng.FedDraws(*tp.eval_draws(key, n_eval, 2, 5, max_steps),
                                device="cpu")
    tl, tg, taux = td.evaluate(tts, fed(), n_eval)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(float(tg), float(jg), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(taux["act_dist"].numpy(),
                               np.asarray(jaux["act_dist"]), rtol=RTOL,
                               atol=ATOL)
    pl, _, paux = plain.evaluate(tts, fed(), n_eval)
    assert not (torch.equal(pl, tl)
                and torch.equal(paux["act_dist"], taux["act_dist"]))
