"""The on-policy driver with shard-local replay against the JAX
package's, with JAX's draws fed in: particle CM3's fill chunk, policy
chunk and burst at D = 2, and the discard, which zeroes every shard's
device cursors.  Tolerances as ``test_torch_onpolicy.py``'s: the nets'
float32 sums in other orders, rtol 1e-5 / atol 1e-6; replay rows and
cursors exactly."""

import jax
import jax.numpy as jnp
import numpy as np

from cm3_tpu.core import config as jcfg
from cm3_tpu.train.experiments import make_hooks as jax_hooks
from cm3_tpu.train.offpolicy import init_rollout as jax_init_rollout
from cm3_tpu.train.onpolicy import OnPolicyDriver as JaxOnPolicy
from cm3_tpu_torch import convert
from cm3_tpu_torch.core import config as tcfg
from cm3_tpu_torch.train.experiments import make_hooks
from cm3_tpu_torch.train.offpolicy import init_rollout
from cm3_tpu_torch.train.onpolicy import OnPolicyDriver
from tests import torch_parity as tp
from tests.test_torch_sharded_driver import hold_ring

tp.set_torch_cpu()

RTOL, ATOL = 1e-5, 1e-6


PE, PCAP, PB, PSPT, PEPOCHS, PD, EPS = 4, 64, 16, 5, 3, 2, 0.2


def test_onpolicy_burst_matches_jax():
    """Particle CM3 on-policy with D = 2: a fill chunk and a policy
    chunk (every shard 20 rows), a burst of 3 updates drawing 8 rows
    from each shard, then the discard: the state and metrics, the
    shards' rows and cursors, and every cursor 0 after it."""
    kw = dict(n_envs=PE, buffer_size=PCAP, batch_size=PB,
              steps_per_train=PSPT, epochs=PEPOCHS, episode_log=16,
              replay_shards=PD)
    je, te = tp.particle_envs("stage2_antipodal", prob_random=0.5,
                              max_steps=7)
    ja, ta = tp.particle_algs("cm3", je.spec())
    jd = JaxOnPolicy(jax_hooks("particle", je), ja, jcfg.TrainConfig(**kw))
    td = OnPolicyDriver(make_hooks("particle", te), ta,
                        tcfg.TrainConfig(**kw))
    k0 = jax.random.PRNGKey(0)
    jrs = jax_init_rollout(jd.hooks, k0, PE, 16)
    jts = ja.init_state(jax.random.PRNGKey(1), jrs.obs, jrs.state, jrs.goals)
    zeros = jnp.zeros((PE, 4), jnp.int32)
    tr = jd._transition(jrs, zeros, jax.vmap(je.step)(jrs.env_state,
                                                      zeros)[1], None)
    jbuf = jd._replay_init(jax.tree_util.tree_map(lambda x: x[0], tr))
    keys = [jax.random.PRNGKey(11 + i) for i in range(3)]
    d = tp.ParticleDraws(4)
    d.reset(k0, PE)
    d.rollout(keys[0], PE, PSPT, True)
    d.rollout(keys[1], PE, PSPT, False)
    d.burst(keys[2], PEPOCHS, PB, np.full(PD, 2 * PSPT * PE // PD))
    draws = d.fed()
    trs = init_rollout(td.hooks, PE, draws, 16)
    tts = convert.state_from_jax(ta, jax.device_get(jts))
    tbuf = td._replay_init(td.example_transition(trs))
    jbuf, jrs = jd._rollout(jts, jbuf, jrs, keys[0], True, EPS)
    tbuf, trs = td._rollout_chunk(tts, tbuf, trs, EPS, draws, True)
    jbuf, jrs = jd._rollout(jts, jbuf, jrs, keys[1], False, EPS)
    tbuf, trs = td._rollout_chunk(tts, tbuf, trs, EPS, draws, False)
    hold_ring(tbuf, jax.device_get(jbuf), "ring")
    jts, jm = jd._burst(jts, jbuf, EPS, keys[2])
    tts, tm = td._train_burst(tts, tbuf, EPS, draws)
    assert not any(draws.remaining().values()), draws.remaining()
    tp.hold_states(tts, convert.state_from_jax(ta, jax.device_get(jts)),
                   ta.net_names())
    for k in tm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=RTOL,
                                   atol=ATOL, err_msg=k)
    assert td.filled(tbuf) == 2 * PSPT * PE
    td.discard(tbuf)
    assert tbuf.size.tolist() == tbuf.insert.tolist() == [0] * PD
    assert td.filled(tbuf) == 0
