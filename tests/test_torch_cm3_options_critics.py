"""The critics' options of CM3 in the port against the JAX update: the
V(s, g^n) ablation critic without Q_credit (``use_V``,
``use_Q_credit=0``) and ``use_Q_credit=0`` alone (the summed Q_actual
advantage), one, two and three updates from the same converted state on
the same batches and a' noise; and a random-fill and a training chunk
with ``pg_is_clip`` against JAX's ``_chunk``, the stored behavior
probability ``bp`` included."""

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
from cm3_tpu_torch.core.tree import tree_leaves
from cm3_tpu_torch.train.experiments import make_hooks
from cm3_tpu_torch.train.offpolicy import OffPolicyDriver, init_rollout
from tests import torch_parity as tp

tp.set_torch_cpu()

# (n_agents, AlgConfig options), on the optax path
CASES = {
    "use_V": (2, dict(use_Q_credit=False, use_V=True, lr_V=3e-3)),
    "no_credit": (2, dict(use_Q_credit=False)),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def runs(request):
    return tp.option_runs(request.param, *CASES[request.param])


@pytest.mark.parametrize("after", [1, 2, tp.OPTION_UPDATES])
def test_critic_options_match_jax(runs, after):
    """As ``torch_parity.hold_option_updates`` holds them."""
    tp.hold_option_updates(runs, after)


def test_critic_options_take_effect(runs):
    """As ``torch_parity.hold_options_take_effect`` holds it."""
    tp.hold_options_take_effect(runs)


# --------------------------------------------------------------------- #
# the stored behavior probability
# --------------------------------------------------------------------- #

E, CAP, SPT, U, EPS = 8, 64, 10, 2, 0.2


def test_chunks_store_behavior_probs_as_jax():
    """A random-fill chunk (bp = 1/A) and a training chunk (bp of the
    stored action under the eps-mixed policy, then U updates with the
    importance weight) with ``pg_is_clip`` on, against JAX's
    ``_chunk`` with its draws fed in: the replay rows, ``bp`` among
    them, and the state after the updates at the parity tolerance."""
    je, te = tp.envs(max_steps=7)
    ja, ta = tp.algs(je.spec(), fused_opt=False, pg_is_clip=1.0)
    kw = dict(n_envs=E, buffer_size=CAP, batch_size=tp.OPTION_B,
              steps_per_train=SPT, updates_per_chunk=U)
    jd = JaxDriver(jax_hooks("checkers", je), ja, jcfg.TrainConfig(**kw))
    td = OffPolicyDriver(make_hooks("checkers", te), ta,
                         tcfg.TrainConfig(**kw))
    jrs = jax_init_rollout(jd.hooks, jax.random.PRNGKey(0), E)
    jts = ja.init_state(jax.random.PRNGKey(1), jrs.obs, jrs.state, jrs.goals)
    zeros = jnp.zeros((E, 2), jnp.int32)
    tr = jd._transition(jrs, zeros,
                        jax.vmap(je.step)(jrs.env_state, zeros)[1], None)
    assert "bp" in tr
    jbuf = jreplay.init(jax.tree_util.tree_map(lambda x: x[0], tr), CAP)
    trs = init_rollout(td.hooks, E)
    tts = convert.state_from_jax(ta, jax.device_get(jts))
    tbuf = td._replay_init(td.example_transition(trs))
    assert "bp" in tbuf.data

    key = jax.random.PRNGKey(11)
    jts, jbuf, jrs, _ = jd._chunk_fill(jts, jbuf, jrs, EPS, key)
    draws = prng.FedDraws(*tp.chunk_draws(key, E, 2, 5, SPT, True),
                          device="cpu")
    tts, tbuf, trs, _ = td._chunk(tts, tbuf, trs, EPS, draws, False, True)
    fill_bp = tbuf.data["bp"]
    assert torch.equal(fill_bp, torch.full_like(fill_bp, 0.2))

    key = jax.random.PRNGKey(12)
    size = min(int(jbuf.size) + SPT * E, CAP)
    jts, jbuf, jrs, jm = jd._chunk_train(jts, jbuf, jrs, EPS, key)
    draws = prng.FedDraws(*tp.chunk_draws(
        key, E, 2, 5, SPT, False, U, tp.OPTION_B, [size] * U), device="cpu")
    tts, tbuf, trs, tm = td._chunk(tts, tbuf, trs, EPS, draws, True, False)
    assert draws.remaining() == {"randint": 0, "gumbel": 0}
    jbuf = jax.device_get(jbuf)
    assert (tbuf.insert, tbuf.size) == (int(jbuf.insert), int(jbuf.size))
    for path, leaf in tree_leaves(tbuf.data):
        want = jbuf.data
        for k in path:
            want = want[k]
        want = np.asarray(want)
        if np.issubdtype(want.dtype, np.floating):
            np.testing.assert_allclose(leaf.numpy(), want, rtol=1e-5,
                                       atol=1e-6, err_msg="/".join(path))
        else:
            np.testing.assert_array_equal(leaf.numpy(), want,
                                          err_msg="/".join(path))
    bp = tbuf.data["bp"].numpy()
    assert ((bp > 0.04) & (bp < 1.0)).all() and (bp != 0.2).any()
    tp.hold_states(tts, convert.state_from_jax(ta, jax.device_get(jts)),
                   ta.net_names())
    assert set(tm) == set(jm)
    for k in tm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   err_msg=k)
