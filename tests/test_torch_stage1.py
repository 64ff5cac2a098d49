"""Stage 1, the single-agent game (n_agents = 1): the port's engine, its
goals and its CM3 update (Q_global counterfactual, no Q_credit) against
the JAX package on the same inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cm3_tpu.train.experiments import make_hooks as jax_hooks
from cm3_tpu_torch import convert
from cm3_tpu_torch.core import prng
from cm3_tpu_torch.train.experiments import make_hooks
from tests import torch_parity as tp

tp.set_torch_cpu()


def _snake(goal_green):
    """Actions that walk the agent from its start cell through all 24
    reward cells: along its start row to the left, one row over, back to
    the right, one row over, to the left (3 = left, 4 = right, 1 = up,
    2 = down)."""
    turn = 2 if goal_green else 1
    return [3] * 8 + [turn] + [4] * 7 + [turn] + [3] * 7


@pytest.mark.parametrize("goal", [0, 1], ids=["green", "orange"])
def test_engine_reset_and_termination_match_jax(goal):
    """The start row follows the goal (row 0 green, row 2 orange), and
    the episode ends on the step that collects the twelfth cell of the
    goal's colour, well before the step cap: every field at every step,
    bit-exact except the normalized coordinates (one float32 ulp, rtol
    2^-23: compiled XLA multiplies by the reciprocal)."""
    e = 4
    je, te = tp.envs(max_steps=40, n_agents=1)
    goals = np.zeros((e, 1, 2), np.float32)
    goals[:, 0, goal] = 1.0
    js, jts = jax.jit(jax.vmap(je.reset))(
        jax.random.split(jax.random.PRNGKey(0), e), jnp.asarray(goals))
    ts_, tts = te.reset(torch.from_numpy(goals))
    np.testing.assert_array_equal(ts_.loc.numpy(), np.asarray(js.loc))
    assert int(ts_.loc[0, 0, 0]) == te.cfg.n_obs + (0 if goal == 0 else 2)
    step = jax.jit(jax.vmap(je.step))
    done_at = None
    for t, a in enumerate(_snake(goal == 0)):
        acts = np.full((e, 1), a)
        js, jts = step(js, jnp.asarray(acts, jnp.int32))
        ts_, tts = te.step(ts_, torch.from_numpy(acts))
        np.testing.assert_array_equal(ts_.world.numpy(), np.asarray(js.world))
        np.testing.assert_array_equal(tts.done.numpy(), np.asarray(jts.done))
        np.testing.assert_array_equal(tts.reward_local.numpy(),
                                      np.asarray(jts.reward_local))
        for k in jts.obs:
            np.testing.assert_allclose(tts.obs[k].numpy(),
                                       np.asarray(jts.obs[k]),
                                       rtol=2.0 ** -23, atol=0, err_msg=k)
        np.testing.assert_array_equal(tts.state["vec"].numpy(),
                                      np.asarray(jts.state["vec"]))
        if done_at is None and bool(tts.done[0]):
            done_at = t + 1
    assert done_at is not None and done_at < 40
    # others is the agent's own normalized location
    np.testing.assert_array_equal(tts.obs["others"].numpy(),
                                  tts.obs["self_v"][..., :2].numpy())


def test_hooks_goals_match_jax():
    """``episode_init``: the goal index drawn per instance (fed JAX's
    draw), its one-hot and the reset it starts; identity goals for two
    agents, which draw nothing."""
    e = 64
    je, te = tp.envs(n_agents=1)
    key = jax.random.PRNGKey(4)
    keys = jax.vmap(lambda i: jax.random.fold_in(key, i))(jnp.arange(e))
    js, jts, jgoals = jax.vmap(jax_hooks("checkers", je).episode_init)(keys)
    draws = prng.FedDraws([tp.goal_draws(key, e)], device="cpu")
    ts_, tts, goals = make_hooks("checkers", te).episode_init(e, draws)
    assert draws.remaining() == {"randint": 0, "gumbel": 0}
    np.testing.assert_array_equal(goals.numpy(), np.asarray(jgoals))
    assert 0 < int(goals[:, 0, 0].sum()) < e
    np.testing.assert_array_equal(ts_.loc.numpy(), np.asarray(js.loc))
    np.testing.assert_array_equal(ts_.world.numpy(), np.asarray(js.world))
    je2, te2 = tp.envs()
    empty = prng.FedDraws(device="cpu")
    _, _, g2 = make_hooks("checkers", te2).episode_init((3, 5), empty)
    assert g2.shape == (3, 5, 2, 2)
    assert torch.equal(g2[2, 4], torch.eye(2))


@pytest.mark.parametrize("fused", [False, True], ids=["optax", "fused"])
def test_stage1_update_matches_jax(fused, monkeypatch):
    """One n = 1 update: Q_global's TD step, then the policy gradient
    with the baseline sum_a pi(a) Q(s, a) of the POST-update Q_global;
    no Q_credit.  Losses at rtol 1e-5; networks, targets and moments at
    rtol 1e-5 / atol 1e-6 (nu atol 1e-9).  The fused path makes two
    launches' worth of calls: Q_global's, then the actor's."""
    from cm3_tpu_torch.ops import fused_opt
    calls = []
    many = fused_opt.adam_polyak_many
    monkeypatch.setattr(fused_opt, "adam_polyak_many", lambda items, tau: (
        calls.append(len(items)), many(items, tau)))
    b = 16
    je, _ = tp.envs(n_agents=1)
    ja, ta = tp.algs(je.spec(), fused_opt=fused)
    batch = tp.replay_batch(je, b, np.random.default_rng(2))
    jts = ja.init_state(jax.random.PRNGKey(1), batch["obs"], batch["state"],
                        batch["goals"])
    tts = convert.state_from_jax(ta, jax.device_get(jts))
    assert tts.qc is None and tts.opt_qc is None
    key = jax.random.PRNGKey(6)
    jts2, jm = jax.jit(ja.update)(jts, batch, 0.2, key)
    gumbel = np.array(jax.random.gumbel(key, (b, 1, 5)))
    tts, tm = ta.update(tts, tp.to_torch(jax.device_get(batch)), 0.2,
                        torch.from_numpy(gumbel))
    assert set(tm) == set(jm) == {"loss_Q_global", "policy_loss"}
    for k in tm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   err_msg=k)
    tp.hold_states(tts, convert.state_from_jax(ta, jax.device_get(jts2)),
                   ("actor", "qg"))
    assert calls == ([1, 1] if fused else [])


def test_stage1_init_state_has_no_credit_critic():
    """``init_state`` for n = 1: actor and Q_global pairs, no Q_credit;
    with three seeds each network is [3, n] with distinct rows."""
    je, _ = tp.envs(n_agents=1)
    _, ta = tp.algs(je.spec(), fused_opt=False)
    st = ta.init_state(0)
    assert st.qc is None and st.qc_tgt is None and st.opt_qc is None
    _, t3 = tp.algs(je.spec(), n_seeds=3, fused_opt=False)
    st3 = t3.init_state([0, 1, 2])
    assert st3.qg.flat.shape == (3, st.qg.flat.numel())
    assert torch.equal(st3.qg.flat[0], st.qg.flat)
    assert not torch.equal(st3.qg.flat[0], st3.qg.flat[1])
