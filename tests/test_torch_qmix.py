"""The port's QMIX (``cm3_tpu_torch.algs.qmix``) against the JAX
package's: one and three updates from the same converted state on the
same batches, with ``qmix_ref_bug`` off and on and with ``grad_clip``
10, whose one norm over agent nets and mixer a per-network clip would
miss; ``act`` with JAX's override draws fed in at epsilon 0, 0.3 and 1;
and the mixer's monotonicity."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from cm3_tpu_torch import convert
from cm3_tpu_torch.algs import common
from tests import torch_parity as tp

tp.set_torch_cpu()

CASES = {"plain": dict(), "ref_bug": dict(qmix_ref_bug=True),
         "clip": dict(grad_clip=10.0),
         "ref_bug_clip": dict(qmix_ref_bug=True, grad_clip=10.0)}


@pytest.fixture(scope="module", params=sorted(CASES))
def runs(request):
    out = tp.other_runs("qmix", CASES[request.param])
    out["case"] = request.param
    return out


@pytest.mark.parametrize("after", [1, tp.OPTION_UPDATES])
def test_qmix_updates_match_jax(runs, after):
    """The joint network (agent nets and mixer), its target, the one
    Adam state at rtol 1e-5 / atol 1e-4 (nu atol 1e-7; ``tp.QMIX_TOL``
    says why) and ``loss_mixer`` at rtol 1e-5 / atol 1e-6: float32 sums
    in other orders."""
    tp.hold_other_updates(runs, after, **tp.QMIX_TOL)


@pytest.mark.parametrize("case", ["plain", "ref_bug"])
def test_qmix_gradient_matches_jax(case):
    """The first update's gradient over the joint buffer equals JAX's
    (``with_grads``: agent, then mixer, ``ravel_pytree`` order) at rtol
    1e-5 / atol 2e-7 of max |g| (float32 sums of terms as large as the
    largest gradient: measured 1.2e-7 of it), and where |g| < 1e-6
    within 1e-8 (measured 1.2e-9): the rounding Adam amplifies."""
    je, _ = tp.envs()
    ja, ta = tp.other_algs("qmix", je.spec(), **CASES[case])
    batch = tp.replay_batch(je, tp.OPTION_B, np.random.default_rng(0))
    jts = ja.init_state(jax.random.PRNGKey(1), batch["obs"], batch["state"],
                        batch["goals"])
    tts = convert.state_from_jax(ta, jax.device_get(jts))
    _, jm = jax.jit(lambda t, b: ja.update(
        t, b, 0.2, jax.random.PRNGKey(0), with_grads=True))(jts, batch)
    g = jax.device_get(jm["grads"])
    vec, _ = ravel_pytree(({"params": g["Agent"]["params"]},
                           {"params": g["Mixer"]["params"]}))
    want = convert.flat_to_torch(tts.qmix, np.asarray(vec))
    tts, _ = ta.update(tts, tp.to_torch(jax.device_get(batch)), 0.2, None)
    got, want = tts.qmix.flat_grad.numpy(), want.numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=2e-7 * np.abs(want).max())
    tiny = np.abs(want) < 1e-6
    assert tiny.sum() > 1000
    np.testing.assert_allclose(got[tiny], want[tiny], rtol=0, atol=1e-8)


def test_ref_bug_changes_the_target():
    """``qmix_ref_bug`` takes the main nets' q at a*: the same as the
    target nets' while they are equal (the first update), different
    after, so three updates end apart."""
    plain, bug = (tp.other_runs("qmix", CASES[c]) for c in ("plain",
                                                            "ref_bug"))
    assert torch.equal(plain["states"][0][1].qmix.flat,
                       bug["states"][0][1].qmix.flat)
    assert not torch.equal(plain["states"][-1][1].qmix.flat,
                           bug["states"][-1][1].qmix.flat)


def _per_network_clip(split):
    """``common.clip_by_global_norm`` with one norm for the agent nets'
    segment [:split] and one for the mixer's."""
    clip = common.clip_by_global_norm

    def per_network(g, max_norm):
        return torch.cat([clip(g[..., :split], max_norm),
                          clip(g[..., split:], max_norm)], dim=-1)
    return per_network


def test_clip_is_one_norm_over_agent_and_mixer(monkeypatch):
    """At ``grad_clip`` 10 the first update's joint gradient norm is
    above 10, so the clip acts.  JAX clips one norm over both networks
    (``optax.flatten`` over the pair): the port holds JAX's update
    (``test_qmix_updates_match_jax[clip]``), and with a norm per
    network instead it misses it far beyond the tolerance."""
    runs = tp.other_runs("qmix", CASES["clip"], n_updates=1)
    alg, want = runs["alg"], runs["states"][0][0]
    batch = tp.to_torch(jax.device_get(runs["batches"][0]))
    st, _ = alg.update(tp.copy_state(alg, runs["start"]), batch, 0.2, None)
    grad = st.qmix.flat_grad
    split = sum(p.numel() for n, p in st.qmix.named_parameters()
                if n.startswith("agent."))
    norms = [float(grad[sl].norm()) for sl in (slice(None), slice(split),
                                               slice(split, None))]
    assert norms[0] > 10.0 and min(norms[1:]) > 0.0, norms
    np.testing.assert_allclose(st.qmix.flat.numpy(), want.qmix.flat.numpy(),
                               rtol=1e-5, atol=tp.QMIX_TOL["atol"])
    monkeypatch.setattr(common, "clip_by_global_norm",
                        _per_network_clip(split))
    st, _ = alg.update(tp.copy_state(alg, runs["start"]), batch, 0.2, None)
    diff = float((st.qmix.flat - want.qmix.flat).abs().max())
    assert diff > 1e-4, diff


@pytest.fixture(scope="module")
def act_setup():
    """A JAX QMIX state after one update (so targets and mains differ)
    and the port's, with a batch of observations."""
    je, _ = tp.envs()
    ja, ta = tp.other_algs("qmix", je.spec())
    rng = np.random.default_rng(4)
    batch = tp.replay_batch(je, 64, rng)
    jts = ja.init_state(jax.random.PRNGKey(2), batch["obs"], batch["state"],
                        batch["goals"])
    jts, _ = jax.jit(ja.update)(jts, batch, 0.1, jax.random.PRNGKey(3))
    return ja, ta, jts, convert.state_from_jax(ta, jax.device_get(jts)), \
        batch


@pytest.mark.parametrize("eps", [0.0, 0.3, 1.0])
def test_act_matches_jax_with_its_draws(act_setup, eps):
    """``act`` equals JAX's ``act`` given the random actions and the
    uniforms JAX draws from its key, in JAX's order; at 0.3 both the
    greedy and the random branch occur, and the greedy one is the
    argmax of the agent nets."""
    ja, ta, jts, tts, batch = act_setup
    key = jax.random.PRNGKey(int(eps * 10) + 7)
    want = np.asarray(ja.act(jts, batch["obs"], batch["goals"],
                             batch["a_prev"], eps, key))
    shape = batch["a_prev"].shape
    rand_a, u = tp.qmix_act_draws(key, shape, 5)
    tb = tp.to_torch(jax.device_get(batch))
    got = ta.act(tts, tb["obs"], tb["goals"], tb["a_prev"], eps,
                 (torch.from_numpy(rand_a.astype(np.int64)),
                  torch.from_numpy(u.copy())))
    np.testing.assert_array_equal(got.numpy(), want)
    greedy = np.asarray(jnp.argmax(ja._agent_qs(
        jts.agent, batch["obs"], batch["goals"], batch["a_prev"]), -1))
    explore = u < eps
    assert explore.all() if eps == 1.0 else (
        not explore.any() if eps == 0.0 else 0 < explore.mean() < 1)
    np.testing.assert_array_equal(want[~explore], greedy[~explore])
    np.testing.assert_array_equal(want[explore], rand_a[explore])


def test_mixer_is_monotonic(act_setup):
    """Q_tot never falls when one agent's q rises
    (``tests/test_qmix_baseline.py:42-48``), and the port's mixer equals
    JAX's on the same inputs."""
    ja, ta, jts, tts, batch = act_setup
    tb = tp.to_torch(jax.device_get(batch))
    b = batch["a"].shape[0]
    rng = np.random.default_rng(5)
    q0 = rng.normal(size=(b, 2)).astype(np.float32)
    with torch.no_grad():
        base = ta._mix(tts.qmix, torch.from_numpy(q0), tb["state"],
                       tb["goals"])
        np.testing.assert_allclose(
            base.numpy(), np.asarray(ja._mix(jts.mixer, q0, batch["state"],
                                             batch["goals"])),
            rtol=1e-5, atol=1e-6)
        for i in range(2):
            up = q0.copy()
            up[:, i] += 1.0
            got = ta._mix(tts.qmix, torch.from_numpy(up), tb["state"],
                          tb["goals"])
            assert (got >= base - 1e-6).all()
            assert (got > base).any()
