"""The gradient snapshot through the drivers, against the JAX package's
with JAX's draws fed in (the snapshot's from its own keys,
``fold_in(k_eval, 1_000_000 + period)``): the off-policy ``run`` on
Checkers stage 1 and the on-policy ``run`` on particle, each with
``summarize`` on; their rows' ``_grads`` equal JAX's, and the same run
with ``summarize`` off gives the same rows and the same state bit for
bit."""

import jax
import numpy as np
import pytest
import torch

from cm3_tpu.core import config as jcfg
from cm3_tpu.train.experiments import make_hooks as jax_hooks
from cm3_tpu.train.offpolicy import OffPolicyDriver as JaxDriver
from cm3_tpu.train.onpolicy import OnPolicyDriver as JaxOnPolicy
from cm3_tpu_torch import convert
from cm3_tpu_torch.core import config as tcfg
from cm3_tpu_torch.core import prng
from cm3_tpu_torch.train.experiments import make_hooks
from cm3_tpu_torch.train.offpolicy import OffPolicyDriver
from cm3_tpu_torch.train.onpolicy import OnPolicyDriver
from tests import torch_parity as tp
from tests.test_torch_summaries import RTOL, ATOL, hold_grads

tp.set_torch_cpu()

SKIP = ("episode", "epsilon", "duration_s", "t_env", "t_train", "_episodes",
        "_grads")


def hold_rows(jh, th):
    """Rows with the same keys in the same order, epsilons exactly, the
    rest at rtol 1e-5 / atol 1e-6."""
    assert [r["episode"] for r in th] == [r["episode"] for r in jh]
    for j, t in zip(jh, th):
        assert list(t) == list(j)
        assert t["epsilon"] == pytest.approx(j["epsilon"], rel=1e-12)
        for k in j:
            if k not in SKIP:
                np.testing.assert_allclose(np.asarray(t[k]),
                                           np.asarray(j[k]), rtol=RTOL,
                                           atol=ATOL, err_msg=k)


def same_rows(a, b):
    """Two of the port's histories equal but for the clock and
    ``_grads``."""
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert [k for k in x if k != "_grads"] == list(y)
        for k in y:
            if k == "_episodes":
                for u, v in zip(x[k], y[k]):
                    np.testing.assert_array_equal(u, v)
            elif k not in ("duration_s", "t_env", "t_train"):
                np.testing.assert_array_equal(x[k], y[k], err_msg=k)


def same_state(a, b, nets):
    for name in nets:
        for suffix in ("", "_tgt"):
            assert torch.equal(getattr(a, name + suffix).flat,
                               getattr(b, name + suffix).flat)
        oa, ob = getattr(a, "opt_" + name), getattr(b, "opt_" + name)
        assert torch.equal(oa.mu, ob.mu) and torch.equal(oa.nu, ob.nu)
        assert int(oa.count) == int(ob.count)
    assert int(a.step) == int(b.step)


def snapshot_draws(key, batch, size, n_agents, cls=tp.ParticleDraws):
    """The draws of one gradient snapshot from ``key``: the replay
    sample's indices, then the update's a' noise."""
    d = cls(n_agents)
    d.update(key, batch, size)
    return d.fed()


# --------------------------------------------------------------------- #
# off-policy: Checkers stage 1, rows at 8 (after the random fill: no
# snapshot) and 16 (after two training chunks: a snapshot of the full
# ring of 64)
# --------------------------------------------------------------------- #

E, SPT, U, B, CAP = 4, 5, 2, 8, 64
RUN = dict(n_envs=E, steps_per_train=SPT, updates_per_chunk=U, batch_size=B,
           buffer_size=CAP, pretrain_episodes=8, period=8, N_train=16,
           N_eval=3, max_steps=5, episode_log=6)


def _offpolicy_draws(key):
    k_init, k_loop, k_eval = jax.random.split(key, 3)
    randints, gumbels = [tp.goal_draws(k_init, E)], []
    size = 0
    for c in range(4):
        size = min(size + SPT * E, CAP)
        r, g = tp.chunk_draws(jax.random.fold_in(k_loop, c), E, 1, 5, SPT,
                              c < 2, 0 if c < 2 else U, B, [size] * U)
        randints += r
        gumbels += g
    ev = [tp.eval_draws(jax.random.fold_in(k_eval, p), RUN["N_eval"], 1, 5,
                        RUN["max_steps"]) for p in (1, 2)]
    fed = lambda r, g: prng.FedDraws(r, g, device="cpu")
    return (lambda: fed(randints, gumbels),
            lambda: fed(*(sum((e[i] for e in ev), []) for i in range(2))),
            lambda: snapshot_draws(jax.random.fold_in(k_eval, 1_000_002),
                                   B, CAP, 1))


@pytest.fixture(scope="module")
def offpolicy_runs():
    je, te = tp.envs(max_steps=5, n_agents=1)
    ja, ta = tp.algs(je.spec(), fused_opt=False)
    jd = JaxDriver(jax_hooks("checkers", je), ja,
                   jcfg.TrainConfig(**RUN, summarize=True))
    batch = tp.replay_batch(je, 2, np.random.default_rng(0))
    jts = ja.init_state(jax.random.PRNGKey(3), batch["obs"], batch["state"],
                        batch["goals"])
    start = jax.device_get(jts)
    key = jax.random.PRNGKey(21)
    jts, jout = jd.run(jts, key)
    draws, evals, snaps = _offpolicy_draws(key)
    out = {"jax": (convert.state_from_jax(ta, jax.device_get(jts)), jout),
           "alg": ta}
    for on in (True, False):
        td = OffPolicyDriver(make_hooks("checkers", te), ta,
                             tcfg.TrainConfig(**RUN, summarize=on))
        d, e, s = draws(), evals(), snaps()
        logged = []
        ts, tout = td.run(convert.state_from_jax(ta, start), draws=d,
                          eval_draws=e, snapshot_draws=s if on else None,
                          log_fn=logged.append)
        assert not any(d.remaining().values())
        assert not any(e.remaining().values())
        out[on] = (ts, tout, logged, s)
    return out


def test_offpolicy_snapshot_matches_jax(offpolicy_runs):
    """Only the row after training carries ``_grads`` (the fill's does
    not, as JAX's), equal to JAX's by name; every other key as JAX's;
    the snapshot took exactly its draws; ``log_fn`` sees the gradients
    with the state."""
    want, jout = offpolicy_runs["jax"]
    ts, tout, logged, s = offpolicy_runs[True]
    jh, th = jout["history"], tout["history"]
    hold_rows(jh, th)
    assert ["_grads" in r for r in th] == ["_grads" in r for r in jh] == [
        False, True]
    hold_grads(ts, th[1]["_grads"], jh[1]["_grads"])
    assert not any(s.remaining().values())
    assert logged[1]["_grads"] is th[1]["_grads"]
    tp.hold_states(ts, want, ("actor", "qg"))


def test_offpolicy_summaries_change_no_training(offpolicy_runs):
    """The same run with ``summarize`` off: the same rows (but
    ``_grads``) and the same final state, bit for bit."""
    on, off = offpolicy_runs[True], offpolicy_runs[False]
    same_rows(on[1]["history"], off[1]["history"])
    same_state(on[0], off[0], ("actor", "qg"))
    assert "_grads" not in off[1]["history"][1]


# --------------------------------------------------------------------- #
# on-policy: particle CM3 stage 2, rows at 4, 8, 12 and 16; a burst at 12
# discards the ring, so only the row at 16 (a ring of 20) snapshots
# --------------------------------------------------------------------- #

EPOCHS = 2
ONRUN = dict(n_envs=E, steps_per_train=SPT, batch_size=B, epochs=EPOCHS,
             buffer_size=CAP, pretrain_episodes=8, episodes_per_train=12,
             period=4, N_train=16, N_eval=3, max_steps=5, episode_log=6)


@pytest.fixture(scope="module")
def onpolicy_runs():
    je, te = tp.particle_envs("stage2_antipodal", prob_random=0.0,
                              max_steps=5)
    ja, ta = tp.particle_algs("cm3", je.spec())
    jd = JaxOnPolicy(jax_hooks("particle", je), ja,
                     jcfg.TrainConfig(**ONRUN, summarize=True))
    batch = tp.particle_batch(je, 2, np.random.default_rng(0))
    jts = ja.init_state(jax.random.PRNGKey(3), batch["obs"], batch["state"],
                        batch["goals"])
    start = jax.device_get(jts)
    key = jax.random.PRNGKey(21)
    jts, jout = jd.run(jts, key)
    k_init, k_loop, k_eval = jax.random.split(key, 3)

    def draws():
        d = tp.ParticleDraws(4)
        d.reset(k_init, E)
        for c in range(4):
            k = jax.random.fold_in(k_loop, c)
            d.rollout(k, E, SPT, c < 2)
            if c == 2:
                d.burst(jax.random.fold_in(k, 1), EPOCHS, B, 3 * SPT * E)
        return d.fed()

    def evals():
        ev = tp.ParticleDraws(4)
        for p in range(1, 5):
            ev.evaluate(jax.random.fold_in(k_eval, p), ONRUN["N_eval"],
                        ONRUN["max_steps"])
        return ev.fed()

    out = {"jax": (convert.state_from_jax(ta, jax.device_get(jts)), jout)}
    for on in (True, False):
        td = OnPolicyDriver(make_hooks("particle", te), ta,
                            tcfg.TrainConfig(**ONRUN, summarize=on))
        d, e = draws(), evals()
        s = snapshot_draws(jax.random.fold_in(k_eval, 1_000_004), B,
                           SPT * E, 4)
        ts, tout = td.run(convert.state_from_jax(ta, start), draws=d,
                          eval_draws=e, snapshot_draws=s if on else None)
        assert not any(d.remaining().values())
        assert not any(e.remaining().values())
        out[on] = (ts, tout, s)
    return out


def test_onpolicy_snapshot_matches_jax(onpolicy_runs):
    """The rows' keys as JAX's (no learning metrics: JAX's single-seed
    quirk); ``_grads`` only at 16, where the ring holds the 20 rows of
    the chunk after the burst, equal to JAX's by name."""
    want, jout = onpolicy_runs["jax"]
    ts, tout, s = onpolicy_runs[True]
    jh, th = jout["history"], tout["history"]
    hold_rows(jh, th)
    assert [r["episode"] for r in th] == [4, 8, 12, 16]
    assert ["_grads" in r for r in th] == ["_grads" in r for r in jh] == [
        False, False, False, True]
    hold_grads(ts, th[3]["_grads"], jh[3]["_grads"])
    assert not any(s.remaining().values())
    tp.hold_states(ts, want, ("actor", "qg", "qc"))


def test_onpolicy_summaries_change_no_training(onpolicy_runs):
    on, off = onpolicy_runs[True], onpolicy_runs[False]
    same_rows(on[1]["history"], off[1]["history"])
    same_state(on[0], off[0], ("actor", "qg", "qc"))
