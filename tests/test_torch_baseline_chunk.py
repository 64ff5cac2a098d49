"""One whole ``OffPolicyDriver._chunk`` of COMA and of QMIX in the port
against the JAX chunk, with JAX's draws fed in (QMIX's override draws
among them): a random-fill chunk, then a training chunk of 10 env
steps with replay adds and auto-resets and 3 updates; and one greedy
evaluation of QMIX with its draws."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

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

E, CAP, B, U, SPT, EPS = 8, 64, 16, 3, 10, 0.3
KINDS = {"coma": ("baseline", dict(use_Q=True)), "qmix": ("qmix", dict())}


def _fed(kind, draws):
    """A ``FedDraws`` of ``tp.chunk_draws``' output for ``kind``."""
    if kind == "qmix":
        randints, gumbels, uniforms = draws
        return prng.FedDraws(randints, gumbels, device="cpu",
                             uniforms=uniforms)
    return prng.FedDraws(*draws, device="cpu")


@pytest.fixture(scope="module", params=sorted(KINDS))
def runs(request):
    name = request.param
    kind, opts = KINDS[name]
    qmix = kind == "qmix"
    je, te = tp.envs(max_steps=7)
    ja, ta = tp.other_algs(kind, je.spec(), **opts)
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
    tbuf = td._replay_init(td.example_transition(trs))

    out = {"name": name}
    key = jax.random.PRNGKey(11)
    jts, jbuf, jrs, _ = jd._chunk_fill(jts, jbuf, jrs, EPS, key)
    draws = _fed(kind, tp.chunk_draws(key, E, 2, 5, SPT, True, qmix=qmix))
    tts, tbuf, trs, _ = td._chunk(tts, tbuf, trs, EPS, draws, False, True)
    assert not any(draws.remaining().values())
    key = jax.random.PRNGKey(12)
    size = min(int(jbuf.size) + SPT * E, CAP)
    jts, jbuf, jrs, jm = jd._chunk_train(jts, jbuf, jrs, EPS, key)
    draws = _fed(kind, tp.chunk_draws(key, E, 2, 5, SPT, False, U, B,
                                      [size] * U, qmix=qmix))
    tts, tbuf, trs, tm = td._chunk(tts, tbuf, trs, EPS, draws, True, False)
    assert not any(draws.remaining().values())
    out["train"] = (jax.device_get((jrs, jbuf)), (trs, tbuf))
    out["alg"] = (convert.state_from_jax(ta, jax.device_get(jts)), tts,
                  jax.device_get(jm), tm, ta)
    out["eval"] = (jd, td, jts, tts, ta)
    return out


# floats carry one-ulp differences from the engine's normalized
# coordinates through the nets, as in test_torch_chunk.py
RTOL, ATOL = 1e-5, 1e-6


def _close(got, want, name):
    got, want = got.numpy(), np.asarray(want)
    if np.issubdtype(want.dtype, np.floating):
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                                   err_msg=name)
    else:
        np.testing.assert_array_equal(got, want, err_msg=name)


def test_rollout_and_replay_match(runs):
    """The training chunk's actions (the policy's: QMIX's override and
    argmax, COMA's sample) reach the same replay rows, returns and
    episode counts as JAX's."""
    (jrs, jbuf), (trs, tbuf) = runs["train"]
    assert (tbuf.insert, tbuf.size) == (int(jbuf.insert), int(jbuf.size))
    for path, leaf in tree_leaves(tbuf.data):
        want = jbuf.data
        for k in path:
            want = want[k]
        _close(leaf, want, "replay " + "/".join(path))
    for name in ("a_prev", "ep_ret_local", "episodes"):
        _close(getattr(trs, name), getattr(jrs, name), name)
    assert int(trs.episodes) > 0


def test_training_chunk_matches(runs):
    """After the chunk's 3 updates: the state at the update tests'
    tolerances (QMIX at ``tp.QMIX_TOL``) and the last update's
    metrics."""
    want, got, jm, tm, alg = runs["alg"]
    tol = tp.QMIX_TOL if runs["name"] == "qmix" else {}
    tp.hold_states(got, want, alg.net_names(), **tol)
    assert got.step == want.step == U
    assert set(tm) == set(jm)
    for k in tm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


def test_evaluate_matches(runs):
    """``evaluate`` at epsilon 0 with JAX's draws fed in (QMIX: each
    step's override actions and uniforms, never taken at epsilon 0):
    the same returns and action distribution."""
    jd, td, jts, tts, ta = runs["eval"]
    key, n_eval = jax.random.PRNGKey(21), 4
    jl, jg, jaux = jd.evaluate(jts, key, n_eval)
    ks = jax.random.split(key, td.cfg.max_steps)
    if runs["name"] == "qmix":
        pairs = [tp.qmix_act_draws(k, (n_eval, 2), 5) for k in ks]
        draws = prng.FedDraws([p[0] for p in pairs], device="cpu",
                              uniforms=[p[1] for p in pairs])
    else:
        draws = prng.FedDraws(*tp.eval_draws(key, n_eval, 2, 5,
                                             td.cfg.max_steps), device="cpu")
    tl, tg, taux = td.evaluate(tts, draws, n_eval)
    assert not any(draws.remaining().values())
    _close(tl, jl, "r_local")
    _close(tg, jg, "r_global")
    _close(taux["act_dist"], jaux["act_dist"], "act_dist")
