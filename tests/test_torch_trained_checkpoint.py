"""JAX's trained Checkers policies on the port: the committed
``runs/reproduce/saved/ck_s1_12344/model_final`` (stage 1, a seed
through the gate) and ``ck_s2_12341/model_final`` (stage 2, the
two-agent winner) restored with JAX's
``scripts/verify_checkpoints._build_and_restore`` and converted with
``convert.state_from_jax``: the greedy evaluation with JAX's draws fed
gives JAX's returns and action distribution (to the last place of
their float32 sums), and the policy's
probabilities on real observations equal JAX's at atol 1e-5."""

import os

import jax
import numpy as np
import pytest
import torch

from cm3_tpu.train import runner as jrunner
from cm3_tpu_torch import convert
from cm3_tpu_torch.core import prng
from cm3_tpu_torch.train import runner
from scripts import reproduce_paper as jrp
from scripts import verify_checkpoints as jvc
from tests import torch_parity as tp

tp.set_torch_cpu()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAVED = os.path.join(ROOT, "runs", "reproduce", "saved")
CASES = {"ck_s1_12344": "checkers_s1", "ck_s2_12341": "checkers_s2"}
N_EVAL = 10
# the same actions give the same rewards; their float32 sums differ in
# the last place where compiled XLA adds in another order (as in
# test_torch_evaluate.py)
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(scope="module", params=sorted(CASES))
def trained(request):
    """(JAX driver, JAX state, port driver, port algorithm, port state)
    of one committed checkpoint at the cell's full widths."""
    d = request.param
    m = jrunner.cfgmod.load_json("master.json")
    m.update(jrp.cells(50000)[CASES[d]])
    m.update(seed=int(d.rsplit("_", 1)[1]), dir_name=d)
    jd, jts = jvc._build_and_restore(m, os.path.join(SAVED, d,
                                                     "model_final"))
    td, ta, _, _ = runner.build(m, device="cpu")
    tts = convert.state_from_jax(ta, jax.device_get(jts))
    return jd, jts, td, ta, tts


def test_greedy_evaluation_equals_jax(trained):
    """Ten greedy episodes from JAX's evaluation key, its goal and
    sampling draws fed: the per-agent and global returns and the action
    distribution equal JAX's, at the trained policy's level."""
    jd, jts, td, ta, tts = trained
    key = jax.random.PRNGKey(4242)
    with jax.default_matmul_precision("float32"):
        jl, jg, jaux = jax.jit(jd.evaluate, static_argnums=(2,))(
            jts, key, N_EVAL)
    n = jd.hooks.n_agents
    draws = prng.FedDraws(*tp.eval_draws(key, N_EVAL, n, 5,
                                         td.cfg.max_steps), device="cpu")
    tl, tg, taux = td.evaluate(tts, draws, N_EVAL)
    assert draws.remaining() == {"randint": 0, "gumbel": 0}
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(float(tg), float(jg), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(taux["act_dist"].numpy(),
                               np.asarray(jaux["act_dist"]), rtol=RTOL,
                               atol=ATOL)
    # a trained policy: stage 1 past the sweep's +6.0, stage 2 the
    # two-agent winner
    assert float(tg) > (9.0 if n == 1 else 18.0)


def test_policy_probabilities_equal_jax(trained):
    """The policy's probabilities (the actor ends in a softmax) on 64
    replay-like transitions of the cell's engine, epsilon 0, equal
    JAX's at atol 1e-5."""
    jd, jts, td, ta, tts = trained
    rng = np.random.default_rng(3)
    batch = jax.jit(lambda: tp.replay_batch(jd.hooks.env, 64, rng))()
    with jax.default_matmul_precision("float32"):
        want = np.asarray(jd.alg.actor_probs(
            jts.actor, batch["obs"], batch["goals"], batch["a_prev"], 0.0))
    b = tp.to_torch(batch)
    with torch.no_grad():
        got = ta.actor_probs(ta._handle(tts.actor), b["obs"], b["goals"],
                             b["a_prev"], 0.0).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # a trained, mostly decided policy
    assert float(want.max(-1).mean()) > 0.5
