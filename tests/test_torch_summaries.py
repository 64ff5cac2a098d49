"""The gradient summaries (``summarize``) against the JAX package's:
``update(..., with_grads=True)``'s gradients by name for every
algorithm on Checkers (particle and roadway, and the snapshot that
leaves the state as it was: ``test_torch_summaries_snapshot.py``; the
drivers: ``test_torch_summaries_run.py``; the runners' event files:
``test_torch_summaries_runner.py``)."""

import jax
import numpy as np
import pytest
import torch

from cm3_tpu_torch import convert
from tests import torch_parity as tp

tp.set_torch_cpu()

RTOL, ATOL = 1e-5, 1e-6


def jax_grads(grads):
    """JAX's ``metrics["grads"]`` as {name: leaf} under the writer's
    names (``tboard.log_train_state``'s)."""
    out = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(grads):
        out["/".join(str(getattr(p, "key", getattr(p, "name", p)))
                     .strip(".[]'\"") for p in path)] = np.asarray(leaf)
    return out


def hold_grads(ts, got, want, seed=None, **tol):
    """The port's gradients ``got`` (by JAX's name, flat) against JAX's
    ``want``: the same names in the same order, each leaf in flax layout
    at ``tol`` (rtol 1e-5 / atol 1e-6 unless told)."""
    tol = dict(dict(rtol=RTOL, atol=ATOL), **tol)
    leaves = convert.jax_grad_leaves(ts, got, seed)
    want = jax_grads(want)
    assert [n for n, _ in leaves] == list(want)
    for name, leaf in leaves:
        np.testing.assert_allclose(leaf, want[name], err_msg=name, **tol)


# --------------------------------------------------------------------- #
# update(..., with_grads=True)
# --------------------------------------------------------------------- #

def _checkers(kind, opts, n_agents=2, n_seeds=None):
    je, _ = tp.envs(n_agents=n_agents)
    if kind == "cm3":
        ja, ta = tp.algs(je.spec(), n_seeds=n_seeds, **opts)
    else:
        ja, ta = tp.other_algs(kind, je.spec(), n_seeds=n_seeds, **opts)
    return ja, ta, tp.replay_batch(je, 16, np.random.default_rng(0))


GRAD_CASES = {
    "cm3_s2_fused": (_checkers, "cm3", {}, {}),
    "cm3_s2_V_optax": (_checkers, "cm3", dict(fused_opt=False, use_V=True),
                       {}),
    "cm3_s1": (lambda k, o: _checkers(k, o, n_agents=1), "cm3",
               dict(fused_opt=False), {}),
    "coma": (_checkers, "baseline", dict(use_Q=True), {}),
    "iac": (_checkers, "baseline", dict(use_V=True, IAC=True), {}),
    "central_v": (_checkers, "baseline", dict(use_V=True), {}),
    "qmix": (_checkers, "qmix", {}, dict(atol=tp.QMIX_TOL["atol"])),
}


@pytest.mark.parametrize("name", sorted(GRAD_CASES))
def test_update_grads_match_jax(name):
    """One update from the same converted state on the same batch and
    a' noise: every network's raw gradient by JAX's name (``Policy``,
    ``Q_global``, ``Q_credit``, ``V``, ``Q``; QMIX's ``Agent`` and
    ``Mixer``) at the update's tolerance (QMIX at ``QMIX_TOL``'s atol:
    its gradients reach |g| ~ 1e2)."""
    make, kind, opts, tol = GRAD_CASES[name]
    ja, ta, batch = make(kind, opts)
    jts = ja.init_state(jax.random.PRNGKey(1), batch["obs"], batch["state"],
                        batch["goals"])
    tts = convert.state_from_jax(ta, jax.device_get(jts))
    key = jax.random.PRNGKey(5)
    _, jm = jax.jit(ja.update, static_argnames="with_grads")(
        jts, batch, 0.2, key, with_grads=True)
    b, n = batch["a"].shape
    noise = (None if kind == "qmix" else torch.from_numpy(np.array(
        jax.random.gumbel(key, (b, n, ta.n_actions)))))
    _, tm = ta.update(tts, tp.to_torch(jax.device_get(batch)), 0.2, noise,
                      with_grads=True)
    assert sorted(tm["grads"]) == sorted(jm["grads"])
    hold_grads(tts, tm["grads"], jm["grads"], **tol)
    assert set(tm) - {"grads"} == set(jm) - {"grads"}
