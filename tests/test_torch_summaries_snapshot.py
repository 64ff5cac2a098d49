"""The gradient snapshot (``alg.grad_snapshot``: an update whose result
is dropped) leaves every tensor of the state as it was and returns the
gradients of the update it dropped, for CM3 (fused with the actor
frozen, optax with V and the clip, three seeds), COMA and QMIX (three
seeds); and ``update(..., with_grads=True)``'s gradients on particle and
roadway against the JAX package's."""

import jax
import numpy as np
import pytest
import torch

from cm3_tpu_torch import convert
from cm3_tpu_torch.core import prng
from tests import torch_parity as tp
from tests.test_torch_summaries import _checkers, hold_grads

tp.set_torch_cpu()


@pytest.mark.parametrize("env", ["particle", "roadway"])
def test_update_grads_match_jax(env):
    """CM3 stage 2 on four-agent particle and on two-car roadway: the
    raw gradients by JAX's name at the update's tolerance."""
    if env == "particle":
        je, _ = tp.particle_envs("stage2_antipodal", prob_random=1.0)
        ja, ta = tp.particle_algs("cm3", je.spec())
        batch = tp.particle_batch(je, 16, np.random.default_rng(0))
    else:
        je, _ = tp.roadway_envs(2)
        ja, ta = tp.roadway_algs("cm3", je.spec())
        batch = tp.roadway_batch(je, 16, np.random.default_rng(2))
    jts = ja.init_state(jax.random.PRNGKey(1), batch["obs"], batch["state"],
                        batch["goals"])
    tts = convert.state_from_jax(ta, jax.device_get(jts))
    key = jax.random.PRNGKey(5)
    _, jm = jax.jit(ja.update, static_argnames="with_grads")(
        jts, batch, 0.2, key, with_grads=True)
    b, n = batch["a"].shape
    noise = torch.from_numpy(np.array(jax.random.gumbel(key, (b, n, 5))))
    _, tm = ta.update(tts, tp.to_torch(jax.device_get(batch)), 0.2, noise,
                      with_grads=True)
    assert sorted(tm["grads"]) == sorted(jm["grads"]) == [
        "Policy", "Q_credit", "Q_global"]
    hold_grads(tts, tm["grads"], jm["grads"])


# --------------------------------------------------------------------- #
# the snapshot: a dropped update that leaves the state as it was
# --------------------------------------------------------------------- #


def _tensors(ts):
    """Every tensor of a state: each network's buffer, each Adam state's
    moments and count, and the step; cloned."""
    out = {"step": ts.step.clone()}
    for f in ts.__dataclass_fields__:
        v = getattr(ts, f)
        if v is None or f == "step":
            continue
        if f.startswith("opt_"):
            out[f + ".mu"], out[f + ".nu"] = v.mu.clone(), v.nu.clone()
            out[f + ".count"] = v.count.clone()
        else:
            out[f] = v.flat.clone()
    return out


SNAP_CASES = {
    "cm3_fused_freeze": ("cm3", dict(actor_freeze_updates=2), None),
    "cm3_optax_V": ("cm3", dict(fused_opt=False, use_V=True,
                                grad_clip=1.0), None),
    "cm3_seeds": ("cm3", {}, 3),
    "coma": ("baseline", dict(use_Q=True), None),
    "qmix_seeds": ("qmix", {}, 3),
}


@pytest.mark.parametrize("name", sorted(SNAP_CASES))
def test_snapshot_leaves_the_state(name):
    """``grad_snapshot`` twice on a state that has trained a step: every
    network, target, Adam moment, Adam count and the step bit for bit as
    before (the tensors' values, and the counts' very tensors); its
    gradients are those of the update it dropped, bit for bit, and the
    next real update is the one it would have been."""
    kind, opts, seeds = SNAP_CASES[name]
    _, ta, batch = _checkers(kind, opts, n_seeds=seeds)
    tb = tp.to_torch(jax.device_get(batch))
    if seeds:
        tb = {k: (v.expand((seeds,) + v.shape) if not isinstance(v, dict)
                  else {kk: vv.expand((seeds,) + vv.shape)
                        for kk, vv in v.items()})
              for k, v in tb.items()}
    b, n = batch["a"].shape
    lead = (seeds, b) if seeds else (b,)
    gen = torch.Generator().manual_seed(0)
    noise = lambda: (None if kind == "qmix" else prng.gumbel_from_uniform(
        torch.rand(lead + (n, ta.n_actions), generator=gen)))
    eps = 0.2 if not seeds else torch.tensor([0.1, 0.2, 0.3])
    ts = ta.init_state(3 if not seeds else [3, 4, 5])
    ts, _ = ta.update(ts, tb, eps, noise())
    before = _tensors(ts)
    counts = {f: getattr(ts, f).count for f in ts.__dataclass_fields__
              if f.startswith("opt_") and getattr(ts, f) is not None}
    z = noise()
    g1 = ta.grad_snapshot(ts, tb, eps, z)
    g2 = ta.grad_snapshot(ts, tb, eps, z)
    after = _tensors(ts)
    assert list(after) == list(before)
    for k in before:
        assert torch.equal(after[k], before[k]), k
    for f, c in counts.items():
        assert getattr(ts, f).count is c, f
    _, m = ta.update(ts, tb, eps, z, with_grads=True)
    assert sorted(g1) == sorted(m["grads"])
    for k in g1:
        assert torch.equal(g1[k], m["grads"][k]), k
        assert torch.equal(g2[k], g1[k]), k
    assert int(ts.step) == 2
