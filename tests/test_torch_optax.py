"""The port's optax path (``AlgConfig.fused_opt=False``, the default and
the reference's headline program) against the JAX update on it: one and
three CM3 updates from the same converted state on the same batches and
a' noise, without a gradient clip, with a global-norm clip that
triggers on every network and with one that never does, and with the
actor's lr anneal."""

import jax
import numpy as np
import pytest
import torch

from cm3_tpu_torch import convert
from cm3_tpu_torch.algs import common
from tests import torch_parity as tp

tp.set_torch_cpu()

B, UPDATES = 16, 3
CASES = {
    "plain": dict(),
    # 1e-3 is far below every network's gradient norm here, 1e6 far above
    "clip_triggers": dict(grad_clip=1e-3),
    "clip_idle": dict(grad_clip=1e6),
    # scale 1, 0.5, 0: the third actor step is annulled
    "anneal": dict(actor_lr_anneal_updates=2),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def runs(request):
    """UPDATES updates in both packages; the port's state after the
    first and after the last, the JAX states converted, the losses, and
    each step's gradient norms (from the port's flat gradients)."""
    je, _ = tp.envs()
    ja, ta = tp.algs(je.spec(), fused_opt=False, **CASES[request.param])
    rng = np.random.default_rng(0)
    batches = [tp.replay_batch(je, B, rng) for _ in range(UPDATES)]
    jts = ja.init_state(jax.random.PRNGKey(1), batches[0]["obs"],
                        batches[0]["state"], batches[0]["goals"])
    tts = convert.state_from_jax(ta, jax.device_get(jts))
    upd = jax.jit(ja.update)
    out = {"case": CASES[request.param], "norms": [], "states": []}
    for i, batch in enumerate(batches):
        key = jax.random.PRNGKey(5 + i)
        jts, jm = upd(jts, batch, 0.2, key)
        gumbel = np.array(jax.random.gumbel(key, (B, 2, 5)))
        tts, tm = ta.update(tts, tp.to_torch(jax.device_get(batch)), 0.2,
                            torch.from_numpy(gumbel))
        out["norms"].append({n: float(getattr(tts, n).flat_grad.norm())
                             for n in ("actor", "qg", "qc")})
        out["states"].append((convert.state_from_jax(ta, jax.device_get(
            jts)), _copy(ta, tts), jax.device_get(jm), tm))
    return out


def _copy(alg, st):
    c = alg.empty_state()
    for name in ("actor", "qg", "qc"):
        for suffix in ("", "_tgt"):
            getattr(c, name + suffix).flat.copy_(
                getattr(st, name + suffix).flat)
        g, w = getattr(c, "opt_" + name), getattr(st, "opt_" + name)
        g.mu.copy_(w.mu)
        g.nu.copy_(w.nu)
        g.count = w.count
    c.step = st.step
    return c


@pytest.mark.parametrize("after", [1, UPDATES])
def test_optax_updates_match_jax(runs, after):
    """Networks, targets and Adam moments at rtol 1e-5 / atol 1e-6 (nu
    atol 1e-9), losses at rtol 1e-5: float32 sums in other orders, as in
    ``test_torch_cm3.py``."""
    want, got, jm, tm = runs["states"][after - 1]
    tp.hold_states(got, want, ("actor", "qg", "qc"))
    assert got.step == want.step == after
    for k in ("loss_Q_global", "loss_Q_credit", "policy_loss"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   err_msg=k)


def test_clip_is_where_it_should_be(runs):
    """The clip cases do what their names say: every gradient norm above
    1e-3 and below 1e6, so the one clip acts on every network and step
    and the other never."""
    for norms in runs["norms"]:
        assert all(1e-3 < v < 1e6 for v in norms.values()), norms


@pytest.mark.parametrize("runs", ["anneal"], indirect=True)
def test_anneal_stops_the_actor(runs):
    """With ``actor_lr_anneal_updates`` = 2 the third actor step has lr
    scale 0: the actor is unchanged by it, its moments still move."""
    (_, before, _, _), (_, after, _, _) = runs["states"][1:]
    assert torch.equal(before.actor.flat, after.actor.flat)
    assert not torch.equal(before.opt_actor.mu, after.opt_actor.mu)


def test_adam_apply_is_optax_order():
    """``common.adam_apply`` equals numpy float32 arithmetic in optax's
    order (moments, then the count, then the bias-corrected ratio times
    -lr), per seed over an [S, n] buffer, with a clip that triggers on
    one seed and not on the other."""
    rng = np.random.default_rng(3)
    p = rng.normal(size=(2, 64)).astype(np.float32)
    g = rng.normal(size=(2, 64)).astype(np.float32)
    g[1] *= 1e-3
    mu = rng.normal(size=(2, 64)).astype(np.float32) * 1e-2
    nu = np.square(rng.normal(size=(2, 64)).astype(np.float32)) * 1e-3
    st = common.AdamState(torch.from_numpy(mu.copy()),
                          torch.from_numpy(nu.copy()), count=4)
    tp_ = torch.from_numpy(p.copy())
    common.adam_apply(st, tp_, torch.from_numpy(g), 1e-3, clip=1.0)
    f = np.float32
    norm = np.sqrt(np.sum(g * g, axis=-1, keepdims=True))
    assert norm[0, 0] > 1.0 > norm[1, 0]
    gc = np.where(norm < f(1.0), g, (g / norm) * f(1.0))
    m2 = f(1 - 0.9) * gc + f(0.9) * mu
    v2 = f(1 - 0.999) * (gc * gc) + f(0.999) * nu
    c1 = f(1) - np.power(f(0.9), f(5))
    c2 = f(1) - np.power(f(0.999), f(5))
    u = f(-1e-3) * ((m2 / c1) / (np.sqrt(v2 / c2) + f(1e-8)))
    np.testing.assert_array_equal(tp_.numpy(), p + u)
    np.testing.assert_array_equal(st.mu.numpy(), m2)
    np.testing.assert_array_equal(st.nu.numpy(), v2)
    assert st.count == 5
