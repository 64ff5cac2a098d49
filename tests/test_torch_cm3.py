"""One CM3 update of the port against the JAX update, both with
fused_opt=True (the JAX Pallas kernel in interpret mode), from the same
converted state, on the same batch and the same a' noise."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cm3_tpu_torch import convert
from cm3_tpu_torch.core import config as tcfg
from cm3_tpu_torch.algs.cm3 import CM3
from cm3_tpu_torch.ops import seed_conv
from tests import torch_parity as tp

tp.set_torch_cpu()

NETS = ("actor", "actor_tgt", "qg", "qg_tgt", "qc", "qc_tgt")


def _batch(env, b, rng):
    """A replay-like batch from real Checkers transitions, with noisy
    local rewards and some terminal rows."""
    goals = jnp.tile(jnp.eye(2, 2)[None], (b, 1, 1))
    s, ts = jax.vmap(env.reset)(jax.random.split(jax.random.PRNGKey(0), b),
                                goals)
    for _ in range(3):
        s, ts = jax.vmap(env.step)(
            s, jnp.asarray(rng.integers(0, 5, (b, 2)), jnp.int32))
    a = jnp.asarray(rng.integers(0, 5, (b, 2)), jnp.int32)
    _, ts2 = jax.vmap(env.step)(s, a)
    return {"obs": ts.obs, "state": ts.state, "a": a,
            "a_prev": jnp.asarray(rng.integers(0, 5, (b, 2)), jnp.int32),
            "r": ts2.reward,
            "rl": ts2.reward_local + jnp.asarray(rng.normal(size=(b, 2)),
                                                 jnp.float32),
            "obs_next": ts2.obs, "state_next": ts2.state,
            "done": jnp.asarray(rng.random(b) < 0.3), "goals": goals}


@pytest.mark.parametrize("target_clip", [0.0, 0.5])
def test_update_matches_jax(target_clip, monkeypatch):
    """Losses at rtol 1e-5; params, targets and Adam moments at
    rtol 1e-5 / atol 1e-6 (float32 sums in another order through the
    forward and backward passes; measured differences are ~1e-7).  The
    port takes the two critics' steps in one ``adam_polyak_many`` call
    (one launch on the card) and the actor's in another, where the JAX
    package makes three calls."""
    from cm3_tpu_torch.ops import fused_opt
    calls = []
    many = fused_opt.adam_polyak_many
    monkeypatch.setattr(fused_opt, "adam_polyak_many", lambda items, tau: (
        calls.append([p.numel() for _, p, *_ in items]), many(items, tau)))
    b = 16
    je, _ = tp.envs()
    ja, ta = tp.algs(je.spec(), target_clip=target_clip)
    batch = _batch(je, b, np.random.default_rng(0))
    jts = ja.init_state(jax.random.PRNGKey(1), batch["obs"], batch["state"],
                        batch["goals"])
    tts = convert.state_from_jax(ta, jax.device_get(jts))
    key = jax.random.PRNGKey(5)
    jts2, jm = jax.jit(ja.update)(jts, batch, 0.2, key)
    gumbel = np.array(jax.random.gumbel(key, (b, 2, 5)))
    tts, tm = ta.update(tts, tp.to_torch(jax.device_get(batch)), 0.2,
                        torch.from_numpy(gumbel))
    for k in ("loss_Q_global", "loss_Q_credit", "policy_loss"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   err_msg=k)
    ref = convert.state_from_jax(ta, jax.device_get(jts2))
    for name in NETS:
        np.testing.assert_allclose(getattr(tts, name).flat.numpy(),
                                   getattr(ref, name).flat.numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    for name in ("opt_actor", "opt_qg", "opt_qc"):
        got, want = getattr(tts, name), getattr(ref, name)
        assert got.count == want.count == 1
        np.testing.assert_allclose(got.mu.numpy(), want.mu.numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
        np.testing.assert_allclose(got.nu.numpy(), want.nu.numpy(),
                                   rtol=1e-5, atol=1e-9, err_msg=name)
    assert tts.step == int(jts2.step) == 1
    assert calls == [[tts.qg.flat.numel(), tts.qc.flat.numel()],
                     [tts.actor.flat.numel()]]


def test_nets_run_in_full_float32_whatever_the_caller_set(monkeypatch):
    """``act`` and ``update`` run every convolution, forward (each call
    of the nets' convolution op, ``ops/seed_conv.py``) and backward,
    with cuDNN's and cuBLAS's TF32 off, though the caller left both on;
    the caller's flags are back afterwards, also after a raise."""
    b = 8
    je, _ = tp.envs()
    ja, ta = tp.algs(je.spec())
    batch = _batch(je, b, np.random.default_rng(1))
    tts = convert.state_from_jax(ta, jax.device_get(ja.init_state(
        jax.random.PRNGKey(1), batch["obs"], batch["state"],
        batch["goals"])))
    tb = tp.to_torch(jax.device_get(batch))
    flags = lambda: (torch.backends.cudnn.allow_tf32,
                     torch.backends.cuda.matmul.allow_tf32)
    seen = []
    convs = [m for name in ("actor", "qg", "qc")
             for m in getattr(tts, name).modules()
             if isinstance(m, torch.nn.Conv2d)]
    conv_op = seed_conv.relu_flat_conv

    def recorded(*args):
        seen.append(("fwd", flags()))
        return conv_op(*args)
    monkeypatch.setattr(seed_conv, "relu_flat_conv", recorded)
    hooks = [m.weight.register_hook(
        lambda _: seen.append(("bwd", flags()))) for m in convs]
    saved = flags()
    try:
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        ta.update(tts, tb, 0.2, torch.zeros(b, 2, 5))
        ta.act(tts, tb["obs"], tb["goals"], tb["a_prev"], 0.2,
               torch.zeros(b, 2, 5))
        assert flags() == (True, True)
        with pytest.raises(RuntimeError):
            ta.act(tts, tb["obs"], tb["goals"][:, :1], tb["a_prev"], 0.2,
                   torch.zeros(b, 2, 5))
        assert flags() == (True, True)
    finally:
        for h in hooks:
            h.remove()
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = saved
    assert {kind for kind, _ in seen} == {"fwd", "bwd"}
    assert all(f == (False, False) for _, f in seen), seen


def test_init_state():
    """Targets start equal to the mains, Adam at zero, parameters a
    function of the key alone, and gradients land in the flat buffer."""
    je, _ = tp.envs()
    _, ta = tp.algs(je.spec())
    st, st2 = ta.init_state(3), ta.init_state(3)
    for name in ("actor", "qg", "qc"):
        main, tgt = getattr(st, name), getattr(st, name + "_tgt")
        assert torch.equal(main.flat, tgt.flat)
        assert torch.equal(main.flat, getattr(st2, name).flat)
        assert not torch.equal(main.flat, getattr(ta.init_state(4), name).flat)
        opt = getattr(st, "opt_" + name)
        assert opt.count == 0 and not opt.mu.any() and not opt.nu.any()
        assert all(p.grad.data_ptr() >= main.flat_grad.data_ptr()
                   for p in main.parameters())


@pytest.mark.parametrize("bad", [dict(grad_clip=10.0),
                                 dict(actor_lr_anneal_updates=100)])
def test_rejects_what_the_fused_path_cannot_do(bad):
    kw = dict(n_agents=2, stage=2, fused_opt=True)
    kw.update(bad)
    with pytest.raises((ValueError, NotImplementedError)):
        CM3("checkers", tp.envs()[1].spec(), tcfg.AlgConfig(**kw),
            device="cpu")


def test_sample_actions_is_jax_categorical():
    """argmax(log(p + 1e-20) + gumbel(key)) is ``common.sample_actions``
    of the JAX package for the same key, zero probabilities included
    (the 1e-20 floor keeps them finite and never sampled)."""
    from cm3_tpu.algs import common as jcommon
    from cm3_tpu_torch.algs import common

    rng = np.random.default_rng(4)
    p = rng.random((64, 2, 5)).astype(np.float32)
    p[p < 0.3] = 0.0
    p[:, :, 0] += 1e-3
    p /= p.sum(-1, keepdims=True)
    key = jax.random.PRNGKey(9)
    want = np.asarray(jcommon.sample_actions(key, jnp.asarray(p)))
    got = common.sample_actions(torch.from_numpy(p), torch.from_numpy(
        np.array(jax.random.gumbel(key, p.shape))))
    np.testing.assert_array_equal(got.numpy(), want)
    assert np.all(p[np.arange(64)[:, None], np.arange(2), want] > 0)
