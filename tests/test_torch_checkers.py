"""The port's batched Checkers engine against the JAX engine on fed
actions: every TimeStep field, the state, and the spec."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tests import torch_parity as tp

tp.set_torch_cpu()


def _goals(e):
    return np.tile(np.eye(2, 2, dtype=np.float32)[None], (e, 1, 1))


def _compare(jts, tts, float_rtol):
    """Exact on every field except the normalized coordinates
    (obs others/self_v), which get ``float_rtol``."""
    for k in jts.obs:
        want, got = np.asarray(jts.obs[k]), tts.obs[k].numpy()
        if k in ("others", "self_v"):
            np.testing.assert_allclose(got, want, rtol=float_rtol, atol=0,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(got, want, err_msg=k)
    for k in jts.state:
        np.testing.assert_array_equal(tts.state[k].numpy(),
                                      np.asarray(jts.state[k]), err_msg=k)
    np.testing.assert_array_equal(tts.reward.numpy(), np.asarray(jts.reward))
    np.testing.assert_array_equal(tts.reward_local.numpy(),
                                  np.asarray(jts.reward_local))
    np.testing.assert_array_equal(tts.done.numpy(), np.asarray(jts.done))


def _compare_state(js, ts_):
    np.testing.assert_array_equal(ts_.world.numpy(), np.asarray(js.world))
    np.testing.assert_array_equal(ts_.loc.numpy(), np.asarray(js.loc))
    np.testing.assert_array_equal(ts_.collected.numpy(),
                                  np.asarray(js.collected))
    np.testing.assert_array_equal(ts_.steps.numpy(), np.asarray(js.steps))


def test_spec_matches():
    je, te = tp.envs()
    assert te.spec() == je.spec()


def test_engine_matches_compiled_jax_on_fed_actions():
    """60 steps of 16 instances with the step cap at 20, so ``done``
    turns on inside the sequence (the engine itself does not reset; the
    driver does).  Tolerance: bit-exact except
    the normalized coordinates, one float32 ulp (rtol 2^-23) - compiled
    XLA computes ``x / const`` as ``x * (1/const)``, the port (and
    op-by-op JAX, next test) as a true division."""
    e, steps = 16, 60
    je, te = tp.envs(max_steps=20)
    js, jts = jax.jit(jax.vmap(je.reset))(
        jax.random.split(jax.random.PRNGKey(0), e), jnp.asarray(_goals(e)))
    ts_, tts = te.reset(torch.from_numpy(_goals(e)))
    _compare(jts, tts, 2.0 ** -23)
    step = jax.jit(jax.vmap(je.step))
    rng = np.random.default_rng(0)
    n_done = 0
    for _ in range(steps):
        a = rng.integers(0, 5, (e, 2))
        js, jts = step(js, jnp.asarray(a, jnp.int32))
        ts_, tts = te.step(ts_, torch.from_numpy(a))
        _compare(jts, tts, 2.0 ** -23)
        _compare_state(js, ts_)
        n_done += int(tts.done.sum())
    assert n_done > 0


def test_engine_matches_op_by_op_jax_bitwise():
    """Op-by-op JAX divides as the port does: every field bit-exact."""
    e = 4
    je, te = tp.envs()
    js, jts = jax.vmap(je.reset)(
        jax.random.split(jax.random.PRNGKey(0), e), jnp.asarray(_goals(e)))
    ts_, tts = te.reset(torch.from_numpy(_goals(e)))
    _compare(jts, tts, 0.0)
    rng = np.random.default_rng(1)
    for _ in range(4):
        a = rng.integers(0, 5, (e, 2))
        js, jts = jax.vmap(je.step)(js, jnp.asarray(a, jnp.int32))
        ts_, tts = te.step(ts_, torch.from_numpy(a))
        _compare(jts, tts, 0.0)
        _compare_state(js, ts_)


def test_all_collected_ends_the_episode():
    """Sweep both agents over every cell: the episode ends on the step
    that collects the last cell, before the step cap."""
    _, te = tp.envs(max_steps=1000)
    ts_, _ = te.reset(torch.from_numpy(_goals(1)))
    # agent 0 starts at row 0, agent 1 at row 2, both in the start column
    sweep = [3] * 8 + [2] + [4] * 7     # row 0 leftwards, down, row 1 right
    done = []
    for a0 in sweep:
        ts_, tts = te.step(ts_, torch.tensor([[a0, 3]]))
        done.append(bool(tts.done[0]))
    assert done[-1] and not any(done[:-1])
    assert float(tts.reward_local.sum()) != 0.0
