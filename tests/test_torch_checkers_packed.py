"""The port's bit-packed Checkers engine against ``cm3_tpu``'s, and
against the port's own grid engine, on the CPU.  Inputs come from numpy
seeds; every comparison is exact (the engines do the same integer
operations and round the same float32 products and sums)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity
from cm3_tpu.core import config as jcfg
from cm3_tpu.envs import checkers_packed as jcp
from cm3_tpu_torch.core import config as tcfg
from cm3_tpu_torch.envs import checkers_packed as tcp
from cm3_tpu_torch.envs.checkers import Checkers, CheckersState
from cm3_tpu_torch.train.offpolicy import _where

CASES = {
    "two_agents": (dict(n_agents=2, agents_r=(0, 2), agents_c=(8, 8),
                        max_steps=50), (True, False)),
    "one_agent": (dict(n_agents=1, agents_r=(2,), agents_c=(8,),
                       max_steps=50), (False,)),
}


@pytest.fixture(autouse=True)
def _cpu():
    torch_parity.set_torch_cpu()


def _specs(case):
    kw, goal_green = CASES[case]
    return (jcp.make_spec(jcfg.CheckersEnvConfig(**kw), goal_green),
            tcp.make_spec(tcfg.CheckersEnvConfig(**kw), goal_green))


@pytest.mark.parametrize("case", sorted(CASES))
def test_make_spec_matches_jax(case):
    j, t = _specs(case)
    assert t._fields == j._fields
    for name in j._fields:
        assert getattr(t, name) == getattr(j, name), name


def test_make_spec_refuses_more_than_32_cells():
    with pytest.raises(ValueError):
        tcp.make_spec(tcfg.CheckersEnvConfig(n_rows=4, n_columns=8))


@pytest.mark.parametrize("case", sorted(CASES))
def test_packed_step_matches_jax(case):
    """B = 64 instances, T = 200 fed steps (each instance several
    episodes): positions, collected mask, step counter, per-agent
    rewards and done flags equal JAX's at every step."""
    jspec, tspec = _specs(case)
    n = len(jspec.init_pos)
    b, steps = 64, 200
    actions = np.random.default_rng(7 + n).integers(0, 5, (steps, n, b),
                                                    dtype=np.int32)
    jstep = jax.jit(lambda s, a: jcp.packed_step(
        jspec, s, tuple(a[i] for i in range(n))))
    js = jcp.packed_init(jspec, (b,))
    ts = tcp.packed_init(tspec, (b,), device="cpu")
    dones = 0
    for k in range(steps):
        js, jr, jd = jstep(js, jnp.asarray(actions[k]))
        ts, tr, td = tcp.packed_step(
            tspec, ts, tuple(torch.from_numpy(actions[k, i])
                             for i in range(n)))
        for i in range(n):
            np.testing.assert_array_equal(ts.pos[i].numpy(),
                                          np.asarray(js.pos[i], np.int64))
            np.testing.assert_array_equal(tr[i].numpy(), np.asarray(jr[i]))
        np.testing.assert_array_equal(ts.collected.numpy(),
                                      np.asarray(js.collected, np.int64))
        np.testing.assert_array_equal(ts.steps.numpy(), np.asarray(js.steps))
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        dones += int(td.sum())
    assert dones >= 3 * b          # the cap of 50 alone ends 4 per instance


def test_packed_matches_grid_engine():
    """The port's packed engine against the port's grid engine on fed
    actions (as ``tests/test_checkers_packed.py`` holds the two JAX
    engines): B = 32 instances, T = 150 steps, per-agent rewards and
    done flags equal, with the grid engine reset where done."""
    kw, goal_green = CASES["two_agents"]
    cfg = tcfg.CheckersEnvConfig(**kw)
    spec = tcp.make_spec(cfg, goal_green)
    b, steps = 32, 150
    actions = np.random.default_rng(3).integers(0, 5, (steps, b, 2))
    env = Checkers(cfg, device="cpu")
    goals = torch.eye(2).expand(b, -1, -1)     # agent 0 green, 1 orange
    state, _ = env.reset(goals)
    reset = env.reset(goals)[0]
    s = tcp.packed_init(spec, (b,), device="cpu")
    for k in range(steps):
        a = torch.from_numpy(actions[k])
        state, ts = env.step(state, a)
        state = CheckersState(**{
            f.name: _where(ts.done, getattr(reset, f.name),
                           getattr(state, f.name))
            for f in dataclasses.fields(state)})
        s, rs, done = tcp.packed_step(spec, s, (a[:, 0], a[:, 1]))
        torch.testing.assert_close(torch.stack(rs, dim=1), ts.reward_local,
                                   rtol=0, atol=0)
        assert torch.equal(done, ts.done)


def test_blocked_by_other_agent_and_border():
    _, spec = _specs("two_agents")
    s = tcp.packed_init(spec, (1,), device="cpu")
    one = lambda v: torch.tensor([v])
    # agent 0 down to row 1; agent 1 up into row 1 is blocked (-0.1)
    s, r, _ = tcp.packed_step(spec, s, (one(2), one(1)))
    assert (float(r[0]), float(r[1])) == (0.0, pytest.approx(-0.1))
    # agent 0 right from the start column leaves the board (-0.1)
    s, r, _ = tcp.packed_step(spec, s, (one(4), one(0)))
    assert float(r[0]) == pytest.approx(-0.1)
