"""Roadway's occlusion and its other traffic surfaces against
``cm3_tpu.envs.roadway``: ``occlude`` on random grids (exactly: its
values are -1, 0 and 1 and the relative speeds it keeps or zeroes), the
observation with ``occlusion=True`` over a reset and filtered steps to
the end of the episodes against JAX's engine run op by op (exactly, as
``test_torch_roadway_engine.py`` holds the engine), and ``avg_speeds``,
``count_remaining`` and ``global_tensor`` on the same states; one car
here, two in ``test_torch_roadway_occlusion.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cm3_tpu.envs.roadway import occlude as jax_occlude
from cm3_tpu_torch.core import config as tcfg
from cm3_tpu_torch.envs.roadway import occlude
from tests import torch_parity as tp
from tests.test_torch_roadway_engine import _jax_state, _pairs

tp.set_torch_cpu()

E, T = 4, 42
CFG = tcfg.RoadwayEnvConfig()
BACK = int(round(CFG.obs_back / CFG.res_forward))
NUM_EGO = int(round(CFG.car_length / CFG.res_forward))


@pytest.mark.parametrize("density", [0.1, 0.3, 0.6])
def test_occlude_matches_jax(density):
    """200 random 13 x 9 grids with the ego's own cells occupied, batched
    in one call, against JAX's ``occlude`` under ``vmap``."""
    rows, cols = CFG.obs_rows, CFG.obs_cols
    rng = np.random.default_rng(int(density * 10))
    occ = (rng.random((200, rows, cols)) < density).astype(np.float32)
    occ[:, BACK - NUM_EGO + 1:BACK + 1, CFG.obs_left] = 1.0
    rel = rng.normal(size=occ.shape).astype(np.float32)
    kw = dict(back=BACK, front=rows - BACK - 1, num_ego_cells=NUM_EGO,
              c_self=CFG.obs_left)
    jo, jr = jax.vmap(lambda o, r: jax_occlude(o, r, **kw))(occ, rel)
    to, tr = occlude(torch.from_numpy(occ), torch.from_numpy(rel), **kw)
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    shadowed = to.numpy() == -1.0
    assert shadowed.any() and (tr.numpy()[shadowed] == 0.0).all()


def _run(stage, seed=0):
    """E instances with occlusion on, reset from random lanes and JAX's
    depart noise, then filtered steps of the same random actions in both
    engines (JAX's op by op) until every episode has ended (at most T,
    past the 40-step cap); per step (JAX's, the port's)."""
    je, te = tp.roadway_envs(stage, occlusion=True)
    n = te.cfg.n_agents
    rng = np.random.default_rng(seed)
    lanes, goal_lanes = (rng.integers(0, 4, (E, n)) for _ in range(2))
    keys = jax.random.split(jax.random.PRNGKey(seed), E)
    noise = np.array(jax.vmap(lambda k: jax.random.normal(k, (n,)))(keys))
    reset, step = jax.vmap(je.reset), jax.vmap(je.step)
    check = jax.vmap(je.check_actions)
    with jax.disable_jit():
        js, jts = reset(keys, dict(lanes=jnp.asarray(lanes, jnp.int32),
                                   goal_lanes=jnp.asarray(goal_lanes,
                                                          jnp.int32)))
        ts_, tts = te.reset(dict(lanes=torch.from_numpy(lanes),
                                 goal_lanes=torch.from_numpy(goal_lanes)),
                            torch.from_numpy(noise))
        out = [((js, jts, None), (ts_, tts, None))]
        for _ in range(T):
            raw = rng.integers(0, 5, (E, n))
            ja = check(js, jnp.asarray(raw, jnp.int32))
            ta = te.check_actions(ts_, torch.from_numpy(raw))
            js, jts = step(js, ja)
            ts_, tts = te.step(ts_, ta)
            out.append(((js, jts, ja), (ts_, tts, ta)))
            if bool(ts_.removed.all()):
                break           # every episode over: no car moves again
    return je, te, out


@pytest.fixture(scope="module")
def runs():
    return _run(1)


def test_occluded_observation_matches_jax(runs):
    """Every output of every step equal to JAX's op by op, the occluded
    grids among them; with two cars some cell is shadowed."""
    _, te, traj = runs
    shadowed = 0
    for t, (want, got) in enumerate(traj):
        for name, g, w in _pairs(want, got):
            np.testing.assert_array_equal(g, w.astype(g.dtype),
                                          err_msg=f"{name} at step {t}")
        shadowed += int((got[1].obs["self_t"][..., 0] == -1.0).sum())
    assert (shadowed > 0) == (te.cfg.n_agents > 1)


def test_extras_match_jax(runs):
    """``avg_speeds`` [*L, 6], ``count_remaining`` [*L] and
    ``global_tensor`` [*L, 80, 16, 4] (with the step's filtered actions
    as the signals, and without) on every step's states, against JAX's
    under ``vmap``, op by op, exactly."""
    je, te, traj = runs
    fns = {f: jax.vmap(getattr(je, f))
           for f in ("avg_speeds", "count_remaining", "global_tensor")}
    seen = set()
    for t, (want, got) in enumerate(traj):
        ts_, ta = got[0], got[2]
        js = _jax_state(ts_)
        with jax.disable_jit():
            for f in ("avg_speeds", "count_remaining", "global_tensor"):
                np.testing.assert_array_equal(
                    getattr(te, f)(ts_).numpy(), np.asarray(fns[f](js)),
                    err_msg=f"{f} at step {t}")
            if ta is not None:
                jg = jax.vmap(je.global_tensor)(js, jnp.asarray(
                    ta.numpy(), jnp.int32))
                tg = te.global_tensor(ts_, ta)
                np.testing.assert_array_equal(tg.numpy(), np.asarray(jg),
                                              err_msg=f"signals at {t}")
                seen.update(np.flatnonzero(tg[..., 2:].sum((0, 1, 2))
                                           .numpy()))
        assert te.global_tensor(ts_).shape == (E, te.cfg.n_rows,
                                               te.cfg.n_cols, 4)
    assert seen == {0, 1}
