"""Episode rendering against the JAX package's: ``collect_episode`` with
JAX's draws fed in on Checkers, particle and roadway, and the text and
SVG renderers byte for byte on the same states (the runner's rendering,
the live viewer, the interactive harness and profiling:
``test_torch_tools.py``)."""

import dataclasses
import xml.etree.ElementTree as ET

import jax
import numpy as np
import pytest
import torch

from cm3_tpu.envs import render as jrender
from cm3_tpu.train.experiments import make_hooks as jax_hooks
from cm3_tpu_torch import convert
from cm3_tpu_torch.core import prng
from cm3_tpu_torch.envs import render
from cm3_tpu_torch.train.experiments import make_hooks
from tests import torch_parity as tp

tp.set_torch_cpu()


# --------------------------------------------------------------------- #
# collect_episode in both packages (and the renderers on its states)
# --------------------------------------------------------------------- #


def _single_reset(game, key, n):
    """What the port's ``episode_init((1,), draws)`` asks for where JAX's
    hooks reset one instance from ``key`` (``experiments.py:76-151``):
    (randints, uniforms, normals), each draw with a leading [1]."""
    if game == "checkers":
        return [], [], []
    k = jax.random.split(key, 4)
    if game == "particle":
        u = [jax.random.uniform(k[0], (1,)),
             jax.random.uniform(k[1], (1, n, 2), minval=-1.0, maxval=1.0),
             jax.random.uniform(k[2], (1, n, 2), minval=-1.0, maxval=1.0)]
        return [], u, [jax.random.normal(k[3], (1, n, 2))]
    return ([jax.random.randint(k[1], (1, n), 0, 4),
             jax.random.randint(k[2], (1, n), 0, 4)],
            [jax.random.uniform(k[0], (1,))],
            [jax.random.normal(k[3], (1, n))])


def _setup(game):
    if game == "checkers":
        je, te = tp.envs(max_steps=12)
        ja, ta = tp.algs(je.spec())
        batch = tp.replay_batch(je, 2, np.random.default_rng(0))
    elif game == "particle":
        je, te = tp.particle_envs("stage2_antipodal", prob_random=1.0,
                                  max_steps=12)
        ja, ta = tp.particle_algs("cm3", je.spec())
        batch = tp.particle_batch(je, 2, np.random.default_rng(0))
    else:
        je, te = tp.roadway_envs(2, prob_random=1.0)
        ja, ta = tp.roadway_algs("cm3", je.spec())
        batch = tp.roadway_batch(je, 2, np.random.default_rng(0))
    jts = ja.init_state(jax.random.PRNGKey(1), batch["obs"], batch["state"],
                        batch["goals"])
    return je, te, ja, ta, jts


def _max_steps(cfg):
    return getattr(cfg, "max_steps", None) or cfg.max_step


@pytest.fixture(scope="module", params=["checkers", "particle", "roadway"])
def episodes(request):
    game = request.param
    je, te, ja, ta, jts = _setup(game)
    jh, th = jax_hooks(game, je), make_hooks(game, te)
    key = jax.random.PRNGKey(7)
    steps = _max_steps(te.cfg)
    jstates = jrender.collect_episode(jh, ja, jts, key, steps)
    k_init, k_roll = jax.random.split(key)
    n = th.n_agents
    r, u, z = _single_reset(game, k_init, n)
    g = [np.asarray(jax.random.gumbel(jax.random.fold_in(k_roll, t),
                                      (1, n, 5))) for t in range(steps)]
    draws = prng.FedDraws(r, g, device="cpu", uniforms=u, normals=z)
    tstates = render.collect_episode(th, ta, convert.state_from_jax(
        ta, jax.device_get(jts)), draws, steps)
    return game, te, jstates, tstates, draws


def test_collect_episode_matches_jax(episodes):
    """The same number of states (the initial one, then one per step
    until the episode ends), each field equal: integers and flags
    exactly, positions and speeds at rtol 1e-5 / atol 1e-5 (JAX's
    engine step is jitted); every fed draw taken."""
    game, _, jstates, tstates, draws = episodes
    assert len(tstates) == len(jstates) > 2
    assert draws.remaining().get("randint", 0) == 0
    for j, t in zip(jstates, tstates):
        assert type(t).__name__ == type(j).__name__
        for f in dataclasses.fields(j):
            a, b = np.asarray(getattr(t, f.name)), np.asarray(
                getattr(j, f.name))
            assert a.shape == b.shape, f.name
            if np.issubdtype(b.dtype, np.floating):
                np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5,
                                           err_msg=f.name)
            else:
                np.testing.assert_array_equal(a, b, err_msg=f.name)


def _as_port(te, game, jstate):
    """JAX's host state as the port's engine state of one instance
    ([1, ...] tensors), then read back with ``host_state``."""
    from cm3_tpu_torch.envs import checkers, particle, roadway
    cls = {"checkers": checkers.CheckersState,
           "particle": particle.ParticleState,
           "roadway": roadway.RoadwayState}[game]
    st = cls(**{f.name: torch.from_numpy(np.array(getattr(jstate, f.name))
                                         [None]).to(
        torch.int64 if np.issubdtype(np.asarray(getattr(jstate, f.name))
                                     .dtype, np.signedinteger)
        else None) for f in dataclasses.fields(jstate)})
    return render.host_state(st)


def test_renderers_equal_jax(episodes):
    """Text frames and the animated SVG, byte for byte, on JAX's states
    taken across into the port's state type (int32 -> int64)."""
    game, te, jstates, _, _ = episodes
    ported = [_as_port(te, game, s) for s in jstates]
    cfg = te.cfg
    text = {"checkers": (jrender.render_checkers, render.render_checkers),
            "particle": (jrender.render_particle, render.render_particle),
            "roadway": (lambda s: jrender.render_roadway(s, cfg),
                        lambda s: render.render_roadway(s, cfg))}[game]
    for j, t in zip(jstates, ported):
        assert text[1](t) == text[0](j)
    svg = render.render_episode_svg(game, ported, cfg)
    assert svg == jrender.render_episode_svg(game, jstates, cfg)
    root = ET.fromstring(svg)
    assert root.tag.endswith("svg")
    assert any(e.tag.endswith("animate") for e in root.iter())
