"""The port's checkpoints and curriculum graft
(``cm3_tpu_torch.train.checkpoint``): ``stage2_init_cm3`` on converted
states against JAX's ``checkpoint.stage2_init_cm3`` exactly, for one
seed and for three seeds in lockstep; the shape-mismatch error; a
save/restore round trip bit for bit (Adam state and step included);
seed ``i`` of a stack restored into a one-seed state and one-seed
states stacked; and a restore across a ``grad_clip`` toggle, which keeps
parameters and targets and restarts the optimizer, as JAX's
``test_stage2_graft_across_grad_clip_structures`` shows for JAX."""

import functools
import os

import jax
import numpy as np
import pytest
import torch

from cm3_tpu.train import checkpoint as jckpt
from cm3_tpu_torch import convert
from cm3_tpu_torch.core import config as tcfg
from cm3_tpu_torch.core import prng
from cm3_tpu_torch.train import checkpoint, runner
from tests import torch_parity as tp

tp.set_torch_cpu()

NETS = ("actor", "actor_tgt", "qg", "qg_tgt", "qc", "qc_tgt")


@functools.lru_cache(maxsize=None)
def _jax_batch(n_agents):
    """One replay-like JAX batch of 8 transitions (made once)."""
    je, _ = tp.envs(n_agents=n_agents)
    return jax.device_get(tp.replay_batch(je, 8, np.random.default_rng(0)))


def _jax_state(n_agents, key, n_seeds=None, **alg):
    """A JAX CM3 state (stage 1 for one agent, stage 2 for two) at the
    parity widths, stacked over ``n_seeds`` if given, and the port's
    algorithm for it."""
    je, _ = tp.envs(n_agents=n_agents)
    ja, ta = tp.algs(je.spec(), n_seeds=n_seeds, fused_opt=False, **alg)
    b = _jax_batch(n_agents)
    init = jax.jit(lambda k: ja.init_state(k, b["obs"], b["state"],
                                           b["goals"]))
    if n_seeds is None:
        return jax.device_get(init(jax.random.PRNGKey(key))), ta
    keys = jax.random.split(jax.random.PRNGKey(key), n_seeds)
    return jax.device_get(jax.vmap(init)(keys)), ta


@pytest.mark.parametrize("n_seeds", [None, 3])
def test_stage2_graft_equals_jax(n_seeds):
    """The port's graft on converted states equals JAX's graft
    converted, bit for bit (rtol 0, atol 0): every network and target;
    the optimizer states stay stage 2's own."""
    j1, t1 = _jax_state(1, 11, n_seeds)
    j2, t2 = _jax_state(2, 22, n_seeds)
    want = convert.state_from_jax(t2, jckpt.stage2_init_cm3(
        j2, j1.actor, j1.qg))
    s1 = convert.state_from_jax(t1, j1)
    got = checkpoint.stage2_init_cm3(convert.state_from_jax(t2, j2),
                                     s1.actor, s1.qg)
    for name in NETS:
        assert torch.equal(getattr(got, name).flat,
                           getattr(want, name).flat), name
    fresh = convert.state_from_jax(t2, j2)
    for name in ("opt_actor", "opt_qg", "opt_qc"):
        g, w = getattr(got, name), getattr(fresh, name)
        assert torch.equal(g.mu, w.mu) and torch.equal(g.nu, w.nu)
        assert g.count == w.count
    # the graft did something: stage 1's shared leaves, stage 2's own
    views1 = checkpoint.named_views(s1.actor)
    for name, v in checkpoint.named_views(got.actor).items():
        if "stage2" in name.split("."):
            assert torch.equal(v, checkpoint.named_views(fresh.actor)[name])
        else:
            assert torch.equal(v, views1[name]), name


def test_graft_into_a_v_state_leaves_v_fresh():
    """With the V critic (and no Q_credit) the graft leaves V and its
    target as they were: all of V lives under ``stage2``."""
    j1, t1 = _jax_state(1, 3)
    j2, t2 = _jax_state(2, 4, use_Q_credit=False, use_V=True)
    want = convert.state_from_jax(t2, jckpt.stage2_init_cm3(
        j2, j1.actor, j1.qg))
    s1 = convert.state_from_jax(t1, j1)
    got = checkpoint.stage2_init_cm3(convert.state_from_jax(t2, j2),
                                     s1.actor, s1.qg)
    assert got.qc is None and got.v is not None
    for name in ("actor", "actor_tgt", "qg", "qg_tgt", "v", "v_tgt"):
        assert torch.equal(getattr(got, name).flat,
                           getattr(want, name).flat), name
    assert all("stage2" in n.split(".")
               for n in checkpoint.named_views(got.v))


def test_graft_shape_mismatch_raises():
    """A leaf of another shape raises, as JAX's ``graft_params`` does."""
    j1, t1 = _jax_state(1, 0)
    s1 = convert.state_from_jax(t1, j1)
    nn = dict(tp.SMALL_NN, A_n_h1=tp.SMALL_NN["A_n_h1"] + 4)
    je, _ = tp.envs()
    other = tp.algs(je.spec(), fused_opt=False)[1]
    other.nn_cfg = tcfg.NNConfig(**nn)
    s2 = other.init_state(prng.root_key(0))
    with pytest.raises(ValueError, match="graft shape mismatch"):
        checkpoint.graft_params(s2.actor, s1.actor)


def _trained(alg, seed, updates=2):
    """A state of ``alg`` after a few updates (nonzero Adam state) on
    one batch with rewards drawn anew for each update and seed."""
    rng = np.random.default_rng(seed)
    s = alg.n_seeds
    keys = (prng.root_key(seed) if s is None
            else [prng.root_key(seed + i) for i in range(s)])
    st = alg.init_state(keys)
    base = tp.to_torch(_jax_batch(alg.n_agents))
    for _ in range(updates):
        bs = [dict(base, rl=torch.from_numpy(rng.normal(
            size=tuple(base["rl"].shape)).astype(np.float32)))
              for _ in range(s or 1)]
        g = torch.from_numpy(rng.gumbel(size=(s or 1, 8, alg.n_agents, 5))
                             .astype(np.float32))
        if s is None:
            st, _ = alg.update(st, bs[0], 0.2, g[0])
        else:
            batch = jax.tree_util.tree_map(lambda *x: torch.stack(x), *bs)
            st, _ = alg.update(st, batch, torch.full((s,), 0.2), g)
    return st


def _equal(a, b, names):
    for name in names:
        for x in ("", "_tgt"):
            assert torch.equal(getattr(a, name + x).flat,
                               getattr(b, name + x).flat), name + x
        oa, ob = getattr(a, "opt_" + name), getattr(b, "opt_" + name)
        assert torch.equal(oa.mu, ob.mu) and torch.equal(oa.nu, ob.nu)
        assert (oa.count, oa.clipped) == (ob.count, ob.clipped)
    assert a.step == b.step


@pytest.mark.parametrize("n_seeds", [None, 3])
@pytest.mark.parametrize("opts", [dict(), dict(use_Q_credit=False,
                                               use_V=True)],
                         ids=["credit", "V"])
def test_save_restore_round_trip(tmp_path, n_seeds, opts):
    """Parameters, targets, Adam moments and counts, and the step come
    back bit for bit into a state of other values, whose buffers are
    kept (the seed stacks' leaves and gradients stay views into them);
    the autosave form carries the episode counts."""
    je, _ = tp.envs()
    _, alg = tp.algs(je.spec(), n_seeds=n_seeds, fused_opt=False, **opts)
    st = _trained(alg, 5)
    path = os.path.join(str(tmp_path), "ckpt")
    checkpoint.save(path, st)
    assert os.listdir(path) == [checkpoint.FILE]
    like = alg.init_state(prng.root_key(9) if n_seeds is None
                          else [prng.root_key(9 + i) for i in range(3)])
    buffers = {n: getattr(like, n).flat for n in alg.net_names()}
    got = checkpoint.restore(path, like)
    assert got is like
    _equal(got, st, alg.net_names())
    for n, buf in buffers.items():
        assert getattr(got, n).flat is buf
    eps = 40 if n_seeds is None else np.array([40, 41, 39])
    checkpoint.save(path, {"ts": st, "episodes": eps})
    back = checkpoint.restore(path, {"ts": alg.empty_state(),
                                     "episodes": 0})
    _equal(back["ts"], st, alg.net_names())
    np.testing.assert_array_equal(back["episodes"], eps)
    if n_seeds is None:
        assert isinstance(back["episodes"], int)


def test_restore_refuses_other_networks(tmp_path):
    """A stage-2 checkpoint does not restore into a stage-1 state, nor a
    stack into a one-seed state."""
    je, _ = tp.envs()
    _, a2 = tp.algs(je.spec(), fused_opt=False)
    path = os.path.join(str(tmp_path), "c")
    checkpoint.save(path, a2.init_state(prng.root_key(0)))
    j1, _ = tp.envs(n_agents=1)
    _, a1 = tp.algs(j1.spec(), fused_opt=False)
    with pytest.raises(ValueError):
        checkpoint.restore(path, a1.empty_state())
    checkpoint.save(path, a2.for_seeds(2).init_state(
        [prng.root_key(0), prng.root_key(1)]))
    with pytest.raises(ValueError):
        checkpoint.restore(path, a2.empty_state())


def test_seed_of_a_stack_restores_into_one_seed(tmp_path):
    """Seed 1 of a trained S = 3 stack, saved as a one-seed state (a
    per-seed ``model_final``), restores into a one-seed state equal to
    that row; the one-seed states stacked again equal the stack."""
    je, _ = tp.envs()
    _, alg = tp.algs(je.spec(), fused_opt=False)
    stack_alg = alg.for_seeds(3)
    stacked = _trained(stack_alg, 2)
    singles = []
    for i in range(3):
        path = os.path.join(str(tmp_path), f"seed{i}")
        checkpoint.save(path, checkpoint.seed_state(alg, stacked, i))
        singles.append(checkpoint.restore(path, alg.empty_state()))
    for name in alg.net_names():
        assert torch.equal(getattr(singles[1], name).flat,
                           getattr(stacked, name).flat[1])
        o = getattr(singles[1], "opt_" + name)
        assert torch.equal(o.mu, getattr(stacked, "opt_" + name).mu[1])
    _equal(checkpoint.stack_states(stack_alg, singles), stacked,
           alg.net_names())


# --------------------------------------------------------------------- #
# a restore across a grad_clip toggle
# --------------------------------------------------------------------- #


def _master(**over):
    m = tcfg.load_json("master.json")
    m.update(experiment="checkers", n_envs=8, seed=5, N_train=40,
             period=20, N_eval=2, pretrain_episodes=8, batch_size=16,
             buffer_size=256, steps_per_train=4, updates_per_chunk=1,
             episode_log=0)
    m.update(over)
    return m


@pytest.fixture
def small_nets(monkeypatch):
    monkeypatch.setattr(runner, "_nn_config", lambda m, e, s: tcfg.NNConfig(
        **tp.SMALL_NN))


def test_restore_across_grad_clip_keeps_params_and_restarts_adam(
        tmp_path, small_nets):
    """A checkpoint trained without a clip restores into a configuration
    with one (and back): parameters, targets and the step come from the
    checkpoint, the optimizer starts fresh with the configured clip.
    Then the JAX test's runs: a stage-2 graft into a clipped
    configuration, and a same-stage warm start without the clip."""
    wd = str(tmp_path)
    m1 = _master(stage=1, dir_name="s1nc", grad_clip=0.0)
    ts1, _ = runner.train_function(m1, workdir=wd, verbose=False,
                                   device="cpu")
    path = os.path.join(wd, "saved", "s1nc", "model_final")
    key = prng.root_key(5)
    got = runner._restore_flexible(path, dict(m1, grad_clip=10.0), key,
                                   "cpu")
    for name in ("actor", "qg"):
        for x in ("", "_tgt"):
            assert torch.equal(getattr(got, name + x).flat,
                               getattr(ts1, name + x).flat)
        o = getattr(got, "opt_" + name)
        assert o.clipped and o.count == 0
        assert not o.mu.any() and not o.nu.any()
    assert got.step == ts1.step > 0
    with pytest.raises(ValueError, match="grad_clip"):
        checkpoint.restore(path, runner.build(
            dict(m1, grad_clip=10.0), device="cpu")[1].empty_state())

    m2 = _master(stage=2, dir_name="s2c", dir_restore="s1nc",
                 train_from_nothing=0, grad_clip=10.0)
    _, stats = runner.train_function(m2, workdir=wd, verbose=False,
                                     device="cpu")
    assert stats["episodes"] >= 40
    m3 = _master(stage=2, dir_name="s2nc", dir_restore="s2c",
                 train_from_nothing=0, restore_same_stage=1, grad_clip=0.0)
    _, stats3 = runner.train_function(m3, workdir=wd, verbose=False,
                                      device="cpu")
    assert stats3["episodes"] >= 40
