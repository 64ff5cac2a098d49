"""The baselines and QMIX through the port's runner and checkpoints on
the CPU: ``build`` against JAX's ``build`` for each ``alg_name``;
``stage2_init_baseline`` against JAX's on converted states, one seed
and three; QMIX's stage-2 start, which restores the stage-1 checkpoint
and grafts nothing, as JAX's runner; save/restore round trips of both
states; training through ``train_function``, ``train_multiseed`` in
lockstep with the graft into every seed and an auto-resume; and the CLI
with ``--alg qmix``."""

import csv
import dataclasses
import functools
import json
import os

import jax
import numpy as np
import pytest
import torch

from cm3_tpu.train import checkpoint as jckpt
from cm3_tpu.train import runner as jrunner
from cm3_tpu_torch import convert
from cm3_tpu_torch.core import config as tcfg
from cm3_tpu_torch.core import prng
from cm3_tpu_torch.train import checkpoint, runner
from tests import torch_parity as tp

tp.set_torch_cpu()

# the paper's comparison cells (scripts/reproduce_paper.py:216-237)
CELL = dict(experiment="checkers", stage=2, n_envs=16, train_from_nothing=1,
            period=100, N_eval=10)
BUILDS = {
    "checkers_qmix": dict(CELL, alg_name="qmix"),
    "checkers_qmix_ref": dict(CELL, alg_name="qmix", qmix_ref_bug=1),
    "checkers_coma": dict(CELL, alg_name="coma"),
    "checkers_iac": dict(CELL, alg_name="iac"),
    "coma_use_V": dict(CELL, alg_name="coma", use_V=1),
    "coma_blend": dict(CELL, alg_name="coma", use_V=1, use_Q=1, alpha=0.4),
    "iac_stage1": dict(CELL, alg_name="iac", stage=1),
    "coma_by_flags": dict(CELL, alg_name="", use_alg_credit=0),
    "qmix_by_flags": dict(CELL, alg_name="", use_alg_credit=0, use_qmix=1,
                          grad_clip=10.0),
}


def _master(base=None, **over):
    m = tcfg.load_json("master.json")
    m.update(base or {})
    m.update(over)
    return m


@pytest.mark.parametrize("name", sorted(BUILDS))
def test_build_matches_jax(name):
    """The same algorithm class, every ``AlgConfig`` field the port has,
    the widths JAX's runner reads (``NNConfig``) and the same critics as
    JAX's ``build``."""
    m = _master(BUILDS[name])
    _, ja, _, _ = jrunner.build(m)
    _, ta, _, _ = runner.build(m, device="cpu")
    assert type(ta).__name__ == type(ja).__name__
    jnn = jrunner._nn_config(m, "checkers", m["stage"])
    for got, want in ((ta.cfg, ja.cfg), (ta.nn_cfg, jnn)):
        for f in dataclasses.fields(got):
            assert getattr(got, f.name) == getattr(want, f.name), f.name
    for attr in ("use_q", "use_v", "iac"):
        assert getattr(ta, attr, None) == getattr(ja, attr, None), attr


# --------------------------------------------------------------------- #
# checkpoints
# --------------------------------------------------------------------- #


@functools.lru_cache(maxsize=None)
def _jax_batch(n_agents):
    je, _ = tp.envs(n_agents=n_agents)
    return jax.device_get(tp.replay_batch(je, 8, np.random.default_rng(0)))


def _jax_state(kind, n_agents, key, n_seeds=None, **opts):
    """A JAX Baseline or QMIX state at the parity widths (stacked over
    ``n_seeds`` if given) and the port's algorithm for it."""
    je, _ = tp.envs(n_agents=n_agents)
    ja, ta = tp.other_algs(kind, je.spec(), n_seeds=n_seeds, **opts)
    b = _jax_batch(n_agents)
    init = jax.jit(lambda k: ja.init_state(k, b["obs"], b["state"],
                                           b["goals"]))
    if n_seeds is None:
        return jax.device_get(init(jax.random.PRNGKey(key))), ta
    keys = jax.random.split(jax.random.PRNGKey(key), n_seeds)
    return jax.device_get(jax.vmap(init)(keys)), ta


GRAFTS = {"iac": dict(use_V=True, IAC=True), "central_v": dict(use_V=True),
          "coma": dict(use_Q=True), "blend": dict(use_Q=True, use_V=True)}


@pytest.mark.parametrize("n_seeds", [None, 3])
@pytest.mark.parametrize("variant", sorted(GRAFTS))
def test_stage2_init_baseline_equals_jax(variant, n_seeds):
    """The port's graft on converted states equals JAX's graft converted,
    bit for bit: the actor (and V where both stages have one) grafted,
    targets equal mains, COMA's critic and every optimizer state stage
    2's own."""
    opts = GRAFTS[variant]
    j1, t1 = _jax_state("baseline", 1, 11, n_seeds, **opts)
    j2, t2 = _jax_state("baseline", 2, 22, n_seeds, **opts)
    want = convert.state_from_jax(t2, jckpt.stage2_init_baseline(
        j2, j1.actor, j1.v))
    s1 = convert.state_from_jax(t1, j1)
    got = checkpoint.stage2_init_baseline(convert.state_from_jax(t2, j2),
                                          s1.actor, s1.v)
    fresh = convert.state_from_jax(t2, j2)
    for name in t2.net_names():
        for x in ("", "_tgt"):
            assert torch.equal(getattr(got, name + x).flat,
                               getattr(want, name + x).flat), name + x
        o, f = getattr(got, "opt_" + name), getattr(fresh, "opt_" + name)
        assert torch.equal(o.mu, f.mu) and o.count == f.count
    views1 = checkpoint.named_views(s1.actor)
    for name, v in checkpoint.named_views(got.actor).items():
        if "stage2" not in name.split("."):
            assert torch.equal(v, views1[name]), name
    if got.q is not None:
        assert torch.equal(got.q.flat, fresh.q.flat)


def _trained(alg, seed, updates=2):
    """``alg``'s fresh state after a few updates on a JAX batch with
    rewards drawn anew (nonzero Adam state)."""
    rng = np.random.default_rng(seed)
    s = alg.n_seeds
    st = alg.init_state(prng.root_key(seed) if s is None
                        else [prng.root_key(seed + i) for i in range(s)])
    base = tp.to_torch(_jax_batch(2))
    for _ in range(updates):
        bs = [dict(base, rl=torch.from_numpy(rng.normal(
            size=tuple(base["rl"].shape)).astype(np.float32)))
              for _ in range(s or 1)]
        g = torch.from_numpy(rng.gumbel(size=(s or 1, 8, 2, 5))
                             .astype(np.float32))
        batch = bs[0] if s is None else jax.tree_util.tree_map(
            lambda *x: torch.stack(x), *bs)
        st, _ = alg.update(st, batch, 0.2 if s is None
                           else torch.full((s,), 0.2),
                           g[0] if s is None else g)
    return st


@pytest.mark.parametrize("n_seeds", [None, 3])
@pytest.mark.parametrize("kind,opts", [
    ("baseline", dict(use_Q=True)), ("baseline", dict(use_V=True, IAC=True)),
    ("qmix", dict(grad_clip=10.0))], ids=["coma", "iac", "qmix"])
def test_save_restore_round_trip(tmp_path, kind, opts, n_seeds):
    """Parameters, targets, Adam moments and counts (QMIX's one joint
    Adam state), whether it clips, and the step come back bit for bit
    into a state of other values, whose buffers are kept; an absent
    critic stays None."""
    je, _ = tp.envs()
    _, alg = tp.other_algs(kind, je.spec(), n_seeds=n_seeds, **opts)
    st = _trained(alg, 5)
    path = os.path.join(str(tmp_path), "ckpt")
    checkpoint.save(path, {"ts": st, "episodes": 40 if n_seeds is None
                           else np.array([40, 41, 39])})
    like = alg.init_state(prng.root_key(9) if n_seeds is None
                          else [prng.root_key(9 + i) for i in range(3)])
    buffers = {n: getattr(like, n).flat for n in alg.net_names()}
    back = checkpoint.restore(path, {"ts": like, "episodes": 0})
    got = back["ts"]
    for name in alg.net_names():
        for x in ("", "_tgt"):
            assert torch.equal(getattr(got, name + x).flat,
                               getattr(st, name + x).flat), name + x
        assert getattr(got, name).flat is buffers[name]
        o, w = getattr(got, "opt_" + name), getattr(st, "opt_" + name)
        assert torch.equal(o.mu, w.mu) and torch.equal(o.nu, w.nu)
        assert (o.count, o.clipped) == (w.count, w.clipped) == (
            2, bool(opts.get("grad_clip")))
    assert got.step == st.step == 2
    if kind == "baseline":
        assert (got.q is None) == (got.v is not None)
    if n_seeds is not None:
        one = checkpoint.seed_state(alg.for_seeds(None), st, 1)
        stacked = checkpoint.stack_states(alg, [
            checkpoint.seed_state(alg.for_seeds(None), st, i)
            for i in range(3)])
        name = alg.net_names()[-1]
        assert torch.equal(getattr(one, name).flat,
                           getattr(st, name).flat[1])
        assert torch.equal(getattr(stacked, "opt_" + name).nu,
                           getattr(st, "opt_" + name).nu)


def test_qmix_state_from_jax_keeps_the_joint_adam_state():
    """JAX's one Adam state over (agent, mixer) after an update loads
    whole into the port's joint buffer: agent leaves first."""
    j, ta = _jax_state("qmix", 2, 3)
    je, _ = tp.envs()
    ja, _ = tp.other_algs("qmix", je.spec())
    j2, _ = jax.jit(ja.update)(j, _jax_batch(2), 0.1, jax.random.PRNGKey(0))
    st = convert.state_from_jax(ta, jax.device_get(j2))
    agent = convert.params_to_flat(st.qmix.agent, j2.agent)
    mixer = convert.params_to_flat(st.qmix.mixer, j2.mixer)
    assert torch.equal(st.qmix.flat, torch.cat([agent, mixer]))
    assert st.opt_qmix.count == 1 and st.opt_qmix.mu.abs().sum() > 0
    assert st.opt_qmix.mu.shape == st.qmix.flat.shape


# --------------------------------------------------------------------- #
# the runner at narrow widths
# --------------------------------------------------------------------- #

SMALL = dict(n_envs=8, seed=5, N_train=60, period=30, N_eval=2,
             pretrain_episodes=8, batch_size=16, buffer_size=256,
             steps_per_train=4, updates_per_chunk=1, episode_log=64,
             dir_name="b1", dir_restore="b1")


@pytest.fixture
def small_nets(monkeypatch):
    monkeypatch.setattr(runner, "_nn_config", lambda m, e, s: tcfg.NNConfig(
        **tp.SMALL_BASE_NN))


def _century(wd, d):
    with open(os.path.join(wd, "log", d, "log_century.csv")) as f:
        return list(csv.DictReader(f))


def _no_updates(**over):
    """A run too short to leave the random fill: its final state is its
    initial one."""
    return dict(SMALL, N_train=20, pretrain_episodes=1000, **over)


def test_qmix_stage2_restores_stage1_and_grafts_nothing(tmp_path,
                                                        small_nets):
    """As JAX's runner (``runner.py:208-214``): QMIX at stage 2 with
    ``train_from_nothing`` 0 needs the stage-1 checkpoint (it restores
    it) but starts from its own fresh parameters, one seed and seeds in
    lockstep."""
    wd = str(tmp_path)
    m2 = _master(_no_updates(alg_name="qmix", stage=2, dir_name="q2",
                             train_from_nothing=0))
    with pytest.raises(FileNotFoundError):     # no stage-1 checkpoint
        runner.train_function(m2, wd, verbose=False, device="cpu")
    ts1, _ = runner.train_function(_master(SMALL, alg_name="qmix", stage=1),
                                   wd, verbose=False, device="cpu")
    assert ts1.step > 0
    st, _ = runner.train_function(m2, wd, verbose=False, device="cpu")
    alg = runner.build(m2, device="cpu")[1]
    fresh = alg.init_state(prng.root_key(SMALL["seed"]))
    assert st.step == 0
    for x in ("qmix", "qmix_tgt"):
        assert torch.equal(getattr(st, x).flat, getattr(fresh, x).flat)
    mv = dict(m2, vmapped_seeds=1, n_seeds=2, dir_name="q2v")
    stack, _ = runner.vmapped_resume(mv, wd, alg, alg.for_seeds(2), "cpu")
    for i in range(2):
        assert torch.equal(stack.qmix.flat[i], alg.init_state(
            prng.root_key(SMALL["seed"] + i)).qmix.flat)


def test_iac_trains_and_grafts_through_the_runner(tmp_path, small_nets):
    """IAC stage 1 through ``train_function`` (its logs and
    ``model_final``), then stage 2 grafted from it: the actor's and V's
    shared leaves equal stage 1's, targets equal mains; then stage 2
    trains with the losses of both networks in its rows."""
    wd = str(tmp_path)
    ts1, st1 = runner.train_function(_master(SMALL, alg_name="iac"), wd,
                                     verbose=False, device="cpu")
    assert ts1.v is not None and ts1.q is None and st1["episodes"] >= 60
    st, _ = runner.train_function(_master(_no_updates(
        alg_name="iac", stage=2, dir_name="g", train_from_nothing=0)), wd,
        verbose=False, device="cpu")
    for net, src in ((st.actor, ts1.actor), (st.v, ts1.v)):
        views = checkpoint.named_views(src)
        for name, v in checkpoint.named_views(net).items():
            if "stage2" not in name.split("."):
                assert torch.equal(v, views[name]), name
    for name in ("actor", "v"):
        assert torch.equal(getattr(st, name).flat,
                           getattr(st, name + "_tgt").flat)
    ts2, stats = runner.train_function(
        _master(SMALL, alg_name="iac", stage=2, dir_name="s2",
                train_from_nothing=0), wd, verbose=False, device="cpu")
    assert ts2.step > 0 and stats["episodes"] >= 60
    with open(os.path.join(wd, "log", "s2", "metrics.jsonl")) as f:
        last = json.loads(f.readlines()[-1])
    assert {"loss_V", "policy_loss"} <= set(last) and "loss_Q" not in last


def test_coma_seeds_in_lockstep_and_resume(tmp_path, small_nets):
    """``checkers_coma`` with 3 seeds in lockstep through
    ``train_multiseed``: per-seed logs and ``model_final``, seeds apart;
    a rerun with ``auto_resume`` goes on from the stack's autosave."""
    wd = str(tmp_path)
    m = _master(SMALL, alg_name="coma", stage=2, dir_name="c",
                vmapped_seeds=1, n_seeds=3)
    st, hist = runner.train_multiseed(m, wd, device="cpu")
    assert st.q is not None and st.v is None and st.step > 0
    assert (hist[-1]["episode"] >= 60).all()
    assert not torch.equal(st.actor.flat[0], st.actor.flat[1])
    alg1 = runner.build(m, device="cpu")[1]
    for i in range(3):
        final = checkpoint.restore(
            os.path.join(wd, "saved", f"c_{i + 1}", "model_final"),
            alg1.empty_state())
        assert torch.equal(final.q.flat, st.q.flat[i])
        assert len(_century(wd, f"c_{i + 1}")) == len(hist)
    st2, hist2 = runner.train_multiseed(
        dict(m, auto_resume=1, require_resume=1, N_train=90), wd,
        device="cpu")
    assert (hist2[0]["episode"] > hist[-1]["episode"].min()).all()
    assert st2.step > st.step


def test_qmix_auto_resume(tmp_path, small_nets):
    """QMIX resumed from its autosave: the episode count and the state
    (its one Adam count grows from the saved one)."""
    wd = str(tmp_path)
    m = _master(SMALL, alg_name="qmix", stage=2, dir_name="qr")
    ts, stats = runner.train_function(m, wd, verbose=False, device="cpu")
    saved = checkpoint.restore(
        os.path.join(wd, "saved", "qr", "model_autosave"),
        {"ts": runner.build(m, device="cpu")[1].empty_state(),
         "episodes": 0})
    ts2, stats2 = runner.train_function(
        dict(m, auto_resume=1, require_resume=1, N_train=120), wd,
        verbose=False, device="cpu")
    rows = _century(wd, "qr")
    assert int(rows[-1]["Century"]) >= 120 > saved["episodes"] > 0
    assert ts2.opt_qmix.count > saved["ts"].opt_qmix.count > 0


def test_cli_alg_qmix_on_the_cpu(tmp_path, small_nets):
    """``main`` with ``--alg qmix --device cpu`` trains one period."""
    wd = str(tmp_path)
    cfg = os.path.join(wd, "master.json")
    with open(cfg, "w") as f:
        json.dump(_master(SMALL, stage=2, dir_name="cli"), f)
    runner.main(["--config", cfg, "--alg", "qmix", "--episodes", "30",
                 "--workdir", wd, "--device", "cpu"])
    rows = _century(wd, "cli")
    assert len(rows) == 1 and int(rows[0]["Century"]) >= 30
    final = checkpoint.restore(
        os.path.join(wd, "saved", "cli", "model_final"),
        runner.build(_master(SMALL, stage=2, alg_name="qmix"),
                     device="cpu")[1].empty_state())
    assert final.step > 0
