"""The port's runner and CLI (``cm3_tpu_torch.train.runner``) on the CPU:
``build`` against JAX's ``build`` on the same masters; the masters
once refused (a ``mesh`` key, ``replay_shards``), which now train (the
baselines and QMIX are in ``test_torch_baseline_runner.py``);
``train_function`` end to end at narrow widths, with the files it
writes; the stage-1 -> stage-2 graft; the
autosave's ``auto_resume`` and ``require_resume``; ``train_multiseed``
one seed after another and in lockstep (``vmapped_seeds``) with the
graft into every seed; and ``main`` with ``--device cpu``."""

import csv
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from cm3_tpu.train import runner as jrunner
from cm3_tpu_torch.core import config as tcfg
from cm3_tpu_torch.train import checkpoint, runner
from tests import torch_parity as tp

tp.set_torch_cpu()

# the paper's Checkers cells (scripts/reproduce_paper.py:153-161, 448-452)
S1 = dict(experiment="checkers", stage=1, n_envs=16, dir_name="ck_s1",
          period=100, N_eval=10)
S2 = dict(S1, stage=2, dir_name="ck_s2", dir_restore="ck_s1",
          train_from_nothing=0)
S2_V = dict(S2, dir_name="ck_s2V", use_Q_credit=0, use_V=1)
BUILDS = {
    "master": {},
    "checkers_s1": S1,
    "checkers_s2": S2,
    "checkers_s2_V": S2_V,
    "options": dict(S2, fused_opt=1, actor_freeze_updates=40, adv_norm=1,
                    pg_is_clip=1.0, pg_ent_coef=0.01, lr_V=3e-3,
                    target_clip=20.0, threshold=12.0, save_threshold=3.0,
                    n_seeds=4, seed=3, init_scheme="tf1"),
    "optax_clip": dict(S2, grad_clip=10.0, actor_lr_anneal_updates=100),
}


def _master(base=None, **over):
    m = tcfg.load_json("master.json")
    m.update(base or {})
    m.update(over)
    return m


@pytest.mark.parametrize("name", sorted(BUILDS))
def test_build_matches_jax(name):
    """The same AlgConfig, TrainConfig and NNConfig values as JAX's
    ``build`` (every field the port's configs have; the port's
    TrainConfig has all of JAX's), the same spec and driver settings."""
    m = _master(BUILDS[name])
    jd, ja, jh, jtc = jrunner.build(m)
    td, ta, th, ttc = runner.build(m, device="cpu")
    for got, want in ((ta.cfg, ja.cfg), (ttc, jtc), (ta.nn_cfg, ja.nn_cfg),
                      (th.env.cfg, jh.env.cfg)):
        for f in dataclasses.fields(got):
            assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert {f.name for f in dataclasses.fields(ttc)} == {
        f.name for f in dataclasses.fields(jtc)}
    assert ta.spec == dict(ja.spec, n_agents=ja.n_agents)
    assert (ta.use_credit, ta.use_v) == (ja.use_credit, ja.use_v)
    assert th.n_agents == jh.n_agents
    assert td._store_bp == jd._store_bp
    for f in dataclasses.fields(th.env.cfg):
        assert getattr(th.env.cfg, f.name) == getattr(jh.env.cfg, f.name)


# masters once refused: a mesh key (fault C1: JAX's build keeps only
# TrainConfig's fields, so the key is ignored) and shard-local replay
# (ROADMAP A14a)
ONCE_REFUSED = {
    "mesh": dict(mesh=[4]),
    "replay_shards": dict(replay_shards=2),
}


@pytest.mark.parametrize("name", sorted(ONCE_REFUSED))
def test_once_refused_masters_train(name, tmp_path, small_nets):
    """Such a master builds the TrainConfig JAX's ``build`` makes of it
    and trains a few episodes through ``train_function``: period rows
    with losses, ``model_final``; with ``replay_shards`` the driver's
    replay is two shards."""
    m = _master(SMALL, N_train=24, period=12, **ONCE_REFUSED[name])
    jtc = jrunner.build(m)[3]
    td, _, _, ttc = runner.build(m, device="cpu")
    for f in dataclasses.fields(ttc):
        assert getattr(ttc, f.name) == getattr(jtc, f.name), f.name
    ts, stats = runner.train_function(m, str(tmp_path), verbose=False,
                                      device="cpu")
    assert stats["episodes"] >= 24 and ts.step > 0
    assert "policy_loss" in stats["history"][-1]
    assert os.path.isdir(os.path.join(str(tmp_path), "saved", "s1",
                                      "model_final"))
    if name == "replay_shards":
        assert tuple(stats["buffer"].size.shape) == (2,)


def test_summarize_builds():
    """``summarize`` (once refused, ROADMAP A15) reaches the driver; the
    event files it makes are held in ``test_torch_summaries_runner.py``."""
    driver, *_ = runner.build(_master(summarize=True), device="cpu")
    assert driver.cfg.summarize


@pytest.mark.parametrize("flag", [["--render-only"],
                                  ["--render-episodes", "2"]])
def test_rendering_flags_run(flag, tmp_path, small_nets, capsys):
    """The rendering flags (once refused, ROADMAP A15) write their SVGs:
    ``--render-episodes`` after a tiny run, ``--render-only`` (three by
    default) from a saved ``model_final``."""
    m = _master(SMALL, N_train=4, period=4, pretrain_episodes=2)
    cfg = tmp_path / "m.json"
    cfg.write_text(json.dumps(m))
    wd = str(tmp_path / "wd")
    base = ["--config", str(cfg), "--workdir", wd, "--device", "cpu"]
    if flag == ["--render-only"]:
        runner.main(base)
        capsys.readouterr()
    runner.main(base + flag)
    paths = capsys.readouterr().out.strip().splitlines()
    n = 3 if flag == ["--render-only"] else 2
    assert paths[-n:] == [os.path.join(wd, "render", "s1",
                                       f"episode_{i}.svg")
                          for i in range(n)]
    assert all(os.path.getsize(p) > 0 for p in paths[-n:])


# --------------------------------------------------------------------- #
# training through the runner, at narrow widths
# --------------------------------------------------------------------- #

SMALL = dict(n_envs=8, seed=5, N_train=60, period=30, N_eval=2,
             pretrain_episodes=8, batch_size=16, buffer_size=256,
             steps_per_train=4, updates_per_chunk=1, episode_log=64,
             dir_name="s1", dir_restore="s1")


@pytest.fixture
def small_nets(monkeypatch):
    monkeypatch.setattr(runner, "_nn_config", lambda m, e, s: tcfg.NNConfig(
        **tp.SMALL_NN))


def _century(wd, d):
    with open(os.path.join(wd, "log", d, "log_century.csv")) as f:
        return list(csv.DictReader(f))


def test_train_function_writes_the_files(tmp_path, small_nets):
    """Stage 1 through ``train_function``: period rows in
    ``log_century.csv`` (the reference's header), one JSON line each in
    ``metrics.jsonl``, the sampled episode rows in ``log.csv``, the
    autosave at the last period and ``model_final``, which restores to
    the returned state."""
    wd = str(tmp_path)
    ts, stats = runner.train_function(_master(SMALL), wd, verbose=False,
                                      device="cpu")
    assert stats["episodes"] >= 60
    rows = _century(wd, "s1")
    assert len(rows) == len(stats["history"]) >= 2
    assert list(rows[0])[:3] == ["Century", "r_global_avg", "r_avg_0"]
    with open(os.path.join(wd, "log", "s1", "metrics.jsonl")) as f:
        lines = [json.loads(x) for x in f]
    assert [x["episode"] for x in lines] == [int(r["Century"])
                                             for r in rows]
    assert {"loss_Q_global", "policy_loss", "r_eval_local"} <= set(lines[-1])
    with open(os.path.join(wd, "log", "s1", "log.csv")) as f:
        eps = [int(r["Episode"]) for r in csv.DictReader(f)]
    assert eps == sorted(eps) and len(set(eps)) == len(eps) >= 30
    saved = os.path.join(wd, "saved", "s1")
    assert {"model_final", "model_autosave"} <= set(os.listdir(saved))
    back = checkpoint.restore(os.path.join(saved, "model_autosave"),
                              {"ts": runner.build(_master(SMALL),
                                                  device="cpu")[1]
                               .empty_state(), "episodes": 0})
    assert back["episodes"] == int(rows[-1]["Century"])
    final = checkpoint.restore(os.path.join(saved, "model_final"),
                               runner.build(_master(SMALL), device="cpu")
                               [1].empty_state())
    assert torch.equal(final.actor.flat, ts.actor.flat)
    assert final.step == ts.step > 0


def _no_updates(**over):
    """A run too short to leave the random fill: its final state is its
    initial one."""
    return dict(SMALL, N_train=20, pretrain_episodes=1000, **over)


def _hold_graft(st, s1):
    """The grafted stage-2 state: the actor's and Q_global's leaves
    outside ``stage2`` equal stage 1's, Q_credit's equal Q_global's,
    targets equal their mains."""
    for net, src in ((st.actor, s1.actor), (st.qg, s1.qg), (st.qc, st.qg)):
        if net is None:
            continue
        views = checkpoint.named_views(src)
        for name, v in checkpoint.named_views(net).items():
            if "stage2" not in name.split("."):
                assert torch.equal(v, views[name]), name
    for name in ("actor", "qg", "qc"):
        if getattr(st, name) is not None:
            assert torch.equal(getattr(st, name).flat,
                               getattr(st, name + "_tgt").flat)


@pytest.mark.parametrize("opts", [dict(), dict(use_Q_credit=0, use_V=1)],
                         ids=["credit", "V"])
def test_stage2_grafts_stage1(tmp_path, small_nets, opts):
    """Stage 2 with ``train_from_nothing: 0`` restores the stage-1
    ``model_final`` and grafts it; then it trains from there."""
    wd = str(tmp_path)
    ts1, _ = runner.train_function(_master(SMALL), wd, verbose=False,
                                   device="cpu")
    st, _ = runner.train_function(
        _master(_no_updates(stage=2, dir_name="g", train_from_nothing=0,
                              **opts)), wd, verbose=False, device="cpu")
    assert st.step == 0 < ts1.step      # stage 2 counts its own steps
    _hold_graft(st, ts1)
    assert (st.v is None) == (not opts)
    ts2, stats = runner.train_function(
        _master(SMALL, stage=2, dir_name="s2", train_from_nothing=0,
                fused_opt=1, actor_freeze_updates=2, **opts), wd,
        verbose=False, device="cpu")
    assert stats["episodes"] >= 60 and ts2.step > 0
    for name in ("actor", "qg"):
        assert torch.isfinite(getattr(ts2, name).flat).all()


def test_auto_resume_and_require_resume(tmp_path, small_nets):
    """A rerun with ``auto_resume`` starts at the autosave's episode
    count with its state, appending to the logs; ``require_resume``
    without an autosave refuses to start over."""
    wd = str(tmp_path)
    m = _master(SMALL, dir_name="r")
    with pytest.raises(FileNotFoundError, match="require_resume"):
        runner.train_function(dict(m, require_resume=1), wd, verbose=False,
                              device="cpu")
    ts, stats = runner.train_function(m, wd, verbose=False, device="cpu")
    first = _century(wd, "r")
    auto = os.path.join(wd, "saved", "r", "model_autosave")
    saved = checkpoint.restore(auto, {"ts": runner.build(
        m, device="cpu")[1].empty_state(), "episodes": 0})
    start = saved["episodes"]
    assert start == stats["episodes"] == int(first[-1]["Century"])
    ts2, stats2 = runner.train_function(
        dict(m, auto_resume=1, require_resume=1, N_train=120), wd,
        verbose=False, device="cpu")
    rows = _century(wd, "r")
    assert rows[:len(first)] == first
    assert int(rows[len(first)]["Century"]) > start
    assert stats2["episodes"] >= 120
    # it went on from the autosave's state: its Adam counts grew from it
    assert ts2.opt_qg.count > saved["ts"].opt_qg.count > 0


def test_multiseed_one_after_another(tmp_path, small_nets):
    wd = str(tmp_path)
    out = runner.train_multiseed(_master(SMALL, n_seeds=2, N_train=40,
                                         dir_name="m"), wd, device="cpu")
    assert len(out) == 2
    for i in (1, 2):
        assert os.path.isdir(os.path.join(wd, "saved", f"m_{i}",
                                          "model_final"))
        assert len(_century(wd, f"m_{i}")) >= 1
    assert not torch.equal(out[0][0].actor.flat, out[1][0].actor.flat)


def test_multiseed_in_lockstep_grafts_every_seed(tmp_path, small_nets):
    """``vmapped_seeds`` at stage 2 from a stage-1 winner: every seed is
    grafted (its stage-2 branches its own), per-seed logs and
    ``model_final``, one autosave of the stack that a rerun with
    ``auto_resume`` starts from."""
    wd = str(tmp_path)
    ts1, _ = runner.train_function(_master(SMALL), wd, verbose=False,
                                   device="cpu")
    m = _master(_no_updates(stage=2, dir_name="v", train_from_nothing=0,
                              vmapped_seeds=1, n_seeds=3))
    st, history = runner.train_multiseed(m, wd, device="cpu")
    alg1 = runner.build(m, device="cpu")[1]
    seeds = [checkpoint.seed_state(alg1, st, i) for i in range(3)]
    for one in seeds:
        _hold_graft(one, ts1)
    stage2 = [checkpoint.named_views(one.actor)["stage2.dense.weight"]
              for one in seeds]
    assert not torch.equal(stage2[0], stage2[1])
    for i in range(3):
        final = checkpoint.restore(
            os.path.join(wd, "saved", f"v_{i + 1}", "model_final"),
            alg1.empty_state())
        assert torch.equal(final.actor.flat, st.actor.flat[i])
        assert len(_century(wd, f"v_{i + 1}")) == len(history)
    # train, then resume the stack from its autosave
    m2 = dict(m, N_train=60, pretrain_episodes=8)
    st2, hist2 = runner.train_multiseed(m2, wd, device="cpu")
    assert st2.step > 0 and (hist2[-1]["episode"] >= 60).all()
    st3, hist3 = runner.train_multiseed(
        dict(m2, auto_resume=1, require_resume=1, N_train=100), wd,
        device="cpu")
    assert (hist3[0]["episode"] > hist2[-1]["episode"].min()).all()
    assert st3.step > st2.step
    with pytest.raises(FileNotFoundError, match="require_resume"):
        runner.train_multiseed(dict(m2, dir_name="none", require_resume=1,
                                    auto_resume=1), wd, device="cpu")


def test_main_on_the_cpu(tmp_path, small_nets):
    """The CLI with ``--device cpu``: a config file, ``--stage``,
    ``--episodes``, ``--n-envs`` and ``--workdir``."""
    wd = str(tmp_path)
    cfg = os.path.join(wd, "master.json")
    with open(cfg, "w") as f:
        json.dump(_master(SMALL), f)
    runner.main(["--config", cfg, "--stage", "1", "--episodes", "40",
                 "--n-envs", "4", "--workdir", wd, "--device", "cpu"])
    rows = _century(wd, "s1")
    assert rows and int(rows[-1]["Century"]) >= 30
    assert checkpoint.exists(os.path.join(wd, "saved", "s1", "model_final"))
    runner.main(["--config", cfg, "--episodes", "40", "--workdir", wd,
                 "--multiseed", "--device", "cpu"])
    for i in (1, 2, 3):
        assert _century(wd, f"s1_{i}")
    assert np.isfinite([float(r["r_eval_0"]) for r in rows]).all()
