"""Roadway and the dual buffer through the port's runner against the JAX
runner, on the CPU: ``build`` of the paper's roadway cells
(``scripts/reproduce_paper.py:194-214, 558-562``: ``roadway_s1``,
``roadway_s2`` and ``roadway_s2_stable`` with the master's
``dual_buffer``, ``roadway_qmix``) against JAX's (the configs, the
hooks' ``threshold``, the off-policy choice); the stage-1 -> stage-2
graft on roadway states against JAX's ``stage2_init_cm3`` and
``stage2_init_baseline`` bit for bit, one seed and S = 3; stage 2 with
the dual buffer through both runners, whose CSV and JSONL files agree
in everything the draw streams do not decide (the header, the JSONL
keys and their order: ``n_bad``/``n_good`` and the traffic metrics
among them); the snapshots' default gate, ``roadway_stage<N>.json``'s
``save_threshold``; seeds in lockstep with the dual buffer; and
``--experiment roadway`` through the CLI."""

import csv
import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from cm3_tpu.core import config as jcfg
from cm3_tpu.train import checkpoint as jckpt
from cm3_tpu.train import runner as jrunner
from cm3_tpu_torch import convert
from cm3_tpu_torch.core import config as tcfg
from cm3_tpu_torch.train import checkpoint, runner
from cm3_tpu_torch.train.onpolicy import OnPolicyDriver
from tests import torch_parity as tp

tp.set_torch_cpu()

R1 = dict(experiment="roadway", stage=1, n_envs=16, dir_name="rd_s1",
          period=100, N_eval=10)
R2 = dict(R1, stage=2, dir_name="rd_s2", dir_restore="rd_s1",
          train_from_nothing=0, dual_buffer=1)
CELLS = {
    "roadway_s1": R1,
    "roadway_s2": R2,
    "roadway_s2_stable": dict(R2, dir_name="rd_s2c", grad_clip=10.0),
    "roadway_qmix": dict(R1, stage=2, alg_name="qmix", dir_name="rd_qmix"),
    "roadway_coma_threshold": dict(R2, alg_name="coma", threshold=12.5,
                                   prob_random=1.0),
}


def _master(base, **over):
    m = tcfg.load_json("master.json")
    m.update(base)
    m.update(over)
    return m


@pytest.mark.parametrize("name", sorted(CELLS))
def test_build_matches_jax(name):
    """The same AlgConfig, TrainConfig, NNConfig, env config and hooks
    threshold as JAX's ``build``, the same spec, off-policy."""
    m = _master(CELLS[name])
    jd, ja, jh, jtc = jrunner.build(m)
    td, ta, th, ttc = runner.build(m, device="cpu")
    jnn = jrunner._nn_config(m, "roadway", m["stage"])
    for got, want in ((ta.cfg, ja.cfg), (ttc, jtc), (ta.nn_cfg, jnn),
                      (th.env.cfg, jh.env.cfg)):
        for f in dataclasses.fields(got):
            assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert ta.spec == dict(ja.spec, n_agents=ja.n_agents)
    assert th.threshold == jh.threshold == m["threshold"]
    assert not isinstance(td, OnPolicyDriver)
    assert td._store_bp == jd._store_bp


def _jax_state(kind, stage, key, n_seeds=None, **opts):
    je, _ = tp.roadway_envs(stage)
    ja, ta = tp.roadway_algs(kind, je.spec(), n_seeds=n_seeds, **opts)
    b = jax.device_get(tp.roadway_batch(je, 4, np.random.default_rng(0)))
    init = jax.jit(lambda k: ja.init_state(k, b["obs"], b["state"],
                                           b["goals"]))
    if n_seeds is None:
        return jax.device_get(init(jax.random.PRNGKey(key))), ta
    keys = jax.random.split(jax.random.PRNGKey(key), n_seeds)
    return jax.device_get(jax.vmap(init)(keys)), ta


@pytest.mark.parametrize("n_seeds", [None, 3])
@pytest.mark.parametrize("kind,opts", [
    ("cm3", {}), ("baseline", dict(use_V=True, IAC=True))],
    ids=["cm3", "iac"])
def test_stage2_graft_equals_jax(kind, opts, n_seeds):
    """Stage 1 (one car) grafted into stage 2 (two): the port's graft on
    converted states equals JAX's graft converted, bit for bit; the
    ``stage2`` leaves (the actor's and the IAC critic's grid branch)
    stay stage 2's own, the shared ones are stage 1's, and Q_credit's
    stage-1 leaves are Q_global's (the output bias among them)."""
    j1, t1 = _jax_state(kind, 1, 11, n_seeds, **opts)
    j2, t2 = _jax_state(kind, 2, 22, n_seeds, **opts)
    s1 = convert.state_from_jax(t1, j1)
    fresh = convert.state_from_jax(t2, j2)
    if kind == "cm3":
        want = jckpt.stage2_init_cm3(j2, j1.actor, j1.qg)
        got = checkpoint.stage2_init_cm3(convert.state_from_jax(t2, j2),
                                         s1.actor, s1.qg)
    else:
        want = jckpt.stage2_init_baseline(j2, j1.actor, j1.v)
        got = checkpoint.stage2_init_baseline(
            convert.state_from_jax(t2, j2), s1.actor, s1.v)
    want = convert.state_from_jax(t2, want)
    for name in t2.net_names():
        for x in ("", "_tgt"):
            assert torch.equal(getattr(got, name + x).flat,
                               getattr(want, name + x).flat), name + x
    views1 = checkpoint.named_views(s1.actor)
    for name, v in checkpoint.named_views(got.actor).items():
        if "stage2" in name.split("."):
            assert torch.equal(v, checkpoint.named_views(fresh.actor)[name])
        else:
            assert torch.equal(v, views1[name]), name
    if kind == "cm3":
        qg = checkpoint.named_views(got.qg)
        for name, v in checkpoint.named_views(got.qc).items():
            if "stage2" not in name.split("."):
                assert torch.equal(v, qg[name]), name


# --------------------------------------------------------------------- #
# the curriculum through both runners
# --------------------------------------------------------------------- #

SMALL = dict(n_envs=8, seed=5, N_train=32, period=16, N_eval=2,
             pretrain_episodes=8, batch_size=16, buffer_size=256,
             steps_per_train=4, updates_per_chunk=1, episode_log=64,
             prob_random=1.0, threshold=12.0)


def _files(wd, d):
    with open(os.path.join(wd, "log", d, "log_century.csv")) as f:
        rows = list(csv.reader(f))
    with open(os.path.join(wd, "log", d, "metrics.jsonl")) as f:
        lines = [json.loads(x) for x in f]
    return rows, lines, sorted(os.listdir(os.path.join(wd, "saved", d)))


def test_curriculum_files_match_jax(tmp_path, monkeypatch):
    """The port's curriculum, stage 1 then stage 2 grafted from it with
    the dual buffer, against JAX's runner on the same stage 2 (from
    nothing: the graft changes no file): the same CSV header, JSONL rows
    with the same keys in the same order (the dual rows'
    ``n_bad``/``n_good`` after the episode log's place, the traffic
    metrics, the losses in key order); ``model_final`` and the
    autosave."""
    nn = tp.SMALL_ROADWAY_NN
    monkeypatch.setattr(runner, "_nn_config",
                        lambda m, e, s: tcfg.NNConfig(**nn))
    monkeypatch.setattr(jrunner, "_nn_config",
                        lambda m, e, s: jcfg.NNConfig(**nn))
    s1, s2 = _master(R1, **SMALL), _master(R2, **SMALL)
    wd, jwd = str(tmp_path / "torch"), str(tmp_path / "jax")
    runner.train_function(s1, wd, verbose=False, device="cpu")
    runner.train_function(s2, wd, verbose=False, device="cpu")
    jrunner.train_function(dict(s2, train_from_nothing=1), jwd,
                           verbose=False)
    (g_rows, g_lines, g_saved), (w_rows, w_lines, w_saved) = (
        _files(wd, "rd_s2"), _files(jwd, "rd_s2"))
    assert g_rows[0] == w_rows[0]
    assert [list(x) for x in g_lines] == [list(x) for x in w_lines]
    assert {"model_final", "model_autosave"} <= set(g_saved) & set(w_saved)
    assert g_lines[-1]["n_bad"] + g_lines[-1]["n_good"] > 0
    assert "eval_count_success" in g_lines[-1]
    assert "model_final" in _files(wd, "rd_s1")[2]


def test_save_threshold_defaults_to_the_roadway_files():
    """Without a master ``save_threshold``, roadway's snapshots gate on
    ``roadway_stage<N>.json``'s (9.5 and 18.0), as JAX's runner."""
    m = _master(R1)
    m.pop("save_threshold", None)
    assert runner._save_threshold(m, "roadway", 1) == 9.5
    assert runner._save_threshold(m, "roadway", 2) == 18.0
    assert runner._save_threshold(dict(m, save_threshold=3.0), "roadway",
                                  2) == 3.0
    assert runner._save_threshold(m, "checkers", 1) is None


def test_seeds_in_lockstep_with_the_dual_buffer(tmp_path, monkeypatch):
    """Stage 2 from nothing, three seeds in lockstep with the dual
    buffer through ``train_multiseed``: per-seed logs and
    ``model_final``, the seeds apart."""
    monkeypatch.setattr(runner, "_nn_config", lambda m, e, s: tcfg.NNConfig(
        **tp.SMALL_ROADWAY_NN))
    m = _master(R2, **dict(SMALL, train_from_nothing=1, vmapped_seeds=1,
                           n_seeds=3, N_train=24, period=12))
    ts, hist = runner.train_multiseed(m, str(tmp_path), device="cpu")
    assert hist and (hist[-1]["episode"] >= 24).all()
    assert not torch.equal(ts.actor.flat[0], ts.actor.flat[1])
    for i in (1, 2, 3):
        assert os.path.isdir(tmp_path / "saved" / f"rd_s2_{i}" /
                             "model_final")


def test_cli_trains_roadway(tmp_path, monkeypatch):
    """``--experiment roadway`` through ``main`` on the CPU."""
    monkeypatch.setattr(runner, "_nn_config", lambda m, e, s: tcfg.NNConfig(
        **tp.SMALL_ROADWAY_NN))
    cfg = tmp_path / "m.json"
    cfg.write_text(json.dumps(_master(dict(SMALL, dir_name="cli"))))
    runner.main(["--config", str(cfg), "--experiment", "roadway",
                 "--episodes", "20", "--workdir", str(tmp_path),
                 "--device", "cpu"])
    rows, lines, saved = _files(str(tmp_path), "cli")
    assert len(rows) > 1 and "eval_avg_speed" in lines[-1]
    assert "model_final" in saved
