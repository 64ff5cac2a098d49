"""A particle curriculum through the port's runner and the JAX runner
on the CPU: stage 1, stage 2 grafted from it (CM3 with Q_credit,
on-policy) and an auto-resume of stage 2, at the same narrow widths.
Their CSV and JSONL files agree in everything the draw streams do not
decide: the header, each row's episode and epsilon, and each JSONL
row's keys (the on-policy row carries no losses); the resume restarts
the episode count and epsilon, as JAX's runner does
(``runner.py:293-295``)."""

import csv
import json
import os

from cm3_tpu.core import config as jcfg
from cm3_tpu.train import runner as jrunner
from cm3_tpu_torch.core import config as tcfg
from cm3_tpu_torch.train import runner
from tests import torch_parity as tp
from tests.test_torch_onpolicy_runner import P1, P2, _master

tp.set_torch_cpu()

SMALL = dict(n_envs=4, seed=5, N_train=16, period=8, N_eval=2,
             pretrain_episodes=8, batch_size=8, buffer_size=64, epochs=2,
             episodes_per_train=4, steps_per_train=5, max_steps=5,
             prob_random=0.0, episode_log=64, dir_name="s1",
             dir_restore="s1")


def _files(wd, d):
    with open(os.path.join(wd, "log", d, "log_century.csv")) as f:
        rows = list(csv.reader(f))
    with open(os.path.join(wd, "log", d, "metrics.jsonl")) as f:
        lines = [json.loads(x) for x in f]
    return rows, lines


def _curriculum(train, wd):
    """Stage 1, stage 2 grafted from it (CM3 with Q_credit, on-policy),
    then stage 2 resumed from its autosave to 24 episodes."""
    s1 = _master(P1, **SMALL)
    s2 = _master(P2, **dict(SMALL, dir_name="s2"))
    train(s1, wd)
    train(s2, wd)
    train(dict(s2, auto_resume=1, require_resume=1, N_train=24), wd)
    return _files(wd, "s1"), _files(wd, "s2")


def test_curriculum_files_match_jax(tmp_path, monkeypatch):
    """Both runners at the same narrow widths: the same CSV header, the
    same rows' episodes and epsilons (two bursts by 16 episodes), JSONL
    rows with the same keys and no loss; the resume appends rows that
    restart at the first period with epsilon back at its start, as
    JAX's runner (its on-policy driver takes no ``initial_episodes``)."""
    nn = tp.SMALL_PARTICLE_NN
    monkeypatch.setattr(runner, "_nn_config",
                        lambda m, e, s: tcfg.NNConfig(**nn))
    monkeypatch.setattr(jrunner, "_nn_config",
                        lambda m, e, s: jcfg.NNConfig(**nn))
    want = _curriculum(lambda m, wd: jrunner.train_function(
        m, str(wd), verbose=False), tmp_path / "jax")
    got = _curriculum(lambda m, wd: runner.train_function(
        m, str(wd), verbose=False, device="cpu"), tmp_path / "port")
    for (jrows, jlines), (trows, tlines) in zip(want, got):
        assert trows[0] == jrows[0]
        assert [r[0] for r in trows] == [r[0] for r in jrows]
        eps = trows[0].index("epsilon")
        assert [r[eps] for r in trows] == [r[eps] for r in jrows]
        assert [sorted(x) for x in tlines] == [sorted(x) for x in jlines]
        for line in tlines:
            assert not any(k.startswith(("loss", "policy")) for k in line)
            assert line["t_train"] >= 0.0 and "eval_reach_rate" in line
    (s1_rows, _), (s2_rows, s2_lines) = got
    assert [r[0] for r in s1_rows[1:]] == ["8", "16"]
    # stage 2, then its resume: the count restarts at the first period
    assert [r[0] for r in s2_rows[1:]] == ["8", "16", "8", "16", "24"]
    assert s2_lines[2]["epsilon"] == 0.5 > s2_lines[1]["epsilon"]
    assert os.path.isdir(tmp_path / "port" / "saved" / "s2" / "model_final")
