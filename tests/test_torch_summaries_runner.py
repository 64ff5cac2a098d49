"""The runners' TensorBoard event files against the JAX runner's
(``summarize``): Checkers stage 1 through ``train_function`` (one seed;
three seeds in lockstep through ``train_multiseed``:
``test_torch_summaries_lockstep.py``), from JAX's start with JAX's
draws fed in and both clocks stopped, decoded
through ``tensorboard``'s loader (which checks every record's CRC): the
same events in the same order with the same steps and tags, scalars
(all but ``duration_s``, held by tag and step) at rtol 1e-5 / atol
1e-6, histograms with the same counts and their sums at the state's
tolerance.  And a run with ``summarize`` on leaves the CSV / JSONL
bytes and ``model_final`` of one with it off."""

import glob
import os
import types

import jax
import numpy as np
import pytest
import torch

from cm3_tpu.core import config as jcfg
from cm3_tpu.train import multiseed as jmultiseed
from cm3_tpu.train import offpolicy as joffpolicy
from cm3_tpu.train import runner as jrunner
from cm3_tpu.train import tboard as jtb
from cm3_tpu.train.offpolicy import OffPolicyDriver as JaxDriver
from cm3_tpu_torch import convert
from cm3_tpu_torch.core import config as tcfg
from cm3_tpu_torch.train import checkpoint, multiseed, offpolicy, runner
from cm3_tpu_torch.train import tboard as ttb
from cm3_tpu_torch.train.offpolicy import OffPolicyDriver
from tests import torch_parity as tp
from tests.test_torch_summaries_run import (B, CAP, E, SPT, U,
                                            _offpolicy_draws)

tb_loader = pytest.importorskip(
    "tensorboard.backend.event_processing.event_file_loader")

tp.set_torch_cpu()

S = 3
TINY = dict(experiment="checkers", stage=1, n_envs=E, steps_per_train=SPT,
            updates_per_chunk=U, batch_size=B, buffer_size=CAP,
            pretrain_episodes=8, period=8, N_train=16, N_eval=3,
            max_steps=5, episode_log=6, seed=5, dir_name="ck",
            train_from_nothing=1, summarize=1, fused_opt=0)


def load_events(log_dir):
    """Every event of the one event file in ``log_dir``, decoded by
    tensorboard (its reader checks the TFRecord CRCs)."""
    from tensorboard.compat.proto import event_pb2
    files = glob.glob(os.path.join(log_dir, "events.out.tfevents.*"))
    assert len(files) == 1, files
    loader = tb_loader.RawEventFileLoader(files[0])
    return [event_pb2.Event.FromString(r) for r in loader.Load()]


def hold_events(got, want):
    assert got[0].file_version == want[0].file_version == "brain.Event:2"
    assert len(got) == len(want)
    assert [e.step for e in got] == [e.step for e in want]
    assert [e.wall_time for e in got] == [e.wall_time for e in want]
    n_histo = 0
    for g, w in zip(got[1:], want[1:]):
        (gv,), (wv,) = g.summary.value, w.summary.value
        assert gv.tag == wv.tag
        assert gv.WhichOneof("value") == wv.WhichOneof("value")
        if wv.WhichOneof("value") == "simple_value":
            if wv.tag != "duration_s":
                np.testing.assert_allclose(gv.simple_value, wv.simple_value,
                                           rtol=1e-5, atol=1e-6,
                                           err_msg=wv.tag)
            continue
        n_histo += 1
        gh, wh = gv.histo, wv.histo
        assert gh.num == wh.num and sum(gh.bucket) == sum(wh.bucket) \
            == wh.num, wv.tag
        for f in ("min", "max"):
            np.testing.assert_allclose(getattr(gh, f), getattr(wh, f),
                                       rtol=1e-5, atol=1e-6, err_msg=wv.tag)
        # sums over a leaf: the leaf's values at rtol 1e-5 / atol 1e-6
        np.testing.assert_allclose(gh.sum, wh.sum, rtol=1e-5,
                                   atol=1e-6 * wh.num, err_msg=wv.tag)
        np.testing.assert_allclose(gh.sum_squares, wh.sum_squares,
                                   rtol=1e-4, atol=1e-6 * wh.num,
                                   err_msg=wv.tag)
    return n_histo


@pytest.fixture
def stopped(monkeypatch):
    """Narrow nets, both drivers' clocks stopped and one wall time and
    host name for the event files."""
    monkeypatch.setattr(runner, "_nn_config",
                        lambda m, e, s: tcfg.NNConfig(**tp.SMALL_NN))
    monkeypatch.setattr(jrunner, "_nn_config",
                        lambda m, e, s: jcfg.NNConfig(**tp.SMALL_NN))
    clock = types.SimpleNamespace(time=lambda: 0.0)
    monkeypatch.setattr(joffpolicy, "time", clock)
    monkeypatch.setattr(offpolicy, "time", clock)
    monkeypatch.setattr(multiseed, "time", clock)
    monkeypatch.setattr(jmultiseed, "time", clock)
    wall = types.SimpleNamespace(time=lambda: 1_700_000_000.5)
    host = types.SimpleNamespace(gethostname=lambda: "host")
    for mod in (jtb, ttb):
        monkeypatch.setattr(mod, "time", wall)
        monkeypatch.setattr(mod, "socket", host)
    return monkeypatch


def _master(**over):
    m = tcfg.load_json("master.json")
    m.update(TINY, **over)
    return m


def test_one_seed_events_match_jax(tmp_path, stopped):
    """Rows at 8 (after the fill: no ``grads/``) and 16 episodes."""
    master = _master()
    jwd, twd = str(tmp_path / "jax"), str(tmp_path / "port")
    start = {}
    jax_run = JaxDriver.run

    def record(self, ts_alg, key, **kw):
        start.update(ts=jax.device_get(ts_alg), key=key)
        return jax_run(self, ts_alg, key, **kw)

    stopped.setattr(JaxDriver, "run", record)
    jrunner.train_function(master, jwd, verbose=False)

    def from_jax(master, workdir, device):
        driver, alg, hooks, cfg = runner.build(master, device=device)
        return driver, alg, hooks, cfg, convert.state_from_jax(alg,
                                                               start["ts"])

    port_run = OffPolicyDriver.run
    fed = {}

    def fed_run(self, ts_alg, key, **kw):
        draws, evals, snaps = _offpolicy_draws(start["key"])
        fed.update(d=draws(), e=evals(), s=snaps())
        return port_run(self, ts_alg, key, draws=fed["d"],
                        eval_draws=fed["e"], snapshot_draws=fed["s"], **kw)

    stopped.setattr(runner, "initial_state", from_jax)
    stopped.setattr(OffPolicyDriver, "run", fed_run)
    runner.train_function(master, twd, verbose=False, device="cpu")
    for d in fed.values():
        assert not any(d.remaining().values())
    want = load_events(os.path.join(jwd, "log", "ck"))
    got = load_events(os.path.join(twd, "log", "ck"))
    assert hold_events(got, want) > 0
    tags = [e.summary.value[0].tag for e in got[1:]]
    assert "r_eval_local/agent_0" in tags and "loss_Q_global" in tags
    assert "vars/opt_qg/0/nu" in tags
    grads = [t for t in tags if t.startswith("grads/")]
    assert grads and all(e.step == 16 for e in got[1:]
                         if e.summary.value[0].tag.startswith("grads/"))
    assert {t.split("/")[1] for t in grads} == {"Policy", "Q_global"}


def _files(wd, d):
    out = {}
    for name in ("log_century.csv", "log.csv", "metrics.jsonl"):
        with open(os.path.join(wd, "log", d, name), "rb") as f:
            out[name] = f.read()
    return out


@pytest.mark.parametrize("seeds", [None, S], ids=["one_seed", "lockstep"])
def test_summaries_change_no_training(tmp_path, stopped, seeds):
    """The port's runner with ``summarize`` on and off (its own draws):
    the same CSV and JSONL bytes and the same ``model_final``, and an
    event file only with it on."""
    over = {} if seeds is None else dict(vmapped_seeds=1, n_seeds=seeds)
    out = {}
    for on in (1, 0):
        wd = str(tmp_path / str(on))
        m = _master(summarize=on, **over)
        if seeds is None:
            runner.train_function(m, wd, verbose=False, device="cpu")
            dirs = ["ck"]
        else:
            runner.train_multiseed(m, wd, device="cpu")
            dirs = [f"ck_{i}" for i in range(1, seeds + 1)]
        out[on] = {d: (_files(wd, d), torch.load(
            os.path.join(wd, "saved", d, "model_final", checkpoint.FILE),
            weights_only=True)) for d in dirs}
        assert all(bool(glob.glob(os.path.join(wd, "log", d, "events.*")))
                   == bool(on) for d in dirs)
    for d in out[1]:
        (f1, s1), (f0, s0) = out[1][d], out[0][d]
        assert f1 == f0, d
        flat1 = jax.tree_util.tree_leaves(s1)
        flat0 = jax.tree_util.tree_leaves(s0)
        assert len(flat1) == len(flat0)
        for a, b in zip(flat1, flat0):
            if isinstance(a, torch.Tensor):
                assert torch.equal(a, b)
            else:
                assert a == b
