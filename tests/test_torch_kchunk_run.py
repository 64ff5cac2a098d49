"""The K-chunk schedule through ``OffPolicyDriver.run`` and through the
runners, against the JAX package's, with JAX's draws fed in.

One env instance whose episodes last exactly one chunk (5 steps), so the
host loop's decisions are known in advance: ``run`` with K = 2 from the
start (the first dispatch fills, the second straddles the fill -> train
boundary, the host's epsilon stays put after a dispatch that began in
the fill phase) and resumed past the fill (host-paced warm-up chunks,
then dispatches); then the paper's single-env cells ``checkers_s2_e1``
(CM3, stage 2 from a stage-1 start) and ``checkers_qmix_e1`` (QMIX from
nothing) at K = 32 through both runners: the same ``log_century.csv``
byte for byte, and ``metrics.jsonl`` rows with the same keys in the same
order, the same integers and the floats at rtol 1e-5 / atol 1e-6 (the
port's floats differ from XLA's in their last bits, which the JSON
stream prints in full)."""

import json
import os
import types

import jax
import numpy as np
import pytest

from cm3_tpu.core import config as jcfg
from cm3_tpu.train import offpolicy as joffpolicy
from cm3_tpu.train import runner as jrunner
from cm3_tpu.train.experiments import make_hooks as jax_hooks
from cm3_tpu.train.offpolicy import OffPolicyDriver as JaxDriver
from cm3_tpu_torch import convert
from cm3_tpu_torch.core import config as tcfg
from cm3_tpu_torch.core import prng
from cm3_tpu_torch.train import offpolicy, runner
from cm3_tpu_torch.train.experiments import make_hooks
from cm3_tpu_torch.train.offpolicy import OffPolicyDriver
from tests import torch_parity as tp

tp.set_torch_cpu()

E, SPT, CAP, B = 1, 5, 64, 8


def run_draws(key, *, k_chunks, updates, pretrain, period, n_episodes,
              n_eval, initial=0, qmix=False):
    """The draws of JAX's ``run`` from ``key`` with ``chunks_per_sync`` =
    ``k_chunks``, one episode a chunk, in the order the port asks for
    them: per host iteration a dispatch's draws (``tp.kchunk_draws``), or
    a warm-up chunk's policy draws after a resume; per period row the
    evaluation's.  Returns (rollout FedDraws, eval FedDraws)."""
    k_init, k_loop, k_eval = jax.random.split(key, 3)
    lists, evals = ([], [], []), ([], [], [])
    ep, size, idx, last = initial, 0, 0, initial // period
    while ep < n_episodes:
        k = jax.random.fold_in(k_loop, idx)
        if pretrain <= ep < initial + pretrain:          # warm-up chunk
            d = tp.chunk_draws(k, E, 2, 5, SPT, False, qmix=qmix)
            size, ep = min(size + SPT * E, CAP), ep + 1
        else:
            d, size = tp.kchunk_draws(k, k_chunks, E, 2, 5, SPT, updates, B,
                                      size, CAP, qmix=qmix)
            ep += k_chunks
        for a, b in zip(lists, d):
            a += b
        idx += 1
        if ep // period > last:
            last = ep // period
            ks = jax.random.split(jax.random.fold_in(k_eval, last), SPT)
            if qmix:
                for kk in ks:
                    r, u = tp.qmix_act_draws(kk, (n_eval, 2), 5)
                    evals[0].append(r)
                    evals[2].append(u)
            else:
                evals[1].extend(np.asarray(jax.random.gumbel(
                    kk, (n_eval, 2, 5))) for kk in ks)
    fed = lambda x: prng.FedDraws(x[0], x[1], device="cpu",
                                  uniforms=x[2] if qmix else None)
    return fed(lists), fed(evals)


RUN = dict(n_envs=E, steps_per_train=SPT, updates_per_chunk=2, batch_size=B,
           buffer_size=CAP, pretrain_episodes=3, period=4, N_train=8,
           N_eval=2, max_steps=SPT, chunks_per_sync=2, epsilon_start=0.4,
           epsilon_end=0.05, epsilon_div=2.0)


@pytest.fixture(scope="module", params=["fresh", "resumed"])
def runs(request):
    initial = 4 if request.param == "resumed" else 0
    n_episodes = 12 if initial else 8
    je, te = tp.envs(max_steps=SPT)
    ja, ta = tp.algs(je.spec(), fused_opt=False)
    jd = JaxDriver(jax_hooks("checkers", je), ja, jcfg.TrainConfig(**RUN))
    td = OffPolicyDriver(make_hooks("checkers", te), ta,
                         tcfg.TrainConfig(**RUN))
    batch = tp.replay_batch(je, 2, np.random.default_rng(0))
    jts = ja.init_state(jax.random.PRNGKey(3), batch["obs"], batch["state"],
                        batch["goals"])
    tts = convert.state_from_jax(ta, jax.device_get(jts))
    key = jax.random.PRNGKey(21)
    jts, jout = jd.run(jts, key, n_episodes=n_episodes,
                       initial_episodes=initial)
    draws, eval_draws = run_draws(
        key, k_chunks=2, updates=2, pretrain=3, period=4,
        n_episodes=n_episodes, n_eval=2, initial=initial)
    tts, tout = td.run(tts, draws=draws, eval_draws=eval_draws,
                       n_episodes=n_episodes, initial_episodes=initial)
    assert not any(draws.remaining().values())
    assert not any(eval_draws.remaining().values())
    return (request.param, convert.state_from_jax(ta, jax.device_get(jts)),
            jout, tts, tout)


def test_run_rows_match_jax(runs):
    """Every period row: the same keys in the same order (``trained`` and
    ``trained_chunks`` among the metrics), the episode counts and the
    host's epsilon exactly, the rest at rtol 1e-5 / atol 1e-6; the final
    state likewise.  Fresh: rows at 4 and 8 episodes, the first after the
    straddling dispatch with epsilon still at its start (that dispatch
    began in the fill phase) and one trained chunk; resumed from 4: three
    warm-up chunks, then rows at 9 and 13."""
    name, want, jout, got, tout = runs
    jh, th = jout["history"], tout["history"]
    episodes = [4, 8] if name == "fresh" else [9, 13]
    assert [r["episode"] for r in th] == [r["episode"] for r in jh] \
        == episodes
    assert tout["episodes"] == jout["episodes"]
    assert tout["epsilon"] == jout["epsilon"]
    for j, t in zip(jh, th):
        assert list(t) == list(j)
        assert t["epsilon"] == j["epsilon"]
        for k in j:
            if k in ("episode", "epsilon", "duration_s"):
                continue
            if k == "_episodes":        # the episode-log ring's flush
                np.testing.assert_array_equal(t[k][0], j[k][0])
                np.testing.assert_allclose(t[k][1], j[k][1], rtol=1e-5,
                                           atol=1e-6, err_msg=k)
                continue
            np.testing.assert_allclose(np.asarray(t[k]), np.asarray(j[k]),
                                       rtol=1e-5, atol=1e-6, err_msg=k)
    if name == "fresh":
        assert th[0]["epsilon"] == 0.4 and th[0]["trained_chunks"] == 1.0
        assert th[1]["trained_chunks"] == 2.0 and th[1]["epsilon"] < 0.4
        assert tout["dispatches"] == 4
    else:
        assert tout["dispatches"] == 3 + 3
    tp.hold_states(got, want, ("actor", "qg", "qc"))


# --------------------------------------------------------------------- #
# the paper's single-env cells through both runners
# --------------------------------------------------------------------- #

# reproduce_paper.py:542-552 at tiny scale: n_envs 1, K = 32, N_eval 10
# (here 2), period cut from 100 to 32, episodes of 5 steps, 64 episodes
CELLS = {
    "checkers_s2_e1": dict(experiment="checkers", stage=2, n_envs=1,
                           dir_name="ck_s2e1", dir_restore="ck_s1",
                           train_from_nothing=0, chunks_per_sync=32),
    "checkers_qmix_e1": dict(experiment="checkers", stage=2, n_envs=1,
                             alg_name="qmix", dir_name="ck_qme1",
                             train_from_nothing=1, chunks_per_sync=32),
}
TINY = dict(N_train=64, period=32, N_eval=2, pretrain_episodes=40,
            batch_size=B, buffer_size=CAP, steps_per_train=SPT,
            max_steps=SPT, seed=5)
S1 = dict(experiment="checkers", stage=1, n_envs=1, dir_name="ck_s1",
          N_train=4, period=4, N_eval=1, pretrain_episodes=2,
          batch_size=B, buffer_size=CAP, steps_per_train=SPT, max_steps=SPT,
          seed=5)


def _master(cell):
    m = tcfg.load_json("master.json")
    m.update(cell)
    return m


def _files(wd, d):
    with open(os.path.join(wd, "log", d, "log_century.csv"), "rb") as f:
        century = f.read()
    with open(os.path.join(wd, "log", d, "metrics.jsonl")) as f:
        lines = [json.loads(x) for x in f]
    return century, lines


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_cells_through_both_runners(cell, tmp_path, monkeypatch):
    """JAX's runner trains the cell (``checkers_s2_e1`` from its own
    stage-1 checkpoint) and its driver's start is recorded; the port's
    runner trains the same cell from that start (converted) with JAX's
    draws fed in, both clocks stopped: the same CSV bytes and the same
    JSONL rows, two rows of 32 episodes (one dispatch each), the second
    straddling the fill -> train boundary at 40 episodes."""
    qmix = cell == "checkers_qmix_e1"
    nn = tp.SMALL_BASE_NN if qmix else tp.SMALL_NN
    monkeypatch.setattr(runner, "_nn_config",
                        lambda m, e, s: tcfg.NNConfig(**nn))
    monkeypatch.setattr(jrunner, "_nn_config",
                        lambda m, e, s: jcfg.NNConfig(**nn))
    clock = types.SimpleNamespace(time=lambda: 0.0)
    monkeypatch.setattr(joffpolicy, "time", clock)
    monkeypatch.setattr(offpolicy, "time", clock)
    master = _master(dict(CELLS[cell], **TINY))
    jwd, twd = str(tmp_path / "jax"), str(tmp_path / "port")
    if not qmix:
        jrunner.train_function(_master(S1), jwd, verbose=False)

    start = {}
    jax_run = JaxDriver.run

    def record(self, ts_alg, key, **kw):
        start.update(ts=jax.device_get(ts_alg), key=key)
        return jax_run(self, ts_alg, key, **kw)

    monkeypatch.setattr(JaxDriver, "run", record)
    jrunner.train_function(master, jwd, verbose=False)

    def from_jax(master, workdir, device):
        driver, alg, hooks, cfg = runner.build(master, device=device)
        return driver, alg, hooks, cfg, convert.state_from_jax(alg,
                                                               start["ts"])

    port_run = OffPolicyDriver.run
    fed = {}

    def fed_run(self, ts_alg, key, **kw):
        fed["draws"], fed["evals"] = run_draws(
            start["key"], k_chunks=32, updates=1, pretrain=40, period=32,
            n_episodes=64, n_eval=2, qmix=qmix)
        return port_run(self, ts_alg, key, draws=fed["draws"],
                        eval_draws=fed["evals"], **kw)

    monkeypatch.setattr(runner, "initial_state", from_jax)
    monkeypatch.setattr(OffPolicyDriver, "run", fed_run)
    _, stats = runner.train_function(master, twd, verbose=False,
                                     device="cpu")
    assert not any(fed["draws"].remaining().values())
    assert stats["dispatches"] == 2
    want, got = _files(jwd, master["dir_name"]), _files(twd,
                                                        master["dir_name"])
    assert got[0] == want[0]
    assert [x["episode"] for x in got[1]] == [32, 64]
    for t, j in zip(got[1], want[1]):
        assert list(t) == list(j)
        for k in j:
            if isinstance(j[k], (int, str)):
                assert t[k] == j[k], k
            else:
                np.testing.assert_allclose(t[k], j[k], rtol=1e-5, atol=1e-6,
                                           err_msg=k)
    assert got[1][0]["trained_chunks"] == 0.0
    assert got[1][1]["trained_chunks"] == 24.0
