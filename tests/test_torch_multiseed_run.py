"""Seeds in lockstep, the run: ``train_vmapped_seeds``' period rows
against the JAX package's on a tiny stage-1 run, ``convert.state_from_jax``
of a seed-stacked JAX state, and the ``train_env_steps_per_s`` bench's
control flow (its figure only on the card)."""

import jax
import numpy as np
import pytest
import torch

from cm3_tpu.core import config as jcfg
from cm3_tpu.train import multiseed as jmultiseed
from cm3_tpu.train.experiments import make_hooks as jax_hooks
from cm3_tpu.train.offpolicy import init_rollout as jax_init_rollout
from cm3_tpu_torch import bench, convert
from cm3_tpu_torch.core import config as tcfg
from cm3_tpu_torch.train import multiseed
from cm3_tpu_torch.train.experiments import make_hooks
from tests import torch_parity as tp

tp.set_torch_cpu()

S = 3
NETS = ("actor", "actor_tgt", "qg", "qg_tgt", "qc", "qc_tgt")


def test_state_from_jax_loads_seed_stacks():
    """A JAX state of S seeds (every leaf with a leading seed axis) lands
    row by row in the port's [S, n] buffers: seed s's row equals the
    one-seed conversion of JAX's seed s."""
    je, _ = tp.envs()
    ja, ta = tp.algs(je.spec(), n_seeds=S, fused_opt=False, grad_clip=1.0)
    _, ta1 = tp.algs(je.spec(), fused_opt=False, grad_clip=1.0)
    rs = jax_init_rollout(jax_hooks("checkers", je), jax.random.PRNGKey(0),
                          2)
    jts = jax.tree_util.tree_map(lambda *xs: np.stack(xs), *[
        jax.device_get(ja.init_state(k, rs.obs, rs.state, rs.goals))
        for k in jax.random.split(jax.random.PRNGKey(3), S)])
    st = convert.state_from_jax(ta, jts)
    for s in range(S):
        one = convert.state_from_jax(
            ta1, jax.tree_util.tree_map(lambda x: x[s], jts))
        for name in NETS:
            assert torch.equal(getattr(st, name).flat[s],
                               getattr(one, name).flat)
        assert not torch.equal(st.actor.flat[s], st.actor.flat[(s + 1) % S])


def test_train_vmapped_seeds_rows_match_jax():
    """A tiny stage-1 run of ``train_vmapped_seeds`` in both packages:
    the same period rows (keys, shapes, episode counts, epsilons); the
    port's returns are finite."""
    je, te = tp.envs(max_steps=5, n_agents=1)
    ja, ta = tp.algs(je.spec(), fused_opt=False)
    kw = dict(n_envs=4, buffer_size=64, batch_size=8, steps_per_train=5,
              updates_per_chunk=2, pretrain_episodes=4, period=8,
              N_train=16, N_eval=3, max_steps=5, episode_log=8)
    _, jh = jmultiseed.train_vmapped_seeds(
        jax_hooks("checkers", je), ja, jcfg.TrainConfig(**kw), 2, 7)
    ts, th = multiseed.train_vmapped_seeds(
        make_hooks("checkers", te), ta, tcfg.TrainConfig(**kw), 2, 7)
    assert ts.actor.flat.shape[0] == 2 and ts.qc is None
    assert len(th) == len(jh) == 2
    for j, t in zip(jh, th):
        assert set(t) == set(j)
        for k in j:
            if k in ("duration_s", "_episodes"):
                continue
            assert np.shape(t[k]) == np.shape(j[k]), k
            assert np.isfinite(t[k]).all(), k
        np.testing.assert_array_equal(t["episode"], j["episode"])
        np.testing.assert_allclose(t["epsilon"], j["epsilon"])
        assert len(t["_episodes"]) == len(j["_episodes"]) == 2
        for (ti, tr), (ji, jr) in zip(t["_episodes"], j["_episodes"]):
            np.testing.assert_array_equal(ti, ji)
            assert tr.shape == jr.shape




def test_train_vmapped_seeds_resume_matches_jax():
    """A resumed run (``resume`` = a seed-stacked state and per-seed
    episode counts 12 and 14) in both packages: the replay warms with
    policy rollouts until the slowest seed has ``pretrain_episodes``
    more, then trains; the same period rows (episode counts, epsilons)
    and the same number of updates (Adam counts and steps)."""
    je, te = tp.envs(max_steps=5, n_agents=1)
    ja, ta = tp.algs(je.spec(), fused_opt=False)
    kw = dict(n_envs=4, buffer_size=64, batch_size=8, steps_per_train=5,
              updates_per_chunk=2, pretrain_episodes=4, period=8,
              N_train=32, N_eval=3, max_steps=5, episode_log=8)
    rs = jax_init_rollout(jax_hooks("checkers", je), jax.random.PRNGKey(0),
                          2)
    jts = jax.tree_util.tree_map(lambda *xs: np.stack(xs), *[
        jax.device_get(ja.init_state(k, rs.obs, rs.state, rs.goals))
        for k in jax.random.split(jax.random.PRNGKey(3), 2)])
    initial = np.array([12, 14])
    jout, jh = jmultiseed.train_vmapped_seeds(
        jax_hooks("checkers", je), ja, jcfg.TrainConfig(**kw), 2, 7,
        resume=(jts, initial))
    ts2 = ta.for_seeds(2)
    tout, th = multiseed.train_vmapped_seeds(
        make_hooks("checkers", te), ts2, tcfg.TrainConfig(**kw), 2, 7,
        resume=(convert.state_from_jax(ts2, jts), initial))
    assert len(th) == len(jh) >= 2
    assert th[0]["episode"].min() // 8 > 12 // 8
    for j, t in zip(jh, th):
        np.testing.assert_array_equal(t["episode"], j["episode"])
        np.testing.assert_allclose(t["epsilon"], j["epsilon"])
    jcount = np.asarray(convert._adam(jout.opt_actor).count).reshape(-1)
    assert tout.opt_actor.count == tout.step == int(jcount[0]) > 0
    assert tout.step == int(np.asarray(jout.step).reshape(-1)[0])

SMALL = tcfg.NNConfig(Q_conv_f=2, Q_n_h1_1=8, Q_n_h1_2=4, Q_n_h2=8,
                      A_conv_f=2, A_n_h1=8, A_n_h2=8)


def test_train_bench_runs_small_on_cpu():
    """The headline program's blocks at a tiny size: (median, lo, hi) of
    the blocks' env-steps/s, and the one-seed program through
    ``train_blocks``."""
    med, lo, hi = bench.bench_train_multiseed(
        n_seeds=2, n_envs=4, reps=1, blocks=3, device="cpu", nn_cfg=SMALL)
    assert 0 < lo <= med <= hi
    one = list(bench.train_program(None, 4, True, "cpu", SMALL))
    assert len(bench.train_blocks(one, 1, 2, warmup=1)) == 2
    assert one[1].step == 3 * 8


def test_train_bench_cli_refuses_without_cuda(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench.main(["--one", "train_env_steps_per_s"]) == 1
    assert capsys.readouterr().out == ""


def _small_stage1():
    _, te = tp.envs(max_steps=5, n_agents=1)
    _, ta = tp.algs(te.spec(), fused_opt=False)
    return make_hooks("checkers", te), ta


@pytest.mark.parametrize("field,value,item", [
    ("replay_shards", 2, "A14a")])
def test_driver_runs_what_was_refused(field, value, item):
    """The JAX options the port once refused run, each ported by its
    ROADMAP item: a tiny run with shard-local replay at D = 2 (its
    parity with JAX's: ``test_torch_sharded_*.py``) and the K-chunk
    schedule at K = 4 (``test_torch_kchunk*.py``); ``summarize``:
    ``test_driver_runs_summarize``."""
    from cm3_tpu_torch.train.offpolicy import OffPolicyDriver
    hooks, ta = _small_stage1()
    small = dict(n_envs=2, max_steps=5, steps_per_train=5,
                 pretrain_episodes=2, period=8, N_eval=1, batch_size=8,
                 buffer_size=64, updates_per_chunk=1)
    driver = OffPolicyDriver(hooks, ta, tcfg.TrainConfig(
        **{field: value}, **small))
    ts, stats = driver.run(ta.init_state(0), n_episodes=8)
    assert stats["episodes"] == 8 and ts.step == 3
    assert tuple(stats["buffer"].size.shape) == (value,)
    driver = OffPolicyDriver(hooks, ta, tcfg.TrainConfig(
        chunks_per_sync=4, **small))
    ts, stats = driver.run(ta.init_state(0), n_episodes=8)
    assert stats["episodes"] == 8 and stats["dispatches"] == 1
    assert stats["history"][0]["trained_chunks"] == 3.0 and ts.step == 3


@pytest.mark.parametrize("onpolicy", [False, True],
                         ids=["offpolicy", "onpolicy"])
def test_train_vmapped_seeds_runs_a_seed_mesh(onpolicy):
    """A seed mesh (once refused, ROADMAP A14b): on one process its
    single rank trains every seed, and the rows and the state equal the
    run without a mesh (two ranks: ``test_torch_parallel.py``)."""
    from cm3_tpu_torch.parallel import mesh as meshlib
    hooks, ta = _small_stage1()
    cfg = tcfg.TrainConfig(n_envs=2, max_steps=5, steps_per_train=5,
                           pretrain_episodes=2, period=4, N_eval=1,
                           batch_size=8, buffer_size=64, updates_per_chunk=1,
                           N_train=8, episodes_per_train=2, epochs=2,
                           episode_log=4)
    runs = [multiseed.train_vmapped_seeds(hooks, ta, cfg, 2, 5,
                                          onpolicy=onpolicy, **kw)
            for kw in ({}, dict(mesh=meshlib.make_mesh(1, axis="seed")))]
    (ts0, h0), (ts1, h1) = runs
    assert len(h0) == len(h1) == 2
    for r0, r1 in zip(h0, h1):
        assert list(r0) == list(r1)
        for k in r0:
            if k != "duration_s":
                np.testing.assert_equal(r1[k], r0[k], err_msg=k)
    for name in ta.net_names():
        assert torch.equal(getattr(ts1, name).flat, getattr(ts0, name).flat)


def test_driver_runs_summarize():
    """``summarize`` (once refused, ROADMAP A15): a tiny K = 2 run (a
    row after the dispatch that began in the fill, without ``_grads``,
    and one after training, with them) and the same in lockstep; the
    rows after training carry every network's gradients (their parity
    with JAX's: ``test_torch_summaries*.py``)."""
    from cm3_tpu_torch.train.offpolicy import OffPolicyDriver
    hooks, ta = _small_stage1()
    kw = dict(summarize=True, n_envs=2, max_steps=5, steps_per_train=5,
              pretrain_episodes=2, period=4, N_eval=1, batch_size=8,
              buffer_size=64, updates_per_chunk=1, N_train=8)
    driver = OffPolicyDriver(hooks, ta, tcfg.TrainConfig(
        chunks_per_sync=2, **kw))
    ts, stats = driver.run(ta.init_state(0))
    rows = stats["history"]
    assert [sorted(r.get("_grads", {})) for r in rows] == [
        [], ["Policy", "Q_global"]]
    _, th = multiseed.train_vmapped_seeds(hooks, ta, tcfg.TrainConfig(**kw),
                                          2, 7)
    assert sorted(th[-1]["_grads"]) == ["Policy", "Q_global"]
    assert th[-1]["_grads"]["Policy"].shape == (2, ts.actor.flat.numel())
