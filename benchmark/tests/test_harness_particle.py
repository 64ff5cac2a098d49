"""The harness on an on-policy particle configuration, at a tiny size on
the CPU: CM3 stage 2 on four-agent cooperative navigation
(``particle_cm3_s2.json`` beside this file, the paper's antipodal
scenario, which ``BENCHMARK.json`` does not hold), 2 seeds x 2
instances, bursts of 3 updates every 2 episodes.  The frozen engine and
hooks against the port's, bit for bit; the frozen one-seed update
against the port's; ``train_sweep`` on-policy (correct over the first
burst and into the second, its spans, its chunk count, the planted
faults caught); the reference's on-policy schedule against the
program's; what the reference leaves out refused (the update's FLOPs:
``test_harness_counts.py``)."""

import dataclasses
import json
import os
import time
import types

import pytest
import torch

from benchmark import control, harness
from benchmark.reference import train as rt
from benchmark.reference import weights as wts
from benchmark.reference.port.experiments import flat_call
from benchmark.reference.port.tree import tree_map
from benchmark.run import merged_config

CONFIG_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "particle_cm3_s2.json")
TINY = {"seeds": 2, "checked_updates": 3, "traced_chunks": 7,
        "master": {"n_envs": 2, "pretrain_episodes": 4, "period": 4,
                   "batch_size": 16, "N_eval": 2, "epochs": 3,
                   "episodes_per_train": 2}}
LIMITS = {"loss_gap": 2e-06, "later_loss_gap_q90": 0.0003,
          "grad_gap_q90": 0.0003, "change_gap_q90": 0.002}


def particle_config(**master):
    """The tiny configuration, ``master`` over its master."""
    conf = json.load(open(CONFIG_FILE))
    workload = dict(TINY, master=dict(TINY["master"], **master))
    return merged_config(conf, workload), workload


def _ctx(seed, trace=False, checked=3, **master):
    config, workload = particle_config(**master)
    workload = dict(workload, config="particle_cm3_s2",
                    driver="train_sweep", limits=LIMITS,
                    checked_updates=checked)
    return types.SimpleNamespace(
        workload=workload, config=config, seed=seed, seconds=0.3,
        trace=trace, device="cpu", t_process=time.perf_counter(),
        out_dir=None)


def _limits_hold(compared):
    return all(v <= lim for _, v, lim in compared)


def _leaves(x, prefix=""):
    """{path: tensor} of a dataclass, dict or tensor."""
    if dataclasses.is_dataclass(x):
        x = {f.name: getattr(x, f.name) for f in dataclasses.fields(x)}
    if isinstance(x, dict):
        out = {}
        for k, v in x.items():
            out.update(_leaves(v, f"{prefix}{k}."))
        return out
    return {prefix: x}


def _assert_same(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert la.keys() == lb.keys()
    for k in la:
        assert la[k].dtype == lb[k].dtype and torch.equal(la[k], lb[k]), k


def test_frozen_engine_and_hooks_equal_the_ports():
    """200 lockstep steps of 2 x 3 instances, random actions and the
    auto-reset's fresh episodes, the same draws on both sides."""
    from cm3_tpu_torch.train import runner
    from cm3_tpu_torch.train.experiments import make_hooks

    config, _ = particle_config()
    master = config["master"]
    env_p = runner.build_env(master, "particle", master["stage"], "cpu")
    env_r = rt.build_env(config, "cpu")
    assert dataclasses.asdict(env_p.cfg) == dataclasses.asdict(env_r.cfg)
    hooks_p = make_hooks("particle", env_p)
    hooks_r = rt.build(config, "cpu")[2]
    lead, n = (2, 3), master["max_steps"]
    d_p, d_r = rt.draw_source(2 ** 31 + 7, "cpu"), rt.draw_source(
        2 ** 31 + 7, "cpu")
    s_p, t_p, g_p = hooks_p.episode_init(lead, d_p)
    s_r, t_r, g_r = hooks_r.episode_init(lead, d_r)
    _assert_same(s_p, s_r)
    _assert_same(t_p, t_r)
    assert torch.equal(g_p, g_r)
    ended = 0
    for _ in range(200):
        a_p = d_p.randint(lead + (4,), 5)
        a_r = d_r.randint(lead + (4,), 5)
        s_p, t_p = flat_call(env_p.step, lead, s_p, a_p)
        s_r, t_r = flat_call(env_r.step, lead, s_r, a_r)
        _assert_same(s_p, s_r)
        _assert_same(t_p, t_r)
        assert torch.equal(hooks_p.is_bad_episode(s_p, t_p.reward_local),
                           hooks_r.is_bad_episode(s_r, t_r.reward_local))
        done = t_r.done
        ended += int(done.sum())
        new_p, new_r = (hooks_p.episode_init(lead, d_p),
                        hooks_r.episode_init(lead, d_r))
        _assert_same(new_p[0], new_r[0])
        _assert_same(new_p[1], new_r[1])
        assert torch.equal(new_p[2], new_r[2])
        sel = lambda a, b: torch.where(
            done.view(done.shape + (1,) * (a.dim() - 2)), a, b)
        s_p = tree_map(sel, new_p[0], s_p)
        s_r = tree_map(sel, new_r[0], s_r)
    assert ended >= 200 * 6 // n


def test_frozen_update_equals_the_ports():
    """One seed's CM3 update on a particle minibatch, twice from the
    same weights, batch, epsilon and noise: the losses and every
    network's and target's parameters after each."""
    from cm3_tpu_torch.core import prng
    from cm3_tpu_torch.train import runner

    config, _ = particle_config()
    _, alg_p, _, cfg = runner.build(dict(config["master"]), device="cpu")
    alg_r = rt.build(config, "cpu")[1]
    weights = wts.make_weights(alg_r, 1, 2 ** 31 + 9, "cpu")
    ts_p = alg_p.init_state(prng.root_key(1))
    ts_r = rt.seed_states(alg_r, weights)[0]
    for name, w in weights.items():
        for key in (name, name + "_tgt"):
            getattr(ts_p, key).flat.copy_(w[0])
    sweep = rt.Sweep(config, 1, rt.draw_source(5, "cpu"), "cpu")
    for _ in range(40):
        sweep.step()
    for _ in range(2):
        batch = tree_map(lambda x: x[0], sweep.sample())
        gumbel = alg_r.update_draws(sweep.draws, (cfg.batch_size,))
        eps = torch.tensor(0.3)
        _, m_p = alg_p.update(ts_p, batch, eps, gumbel)
        _, m_r = alg_r.update(ts_r, batch, eps, gumbel)
        assert m_p.keys() == m_r.keys()
        for k in m_r:
            assert torch.equal(m_p[k], m_r[k]), k
        for name in alg_r.net_names():
            for key in (name, name + "_tgt"):
                assert torch.equal(getattr(ts_p, key).flat,
                                   getattr(ts_r, key).flat), key


@pytest.mark.parametrize("dual", [0, 1])
def test_train_sweep_runs_particle_onpolicy(tmp_path, dual):
    """Four checked updates: the first burst's three and the second's
    first, after the discard, the decay and the next rollout chunks.
    The traced stretch is whole cycles: it opens with a rollout chunk
    and closes with the first burst after ``traced_chunks`` chunks."""
    ctx = _ctx(2 ** 31 + 3, trace=True, checked=4, dual_buffer=dual)
    ctx.out_dir = str(tmp_path)
    run = harness.load_module("drivers", "train_sweep").Run(ctx).run()
    assert run.onpolicy
    assert run.metrics["train_env_steps_per_s"] > 0
    assert run.metrics["setup_s"] > 0 and run.attempted > 0
    assert _limits_hold(run.check())
    spans = run.trace.spans
    assert set(spans) == {"chunk", "env_step", "update"}
    chunks, n = len(spans["chunk"]), ctx.workload["traced_chunks"]
    steps = ctx.config["master"]["steps_per_train"]
    assert len(spans["env_step"]) == chunks * steps
    traced = run.trace.counters["traced_updates"]
    epochs = ctx.config["master"]["epochs"]
    assert traced == len(spans["update"])
    assert traced >= 2 * epochs and traced % epochs == 0
    burst_ends = [iv[1] for iv in spans["update"][epochs - 1::epochs]]
    assert spans["chunk"][0][0] < spans["update"][0][0]
    assert spans["chunk"][-1][1] < burst_ends[-1]
    assert chunks >= n > sum(1 for c in spans["chunk"]
                             if c[0] < burst_ends[-2])
    assert harness.load_module("metrics", "eval_share").read(run.trace) > 0
    assert harness.load_module("metrics", "train_mfu").read(run.trace) > 0


@pytest.mark.parametrize("fault", ["half_batch", "frozen"])
def test_train_sweep_particle_faults_fail(fault):
    driver = harness.load_module("drivers", "train_sweep")
    bad = driver.Run(_ctx(11)).checked_only(
        update={"half_batch": control.half_batch,
                "frozen": control.frozen}[fault])
    assert bad.onpolicy
    assert not _limits_hold(bad.check())


def test_onpolicy_schedule_is_the_programs():
    """The reference's first two bursts: the first follows the first
    policy chunk after the fill on a ring that still holds the fill's
    rows, the second comes after the discard on the rows since; each
    burst's epsilon is the one the program's updates take."""
    seed = 2 ** 31 + 13
    seen = []

    def record(update):
        def recorded(ts, batch, epsilon, *args, **kwargs):
            seen.append(epsilon.clone())
            return update(ts, batch, epsilon, *args, **kwargs)
        return recorded

    ctx = _ctx(seed, checked=4)
    run = harness.load_module("drivers", "train_sweep").Run(ctx)
    run.checked_only(update=record)
    sweep = rt.Sweep(ctx.config, 2, rt.draw_source(seed, "cpu"), "cpu")
    cfg = sweep.cfg
    fill_steps = 0
    while int(sweep.episodes.min()) < cfg.pretrain_episodes:
        for _ in range(cfg.steps_per_train):
            sweep.step()
            fill_steps += 1
    states = rt.seed_states(sweep.alg, run.weights)
    bursts = rt._onpolicy_bursts(sweep, states)
    eps1, n_upd = next(bursts)
    assert n_upd == cfg.epochs == 3
    assert torch.equal(eps1, torch.full((2,), cfg.epsilon_start))
    assert sweep.buf.size == (fill_steps + cfg.steps_per_train) * cfg.n_envs
    steps = []
    step = sweep.step
    sweep.step = lambda *a: steps.append(step(*a))
    eps2, _ = next(bursts)
    assert sweep.buf.size == len(steps) * cfg.n_envs > 0
    assert float(eps2[0]) == pytest.approx(
        cfg.epsilon_start - cfg.epsilon_step)
    assert len(seen) == 4
    for got, want in zip(seen, [eps1] * 3 + [eps2]):
        assert torch.equal(got, want)


@pytest.mark.parametrize("master", [{"use_V": 1}, {"stage": 1},
                                    {"alg_name": "coma"}],
                         ids=["V_critic", "stage_1", "coma"])
def test_reference_refuses_what_it_leaves_out(master):
    config, _ = particle_config(**master)
    with pytest.raises(ValueError, match="leaves out|CM3 only"):
        rt.build(config, "cpu")
