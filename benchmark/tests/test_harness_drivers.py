"""Each window driver at a tiny size on the CPU, through its own
functions: the run, its metrics, its comparison with the reference
(correct), and the planted faults that the comparison must catch: an
update that leaves the state unchanged, half the minibatch left out, a
rollout's answers altered."""

import time
import types

import pytest
import torch

from benchmark import control, harness
from benchmark.run import merged_config

TINY_MASTER = {"n_envs": 2, "pretrain_episodes": 4, "period": 4,
               "batch_size": 16, "N_eval": 2}


def _ctx(cell, seed, trace=False, **over):
    bench, entry, workload, conf = harness.cell(cell)
    workload = dict(workload, **over)
    return types.SimpleNamespace(
        workload=workload, config=merged_config(conf, workload), seed=seed,
        seconds=0.3, trace=trace, device="cpu",
        t_process=time.perf_counter(), out_dir=None)


def _limits_hold(compared):
    return all(v <= lim for _, v, lim in compared)


@pytest.fixture
def out_dir(tmp_path):
    return str(tmp_path)


@pytest.mark.parametrize("cell", ["checkers_cm3_s2.sweep256",
                                  "roadway_cm3_s2.sweep256"])
def test_train_sweep_runs_and_is_correct(cell, out_dir):
    ctx = _ctx(cell, 2 ** 31 + 3, trace=True, seeds=2, master=TINY_MASTER)
    ctx.out_dir = out_dir
    run = harness.load_module("drivers", "train_sweep").Run(ctx).run()
    assert run.metrics["train_env_steps_per_s"] > 0
    assert run.metrics["setup_s"] > 0 and run.attempted > 0
    assert _limits_hold(run.check())
    assert run.trace.window_s > 0
    assert set(run.trace.spans) == {"chunk", "env_step", "update"}
    assert len(run.trace.spans["chunk"]) == ctx.workload["traced_chunks"]
    assert len(run.trace.spans["update"]) == run.trace.counters[
        "traced_updates"]
    # no device operations on the CPU: the device readers find nothing
    for name in ("launches_per_chunk", "update_device_ms",
                 "device_idle.train"):
        assert harness.load_module("metrics", name).read(run.trace) is None
    assert harness.load_module("metrics", "eval_share").read(run.trace) > 0
    assert harness.load_module("metrics", "train_mfu").read(run.trace) > 0


@pytest.mark.parametrize("fault", ["half_batch", "frozen"])
def test_train_sweep_faults_fail(fault):
    ctx = _ctx("checkers_cm3_s2.sweep256", 11, seeds=2, master=TINY_MASTER)
    driver = harness.load_module("drivers", "train_sweep")
    bad = driver.Run(ctx).checked_only(
        update={"half_batch": control.half_batch,
                "frozen": control.frozen}[fault])
    assert not _limits_hold(bad.check())


@pytest.mark.parametrize("cell", ["checkers_cm3_s2.rollout",
                                  "roadway_cm3_s2.rollout"])
def test_rollout_runs_and_is_correct(cell, out_dir):
    ctx = _ctx(cell, 2 ** 31 + 5, trace=True, batch=256, steps=8,
               checked_instances=32, traced_calls=2)
    ctx.out_dir = out_dir
    run = harness.load_module("drivers", "rollout").Run(ctx).run()
    assert run.metrics["rollout_env_steps_per_s"] > 0
    compared = run.check()
    assert _limits_hold(compared)
    assert run.trace.counts["ops_per_call"] > 0
    assert harness.load_module("metrics", "rollout_mfu").read(run.trace) > 0


def test_rollout_altered_answer_fails():
    ctx = _ctx("checkers_cm3_s2.rollout", 9, batch=256, steps=8,
               checked_instances=32)
    run = harness.load_module("drivers", "rollout").Run(ctx).run()
    run.kept = [(torch.nextafter(r, r + 1), e) for r, e in run.kept]
    assert not _limits_hold(run.check())
