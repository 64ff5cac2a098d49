"""The comparison's control on the card: the reference computed in the
nearest precision below the configuration's (TF32 for the training
cells, bfloat16 sums for the rollouts) must come out not correct.  At a
size a test run holds (4 seeds x 4 instances; 4,096 instances x 512
steps); the cell-size readings are in PERF.md."""

import pytest

from benchmark import control
from benchmark.run import merged_config


@pytest.mark.cuda
def test_tf32_control_fails(card):
    ctx = control.context("checkers_cm3_s2.sweep256", 2 ** 31 + 21, card)
    ctx.workload = dict(ctx.workload, seeds=4, master={"n_envs": 4})
    ctx.config = merged_config(ctx.config, ctx.workload)
    got = control.train_readings(ctx)
    limits = ctx.workload["limits"]
    assert all(got["program"][k] <= limits[k] for k in limits)
    assert any(got["control"][k] > limits[k] for k in limits)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["checkers_cm3_s2.rollout",
                                  "roadway_cm3_s2.rollout"])
def test_bfloat16_control_fails(card, cell):
    ctx = control.context(cell, 2 ** 31 + 22, card)
    ctx.workload = dict(ctx.workload, batch=4096, steps=512,
                        checked_instances=256)
    got = control.rollout_readings(ctx)
    assert got["program"]["answers_differing"] == 0
    assert got["control"]["answers_differing"] > 0
