"""The benchmark's counts against what they count: the FLOPs of one
update against ``FlopCounterMode`` over the port's own update on the
CPU at B = 128, and the rollout kernels' operation counts against the
kernel notes' formulas counted directly on small inputs."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import harness
from benchmark.counts import flops, rollout_ops
from benchmark.reference import rollout as rr


def _config(cell):
    from benchmark.run import merged_config

    _, _, workload, conf = harness.cell(cell)
    return merged_config(conf, workload)


@pytest.mark.parametrize("cell", ["checkers_cm3_s2.sweep256",
                                  "roadway_cm3_s2.sweep256"])
def test_update_flops_equal_flop_counter(cell):
    from cm3_tpu_torch.core import prng
    from cm3_tpu_torch.train import runner
    from cm3_tpu_torch.train.offpolicy import init_rollout

    config = _config(cell)
    master = dict(config["master"], n_envs=4)
    driver, alg, hooks, cfg = runner.build(master, device="cpu")
    draws = prng.GeneratorDraws(prng.generator(1, "cpu"))
    rs = init_rollout(hooks, 4, draws)
    buf, rs = driver.init_replay(rs)
    ts = alg.init_state(prng.root_key(1))
    for _ in range(4):
        _, buf, rs, _ = driver._chunk(ts, buf, rs, 0.5, draws, False, True)
    batch = driver._replay_sample(buf, draws)
    gumbel = alg.update_draws(draws, (cfg.batch_size,))
    with FlopCounterMode(display=False) as counter:
        alg.update(ts, batch, 0.1, gumbel)
    assert flops.update_flops(config, 128) == counter.get_total_flops()
    with FlopCounterMode(display=False) as counter:
        alg.act(ts, tree(rs.obs, 1), rs.goals[:1], rs.a_prev[:1], 0.1,
                alg.act_draws(draws, (1,)))
    assert flops.act_flops(config) == counter.get_total_flops()


def tree(obs, n):
    return {k: v[:n] for k, v in obs.items()}


def test_published_peaks():
    assert rollout_ops.ISSUE_PER_S == pytest.approx(3.345e13, rel=1e-3)
    assert 2 * rollout_ops.ISSUE_PER_S == pytest.approx(
        rollout_ops.FP32_FLOPS_PER_S, rel=0.002)


def test_checkers_bound_of_a_bench_call():
    # the kernel notes: a call of B = 2^20, T = 8192 is bound at 22.1 ms
    least, bound = rollout_ops.least_time(
        rollout_ops.checkers_ops(1 << 20, 8192), 0,
        rollout_ops.output_bytes(1 << 20))
    assert bound == "issue" and least == pytest.approx(22.08e-3, rel=1e-3)


def test_roadway_counts_equal_the_kernel_notes():
    """L, P, D, F, G of the reference's rollout equal a direct count of
    the kernel notes' definitions over the port's plain rollout with the
    same draws."""
    from cm3_tpu_torch.core import config as pcfg
    from cm3_tpu_torch.envs import roadway_soa as ps
    from cm3_tpu_torch.ops import roadway_rollout as prr

    config = _config("roadway_cm3_s2.rollout")
    _, _, workload, _ = harness.cell("roadway_cm3_s2.rollout")
    cfg = rr.roadway_config(config, workload)
    pc = pcfg.RoadwayEnvConfig(**{k: getattr(cfg, k)
                                  for k in cfg.__dataclass_fields__})
    b, t, seed = 64, 40, 12345
    count = dict.fromkeys(rr.WORK, 0)

    def observe(s, drawn, taken, s2):
        for i in range(2):
            j = 1 - i
            live_i, live_j = s.rem[i] == 0, s.rem[j] == 0
            count["live_car"] += int(live_i.sum())
            count["rejected_draw"] += int((live_i & (taken[i] != drawn[i]))
                                          .sum())
            count["goal_reward"] += int((live_i & (s2.x[i] >= pc.goal_pos[i])
                                         & (s2.coll[i] == 0)).sum())
            lateral = (ps._y(pc, s.sub[j]) - ps._y(pc, s.sub[i])).abs()
            count["ttc_candidate"] += int(
                (live_i & live_j & (s.x[j] > s.x[i]) & (s.vel[j] < s.vel[i])
                 & (lateral < pc.car_width)).sum())
        count["live_pair"] += int(((s.rem[0] == 0) & (s.rem[1] == 0)).sum())

    rew_p, ep_p = prr.rollout_prng_plain(pc, b, t, seed, device="cpu",
                                         observe=observe)
    rew_r, ep_r, work = rr.roadway(cfg, t, seed, torch.arange(b))
    assert torch.equal(rew_p, rew_r) and torch.equal(ep_p, ep_r)
    assert work == count
    ops = rollout_ops.roadway_ops(b, t, *(work[k] for k in rr.WORK),
                                  int(ep_r.sum()))
    assert ops == (50 * b * t + 62 * count["live_car"]
                   + 42 * count["live_pair"] + 13 * count["ttc_candidate"]
                   + 3 * count["rejected_draw"] + 15 * count["goal_reward"]
                   + 10 * int(ep_p.sum()))


def test_checkers_reference_equals_the_ports_plain_version():
    from cm3_tpu_torch.envs import checkers_packed as pcp
    from cm3_tpu_torch.ops import checkers_rollout as pcr

    config = _config("checkers_cm3_s2.rollout")
    _, _, workload, _ = harness.cell("checkers_cm3_s2.rollout")
    spec = rr.checkers_spec(config, workload)
    pspec = pcp.PackedSpec(*spec)
    rew_p, ep_p = pcr.rollout_prng_plain(pspec, 128, 70, 99, device="cpu")
    idx = torch.tensor([0, 5, 77, 127])
    rew_r, ep_r = rr.checkers(spec, 70, 99, idx)
    assert torch.equal(rew_p[idx], rew_r) and torch.equal(ep_p[idx], ep_r)
