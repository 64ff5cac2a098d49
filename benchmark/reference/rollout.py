"""The rollout cells' plain reference: the fused random-policy rollouts'
answers (each instance's reward sum and episode count) for a sample of
instances, recomputed from the call's seed with the frozen copy of the
port's plain engines (``port/checkers_packed.py``, ``port/roadway_soa.py``)
and of Philox (``port/philox.py``).

Philox draws instance b's actions at step t from the counter (t, b), so
any subset of a call's instances is recomputed on its own.  The reward
sums are float32 as the configuration states them; ``acc_dtype``
accumulates them in another type (the comparison's control runs
bfloat16).

The roadway rollout also counts, over the sample, the work its data
decide (``counts/rollout_ops.py``): live cars L, pairs of live cars P,
TTC candidates D, rejected draws F and goal rewards G."""

from __future__ import annotations

import dataclasses

import torch

from benchmark.reference.port import checkers_packed as cp
from benchmark.reference.port import config as cfgmod
from benchmark.reference.port import roadway_soa as rs
from benchmark.reference.port.philox import philox4x32_10

BLOCK = 512     # steps whose draws are made at once


def _actions(seed, t0, t1, idx, n):
    """[t1 - t0] lists of the n agents' actions of instances ``idx``."""
    t = torch.arange(t0, t1, dtype=torch.int64)[:, None]
    words = philox4x32_10((t, idx[None, :], 0, 0), (seed, 0))
    acts = [(words[i] >> 7) % 5 for i in range(n)]
    return [tuple(a[k] for a in acts) for k in range(t1 - t0)]


def checkers_spec(config, workload):
    """The packed game of a Checkers configuration (goals: agent 0 green,
    agent 1 orange, as stage 2's identity goals)."""
    init, master = config["stage_file"]["init"], config["master"]
    env = cfgmod.CheckersEnvConfig(
        n_rows=init["n_rows"], n_columns=init["n_columns"],
        n_obs=init["n_obs"], agents_r=tuple(init["agents_r"]),
        agents_c=tuple(init["agents_c"]),
        n_agents=config["stage_file"]["n_agents"],
        max_steps=workload.get("max_steps", master["max_steps"]))
    return cp.make_spec(env, tuple(i % 2 == 0 for i in range(env.n_agents)))


def roadway_config(config, workload):
    """The roadway game of a roadway configuration, with the cell's
    overrides (``depart_stdev``: the fused kernel's reset is the
    deterministic one)."""
    sf = config["stage_file"]
    cfg = cfgmod.RoadwayEnvConfig(
        n_agents=sf["n_agents"], goal_lane=tuple(sf["goal_lane"]),
        goal_pos=tuple(sf["goal_pos"]), speed=tuple(sf["speed"]),
        lane=tuple(sf["lane"]), init_position=tuple(sf["init_position"]),
        depart_mean=tuple(sf["depart_mean"]),
        depart_stdev=sf["depart_stdev"], total_length=sf["total_length"],
        total_width=sf["total_width"], save_threshold=sf["save_threshold"],
        prob_random=config["master"]["prob_random"])
    over = {k: workload[k] for k in ("depart_stdev",) if k in workload}
    return dataclasses.replace(cfg, **over)


def checkers(spec, n_steps, seed, idx, acc_dtype=torch.float32):
    """(reward sums, episode counts) of instances ``idx`` (int64 [K])."""
    n = len(spec.init_pos)
    s = cp.packed_init(spec, tuple(idx.shape), device="cpu")
    rew = torch.zeros(idx.shape, dtype=acc_dtype)
    ep = torch.zeros(idx.shape, dtype=torch.int32)
    for t0 in range(0, n_steps, BLOCK):
        t1 = min(n_steps, t0 + BLOCK)
        for acts in _actions(seed, t0, t1, idx, n):
            s, rws, done = cp.packed_step(spec, s, acts)
            total = rws[0]
            for r in rws[1:]:
                total = total + r
            rew = rew + total.to(acc_dtype)
            ep = ep + done.int()
    return rew.float(), ep


WORK = ("live_car", "live_pair", "ttc_candidate", "rejected_draw",
        "goal_reward")


def roadway(cfg, n_steps, seed, idx, acc_dtype=torch.float32):
    """(reward sums, episode counts, {work: count over the sample}) of
    instances ``idx``."""
    n = cfg.n_agents
    s0 = rs.soa_init(cfg, tuple(idx.shape), device="cpu")
    s = s0
    rew = torch.zeros(idx.shape, dtype=acc_dtype)
    ep = torch.zeros(idx.shape, dtype=torch.int32)
    work = dict.fromkeys(WORK, 0)
    for t0 in range(0, n_steps, BLOCK):
        t1 = min(n_steps, t0 + BLOCK)
        for drawn in _actions(seed, t0, t1, idx, n):
            acts = rs.soa_check_actions(cfg, s, drawn)
            s2, rws, done = rs.soa_step(cfg, s, acts)
            _count(work, cfg, s, drawn, acts, s2)
            total = rws[0]
            for r in rws[1:]:
                total = total + r
            rew = rew + total.to(acc_dtype)
            s = rs.select(done, s0, s2)
            ep = ep + done.int()
    return rew.float(), ep, work


def _count(work, cfg, s, drawn, taken, s2):
    """The data-dependent work of one step (the kernel notes of
    ``ops/roadway_rollout.py``): a car is live while not removed; a TTC
    candidate is a live car with the other live, ahead, slower and in
    lateral reach; a goal reward is read by a live car at its goal that
    has not crashed."""
    n = cfg.n_agents
    live = [s.rem[i] == 0 for i in range(n)]
    for i in range(n):
        work["live_car"] += int(live[i].sum())
        work["rejected_draw"] += int((live[i] & (taken[i] != drawn[i])).sum())
        work["goal_reward"] += int((live[i] & (s2.x[i] >= cfg.goal_pos[i])
                                    & (s2.coll[i] == 0)).sum())
        for j in range(n):
            if j == i:
                continue
            lateral = (rs._y(cfg, s.sub[j]) - rs._y(cfg, s.sub[i])).abs()
            work["ttc_candidate"] += int(
                (live[i] & live[j] & (s.x[j] - s.x[i] > 0)
                 & (s.vel[j] < s.vel[i]) & (lateral < cfg.car_width)).sum())
            if j > i:
                work["live_pair"] += int((live[i] & live[j]).sum())
