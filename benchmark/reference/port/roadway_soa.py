"""Struct-of-arrays roadway dynamics: per-car tensors of any shape.

Port of ``cm3_tpu.envs.roadway_soa``.  The dynamics state of the
roadway game is eight scalars per car: position x, absolute sublane,
velocity, step count and the flags terminal, collided and removed
(int32 0/1, as in the JAX module).  Every interaction is a pairwise
compare over a fixed car count, so cars are unrolled into tuples of
same-shaped tensors and one step is a few hundred elementwise
operations on [B] tensors.  The fused roadway rollout
(``ops/roadway_rollout.py``) runs the same ``soa_check_actions`` and
``soa_step`` per instance in registers; this module is its plain
version's engine.

Semantics are those of the JAX module (``Roadway.check_actions`` +
``Roadway.step``, which carry the reference citations).  ``soa_init``
is the deterministic reset (depart noise 0: ``depart_mean`` only) and
runs one populating NOOP step, as in the JAX module.

Rounding, so that this module, the CUDA kernel and the JAX module
compute the same float32 values: every product and sum is its own
eager operation, rounded apart (no fused multiply-add), and the
divisions by a constant divide by a 0-dim tensor on the operands'
device, since PyTorch's CUDA ``div`` by a Python scalar multiplies by
the reciprocal instead.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from .config import RoadwayEnvConfig

NOOP, ACC, DEC, LEFT, RIGHT = range(5)


class SoaState(NamedTuple):
    """Per-car tuples of same-shaped tensors (any shape)."""
    x: tuple          # f32 longitudinal position (m)
    sub: tuple        # i32 absolute sublane 0..15
    vel: tuple        # f32 m/s
    steps: tuple      # i32 per-car control steps
    term: tuple       # i32 0/1 reached terminal at some step
    coll: tuple       # i32 0/1 ever collided
    rem: tuple        # i32 0/1 removed (terminal at a previous step)


def _y(cfg, sub):
    return cfg.sublane_res * sub.float() - cfg.total_width


def _const(value, like):
    """A 0-dim float32 tensor on ``like``'s device: a divisor that
    PyTorch divides by in IEEE on every device."""
    return torch.full((), value, dtype=torch.float32, device=like.device)


def soa_check_actions(cfg: RoadwayEnvConfig, s: SoaState, actions):
    """TTC/limit feasibility filter; an infeasible action becomes the
    first feasible one in index order (``Roadway.check_actions``)."""
    n = cfg.n_agents
    out = []
    for i in range(n):
        yi = _y(cfg, s.sub[i])
        danger = torch.zeros_like(s.rem[i], dtype=torch.bool)
        for j in range(n):
            if j == i:
                continue
            dx = s.x[j] - s.x[i]
            ahead = dx > 0
            slower = s.vel[j] < s.vel[i]
            lateral = (_y(cfg, s.sub[j]) - yi).abs() < cfg.car_width
            rel_v = torch.clamp_min(s.vel[i] - s.vel[j], 1e-6)
            ttc = (dx - cfg.car_length) / rel_v
            danger = danger | (ahead & slower & lateral
                               & (ttc <= cfg.ttc_thres) & (s.rem[j] == 0))
        feas = (
            ~danger,                                     # NOOP
            (s.vel[i] < cfg.v_max) & ~danger,            # ACC
            s.vel[i] > cfg.v_min,                        # DEC
            s.sub[i] < cfg.n_sublanes - 1,               # LEFT
            s.sub[i] > 1,                                # RIGHT
        )
        a = actions[i]
        ok = functools.reduce(
            torch.logical_or, ((a == k) & feas[k] for k in range(5)))
        first = torch.where(
            feas[0], NOOP, torch.where(
                feas[1], ACC, torch.where(
                    feas[2], DEC, torch.where(feas[3], LEFT, RIGHT))))
        out.append(torch.where(ok, a, first.to(a.dtype)))
    return tuple(out)


def soa_step(cfg: RoadwayEnvConfig, s: SoaState, actions):
    """One control step.  Returns (state', rewards tuple [per car],
    done)."""
    n = cfg.n_agents
    live = tuple(s.rem[i] == 0 for i in range(n))

    # --- apply controls ---
    vel, sub, x, steps, y = [], [], [], [], []
    for i in range(n):
        a = actions[i]
        acc = torch.where(a == ACC, cfg.acc_val,
                          torch.where(a == DEC, -cfg.dec_val, 0.0))
        v = torch.clamp(s.vel[i] + cfg.dt * acc, 0.0, cfg.v_max)
        dsub = (a == LEFT).int() - (a == RIGHT).int()
        sb = torch.clamp(s.sub[i] + dsub, 0, cfg.n_sublanes - 1)
        v = torch.where(live[i], v, s.vel[i])
        sb = torch.where(live[i], sb, s.sub[i])
        vel.append(v)
        sub.append(sb)
        x.append(torch.where(live[i], s.x[i] + v * cfg.dt, s.x[i]))
        steps.append(s.steps[i] + live[i].int())
        y.append(_y(cfg, sb))

    # --- pairwise overlap collisions + adjacency flags ---
    crashed_each = []
    for i in range(n):
        hit = torch.zeros_like(live[i])
        on_left = torch.zeros_like(live[i])
        on_right = torch.zeros_like(live[i])
        for j in range(n):
            if j == i:
                continue
            pair = live[i] & live[j]
            hit = hit | (pair & ((x[i] - x[j]).abs() < cfg.car_length)
                         & ((y[i] - y[j]).abs() < cfg.car_width))
            fwd = x[j] - x[i]
            near = pair & (fwd > -cfg.res_forward / 2) \
                & (fwd < 1.5 * cfg.res_forward)
            sd = sub[j] - sub[i]
            on_left = on_left | (near & (sd >= 1) & (sd <= 2))
            on_right = on_right | (near & (sd <= -1) & (sd >= -2))
        a = actions[i]
        crashed_each.append(hit | (on_left & (a == LEFT))
                            | (on_right & (a == RIGHT)))

    rewards, term, coll, rem = [], [], [], []
    length = _const(cfg.total_length, x[0])
    n_sub = _const(float(cfg.n_sublanes), x[0])
    for i in range(n):
        goal_sub = cfg.goal_lane[i] * cfg.sublanes_per_lane \
            + cfg.sublanes_per_lane // 2
        delta = goal_sub - sub[i]
        dist_to_goal = (cfg.goal_pos[i] - x[i]) / length
        at_goal = dist_to_goal <= 0.0
        timed_out = steps[i] >= cfg.max_step
        crashed = crashed_each[i]
        r_goal = torch.where(
            delta == 0, 10.0, 10.0 * (1.0 - delta.abs().float() / n_sub))
        r = torch.where(crashed, -1.0,
                        torch.where(at_goal, r_goal,
                                    torch.where(timed_out, -10.0, 0.0)))
        r = r - 0.1 * (vel[i] >= cfg.overspeed).float()
        rewards.append(torch.where(live[i], r, 0.0))
        term.append((live[i] & (crashed | at_goal | timed_out)).int())
        coll.append(s.coll[i] | (live[i] & crashed).int())

    episode_crash = functools.reduce(
        torch.logical_or, (live[i] & crashed_each[i] for i in range(n))
    ).int()
    done = None
    for i in range(n):
        rem.append(s.rem[i] | term[i] | episode_crash)
        done = rem[i] if done is None else done & rem[i]
    done = done == 1

    s2 = SoaState(x=tuple(x), sub=tuple(sub), vel=tuple(vel),
                  steps=tuple(steps),
                  term=tuple(s.term[i] | term[i] for i in range(n)),
                  coll=tuple(coll), rem=tuple(rem))
    return s2, tuple(rewards), done


def soa_init(cfg: RoadwayEnvConfig, shape=(), device="cuda") -> SoaState:
    """Deterministic reset (depart noise 0): car i starts
    ``speed*dt*round(lead)`` ahead, lead_i = (max depart - depart_i)/dt,
    then one populating NOOP step (``Roadway.reset``)."""
    n = cfg.n_agents
    latest = max(cfg.depart_mean)

    def full(v, dtype):
        return torch.full(shape, v, dtype=dtype, device=device)

    x, sub, vel, steps = [], [], [], []
    for i in range(n):
        lead = round((latest - cfg.depart_mean[i]) / cfg.dt)
        vel.append(full(cfg.speed[i], torch.float32))
        x.append(full(cfg.init_position[i] + cfg.speed[i] * cfg.dt * lead,
                      torch.float32))
        sub.append(full(cfg.lane[i] * cfg.sublanes_per_lane
                        + cfg.sublanes_per_lane // 2, torch.int32))
        steps.append(full(0, torch.int32))
    flags = tuple(full(0, torch.int32) for _ in range(n))
    s = SoaState(x=tuple(x), sub=tuple(sub), vel=tuple(vel),
                 steps=tuple(steps), term=flags, coll=flags, rem=flags)
    s, _, _ = soa_step(cfg, s, tuple(full(NOOP, torch.int32)
                                     for _ in range(n)))
    return s


def select(done, init: SoaState, cur: SoaState) -> SoaState:
    """The auto-reset: ``init`` where ``done``, else ``cur``."""
    return SoaState(*(tuple(torch.where(done, a, b) for a, b in zip(fa, fb))
                      for fa, fb in zip(init, cur)))
