"""Kinematic sublane lane-change roadway, batched over env instances.

Port of ``cm3_tpu.envs.roadway`` (the JAX package's replacement for the
reference's SUMO merge network; its docstring carries the reference
citations): N cars on one straight 200 m road of 4 lanes x 4 sublanes,
5 actions (NOOP, ACC, DEC, LEFT, RIGHT: +-2.5 m/s^2 over dt = 0.2 s,
+-one 0.8 m sublane), a per-car step cap, rectangle-overlap and lateral
collisions that end the episode, and goal rewards by the sublane
reached at the goal position.  Terminal cars are removed: frozen,
invisible to the others, zero rewards.

The JAX engine steps one instance and is ``vmap``-ed; here every
per-car tensor is [*L, N] for any leading instance shape L (the driver
passes [E], or [S*E] for seeds in lockstep), and every pairwise one
[*L, ego, other].

Reset.  ``reset`` takes the episode's lanes and goal lanes (the hooks
draw them, ``experiments.RoadwayHooks``) and the standard normal depart
noise [*L, N] (``roadway.py:221-225``): car i departs at depart_mean_i
+ depart_stdev * noise_i, and the cars that depart before the last one
start round(lead) steps of their speed ahead.  It then takes one NOOP
step, as the JAX reset does, so that the observations are populated.

Observations (``roadway.py:347-420``): a 13 x 9 x 2 egocentric grid per
car, occupancy and relative speed / 25 (blank cells -own speed / 25,
off-road columns occupied), as an [ego, other, rows, cols] reduction
over the other cars; and the vector [vel / 29, delta_sublane / 16,
distance to goal].  The global state has a row [(x - 100) / 200,
(y + 6.4) / 12.8, vel / 29] per car.

``occlusion`` (the ray-cast shadows) is left out of this copy.

``check_actions`` is the TTC feasibility filter (``roadway.py:236-268``):
an infeasible action becomes the first feasible one in index order.
The drivers apply it before every step and store what it returns.

Rounding.  The operations follow the JAX engine's order, each rounded
apart; a division by a constant divides by a 0-dim float32 tensor on the
engine's device (PyTorch's CUDA division by a Python scalar multiplies
by the reciprocal); sums over cars run in index order.  Run op by op,
JAX rounds every value the same.  Compiled XLA contracts ``a*b + c``
and divides by a constant as a product with its reciprocal, so a
position can be an ulp off, and ``round()`` of a quotient that sits on
a half-integer can then pick the next grid cell or head-start step
(``tests/test_torch_roadway_engine.py`` counts each such cell).
"""

from __future__ import annotations

import dataclasses

import torch

from .config import RoadwayEnvConfig
from . import envs_base as base
from .roadway_soa import ACC, DEC, LEFT, RIGHT


@dataclasses.dataclass
class RoadwayState:
    x: torch.Tensor          # [*L, N] f32 longitudinal position (m)
    sublane: torch.Tensor    # [*L, N] i64 absolute sublane 0..15
    vel: torch.Tensor        # [*L, N] f32 m/s
    steps: torch.Tensor      # [*L, N] i64 per-car control steps taken
    goal_lane: torch.Tensor  # [*L, N] i64
    terminal: torch.Tensor   # [*L, N] bool: reached goal, timed out, crashed
    collided: torch.Tensor   # [*L, N] bool
    removed: torch.Tensor    # [*L, N] bool: terminal at a previous step


class Roadway(base.Env):

    def __init__(self, cfg: RoadwayEnvConfig, device="cuda"):
        if cfg.occlusion:
            raise ValueError("the reference leaves out the occlusion")
        self.cfg = cfg
        self.device = torch.device(device)
        c = cfg
        dev = self.device

        def const(v):
            return torch.full((), v, dtype=torch.float32, device=dev)

        def per_car(v, dtype=torch.float32):
            return torch.tensor(v, dtype=dtype, device=dev)

        self._eye = torch.eye(c.n_agents, dtype=torch.bool, device=dev)
        self._dt, self._length = const(c.dt), const(c.total_length)
        self._width, self._n_sub = const(c.total_width), const(
            float(c.n_sublanes))
        self._sub_res, self._res_fwd = const(c.sublane_res), const(
            c.res_forward)
        self._v25, self._v29 = const(25.0), const(29.0)
        self._v_thr = const(c.v_threshold)
        self._depart_mean = per_car(c.depart_mean)
        self._speed = per_car(c.speed)
        self._init_pos = per_car(c.init_position)
        self._goal_pos = per_car(c.goal_pos)
        self.lane0 = per_car(c.lane, torch.int64)
        self.goal_lane0 = per_car(c.goal_lane, torch.int64)
        self._rows = torch.arange(c.obs_rows, device=dev)
        self._cols = torch.arange(c.obs_cols, device=dev)

    def spec(self):
        c = self.cfg
        return dict(l_action=5, l_goal=4, l_state_one=3, l_obs=3,
                    h_obs=c.obs_rows, w_obs=c.obs_cols, c_obs=2,
                    n_agents=c.n_agents)

    def _y(self, sublane):
        return 0.8 * sublane.float() - self.cfg.total_width

    # ------------------------------------------------------------------ #

    def reset(self, goals, noise):
        """Fresh episodes: ``goals`` is dict(lanes, goal_lanes) of [*L, N]
        ints (None: the config's), ``noise`` the [*L, N] standard normal
        depart draws (``roadway.py:203-233``)."""
        c = self.cfg
        noise = noise.to(self.device, torch.float32)
        if goals is None:
            lanes = self.lane0.expand(noise.shape)
            goal_lanes = self.goal_lane0.expand(noise.shape)
        else:
            lanes = goals["lanes"].to(self.device, torch.int64)
            goal_lanes = goals["goal_lanes"].to(self.device, torch.int64)
        depart = self._depart_mean + c.depart_stdev * noise
        lead = (depart.amax(dim=-1, keepdim=True) - depart) / self._dt
        vel = self._speed.expand(noise.shape).contiguous()
        x = self._init_pos + vel * c.dt * torch.round(lead)
        spl = c.sublanes_per_lane
        zeros = torch.zeros_like(x, dtype=torch.int64)
        flags = torch.zeros_like(x, dtype=torch.bool)
        state = RoadwayState(
            x=x, sublane=lanes * spl + spl // 2, vel=vel, steps=zeros,
            goal_lane=goal_lanes.expand(noise.shape).contiguous(),
            terminal=flags, collided=flags, removed=flags)
        # the populating NOOP step
        return self.step(state, zeros)

    # ------------------------------------------------------------------ #

    def check_actions(self, state: RoadwayState, actions):
        """The TTC/limit feasibility filter: an infeasible action becomes
        the first feasible one in index order (``roadway.py:236-268``);
        [*L, N] in and out."""
        c = self.cfg
        a = actions.to(self.device, torch.int64)
        x, vel = state.x, state.vel
        y = self._y(state.sublane)
        dx = x[..., None, :] - x[..., :, None]               # [ego, other]
        ahead = dx > 0
        slower = vel[..., None, :] < vel[..., :, None]
        lateral = torch.abs(y[..., None, :] - y[..., :, None]) < c.car_width
        dist = dx - c.car_length
        rel_v = torch.clamp_min(vel[..., :, None] - vel[..., None, :], 1e-6)
        ttc = dist / rel_v
        live = ~state.removed
        danger = (ahead & slower & lateral & (ttc <= c.ttc_thres)
                  & live[..., None, :] & ~self._eye)
        safe = ~danger.any(dim=-1)
        feas = torch.stack([safe, (vel < c.v_max) & safe, vel > c.v_min,
                            state.sublane < c.n_sublanes - 1,
                            state.sublane > 1], dim=-1)
        chosen_ok = torch.gather(feas, -1, a[..., None])[..., 0]
        first = torch.argmax(feas.to(torch.int8), dim=-1)
        return torch.where(chosen_ok, a, first)

    def step(self, state: RoadwayState, actions):
        """One control step of every car (``roadway.py:270-345``)."""
        c = self.cfg
        a = actions.to(self.device, torch.int64)
        live = ~state.removed

        # --- apply controls ---
        acc = torch.where(a == ACC, c.acc_val,
                          torch.where(a == DEC, -c.dec_val, 0.0))
        vel = torch.clamp(state.vel + c.dt * acc, 0.0, c.v_max)
        dsub = (a == LEFT).long() - (a == RIGHT).long()
        sublane = torch.clamp(state.sublane + dsub, 0, c.n_sublanes - 1)
        vel = torch.where(live, vel, state.vel)
        sublane = torch.where(live, sublane, state.sublane)
        x = torch.where(live, state.x + vel * c.dt, state.x)
        steps = state.steps + live.long()
        y = self._y(sublane)

        # --- collisions: rectangle overlap between live cars ---
        dx = torch.abs(x[..., :, None] - x[..., None, :])
        dy = torch.abs(y[..., :, None] - y[..., None, :])
        pair_live = live[..., :, None] & live[..., None, :] & ~self._eye
        hit = ((dx < c.car_length) & (dy < c.car_width)
               & pair_live).any(dim=-1)

        # --- another live car 1-2 sublanes over, dx in (-1.25, 3.75) ---
        fwd = x[..., None, :] - x[..., :, None]              # other - ego
        near = pair_live & (fwd > -c.res_forward / 2) & (
            fwd < 1.5 * c.res_forward)
        sub_diff = sublane[..., None, :] - sublane[..., :, None]
        on_left = (near & (sub_diff >= 1) & (sub_diff <= 2)).any(dim=-1)
        on_right = (near & (sub_diff <= -1) & (sub_diff >= -2)).any(dim=-1)
        crashed = hit | (on_left & (a == LEFT)) | (on_right & (a == RIGHT))

        # --- per-car reward and terminal ---
        spl = c.sublanes_per_lane
        delta_sub = state.goal_lane * spl + spl // 2 - sublane
        dist_to_goal = (self._goal_pos - x) / self._length
        at_goal = dist_to_goal <= 0.0
        timed_out = steps >= c.max_step
        r_goal = torch.where(
            delta_sub == 0, 10.0,
            10.0 * (1.0 - torch.abs(delta_sub).float() / self._n_sub))
        reward = torch.where(
            crashed, -1.0, torch.where(at_goal, r_goal, torch.where(
                timed_out, -10.0, 0.0)))
        reward = reward - 0.1 * (vel >= c.overspeed).float()
        reward = torch.where(live, reward, 0.0)

        terminal = live & (crashed | at_goal | timed_out)
        # any collision ends the whole episode
        episode_crash = (live & crashed).any(dim=-1)
        removed = state.removed | terminal | episode_crash[..., None]
        new_state = RoadwayState(
            x=x, sublane=sublane, vel=vel, steps=steps,
            goal_lane=state.goal_lane, terminal=state.terminal | terminal,
            collided=state.collided | (live & crashed), removed=removed)
        ts = base.TimeStep(
            obs=self._observe(new_state, delta_sub, dist_to_goal),
            state=self._global_state(new_state), reward=base.sum_agents(reward),
            reward_local=reward,
            done=removed.all(dim=-1) | episode_crash)
        return new_state, ts

    # ------------------------------------------------------------------ #

    def _observe(self, state: RoadwayState, delta_sub, dist_to_goal):
        """self_t [*L, N, 13, 9, 2] egocentric grids, self_v [*L, N, 3]."""
        c = self.cfg
        back = int(round(c.obs_back / c.res_forward))
        num_cells = int(round(c.car_length / c.res_forward))
        y = self._y(state.sublane)
        x, vel = state.x, state.vel

        # cell coordinates of each other car in each ego frame
        col = torch.round((y[..., :, None] - y[..., None, :])
                          / self._sub_res).long() + c.obs_left
        r_high = torch.round((x[..., None, :] - x[..., :, None])
                             / self._res_fwd).long() + back + 1
        rr = self._rows
        in_row = ((rr >= (r_high - num_cells)[..., None])
                  & (rr < r_high[..., None]))      # [ego, other, rows]
        valid = ((~state.removed)[..., None, :, None]
                 & ~self._eye[..., None] & in_row)
        in_col = self._cols == col[..., None]        # [ego, other, cols]
        occ_pair = valid[..., None] & in_col[..., None, :]
        occupancy = occ_pair.any(dim=-3).float()    # [ego, rows, cols]
        rel_speed = (vel[..., None, :] - vel[..., :, None]) / self._v25
        relsp_fill = base.sum_agents(occ_pair.float()
                                     * rel_speed[..., None, None], dim=-3)
        blank = -vel[..., :, None, None] / self._v25
        relspeed = torch.where(occupancy > 0, relsp_fill,
                               blank.expand(occupancy.shape))

        # off-road columns occupied
        l_sub = state.sublane[..., :, None] + (c.obs_left - self._cols)
        offroad = (l_sub <= 0) | (l_sub >= c.n_sublanes)
        occupancy = torch.where(offroad[..., :, None, :], 1.0, occupancy)

        grid = torch.stack([occupancy, relspeed], dim=-1)
        vec = torch.stack([vel / self._v29,
                           delta_sub.float() / self._n_sub, dist_to_goal],
                          dim=-1)
        return dict(self_t=grid, self_v=vec)

    def _global_state(self, state: RoadwayState):
        c = self.cfg
        y = self._y(state.sublane)
        return dict(vec=torch.stack(
            [(state.x - c.total_length / 2) / self._length,
             (y + c.total_width / 2) / self._width,
             state.vel / self._v29], dim=-1))


