"""Checkers grid world, batched over env instances.

Port of ``cm3_tpu.envs.checkers`` (itself the reference
``env/checkers.py``): a 3xC reward grid of alternating green/orange
cells plus an agent-start column, an ``n_obs`` padding ring, 5 actions,
goal-conditioned +1/-0.5 rewards, a -0.1 invalid-move penalty, and
mutual blocking through the invalid channel.

The JAX engine steps one instance and is ``vmap``-ed; here every tensor
has a leading env dimension E and the cell reads and writes are batched
gathers and scatters at (env, row, col).  Agents still move **in index
order** within one env step (a Python loop over the agent axis,
``cm3_tpu/envs/checkers.py:130-198``), so a later agent sees the cell an
earlier one just left or entered.

World channels: 0=green (-1 present, +1 collected), 1=orange,
2=invalid (1 border, -1 agent-occupied, 0 free).

Both games are ported.  With n > 1 (stage 2) the reset is
deterministic and an episode ends once every cell is collected; the
single agent of stage 1 starts on row 0 when its goal is green and on
row 2 when it is orange (``checkers.py:110-114``), its episode ends
once every cell of its goal colour is collected (``:180-184``), and
its ``others`` observation is its own normalized location, a
placeholder (``:232``).
"""

from __future__ import annotations

import dataclasses

import torch

from .config import CheckersEnvConfig
from . import envs_base as base


@dataclasses.dataclass
class CheckersState:
    world: torch.Tensor      # [E, total_rows, total_columns, 3] f32
    loc: torch.Tensor        # [E, N, 2] i64 (expanded-grid coordinates)
    collected: torch.Tensor  # [E, N, 2] f32 (#green, #orange)
    goals: torch.Tensor      # [E, N, l_goal] f32 one-hot
    steps: torch.Tensor      # [E] i64


class Checkers(base.Env):

    def __init__(self, cfg: CheckersEnvConfig, device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        c = cfg
        if c.n_agents == 1:
            # the start row follows the goal: [green start, orange start]
            starts = [[(r, c.agents_c[0])] for r in (0, 2)]
        else:
            starts = [list(zip(c.agents_r, c.agents_c))]
        locs = torch.tensor([[[r + c.n_obs, col + c.n_obs]
                              for r, col in start] for start in starts],
                            dtype=torch.int64)          # [K, N, 2]
        self._loc0 = locs.to(self.device)
        self._world0 = torch.stack(
            [self._initial_world(loc) for loc in locs]).to(self.device)

    # ------------------------------------------------------------------ #

    def spec(self):
        c = self.cfg
        n = c.n_agents
        return dict(
            rows_state=c.n_rows, columns_state=c.n_columns + 1,
            channels_state=2, l_state_one=4,
            l_obs_others=2 * max(n - 1, 1), l_obs_self=4,
            rows_obs=2 * c.n_obs + 1, columns_obs=2 * c.n_obs + 1,
            channels_obs=3, l_action=5, l_goal=2, n_agents=n)

    def _initial_world(self, loc):
        """populate_world (reference checkers.py:38-63), one instance."""
        c = self.cfg
        tr, tc = c.total_rows, c.total_columns
        rows = torch.arange(tr)[:, None]
        cols = torch.arange(tc)[None, :]
        border = ((cols < c.n_obs) | (rows < c.n_obs)
                  | (rows >= c.n_obs + c.n_rows)
                  | (cols >= c.n_obs + c.n_columns + 1))
        in_reward = ((rows >= c.n_obs) & (rows < c.n_obs + c.n_rows)
                     & (cols >= c.n_obs) & (cols < c.n_obs + c.n_columns))
        row_par = (rows - c.n_obs) % 2   # 0: green leads
        col_par = (cols - c.n_obs) % 2
        green = in_reward & (col_par == row_par)
        orange = in_reward & (col_par != row_par)
        world = torch.zeros((tr, tc, 3), dtype=torch.float32)
        world[:, :, 0] = torch.where(green, -1.0, 0.0)
        world[:, :, 1] = torch.where(orange, -1.0, 0.0)
        world[:, :, 2] = border.float()
        # agent cells are invalid (-1) so agents block each other
        world[loc[:, 0], loc[:, 1], 2] = -1.0
        return world

    def reset(self, goals):
        """checkers.py:265-291 for E instances at once; ``goals`` is
        [E, N, l_goal].  Deterministic given the goals."""
        c = self.cfg
        goals = goals.to(self.device, torch.float32)
        e = goals.shape[0]
        if c.n_agents == 1:
            # row 0 when the goal is green, row 2 otherwise
            k = (goals[:, 0, 0] != 1.0).long()
            world, loc = self._world0[k], self._loc0[k]
        else:
            world = self._world0[0].expand(e, -1, -1, -1).clone()
            loc = self._loc0[0].expand(e, -1, -1).clone()
        state = CheckersState(
            world=world, loc=loc,
            collected=torch.zeros((e, c.n_agents, 2), device=self.device),
            goals=goals,
            steps=torch.zeros(e, dtype=torch.int64, device=self.device))
        ts = base.TimeStep(
            obs=self._observe(state), state=self._global_state(state),
            reward=torch.zeros(e, device=self.device),
            reward_local=torch.zeros((e, c.n_agents), device=self.device),
            done=torch.zeros(e, dtype=torch.bool, device=self.device))
        return state, ts

    # ------------------------------------------------------------------ #

    def step(self, state: CheckersState, actions):
        """One lockstep transition; ``actions`` is [E, N] in 0..4
        (stay/up/down/left/right)."""
        c = self.cfg
        actions = actions.to(self.device, torch.int64)
        e = actions.shape[0]
        env = torch.arange(e, device=self.device)
        ch_g = state.world[..., 0].clone()
        ch_o = state.world[..., 1].clone()
        ch_i = state.world[..., 2].clone()
        loc = state.loc.clone()
        collected = state.collected.clone()
        local_rewards = []
        for idx in range(c.n_agents):
            a = actions[:, idx]
            r, cc = loc[:, idx, 0], loc[:, idx, 1]
            tr = r + (a == 2).long() - (a == 1).long()
            tc = cc + (a == 4).long() - (a == 3).long()
            # the padding ring keeps (tr, tc) inside the world
            tgt_invalid = ch_i[env, tr, tc]
            moves = a != 0
            can_move = moves & (tgt_invalid == 0.0)
            penalty = torch.where(moves & ~can_move, -0.1, 0.0)
            ch_i[env, tr, tc] = torch.where(can_move, -1.0, tgt_invalid)
            ch_i[env, r, cc] = torch.where(can_move, 0.0, ch_i[env, r, cc])
            nr = torch.where(can_move, tr, r)
            nc = torch.where(can_move, tc, cc)
            loc[:, idx, 0] = nr
            loc[:, idx, 1] = nc
            # collect reward at the new cell, green before orange
            # (get_reward:190-225)
            g_green = state.goals[:, idx, 0] == 1.0
            cell_g = ch_g[env, nr, nc]
            cell_o = ch_o[env, nr, nc]
            has_green = cell_g == -1.0
            has_orange = ~has_green & (cell_o == -1.0)
            rew = torch.where(
                has_green, torch.where(g_green, 1.0, -0.5),
                torch.where(has_orange, torch.where(g_green, -0.5, 1.0),
                            0.0))
            ch_g[env, nr, nc] = torch.where(has_green, 1.0, cell_g)
            ch_o[env, nr, nc] = torch.where(has_orange, 1.0, cell_o)
            collected[:, idx, 0] += has_green.float()
            collected[:, idx, 1] += has_orange.float()
            local_rewards.append(penalty + rew)
        local_rewards = torch.stack(local_rewards, dim=1)
        world = torch.stack([ch_g, ch_o, ch_i], dim=-1)

        steps = state.steps + 1
        if c.n_agents == 1:
            # done once every cell of the goal colour is collected
            half = c.max_collectible / 2.0
            green = state.goals[:, 0, 0] == 1.0
            done_collect = torch.where(
                green, world[..., 0].sum(dim=(1, 2)) == half,
                world[..., 1].sum(dim=(1, 2)) == half)
        else:
            # done once every cell is collected (step:246-260)
            done_collect = world[..., 0:2].sum(dim=(1, 2, 3)) == float(
                c.max_collectible)
        done = (steps == c.max_steps) | done_collect

        new_state = CheckersState(world=world, loc=loc, collected=collected,
                                  goals=state.goals, steps=steps)
        ts = base.TimeStep(
            obs=self._observe(new_state), state=self._global_state(new_state),
            reward=local_rewards.sum(dim=1), reward_local=local_rewards,
            done=done)
        return new_state, ts

    # ------------------------------------------------------------------ #

    def _normalize(self, loc):
        """checkers.py:112-125: center/scale coordinates."""
        c = self.cfg
        loc = loc.float()
        return torch.stack(
            [(loc[..., 0] - c.total_rows / 2.0) / c.total_rows,
             (loc[..., 1] - c.total_columns / 2.0) / c.total_columns],
            dim=-1)

    def _observe(self, state: CheckersState):
        """5x5x3 egocentric crop (own cell's invalid flag cleared), the
        normalized self vector, and the others' normalized coordinates."""
        c = self.cfg
        k = c.n_obs
        n = c.n_agents
        e = state.loc.shape[0]
        span = torch.arange(-k, k + 1, device=self.device)
        rows = state.loc[:, :, 0, None] + span            # [E, N, 2k+1]
        cols = state.loc[:, :, 1, None] + span
        env = torch.arange(e, device=self.device)[:, None, None, None]
        grids = state.world[env, rows[..., :, None], cols[..., None, :]]
        grids[:, :, k, k, 2] = 0.0   # own cell valid (get_obs:107)
        norm = self._normalize(state.loc)                  # [E, N, 2]
        vecs = torch.cat(
            [norm, state.collected / (c.max_collectible / 2.0)], dim=-1)
        if n == 1:
            others = norm                                  # own location
        else:
            others = torch.stack(
                [torch.cat([norm[:, m] for m in range(n) if m != i], dim=-1)
                 for i in range(n)], dim=1)                # [E, N, 2(N-1)]
        return dict(others=others, self_t=grids, self_v=vecs)

    def _global_state(self, state: CheckersState):
        c = self.cfg
        grid = state.world[:, c.n_obs:c.n_obs + c.n_rows,
                           c.n_obs:c.n_obs + c.n_columns + 1, 0:2]
        vec = torch.cat([state.loc.float(), state.collected], dim=-1)
        return dict(grid=grid.contiguous(), vec=vec)
