"""Bit-packed Checkers dynamics: the whole game state in a few words.

Port of ``cm3_tpu.envs.checkers_packed``.  The playable area of the
Checkers grid is ``n_rows x (n_columns + 1)`` = 3 x 9 = 27 cells, so
one word holds it:

  * each agent's position is a one-hot bitmask (bit ``r*9 + c``),
  * the collected-cells set is one bitmask,
  * the step counter is one integer,

and one env step is a few dozen elementwise integer operations: moves
are constant shifts (up ``>>w``, down ``<<w``, left ``>>1``, right
``<<1``), border blocking is an AND with an edge mask, agent blocking
an AND with the other agents' bits, and rewards an AND with the green
and orange masks.

The JAX engine keeps the words in ``uint32``.  PyTorch has no shifts
on ``uint32`` on the CPU, so here every word is an ``int64`` tensor.
The results are the same: ``make_spec`` refuses areas above 32 bits,
the bits that ``p << w`` pushes past the area are never kept (the
edge mask blocks that move), ``tgt & others`` ignores them, and
``~collected`` is only ever ANDed with a mask of the area.

Agents resolve in index order, and agent 1 sees agent 0's new position
(``cm3_tpu/envs/checkers.py``, the grid engine, does the same).  An
invalid move costs -0.1, a pickup +1 (goal colour) or -0.5, and an
instance that is done (step cap, or every goal cell collected) is
reset in the same step.  n = 1 and n = 2 are supported, as in the JAX
engine.  The fused rollout kernel (``ops/checkers_rollout.py``) runs
the same step per instance in registers; this module is its plain
version's engine.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .config import CheckersEnvConfig


class PackedSpec(NamedTuple):
    """Static bit-layout constants derived from the env config."""
    width: int                 # n_columns + 1 (incl. agent-start column)
    height: int                # n_rows
    green_mask: int            # green cells of the area
    orange_mask: int
    full_mask: int             # cells whose collection ends the episode
    up_ok: int                 # positions allowed to move up (r > 0)
    down_ok: int
    left_ok: int
    right_ok: int
    init_pos: tuple            # per-agent start bit masks
    goal_green: tuple          # per-agent bool: goal is green
    max_steps: int


def make_spec(cfg: CheckersEnvConfig, goal_green=(True, False)) -> PackedSpec:
    h, w = cfg.n_rows, cfg.n_columns + 1
    if h * w > 32:
        raise ValueError("playable area exceeds 32 bits; use the grid engine")
    bit = lambda r, c: 1 << (r * w + c)
    green = orange = 0
    for r in range(h):
        for c in range(cfg.n_columns):          # start column has no reward
            if c % 2 == r % 2:
                green |= bit(r, c)
            else:
                orange |= bit(r, c)
    up = down = left = right = 0
    for r in range(h):
        for c in range(w):
            if r > 0:
                up |= bit(r, c)
            if r < h - 1:
                down |= bit(r, c)
            if c > 0:
                left |= bit(r, c)
            if c < w - 1:
                right |= bit(r, c)
    init = tuple(bit(r, c) for r, c in zip(cfg.agents_r, cfg.agents_c))
    # n = 1 ends when the goal colour is exhausted, n > 1 when every
    # cell is collected (the grid engine's done rule)
    if len(goal_green) == 1:
        full = green if goal_green[0] else orange
    else:
        full = green | orange
    return PackedSpec(width=w, height=h, green_mask=green,
                      orange_mask=orange, full_mask=full,
                      up_ok=up, down_ok=down, left_ok=left, right_ok=right,
                      init_pos=init, goal_green=tuple(goal_green),
                      max_steps=cfg.max_steps)


class PackedState(NamedTuple):
    pos: tuple                  # per-agent int64 one-hot bitmasks, shape S
    collected: torch.Tensor     # int64 [S]
    steps: torch.Tensor         # int64 [S]


def packed_init(spec: PackedSpec, shape, device="cuda") -> PackedState:
    full = lambda v: torch.full(shape, v, dtype=torch.int64, device=device)
    return PackedState(pos=tuple(full(p) for p in spec.init_pos),
                       collected=full(0), steps=full(0))


def packed_step(spec: PackedSpec, s: PackedState, actions):
    """One lockstep env step.  ``actions``: tuple of per-agent integer
    tensors (0 stay / 1 up / 2 down / 3 left / 4 right) of the state's
    shape.  Returns (next_state, per-agent float32 rewards tuple, done
    bool tensor).  Auto-resets finished instances."""
    w = spec.width
    pos = list(s.pos)
    collected = s.collected
    rewards = []
    n = len(pos)
    for i in range(n):
        a = actions[i]
        p = pos[i]
        tgt = torch.where(a == 1, p >> w,
                          torch.where(a == 2, p << w,
                                      torch.where(a == 3, p >> 1,
                                                  torch.where(a == 4, p << 1,
                                                              p))))
        edge = torch.where(
            a == 1, p & spec.up_ok,
            torch.where(a == 2, p & spec.down_ok,
                        torch.where(a == 3, p & spec.left_ok,
                                    torch.where(a == 4, p & spec.right_ok,
                                                0))))
        others = torch.zeros_like(p)
        for j in range(n):
            if j != i:
                others = others | pos[j]
        can = (a != 0) & (edge != 0) & ((tgt & others) == 0)
        newp = torch.where(can, tgt, p)
        uncol = ~collected
        has_g = (newp & spec.green_mask & uncol) != 0
        has_o = (newp & spec.orange_mask & uncol) != 0
        collected = torch.where(has_g | has_o, collected | newp, collected)
        gg = spec.goal_green[i]
        rew = (has_g.float() * (1.0 if gg else -0.5)
               + has_o.float() * (-0.5 if gg else 1.0)
               + ((a != 0) & ~can).float() * -0.1)
        rewards.append(rew)
        pos[i] = newp

    steps = s.steps + 1
    full = spec.full_mask
    done = (steps >= spec.max_steps) | ((collected & full) == full)
    # auto-reset finished instances
    pos = tuple(torch.where(done, spec.init_pos[i], pos[i])
                for i in range(n))
    collected = torch.where(done, 0, collected)
    steps = torch.where(done, 0, steps)
    return PackedState(pos=pos, collected=collected, steps=steps), \
        tuple(rewards), done
