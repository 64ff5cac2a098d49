"""Episode rendering (``cm3_tpu.envs.render``).

The reference renders particle episodes with a pyglet/OpenGL viewer
(``multiagent/rendering.py``), which a headless GPU host has no display
for.  These text renderers fill the same debugging role headlessly, and
the animated SVGs (SMIL, no dependencies) are the per-episode artifacts
that the runner's ``--render-episodes`` writes and
``utils/live_viewer.py`` serves.  They are the JAX package's, byte for
byte, over host states: numpy arrays of one instance in the fields of
the engines' state dataclasses (``host_state`` reads one instance of a
port state to the host).  ``collect_episode`` rolls one instance out
greedily with the port's engines and algorithms, from a draw source.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from cm3_tpu_torch.train.experiments import flat_call


def host_state(state):
    """The first instance of a batched engine state (a dataclass of
    [E, ...] tensors) as the same dataclass of host numpy arrays, the
    form the renderers read."""
    return type(state)(**{
        f.name: getattr(state, f.name)[0].detach().cpu().numpy()
        for f in dataclasses.fields(state)})


def render_checkers(state) -> str:
    """world [R,C,3] + loc [N,2] -> grid text: 'g'/'o' uncollected cells,
    '.' empty, '#' border, digits for agents."""
    world = np.asarray(state.world)
    loc = np.asarray(state.loc)
    rows, cols, _ = world.shape
    out = []
    for r in range(rows):
        line = []
        for c in range(cols):
            ch = "."
            if world[r, c, 2] == 1:
                ch = "#"
            elif world[r, c, 0] == -1:
                ch = "g"
            elif world[r, c, 1] == -1:
                ch = "o"
            for i in range(loc.shape[0]):
                if loc[i, 0] == r and loc[i, 1] == c:
                    ch = str(i)
            line.append(ch)
        out.append("".join(line))
    return "\n".join(out)


def render_particle(state, width: int = 41) -> str:
    """pos/landmarks in [-1,1]^2 -> character map ('0'..'9' agents,
    'A'..'J' landmarks)."""
    pos = np.asarray(state.pos)
    lms = np.asarray(state.landmarks)
    h = w = width
    grid = [[" "] * w for _ in range(h)]

    def put(xy, ch):
        c = int(round((xy[0] + 1) / 2 * (w - 1)))
        r = int(round((1 - (xy[1] + 1) / 2) * (h - 1)))
        if 0 <= r < h and 0 <= c < w:
            grid[r][c] = ch

    for i, lm in enumerate(lms):
        put(lm, chr(ord("A") + i))
    for i, p in enumerate(pos):
        put(p, str(i))
    border = "+" + "-" * w + "+"
    return "\n".join([border] + ["|" + "".join(row) + "|" for row in grid]
                     + [border])


def render_roadway(state, cfg, length_cells: int = 80) -> str:
    """Top-down road: rows are sublanes (top = sublane 15), '=' lane
    center markers, digits for cars, 'X' for crashed cars."""
    x = np.asarray(state.x)
    sub = np.asarray(state.sublane)
    removed = np.asarray(state.removed)
    collided = np.asarray(state.collided)
    n_sub = cfg.n_sublanes
    grid = [[" "] * length_cells for _ in range(n_sub)]
    for lane in range(cfg.n_lanes):
        center = lane * cfg.sublanes_per_lane + cfg.sublanes_per_lane // 2
        for c in range(0, length_cells, 4):
            grid[n_sub - 1 - center][c] = "-"
    for i in range(len(x)):
        c = int(x[i] / cfg.total_length * (length_cells - 1))
        c = min(max(c, 0), length_cells - 1)
        r = n_sub - 1 - int(sub[i])
        grid[r][c] = "X" if collided[i] else (
            "x" if removed[i] else str(i))
    border = "+" + "=" * length_cells + "+"
    return "\n".join([border] + ["|" + "".join(row) + "|" for row in grid]
                     + [border])


# --------------------------------------------------------------------- #
# Headless per-episode artifacts: animated SVG (SMIL), no dependencies,
# in place of the reference's pyglet/OpenGL viewer
# (multiagent/rendering.py:1-345): self-contained .svg files (open in any
# browser), written by the runner's --render-episodes
# (cm3_tpu_torch/train/runner.py).
# --------------------------------------------------------------------- #

_FRAME_S = 0.15


def _stack_states(states):
    """list of per-step env-state pytrees -> dict of [T, ...] np arrays
    keyed by field name (host states: the engines' dataclasses)."""
    fields = [f.name for f in dataclasses.fields(states[0])]
    return {f: np.stack([np.asarray(getattr(s, f)) for s in states])
            for f in fields}


def _animate(attr, values, dur, mode="linear"):
    vals = ";".join(f"{v:.4g}" if isinstance(v, float) else str(v)
                    for v in values)
    return (f'<animate attributeName="{attr}" values="{vals}" '
            f'dur="{dur:.3g}s" calcMode="{mode}" '
            f'repeatCount="indefinite"/>')


_AGENT_COLORS = ["#3366cc", "#cc3333", "#33aa55", "#aa33aa",
                 "#cc8833", "#33aaaa", "#888833", "#663399"]


def svg_checkers(states) -> str:
    """Animated board: green/orange reward cells fade out when
    collected, numbered agent discs jump cell-to-cell (discrete)."""
    st = _stack_states(states)
    world, loc = st["world"], st["loc"]          # [T,R,C,3], [T,N,2]
    t_len, rows, cols, _ = world.shape
    dur = t_len * _FRAME_S
    cell = 24
    out = [f'<svg xmlns="http://www.w3.org/2000/svg" '
           f'width="{cols*cell}" height="{rows*cell}" '
           f'viewBox="0 0 {cols*cell} {rows*cell}">',
           f'<rect width="{cols*cell}" height="{rows*cell}" fill="#fafafa"/>']
    for r in range(rows):
        for c in range(cols):
            x, y = c * cell, r * cell
            if world[0, r, c, 2] == 1 and not (loc[0] == [r, c]).all(-1).any():
                out.append(f'<rect x="{x}" y="{y}" width="{cell}" '
                           f'height="{cell}" fill="#ddd"/>')
                continue
            for ch, color in ((0, "#4caf50"), (1, "#ff9800")):
                series = world[:, r, c, ch] == -1
                if series.any():
                    op = [1 if v else 0 for v in series]
                    out.append(
                        f'<rect x="{x+2}" y="{y+2}" width="{cell-4}" '
                        f'height="{cell-4}" rx="4" fill="{color}">'
                        + _animate("opacity", op, dur, "discrete")
                        + "</rect>")
    for i in range(loc.shape[1]):
        cx = [float(c * cell + cell / 2) for c in loc[:, i, 1]]
        cy = [float(r * cell + cell / 2) for r in loc[:, i, 0]]
        col = _AGENT_COLORS[i % len(_AGENT_COLORS)]
        out.append(f'<circle r="{cell*0.35:.4g}" fill="{col}" '
                   f'stroke="#222">'
                   + _animate("cx", cx, dur, "discrete")
                   + _animate("cy", cy, dur, "discrete") + "</circle>")
        out.append(f'<text font-size="{cell*0.5:.4g}" fill="#fff" '
                   f'text-anchor="middle" dy="0.35em">{i}'
                   + _animate("x", cx, dur, "discrete")
                   + _animate("y", cy, dur, "discrete") + "</text>")
    out.append("</svg>")
    return "\n".join(out)


def svg_particle(states, size: int = 480) -> str:
    """Animated arena in [-1.2, 1.2]^2: landmark squares (goal i colored
    like agent i, multi-goal_spread.py goal assignment), agent discs
    with soft-contact radius, smooth (linear) motion."""
    st = _stack_states(states)
    pos, lms = st["pos"], st["landmarks"]        # [T,N,2], [T,N,2]
    t_len, n, _ = pos.shape
    dur = t_len * _FRAME_S
    sc = size / 2.4

    def sx(v):
        return float((v + 1.2) * sc)

    def sy(v):
        return float((1.2 - v) * sc)

    out = [f'<svg xmlns="http://www.w3.org/2000/svg" width="{size}" '
           f'height="{size}" viewBox="0 0 {size} {size}">',
           f'<rect width="{size}" height="{size}" fill="#fcfcfc" '
           f'stroke="#999"/>']
    r_agent = 0.15 * sc                          # cfg.agent_size
    for i in range(lms.shape[1]):
        col = _AGENT_COLORS[i % len(_AGENT_COLORS)]
        s = 10
        out.append(f'<rect width="{2*s}" height="{2*s}" fill="none" '
                   f'stroke="{col}" stroke-width="3">'
                   + _animate("x", [sx(v) - s for v in lms[:, i, 0]], dur)
                   + _animate("y", [sy(v) - s for v in lms[:, i, 1]], dur)
                   + "</rect>")
    for i in range(n):
        col = _AGENT_COLORS[i % len(_AGENT_COLORS)]
        out.append(f'<circle r="{r_agent:.4g}" fill="{col}" '
                   f'fill-opacity="0.75" stroke="#222">'
                   + _animate("cx", [sx(v) for v in pos[:, i, 0]], dur)
                   + _animate("cy", [sy(v) for v in pos[:, i, 1]], dur)
                   + "</circle>")
    out.append("</svg>")
    return "\n".join(out)


def svg_roadway(states, cfg, width: int = 800) -> str:
    """Animated top-down road (4 lanes x 4 sublanes, 200 m): car
    rectangles slide longitudinally and between sublanes; a car turns
    red on collision and fades out once removed."""
    st = _stack_states(states)
    x, sub = st["x"], st["sublane"]              # [T,N]
    collided, removed = st["collided"], st["removed"]
    t_len, n = x.shape
    dur = t_len * _FRAME_S
    px_m = width / cfg.total_length
    lane_px = 40
    height = cfg.n_lanes * lane_px
    sub_px = lane_px / cfg.sublanes_per_lane
    out = [f'<svg xmlns="http://www.w3.org/2000/svg" width="{width}" '
           f'height="{height}" viewBox="0 0 {width} {height}">',
           f'<rect width="{width}" height="{height}" fill="#555"/>']
    for lane in range(1, cfg.n_lanes):
        y = height - lane * lane_px
        out.append(f'<line x1="0" y1="{y}" x2="{width}" y2="{y}" '
                   f'stroke="#fff" stroke-width="2" '
                   f'stroke-dasharray="14 10"/>')
    car_w = cfg.car_length * px_m
    car_h = cfg.car_width / cfg.sublane_res * sub_px
    for i in range(n):
        col = _AGENT_COLORS[i % len(_AGENT_COLORS)]
        xs = [float(v * px_m - car_w / 2) for v in x[:, i]]
        ys = [float(height - (s + 0.5) * sub_px - car_h / 2)
              for s in sub[:, i]]
        fills = ["#d32f2f" if c else col for c in collided[:, i]]
        ops = [0.25 if r else 1.0 for r in removed[:, i]]
        out.append(f'<rect width="{car_w:.4g}" height="{car_h:.4g}" '
                   f'rx="3" stroke="#111">'
                   + _animate("x", xs, dur) + _animate("y", ys, dur)
                   + _animate("fill", fills, dur, "discrete")
                   + _animate("opacity", ops, dur, "discrete")
                   + "</rect>")
    out.append("</svg>")
    return "\n".join(out)


@torch.no_grad()
def collect_episode(hooks, alg, ts_alg, draws, max_steps: int):
    """A greedy (epsilon 0) rollout of one instance, returning the host
    states (``host_state``) of every step, the initial one included,
    until the episode ends or ``max_steps`` steps (``render.py:245-271``):
    the debugging path, not the training path (one env, a host loop).
    ``draws`` (a draw source) gives the reset's draws, then at each step
    what the algorithm's ``act`` consumes; roadway's feasibility filter
    is applied to every action before its step."""
    env = hooks.env
    lead = (1,)
    env_state, ts, goals = hooks.episode_init(lead, draws)
    obs = ts.obs
    a_prev = torch.zeros((1, hooks.n_agents), dtype=torch.int64,
                         device=env.device)
    states = [host_state(env_state)]
    for _ in range(max_steps):
        actions = alg.act(ts_alg, obs, goals, a_prev, 0.0,
                          alg.act_draws(draws, lead))
        if hasattr(env, "check_actions"):
            actions = flat_call(env.check_actions, lead, env_state, actions)
        env_state, ts2 = flat_call(env.step, lead, env_state, actions)
        states.append(host_state(env_state))
        obs, a_prev = ts2.obs, actions
        if bool(ts2.done[0]):
            break
    return states


def render_episode_svg(experiment: str, states, env_cfg=None) -> str:
    if experiment == "checkers":
        return svg_checkers(states)
    if experiment == "particle":
        return svg_particle(states)
    if experiment == "roadway":
        return svg_roadway(states, env_cfg)
    raise ValueError(experiment)
