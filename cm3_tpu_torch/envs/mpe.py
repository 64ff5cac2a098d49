"""The generic MPE world and the nine upstream particle scenarios,
batched over any leading shape of instances (``cm3_tpu.envs.mpe``).

Scenarios (the reference tree's ``multiagent/scenarios/simple*.py``,
which CM3 itself never uses): simple, simple_spread, simple_adversary,
simple_push, simple_tag, simple_reference, simple_speaker_listener,
simple_crypto and simple_world_comm.

One struct-of-arrays state over every entity (agents first, landmarks
after): ``pos`` and ``vel`` [*L, E, 2], the communication state ``c``
[*L, N, max(dim_c, 1)], the secret goal indices ``goal`` [*L, n_goals]
and the step count ``steps`` [*L] (int32).  The JAX module steps one
instance and is ``vmap``-ed; here every tensor carries the instances'
leading shape L (any, [] included).  Physics (``core.py:116-196``): the
soft-contact force between colliding entity pairs, summed over the
other entities in index order, applied to movable entities, damped
Euler velocity with a max-speed clamp.  Communication is a one-hot
symbol (index path, ``mpe_step``) or a continuous vector (multi-head
path, ``mpe_step_multihead``, whose one-hot movement head keeps
upstream's swapped direction pairs: h[1] is +x where index 1 is -x).

Upstream quirks kept (each with a test): ``simple_spread`` counts an
agent as colliding with itself (``_collide_mat`` has no identity
exclusion), and ``simple_world_comm``'s good agents earn +0.05 times
their distance to the nearest food.  Heterogeneous observations are
padded on the right with zeros to the widest (``obs_dims`` the true
lengths).

Reset.  Per instance, in this order, from the draw source
(``mpe.py:205-222``, one key split three ways): agent positions uniform
in [-1, 1) [N, 2], landmark positions uniform in [-r, r) [L, 2] (r the
scenario's ``landmark_range``), and the goal indices in [0, L)
[n_goals] (none where the scenario has none).  ``MPEEnv.draw_reset``
draws them for a whole shape of instances, so a test can feed JAX's.

Rounding.  The operations follow the JAX module's order; square roots
are correctly rounded (``particle_soa.sqrt``: PyTorch's vectorized CPU
``sqrt`` is not in every case), ``logaddexp(0, z)`` is JAX's form
(``particle_soa.logaddexp0``), the one division by a constant divides
by a 0-dim tensor (a CUDA division by a Python scalar multiplies by its
reciprocal), and short sums add in index order (``base.sum_agents``).
Run op by op, JAX rounds the same; compiled XLA contracts ``a*b + c``
into fused multiply-adds, which moves results by ulps.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import torch

from cm3_tpu_torch.envs.base import sum_agents
from cm3_tpu_torch.envs.particle_soa import logaddexp0, sqrt


@dataclasses.dataclass(frozen=True)
class MPEWorld:
    """Static world description.  Entities: agents [0..n_agents), then
    landmarks."""
    n_agents: int
    n_landmarks: int
    size: Tuple[float, ...]        # [E]
    movable: Tuple[bool, ...]      # [E]
    collide: Tuple[bool, ...]      # [E]
    silent: Tuple[bool, ...]       # [N]
    accel: Tuple[float, ...]       # [N] force sensitivity (upstream 5.0)
    max_speed: Tuple[float, ...]   # [N] (<= 0 means unlimited)
    dim_c: int = 0
    dt: float = 0.1
    damping: float = 0.25
    contact_force: float = 1e2
    contact_margin: float = 1e-3

    @property
    def n_entities(self):
        return self.n_agents + self.n_landmarks


@dataclasses.dataclass
class MPEState:
    pos: torch.Tensor     # [*L, E, 2] f32
    vel: torch.Tensor     # [*L, E, 2] f32
    c: torch.Tensor       # [*L, N, max(dim_c, 1)] f32 (zeros when silent)
    goal: torch.Tensor    # [*L, n_goals] i64 (n_goals may be 0)
    steps: torch.Tensor   # [*L] i32


@functools.lru_cache(maxsize=None)
def _consts(world: MPEWorld, device: torch.device):
    """The world's per-entity tables as tensors on ``device``, made once
    per world and device (no host-to-device copy at a step)."""
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=device)
    e = world.n_entities
    size = f32(world.size)
    collide = torch.tensor(world.collide, device=device)
    eye = torch.eye(e, dtype=torch.bool, device=device)
    return dict(
        size=size, dist_min=size[:, None] + size[None, :], eye=eye,
        pair=collide[:, None] & collide[None, :] & ~eye,
        margin=f32(world.contact_margin),
        movable=torch.tensor(world.movable, device=device)[:, None],
        silent=torch.tensor(world.silent, device=device)[:, None],
        accel=f32(world.accel)[:, None],
        vmax=torch.cat([f32(world.max_speed),
                        torch.zeros(world.n_landmarks,
                                    device=device)])[:, None])


def _sqsum(x):
    """The sum of squares over the last axis (of 2): x0^2 + x1^2."""
    x = x * x
    return x[..., 0] + x[..., 1]


def _dist(a, b):
    return sqrt(_sqsum(a - b))


def _pair_deltas(pos):
    """(pos_a - pos_b [*L, a, b, 2], its length [*L, a, b])."""
    delta = pos[..., :, None, :] - pos[..., None, :, :]
    return delta, sqrt(_sqsum(delta))


def _pair_forces(world: MPEWorld, pos):
    """Soft-contact forces on each entity, [*L, E, 2] (core.py:143-196):
    the force on a summed over b in index order."""
    k = _consts(world, pos.device)
    delta, dist = _pair_deltas(pos)
    safe = torch.where(k["eye"], 1.0, dist)
    pen = logaddexp0(-(dist - k["dist_min"]) / k["margin"]) \
        * world.contact_margin
    f = world.contact_force * delta / safe[..., None] * pen[..., None]
    f = torch.where(k["pair"][..., None], f, 0.0)
    return sum_agents(f, dim=-2)


def _integrate(world: MPEWorld, state: MPEState, u, c) -> MPEState:
    """Agent control forces ``u`` [*L, N, 2] (scaled by accel) plus the
    contact forces -> damped velocity, max-speed clamp, position
    (core.py:165-196); ``c`` [*L, N, dim_c] with silent agents zeroed."""
    k = _consts(world, state.pos.device)
    lead = state.pos.shape[:-2]
    pad = torch.zeros(lead + (world.n_landmarks, 2), device=u.device)
    force = torch.cat([u, pad], dim=-2) + _pair_forces(world, state.pos)
    vel = state.vel * (1.0 - world.damping) + force * world.dt
    speed = sqrt(_sqsum(vel))[..., None]
    vmax = k["vmax"]
    vel = torch.where((vmax > 0) & (speed > vmax),
                      vel / torch.clamp_min(speed, 1e-12) * vmax, vel)
    vel = torch.where(k["movable"], vel, state.vel)
    pos = torch.where(k["movable"], state.pos + vel * world.dt, state.pos)
    if world.dim_c > 0:
        c = torch.where(k["silent"], 0.0, c)
    else:
        c = state.c
    return MPEState(pos=pos, vel=vel, c=c, goal=state.goal,
                    steps=state.steps + 1)


def _one_hot(x, n):
    """float32 one-hot of n classes (a row of zeros out of range)."""
    return (x.long()[..., None] == torch.arange(n, device=x.device)).float()


def mpe_step(world: MPEWorld, state: MPEState, move, comm=None) -> MPEState:
    """One physics step.  ``move`` [*L, N] in 0..4 (noop/-x/+x/-y/+y,
    environment.py:194-214); ``comm`` [*L, N] a symbol (ignored for
    silent agents and where dim_c is 0)."""
    k = _consts(world, state.pos.device)
    a = move.to(state.pos.device)
    ux = (a == 2).float() - (a == 1).float()
    uy = (a == 4).float() - (a == 3).float()
    u = torch.stack([ux, uy], dim=-1) * k["accel"]
    if world.dim_c > 0:
        cm = torch.zeros_like(a) if comm is None else comm.to(a.device)
        c = _one_hot(cm, world.dim_c)
    else:
        c = state.c
    return _integrate(world, state, u, c)


def mpe_step_multihead(world: MPEWorld, state: MPEState, move_hot,
                       comm_vec=None) -> MPEState:
    """Multi-head actions (multi_discrete.py:1-45, environment.py:
    177-225): the movement head a one-hot (or soft) 5-vector composed
    as u = [h1 - h2, h3 - h4] * accel (upstream's pairs, swapped against
    the index path's), the comm head a continuous [*L, N, dim_c] vector
    passed into ``c``; an exact one-hot with the pairs swapped gives
    ``mpe_step``'s state bit for bit."""
    k = _consts(world, state.pos.device)
    h = move_hot.to(state.pos.device, torch.float32)
    u = torch.stack([h[..., 1] - h[..., 2], h[..., 3] - h[..., 4]],
                    dim=-1) * k["accel"]
    if world.dim_c > 0 and comm_vec is not None:
        c = comm_vec.to(h.device, torch.float32)
    elif world.dim_c > 0:
        c = torch.zeros(h.shape[:-1] + (world.dim_c,), device=h.device)
    else:
        c = state.c
    return _integrate(world, state, u, c)


def _bound_penalty(x):
    """Out-of-bounds penalty curve (simple_tag.py:104-110)."""
    return torch.where(x < 0.9, 0.0,
                       torch.where(x < 1.0, (x - 0.9) * 10.0,
                                   torch.clamp_max(torch.exp(2.0 * x - 2.0),
                                                   10.0)))


def _flat(x):
    """[*L, k, d] -> [*L, k * d]."""
    return x.reshape(x.shape[:-2] + (-1,))


def _pad_cat(rows, width):
    """Per-agent lists of [*L, k] pieces -> [*L, N, width], each row the
    concatenation padded with zeros on the right."""
    out = []
    for r in rows:
        v = torch.cat(r, dim=-1)
        out.append(torch.nn.functional.pad(v, (0, width - v.shape[-1])))
    return torch.stack(out, dim=-2)


def _pick(rows, idx):
    """rows [*L, K, d], idx [*L] -> rows[..., idx, :] [*L, d] (JAX's
    one-hot product: exact, one term nonzero)."""
    sel = idx.long()[..., None, None].expand(idx.shape + (1, rows.shape[-1]))
    return torch.gather(rows, -2, sel)[..., 0, :]


def _others(n, i):
    return [j for j in range(n) if j != i]


class Scenario:
    """Base: subclasses define ``world``, ``obs_dims``, ``reward`` and
    ``obs`` over batched states."""
    name: str = ""
    world: MPEWorld
    obs_dims: Tuple[int, ...]
    landmark_range: float = 1.0     # reset range for landmark positions
    n_goals: int = 0

    def __init__(self, device="cuda"):
        self.device = torch.device(device)

    def draw_reset(self, shape, draws):
        """The reset's draws for ``shape`` instances, in order: agent
        positions [*shape, N, 2] in [-1, 1), landmark positions [*shape,
        L, 2] in [-r, r), goals [*shape, n_goals] in [0, L)."""
        w, r, shape = self.world, self.landmark_range, tuple(shape)
        d = dict(agents=draws.uniform(shape + (w.n_agents, 2), -1.0, 1.0),
                 landmarks=draws.uniform(shape + (w.n_landmarks, 2), -r, r))
        if self.n_goals:
            d["goal"] = draws.randint(shape + (self.n_goals,), w.n_landmarks)
        return d

    def reset(self, d) -> MPEState:
        """Fresh episodes from ``draw_reset``'s dict (``mpe.py:205-221``)."""
        w = self.world
        pos = torch.cat([d["agents"], d["landmarks"]], dim=-2).to(
            self.device, torch.float32)
        lead = pos.shape[:-2]
        goal = d.get("goal")
        goal = (torch.zeros(lead + (0,), dtype=torch.int64,
                            device=self.device) if goal is None
                else goal.to(self.device, torch.int64))
        return MPEState(
            pos=pos, vel=torch.zeros_like(pos),
            c=torch.zeros(lead + (w.n_agents, max(w.dim_c, 1)),
                          device=self.device),
            goal=goal, steps=torch.zeros(lead, dtype=torch.int32,
                                         device=self.device))

    def _lm(self, state):
        return state.pos[..., self.world.n_agents:, :]

    def _apos(self, state):
        return state.pos[..., :self.world.n_agents, :]

    def _collide_mat(self, state):
        """[*L, E, E] bool: dist < size_i + size_j (scenario
        ``is_collision``, with NO identity exclusion: the upstream
        self-collision quirk)."""
        _, d = _pair_deltas(state.pos)
        return d < _consts(self.world, state.pos.device)["dist_min"]


def _w(n_agents, n_landmarks, *, size_a=0.05, size_l=0.05, collide_a=False,
       collide_l=False, movable_l=False, silent=True, dim_c=0, accel=5.0,
       max_speed=0.0, **kw):
    na, nl = n_agents, n_landmarks
    tup = lambda v, k: tuple(v if not isinstance(v, (tuple, list))
                             else v[i] for i in range(k))
    return MPEWorld(
        n_agents=na, n_landmarks=nl,
        size=tup(size_a, na) + tup(size_l, nl),
        movable=(True,) * na + tup(movable_l, nl),
        collide=tup(collide_a, na) + tup(collide_l, nl),
        silent=tup(silent, na), accel=tup(accel, na),
        max_speed=tup(max_speed, na), dim_c=dim_c, **kw)


class Simple(Scenario):
    """simple.py: 1 agent seeks 1 landmark; r = -dist^2."""
    name = "simple"
    world = _w(1, 1)
    obs_dims = (4,)

    def reward(self, state):
        return -_sqsum(state.pos[..., 0, :] - state.pos[..., 1, :])[..., None]

    def obs(self, state):
        return torch.cat([state.vel[..., 0, :],
                          state.pos[..., 1, :] - state.pos[..., 0, :]],
                         dim=-1)[..., None, :]


class SimpleSpread(Scenario):
    """simple_spread.py: 3 agents cover 3 landmarks; shared -min-dist
    per landmark; -1 per 'collision' INCLUDING self (upstream quirk)."""
    name = "simple_spread"
    world = _w(3, 3, size_a=0.15, collide_a=True, dim_c=2)
    obs_dims = (18, 18, 18)

    def reward(self, state):
        a, l = self._apos(state), self._lm(state)
        d = _dist(a[..., :, None, :], l[..., None, :, :])      # [agent, lm]
        cover = -sum_agents(d.amin(dim=-2))
        coll = self._collide_mat(state)[..., :3, :3]
        return cover[..., None] - coll.sum(dim=-1).float()

    def obs(self, state):
        a, l, v = self._apos(state), self._lm(state), state.vel[..., :3, :]
        rows = []
        for i in range(3):
            oth = _others(3, i)
            ai = a[..., i:i + 1, :]
            rows.append([v[..., i, :], a[..., i, :], _flat(l - ai),
                         _flat(a[..., oth, :] - ai),
                         _flat(state.c[..., oth, :])])
        return _pad_cat(rows, 18)


class SimpleAdversary(Scenario):
    """simple_adversary.py: agent 0 is the adversary; 2 good agents, 2
    landmarks, one secret goal."""
    name = "simple_adversary"
    n_goals = 1
    world = _w(3, 2, size_a=0.15, size_l=0.08, dim_c=2)
    obs_dims = (8, 10, 10)

    def reward(self, state):
        l, a = self._lm(state), self._apos(state)
        goal = _pick(l, state.goal[..., 0])
        d_good = _dist(a[..., 1:, :], goal[..., None, :])        # [2]
        d_adv = _dist(a[..., 0, :], goal)
        good_rew = -d_good.amin(dim=-1) + d_adv
        adv_rew = -_sqsum(a[..., 0, :] - goal)
        return torch.cat([adv_rew[..., None],
                          good_rew[..., None].expand(good_rew.shape + (2,))],
                         dim=-1)

    def obs(self, state):
        a, l = self._apos(state), self._lm(state)
        goal = _pick(l, state.goal[..., 0])
        a0 = a[..., 0, :]
        rows = [[_flat(l - a0[..., None, :]), a[..., 1, :] - a0,
                 a[..., 2, :] - a0]]
        for i in (1, 2):
            ai = a[..., i:i + 1, :]
            rows.append([goal - a[..., i, :], _flat(l - ai),
                         _flat(a[..., _others(3, i), :] - ai)])
        return _pad_cat(rows, 10)


# landmark colors (simple_push.py:35-49)
_PUSH_LM_COLORS = (0.1, 0.9, 0.1, 0.1, 0.1, 0.9)


class SimplePush(Scenario):
    """simple_push.py: adversary 0 pushes good agent 1 away from its
    goal landmark."""
    name = "simple_push"
    n_goals = 1
    world = _w(2, 2, collide_a=True, dim_c=2)
    obs_dims = (8, 19)

    def reward(self, state):
        a, l = self._apos(state), self._lm(state)
        goal = _pick(l, state.goal[..., 0])
        good = -_dist(a[..., 1, :], goal)
        adv = _dist(a[..., 1, :], goal) - _dist(a[..., 0, :], goal)
        return torch.stack([adv, good], dim=-1)

    def obs(self, state):
        a, l, v = self._apos(state), self._lm(state), state.vel[..., :2, :]
        onehot = _one_hot(state.goal[..., 0], 2)
        goal = _pick(l, state.goal[..., 0])
        # the good agent's color: 0.25 + 0.5 * the goal's one-hot in
        # channels 1: (simple_push.py:35-49)
        color = 0.25 + torch.cat([torch.zeros_like(onehot[..., :1]),
                                  onehot * 0.5], dim=-1)
        lm_colors = torch.tensor(_PUSH_LM_COLORS, device=a.device).expand(
            a.shape[:-2] + (6,))
        a0, a1 = a[..., 0, :], a[..., 1, :]
        rows = [
            [v[..., 0, :], _flat(l - a0[..., None, :]), a1 - a0],
            [v[..., 1, :], goal - a1, color, _flat(l - a1[..., None, :]),
             lm_colors, a0 - a1],
        ]
        return _pad_cat(rows, 19)


class SimpleTag(Scenario):
    """simple_tag.py: 3 slower adversaries (0..2) chase 1 faster good
    agent (3) among 2 solid obstacles."""
    name = "simple_tag"
    world = _w(4, 2, size_a=(0.075, 0.075, 0.075, 0.05), size_l=0.2,
               collide_a=True, collide_l=True, dim_c=2,
               accel=(3.0, 3.0, 3.0, 4.0), max_speed=(1.0, 1.0, 1.0, 1.3))
    obs_dims = (16, 16, 16, 14)
    landmark_range = 0.9

    def reward(self, state):
        coll = self._collide_mat(state)
        # (good, adversary) collision pairs; the good agent is 3
        n_hit = sum_agents(coll[..., 3, :3].float())
        adv_rew = 10.0 * n_hit                     # per adversary
        a = self._apos(state)
        bound = sum_agents(_bound_penalty(a[..., 3, :].abs()))
        good_rew = -10.0 * n_hit - bound
        return torch.cat([adv_rew[..., None].expand(adv_rew.shape + (3,)),
                          good_rew[..., None]], dim=-1)

    def obs(self, state):
        a, l, v = self._apos(state), self._lm(state), state.vel[..., :4, :]
        rows = []
        for i in range(4):
            ai = a[..., i:i + 1, :]
            r = [v[..., i, :], a[..., i, :], _flat(l - ai),
                 _flat(a[..., _others(4, i), :] - ai)]
            if i != 3:                 # others' velocity: the good agent's
                r.append(v[..., 3, :])
            rows.append(r)
        return _pad_cat(rows, 16)


_REF_LM_COLORS = ((0.75, 0.25, 0.25), (0.25, 0.75, 0.25), (0.25, 0.25, 0.75))


class SimpleReference(Scenario):
    """simple_reference.py: each agent must guide the OTHER to a secret
    landmark via a 10-symbol channel; r_i = -dist^2(other, my target)."""
    name = "simple_reference"
    n_goals = 2
    world = _w(2, 3, silent=False, dim_c=10)
    obs_dims = (21, 21)

    def reward(self, state):
        a, l = self._apos(state), self._lm(state)
        g0, g1 = (_pick(l, state.goal[..., i]) for i in range(2))
        # agent i's goal agent is the OTHER one
        return -torch.stack([_sqsum(a[..., 1, :] - g0),
                             _sqsum(a[..., 0, :] - g1)], dim=-1)

    def obs(self, state):
        a, l, v = self._apos(state), self._lm(state), state.vel[..., :2, :]
        table = torch.tensor(_REF_LM_COLORS, device=a.device).expand(
            a.shape[:-2] + (3, 3))
        colors = [_pick(table, state.goal[..., i]) for i in range(2)]
        rows = [[v[..., 0, :], _flat(l - a[..., 0:1, :]), colors[0],
                 state.c[..., 1, :]],
                [v[..., 1, :], _flat(l - a[..., 1:2, :]), colors[1],
                 state.c[..., 0, :]]]
        return _pad_cat(rows, 21)


_SL_LM_COLORS = ((0.65, 0.15, 0.15), (0.15, 0.65, 0.15), (0.15, 0.15, 0.65))


class SimpleSpeakerListener(Scenario):
    """simple_speaker_listener.py: immobile speaker (0) names the goal
    landmark; silent listener (1) must reach it.  Shared reward."""
    name = "simple_speaker_listener"
    n_goals = 1
    # the speaker is immovable (simple_speaker_listener.py:19)
    world = dataclasses.replace(
        _w(2, 3, size_a=0.075, size_l=0.04, silent=(False, True), dim_c=3),
        movable=(False, True) + (False,) * 3)
    obs_dims = (3, 11)

    def reward(self, state):
        a, l = self._apos(state), self._lm(state)
        r = -_sqsum(a[..., 1, :] - _pick(l, state.goal[..., 0]))
        return r[..., None].expand(r.shape + (2,))

    def obs(self, state):
        a, l, v = self._apos(state), self._lm(state), state.vel[..., :2, :]
        table = torch.tensor(_SL_LM_COLORS, device=a.device).expand(
            a.shape[:-2] + (3, 3))
        rows = [[_pick(table, state.goal[..., 0])],
                [v[..., 1, :], _flat(l - a[..., 1:2, :]), state.c[..., 0, :]]]
        return _pad_cat(rows, 11)


class SimpleCrypto(Scenario):
    """simple_crypto.py: speaker (2) broadcasts the goal color encrypted
    with a shared key; listener (1) must reconstruct it, adversary (0)
    eavesdrops.  All agents immobile; the game is pure communication.
    goal[0] = goal landmark, goal[1] = key landmark."""
    name = "simple_crypto"
    n_goals = 2
    world = dataclasses.replace(_w(3, 2, dim_c=4, silent=(False,) * 3),
                                movable=(False,) * 5)
    obs_dims = (4, 8, 8)

    @staticmethod
    def _lm_color(idx):
        # landmark i's color = one-hot(i) in dim_c (simple_crypto.py:54-58)
        return _one_hot(idx, 4)

    def reward(self, state):
        goal_color = self._lm_color(state.goal[..., 0])
        c = state.c
        active = lambda i: (c[..., i, :] != 0.0).any(dim=-1)
        err = lambda i: sum_agents((c[..., i, :] - goal_color)
                                   * (c[..., i, :] - goal_color))
        good = torch.where(active(1), -err(1), 0.0) \
            + torch.where(active(0), err(0), 0.0)
        adv = torch.where(active(0), -err(0), 0.0)
        return torch.stack([adv, good, good], dim=-1)

    def obs(self, state):
        goal_color = self._lm_color(state.goal[..., 0])
        key = self._lm_color(state.goal[..., 1])
        comm = state.c[..., 2, :]                # only the speaker's c
        rows = [[comm],                          # adversary
                [key, comm],                     # good listener
                [goal_color, key]]               # speaker
        return _pad_cat(rows, 8)


class SimpleWorldComm(Scenario):
    """simple_world_comm.py: 4 adversaries (0 = speaking leader) hunt 2
    good agents among 1 obstacle, 2 food cells, 2 hiding forests."""
    name = "simple_world_comm"
    world = _w(6, 5, size_a=(0.075,) * 4 + (0.045,) * 2,
               size_l=(0.2, 0.03, 0.03, 0.3, 0.3), collide_a=True,
               collide_l=(True, False, False, False, False), dim_c=4,
               silent=(False,) + (True,) * 5, accel=(3.0,) * 4 + (4.0,) * 2,
               max_speed=(1.0,) * 4 + (1.3,) * 2)
    obs_dims = (34, 34, 34, 34, 28, 28)
    landmark_range = 0.9

    def reward(self, state):
        coll = self._collide_mat(state)
        a = self._apos(state)
        # (good, adversary) collisions, totalled over every pair
        pair_hits = coll[..., 4:6, :4].float().sum(dim=(-2, -1))
        rews = []
        d_ga = _dist(a[..., 4:6, None, :], a[..., None, :4, :])  # [good, adv]
        for i in range(4):                                  # adversaries
            shape = -0.1 * d_ga[..., :, i].amin(dim=-1)
            rews.append(shape + 5.0 * pair_hits)
        food = state.pos[..., 7:9, :]
        for g in range(2):                                  # good agents
            i = 4 + g
            hit_adv = sum_agents(coll[..., i, :4].float())
            bound = sum_agents(_bound_penalty(a[..., i, :].abs()))
            d_food = _dist(food, a[..., i:i + 1, :])
            on_food = sum_agents(coll[..., i, 7:9].float())
            rews.append(-5.0 * hit_adv - 2.0 * bound + 2.0 * on_food
                        + 0.05 * d_food.amin(dim=-1))
        return torch.stack(rews, dim=-1)

    def obs(self, state):
        a, v = self._apos(state), state.vel[..., :6, :]
        lm = state.pos[..., 6:, :]                          # 5 landmarks
        coll = self._collide_mat(state)
        in_f = coll[..., :6, 9:11]                          # [6, 2] bool
        in_f_obs = torch.where(in_f, 1.0, -1.0)
        any_f = in_f.any(dim=-1)                            # [6]
        comm = state.c[..., 0, :]                           # leader only
        rows = []
        for i in range(6):
            oth = _others(6, i)
            vis = []
            for j in oth:
                same_forest = (in_f[..., i, 0] & in_f[..., j, 0]) \
                    | (in_f[..., i, 1] & in_f[..., j, 1])
                neither = ~any_f[..., i] & ~any_f[..., j]
                vis.append(same_forest | neither | (i == 0))
            vis = torch.stack(vis, dim=-1)                  # [5]
            ai = a[..., i:i + 1, :]
            other_pos = torch.where(vis[..., None], a[..., oth, :] - ai, 0.0)
            good_oth = [j for j in oth if j >= 4]
            gsel = [oth.index(j) for j in good_oth]
            other_vel = torch.where(vis[..., gsel, None], v[..., good_oth, :],
                                    0.0)
            r = [v[..., i, :], a[..., i, :], _flat(lm - ai),
                 _flat(other_pos)]
            if i < 4:      # adversaries (the leader too): vel, forest, comm
                r += [_flat(other_vel), in_f_obs[..., i, :], comm]
            else:          # good: the forest flags BEFORE other_vel, no comm
                r += [in_f_obs[..., i, :], _flat(other_vel)]
            rows.append(r)
        return _pad_cat(rows, 34)


SCENARIOS = {s.name: s for s in (Simple, SimpleSpread, SimpleAdversary,
                                 SimplePush, SimpleTag, SimpleReference,
                                 SimpleSpeakerListener, SimpleCrypto,
                                 SimpleWorldComm)}


class MPEEnv:
    """A scenario's episodes, batched over a leading shape:
    ``reset(draws)`` / ``step(state, move[, comm])`` -> (state, (obs
    [*L, N, max(obs_dims)], reward [*L, N], done [*L])).  Episodes cap at
    ``max_steps`` (upstream caps them outside; the world never ends)."""

    def __init__(self, scenario_name: str, max_steps: int = 25,
                 device="cuda"):
        self.scenario = SCENARIOS[scenario_name](device)
        self.max_steps = max_steps
        self.device = self.scenario.device

    def draw_reset(self, shape, draws):
        return self.scenario.draw_reset(shape, draws)

    def _out(self, s: MPEState, done):
        return s, (self.scenario.obs(s), self.scenario.reward(s), done)

    def reset(self, d):
        """Fresh episodes from ``draw_reset``'s dict of draws."""
        s = self.scenario.reset(d)
        return self._out(s, torch.zeros_like(s.steps, dtype=torch.bool))

    def step(self, state: MPEState, move, comm: Optional[torch.Tensor] = None):
        s = mpe_step(self.scenario.world, state, move, comm)
        return self._out(s, s.steps >= self.max_steps)

    def step_multihead(self, state: MPEState, move_hot, comm_vec=None):
        """Multi-head actions: a one-hot (or soft) force head and a
        continuous comm head (``mpe_step_multihead``)."""
        s = mpe_step_multihead(self.scenario.world, state, move_hot,
                               comm_vec)
        return self._out(s, s.steps >= self.max_steps)
