"""Cooperative-navigation particle game, batched over env instances.

Port of ``cm3_tpu.envs.particle`` (itself the reference's forked MPE
physics, ``multiagent/core.py:117-196``, and its ``multi-goal_spread``
scenario): N agents, each with its own landmark, 5 discrete actions
(0 noop, 1 -x, 2 +x, 3 -y, 4 +y, force 5.0), soft-contact forces
between agent pairs, damped Euler integration, reward -dist(agent, own
landmark) - 1 per colliding other agent, a goal reached within 0.05,
and an episode done at the step cap or once every agent has reached.

The JAX engine steps one instance and is ``vmap``-ed; here every tensor
has a leading env dimension E: positions, velocities and landmarks are
[E, N, 2].

Reset.  Each instance takes four draws, in this order, from the draw
source (``cm3_tpu/envs/particle.py:70-76``): a uniform in [0, 1) that
picks the uniform-random start when below ``prob_random``, uniform
agent positions and uniform landmark positions in [-1, 1) [N, 2], and
standard normal noise [N, 2] on the configured agent positions, scaled
by ``initial_std``.  ``ParticleHooks.episode_init`` draws them for a
whole shape of instances.

Rounding.  The operations follow the JAX engine's order (the contact
force is ``force * delta / dist * pen``, summed over the other agents
in index order; the per-agent reward is summed in agent order), square
roots are correctly rounded (``sqrt``: PyTorch's vectorized CPU
``sqrt`` is not in every case), and ``logaddexp(0, z)`` is written as
JAX computes it (``logaddexp0``); the one division by a constant
divides by a 0-dim tensor on the operands' device (a CUDA division by a
Python scalar multiplies by its reciprocal, which can differ by one
ulp).

For one agent the ``others`` observation is a [1, 4] slot of zeros
(``particle.py:148-149``).  ``collisions`` counts colliding ordered
pairs over the episode (the dual buffer's routing predicate).

``REACH``, ``sqrt`` and ``logaddexp0`` are the port's
``envs/particle_soa.py``'s; the rest of that module (the fused
rollout's struct-of-arrays engine) is left out.
"""

from __future__ import annotations

import dataclasses

import torch

from .config import ParticleEnvConfig
from . import envs_base as base

REACH = 0.05      # a goal counts as reached within this distance


def sqrt(x):
    """Correctly rounded float32 square root on every device: the
    float64 root rounded to float32 (53 >= 2 x 24 + 2 bits, so the
    double rounding is exact)."""
    return torch.sqrt(x.double()).float()


def logaddexp0(z):
    """``logaddexp(0, z)`` in JAX's form (``jax._src.lax.other``)."""
    return torch.clamp_min(z, 0.0) + torch.log1p(torch.exp(-(0.0 - z).abs()))


@dataclasses.dataclass
class ParticleState:
    pos: torch.Tensor         # [E, N, 2] f32
    vel: torch.Tensor         # [E, N, 2] f32
    landmarks: torch.Tensor   # [E, N, 2] f32
    reached: torch.Tensor     # [E, N] bool
    steps: torch.Tensor       # [E] i64
    collisions: torch.Tensor  # [E] i64, colliding ordered pairs so far


class Particle(base.Env):

    def __init__(self, cfg: ParticleEnvConfig, device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        c = cfg
        self._pos0 = torch.tensor(list(zip(c.agents_x, c.agents_y)),
                                  dtype=torch.float32, device=self.device)
        self._lm0 = torch.tensor(list(zip(c.landmarks_x, c.landmarks_y)),
                                 dtype=torch.float32, device=self.device)
        self._eye = torch.eye(c.n_agents, dtype=torch.bool,
                              device=self.device)
        # the one division by a constant, as a tensor on the device (a
        # CUDA division by a Python scalar multiplies by its reciprocal)
        self._margin = torch.full((), c.contact_margin, dtype=torch.float32,
                                  device=self.device)

    def spec(self):
        n = self.cfg.n_agents
        return dict(l_action=5, l_goal=2, l_obs_self=4,
                    l_obs_others=4 * max(n - 1, 1), l_state_one=4,
                    n_agents=n)

    def draw_reset(self, shape, draws):
        """The reset's four draws for ``shape`` instances, in order:
        branch [*shape], agent and landmark positions [*shape, N, 2] in
        [-1, 1), normal noise [*shape, N, 2]."""
        shape = tuple(shape)
        pts = shape + (self.cfg.n_agents, 2)
        return dict(branch=draws.uniform(shape),
                    agents=draws.uniform(pts, -1.0, 1.0),
                    landmarks=draws.uniform(pts, -1.0, 1.0),
                    noise=draws.normal(pts))

    # ------------------------------------------------------------------ #

    def reset(self, d):
        """Fresh episodes for E instances from ``draw_reset``'s dict of
        [E, ...] draws (``particle.py:64-91``)."""
        c = self.cfg
        d = {k: v.to(self.device, torch.float32) for k, v in d.items()}
        e, n = d["agents"].shape[0], c.n_agents
        uniform_all = (d["branch"] < c.prob_random)[:, None, None]
        pos_cfg = self._pos0 + c.initial_std * d["noise"]
        state = ParticleState(
            pos=torch.where(uniform_all, d["agents"], pos_cfg),
            vel=torch.zeros((e, n, 2), device=self.device),
            landmarks=torch.where(uniform_all, d["landmarks"],
                                  self._lm0.expand(e, n, 2)),
            reached=torch.zeros((e, n), dtype=torch.bool,
                                device=self.device),
            steps=torch.zeros(e, dtype=torch.int64, device=self.device),
            collisions=torch.zeros(e, dtype=torch.int64,
                                   device=self.device))
        ts = base.TimeStep(
            obs=self._observe(state), state=self._global_state(state),
            reward=torch.zeros(e, device=self.device),
            reward_local=torch.zeros((e, n), device=self.device),
            done=torch.zeros(e, dtype=torch.bool, device=self.device))
        return state, ts

    # ------------------------------------------------------------------ #

    def _dist(self, pos):
        """(delta [E, i, j, 2] = pos_i - pos_j, dist [E, i, j])."""
        delta = pos[:, :, None, :] - pos[:, None, :, :]
        sq = delta * delta
        return delta, sqrt(sq[..., 0] + sq[..., 1])

    def _pair_forces(self, pos):
        """Soft-contact collision forces, [E, N, 2] (core.py:143-196)."""
        c = self.cfg
        delta, dist = self._dist(pos)
        safe = torch.where(self._eye, 1.0, dist)
        pen = logaddexp0(-(dist - 2 * c.agent_size) / self._margin) \
            * c.contact_margin
        f = c.contact_force * delta / safe[..., None] * pen[..., None]
        f = torch.where(self._eye[..., None], 0.0, f)
        out = f[:, :, 0]
        for j in range(1, c.n_agents):
            out = out + f[:, :, j]
        return out

    def step(self, state: ParticleState, actions):
        """One lockstep transition; ``actions`` is [E, N] in 0..4."""
        c = self.cfg
        a = actions.to(self.device, torch.int64)
        ux = (a == 2).float() - (a == 1).float()
        uy = (a == 4).float() - (a == 3).float()
        u = torch.stack([ux, uy], dim=-1) * c.accel

        force = u + self._pair_forces(state.pos)
        vel = state.vel * (1.0 - c.damping) + force * c.dt
        pos = state.pos + vel * c.dt

        # rewards (multi-goal_spread.py:121-138)
        g = pos - state.landmarks
        g = g * g
        d_goal = sqrt(g[..., 0] + g[..., 1])                        # [E, N]
        reached = -d_goal >= -REACH
        _, dist = self._dist(pos)
        colliding = (dist < 2 * c.agent_size) & ~self._eye
        n_coll = colliding.sum(dim=2)
        rl = -d_goal - n_coll.float()

        steps = state.steps + 1
        done = (steps == c.max_steps) | reached.all(dim=1)
        new_state = ParticleState(
            pos=pos, vel=vel, landmarks=state.landmarks, reached=reached,
            steps=steps, collisions=state.collisions + n_coll.sum(dim=1))
        ts = base.TimeStep(
            obs=self._observe(new_state), state=self._global_state(new_state),
            reward=base.sum_agents(rl), reward_local=rl, done=done)
        return new_state, ts

    # ------------------------------------------------------------------ #

    def _observe(self, state: ParticleState):
        """self_v [E, N, 4] = (vel, pos); others [E, N, 4(N-1)], row i
        the concat over j != i of (vel_j - vel_i, pos_j - pos_i)."""
        n = self.cfg.n_agents
        self_v = torch.cat([state.vel, state.pos], dim=-1)
        if n == 1:
            others = torch.zeros_like(self_v)
        else:
            rel = torch.cat(
                [state.vel[:, None, :, :] - state.vel[:, :, None, :],
                 state.pos[:, None, :, :] - state.pos[:, :, None, :]],
                dim=-1)                                   # [E, i, j, 4]
            others = torch.stack(
                [torch.cat([rel[:, i, j] for j in range(n) if j != i],
                           dim=-1) for i in range(n)], dim=1)
        return dict(others=others, self_v=self_v)

    def _global_state(self, state: ParticleState):
        return dict(vec=torch.cat([state.vel, state.pos], dim=-1))
