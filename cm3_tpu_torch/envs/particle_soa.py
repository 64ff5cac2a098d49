"""Struct-of-arrays particle dynamics: per-agent tensors of any shape.

Port of ``cm3_tpu.envs.particle_soa``.  The dynamics state of the
cooperative-navigation particle game (MPE ``core.py:117-196`` physics
and the ``multi-goal_spread`` rewards) is six float32 per agent
(position, velocity, own landmark) plus a step counter and a collision
counter, and every interaction is a pairwise term over a fixed agent
count.  Agents are unrolled into tuples of same-shaped tensors, as in
the JAX module, so one step is a few hundred elementwise operations on
[B] tensors.  The fused particle rollout (``ops/particle_rollout.py``)
runs the same step per instance in registers; this module is its plain
version's engine.

``soa_init`` is the deterministic reset (config positions, zero
velocity: ``prob_random=0``, ``initial_std=0``), as in the JAX module.

Rounding, so that this module, the CUDA kernel and the JAX module
compute the same float32 values:

* every product and sum is its own eager operation, rounded apart (no
  fused multiply-add);
* square roots are rounded correctly (``sqrt``): PyTorch's vectorized
  CPU ``sqrt`` is not in every case (about 0.7% of uniform inputs in
  [0, 10) come out one ulp off on an AVX-512 build), XLA's and CUDA's
  ``sqrtf`` are;
* ``logaddexp(0, z)`` is written out as JAX computes it,
  ``max(0, z) + log1p(exp(-|0 - z|))``;
* the one division by a constant, ``-(dist - dmin) / k``, divides by a
  0-dim tensor on the operands' device: PyTorch's CUDA ``div`` by a
  Python scalar multiplies by the reciprocal instead, which can differ
  by one ulp.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from cm3_tpu_torch.core.config import ParticleEnvConfig

REACH = 0.05      # a goal counts as reached within this distance


class SoaState(NamedTuple):
    """Per-agent tuples of same-shaped tensors (any shape)."""
    px: tuple         # f32 position x
    py: tuple         # f32 position y
    vx: tuple         # f32 velocity x
    vy: tuple         # f32 velocity y
    lx: tuple         # f32 own-landmark x
    ly: tuple         # f32 own-landmark y
    steps: tuple      # (single,) i32 episode step counter
    coll: tuple       # (single,) i32 cumulative ordered colliding pairs


def sqrt(x):
    """Correctly rounded float32 square root on every device: the
    float64 root rounded to float32 (53 >= 2 x 24 + 2 bits, so the
    double rounding is exact)."""
    return torch.sqrt(x.double()).float()


def logaddexp0(z):
    """``logaddexp(0, z)`` in JAX's form (``jax._src.lax.other``)."""
    return torch.clamp_min(z, 0.0) + torch.log1p(torch.exp(-(0.0 - z).abs()))


def soa_step(cfg: ParticleEnvConfig, s: SoaState, actions):
    """One physics step.  Returns (state', rewards tuple, done)."""
    n = cfg.n_agents
    dmin = 2 * cfg.agent_size
    k = torch.full((), cfg.contact_margin, dtype=torch.float32,
                   device=s.px[0].device)

    # --- forces: discrete action thrust + soft-contact pair forces ---
    px, py, vx, vy = [], [], [], []
    for i in range(n):
        a = actions[i]
        fx = ((a == 2).float() - (a == 1).float()) * cfg.accel
        fy = ((a == 4).float() - (a == 3).float()) * cfg.accel
        for j in range(n):
            if j == i:
                continue
            dx = s.px[i] - s.px[j]
            dy = s.py[i] - s.py[j]
            dist = sqrt(dx * dx + dy * dy)
            pen = logaddexp0(-(dist - dmin) / k) * cfg.contact_margin
            scale = cfg.contact_force * pen / dist
            fx = fx + dx * scale
            fy = fy + dy * scale
        nvx = s.vx[i] * (1.0 - cfg.damping) + fx * cfg.dt
        nvy = s.vy[i] * (1.0 - cfg.damping) + fy * cfg.dt
        vx.append(nvx)
        vy.append(nvy)
        px.append(s.px[i] + nvx * cfg.dt)
        py.append(s.py[i] + nvy * cfg.dt)

    # --- rewards on post-move positions ---
    rewards, reached = [], []
    n_coll_total = None
    for i in range(n):
        gx = px[i] - s.lx[i]
        gy = py[i] - s.ly[i]
        d_goal = sqrt(gx * gx + gy * gy)
        reached.append(-d_goal >= -REACH)
        n_coll = None
        for j in range(n):
            if j == i:
                continue
            dx = px[i] - px[j]
            dy = py[i] - py[j]
            c = (sqrt(dx * dx + dy * dy) < dmin).float()
            n_coll = c if n_coll is None else n_coll + c
        if n_coll is None:
            n_coll = torch.zeros_like(d_goal)
        rewards.append(-d_goal - n_coll)
        n_coll_total = n_coll if n_coll_total is None \
            else n_coll_total + n_coll

    steps = s.steps[0] + 1
    done = (steps == cfg.max_steps) | functools.reduce(torch.logical_and,
                                                       reached)
    coll = s.coll[0] + n_coll_total.int()

    s2 = SoaState(px=tuple(px), py=tuple(py), vx=tuple(vx), vy=tuple(vy),
                  lx=s.lx, ly=s.ly, steps=(steps,), coll=(coll,))
    return s2, tuple(rewards), done


def soa_init(cfg: ParticleEnvConfig, shape=(), device="cuda") -> SoaState:
    """Deterministic reset: config agent and landmark positions, zero
    velocity (``Particle.reset`` with prob_random=0, initial_std=0)."""
    n = cfg.n_agents

    def full(v, dtype=torch.float32):
        return torch.full(shape, v, dtype=dtype, device=device)

    return SoaState(
        px=tuple(full(cfg.agents_x[i]) for i in range(n)),
        py=tuple(full(cfg.agents_y[i]) for i in range(n)),
        vx=tuple(full(0.0) for _ in range(n)),
        vy=tuple(full(0.0) for _ in range(n)),
        lx=tuple(full(cfg.landmarks_x[i]) for i in range(n)),
        ly=tuple(full(cfg.landmarks_y[i]) for i in range(n)),
        steps=(full(0, torch.int32),), coll=(full(0, torch.int32),))


def select(done, init: SoaState, cur: SoaState) -> SoaState:
    """The auto-reset: ``init`` where ``done``, else ``cur``."""
    return SoaState(*(tuple(torch.where(done, a, b) for a, b in zip(fa, fb))
                      for fa, fb in zip(init, cur)))
