"""Fused random-policy particle rollout: a whole trajectory per thread.

Replaces the Pallas kernel of ``cm3_tpu/ops/particle_rollout.py``
(``pl.pallas_call`` at line 64 in ``_pallas``, called by
``rollout_prng`` at line 87 and ``rollout_actions`` at line 100;
kernel body ``_body`` at line 35).  For B instances of the
struct-of-arrays particle game (``envs/particle_soa.py``: cooperative
navigation with MPE soft-contact physics) it runs T steps of a uniform
random policy with auto-reset and returns only the reward sum
(float32 [B]) and the episode count (int32 [B]) of each instance:
``bench.py``'s ``particle_fused_env_steps_per_s`` program.

Kernel: ``cm3_tpu_torch/csrc/particle_rollout.cu``, CUDA C++ for
``sm_90a``, built by ``ops/_nvcc.py``.

Bound on an H100.  The outputs are 8 bytes per instance and the Philox
variant reads nothing, so bytes are no limit.  The work is instruction
issue, and the special-function unit (MUFU) takes part of it.  Counted
are the operations whose results the outputs need, at the steps where
they need them, in single instructions of the card.  An IEEE ``sqrtf``
or division is 8 (one MUFU reciprocal or reciprocal square root, the
Newton steps, the range test and its branch), ``expf`` 8 (one MUFU
``ex2``), ``log1pf`` 20 (a polynomial, no MUFU), their fast paths as
the CUDA math library writes them.  With N = 4 agents and Philox draws:

Every step, 293 operations, 4 of them MUFU:

* Philox4x32-10, counter (t, b, 0, 0), key schedule hoisted, all four
  output words used: 36 (round 1 one wide multiply, round 2 three
  since b's product is the same every step, rounds 3-10 four each:
  2 wide multiplies and 2 three-input XORs).
* the actions ``(w >> 7) % 5``: 4 x 4 = 16.
* the contact force's far test, per unordered pair (6; the pair (j, i)
  is the negation of (i, j)): dx, dy 2, the squared distance 3, its
  compare with the one beyond which ``pen`` is exactly 0 (``expf``
  underflows past z = -104: with the default margin, 0.104 beyond
  dmin) 1: 6 x 6 = 36.
* per agent (4): thrust 8 (two compares, two selects per axis); the
  damped velocity 2 x 3; the move 2 x 2: 18 x 4 = 72.
* the collision test on the new positions, per unordered pair (6):
  dx, dy 2, the squared distance 3, the compare 1: 6 x 6 = 36.  A
  correctly rounded ``sqrtf`` is monotone, so ``sqrt(d2) < dmin`` is
  ``d2 < t`` for one float t per config: no root.
* per agent reward (4): the landmark distance 5 + sqrt 8; reached 2
  (compare, AND); the collision count 5 (3 selects, 2 adds); the
  reward 1; the sum over agents 1: 22 x 4 = 88.
* per step, 9: the reward sum, the step count, the done test (2), the
  episode count, the reset's branch, the loop's increment, compare and
  branch.

Per pair whose contact force is not exactly 0 (``pen != 0``), 64 more,
4 of them MUFU: the distance's sqrt 8; z 1 + division 8;
``logaddexp(0, z)`` 3 + exp 8 + log1p 20; pen 1; scale 1 + division 8;
the two force terms 2; their adds into both agents' sums 4.

Per reset (done), 17: the 16 floats of the reset state and the step
count.

A call of B instances and T steps with C such pairs and E resets needs
``293 B T + 64 C + 17 E`` operations, ``4 B T + 4 C`` of them MUFU,
and its two limits are

    issue:  operations / (SMs x 4 warp-instructions per clock x 32 x clock)
    MUFU:   MUFU operations / (SMs x 16 lanes per clock x clock)

with the SM clock from ``nvidia-smi --query-gpu=clocks.max.sm``.
``chip_smoke.py`` counts C with the plain version's ``observe`` at the
bench call's inputs, E from the kernel's own episode counts, and
computes both limits in each run.  There the agents start in the
corners, 1.8 apart where contact begins at 0.3, and a random walk
seldom brings two of them near: C and E are small beside B T
(``PERF.md`` has the counts), so the bound is near 293 operations a
step.

Design.  One instance per thread, its whole state in registers:
position and velocity of each agent, the step counter, the reward sum
and the episode count; the landmarks and the reset state are kernel
arguments, the same for every instance (the collision counter of the
state never reaches an output and is not carried).  A loop over T
inside the thread (``#pragma unroll 1``) takes the place of the TPU
kernel's ``fori_loop``; the agent and pair loops unroll over a
compile-time N in {1, 2, 4}.  A ragged last block is masked.  Nothing
is read or written in the loop except the fed actions of the test
variant (``actions[t, i, b]``, int32 [T, N, B] as JAX takes them,
coalesced over b).  Each step does the work the bound counts:

* The contact term only for pairs in reach.  Each unordered pair
  (lexicographic order, so that every agent adds its contacts in index
  order as the plain version does) computes dx, dy and the squared
  distance d2, rounded as the plain version rounds them, and branches
  into the term (a square root, two IEEE divisions, ``expf``,
  ``log1pf``) only where ``d2 < far_d2``.  ``far_d2`` (``far_d2()``,
  once per config on the host) is the least float from which the
  plain version's z is at most ``FAR_Z`` = -110, six units beyond
  where ``expf(z)`` is 0 in float32: from there ``pen`` and the force
  terms are exactly +-0, and adding +-0 leaves a force sum unchanged
  (it starts at +0 or +-accel and a rounded sum that cancels is +0,
  never -0).  The force of (j, i) is the negation of (i, j), exact, so
  a near pair adds into both agents' sums in registers.
* The collision test without a square root: ``sqrt(d2) < dmin`` is
  ``d2 < hit_d2`` for the least float ``hit_d2`` (``hit_d2()``: a
  correctly rounded root is monotone, so a bisection over the float
  bit patterns finds it).  The landmark distance keeps its root: the
  reward reads it.
* The reset state is loaded only on done (0.03 instances a step).

A warp pays for a branch any of its lanes takes: with the bench's
start (every instance in the same corners, in lockstep) the share of
warps that take a pair's contact branch is what ``chip_smoke.py``
phase 6 counts, beside the share of instances.  Both thresholds reach
the kernel in ``params`` with the constants.  256 threads per block;
the block size and ``__launch_bounds__``'s least resident blocks per
SM are compile-time settings (``CM3_PARTICLE_THREADS``,
``CM3_PARTICLE_MIN_BLOCKS``) that ``scripts/torch_particle_variants.py``
times against each other; ``occupancy()`` reads what the build gives.

The reset state is computed once by the port's own
``particle_soa.soa_init`` and passed as scalars with the config's
constants (``params``), so there is one definition of the reset.

Rounding.  Kernel and plain version compute the same float32 values
step by step: the kernel rounds every product and sum apart
(``__fmul_rn``/``__fadd_rn``, never contracted into a fused
multiply-add, as eager PyTorch runs them), divides in IEEE
(``__fdiv_rn``; the plain version divides by tensors, since PyTorch's
CUDA division by a Python scalar multiplies by the reciprocal) and
takes ``sqrtf``/``expf``/``log1pf`` from the CUDA math library with
no fast math, as PyTorch's CUDA ``sqrt``/``exp``/``log1p`` do.  The
rewards are summed in the JAX kernel's order (``rew + (r0 + r1 + r2 +
r3)``).  PyTorch's CPU ``exp``/``log1p`` and XLA's are other
approximations, so the CPU plain version and JAX agree to an ulp in
the contact terms, not to the bit.

Random numbers.  The TPU kernel seeds its hardware generator with
``seed + program_id * 7919``, which nothing else reproduces.  Here
each step draws Philox4x32-10 (``ops/philox.py``, ``csrc/philox.cuh``)
with key (seed, 0) and counter (t, b, 0, 0); agent i takes word i and
the action ``(word >> 7) % 5``, as in ``particle_rollout.py:30-32``.
The plain version draws the same words; against JAX the PRNG variant
agrees in distribution.

``rollout_prng`` and ``rollout_actions`` take the plain versions for
CPU tensors, launch the kernel for CUDA tensors (or raise), and raise
for any other device.  ``rollout_prng.launches`` and
``rollout_actions.launches`` count kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from cm3_tpu_torch.core.config import ParticleEnvConfig
from cm3_tpu_torch.envs import particle_soa as ps
from cm3_tpu_torch.ops import _nvcc, _rollout
from cm3_tpu_torch.ops.philox import random_actions

AGENTS = (1, 2, 4)          # the agent counts the kernel is built for
MAX_AGENTS = 4
# expf(z) is exactly 0 in float32 below z = ln(2^-150) = -103.97; the
# kernel skips a pair's contact term where z <= FAR_Z, six units beyond
FAR_Z = -110.0
_INF_BITS = 0x7F800000


def _check_agents(n):
    if n not in AGENTS:
        raise ValueError(f"particle_rollout: the kernel takes {AGENTS} "
                         f"agents, not {n}")


def _f32(bits: int):
    return np.array(bits, np.uint32).view(np.float32)[()]


def _least(pred):
    """The least non-negative float32 at which ``pred`` holds, for a
    ``pred`` that is monotone in the value and holds at +inf: bisection
    over the bit patterns, which order the non-negative floats."""
    lo, hi = 0, _INF_BITS
    while lo < hi:
        mid = (lo + hi) // 2
        if pred(_f32(mid)):
            hi = mid
        else:
            lo = mid + 1
    return _f32(lo)


def _sqrt(d2):
    return ps.sqrt(torch.tensor(d2, dtype=torch.float32))


def hit_d2(dmin: float):
    """The least float32 t with ``sqrt(d2) < dmin`` <=> ``d2 < t`` for
    every non-negative float32 ``d2`` (a correctly rounded square root is
    monotone): the collision test without its root."""
    dmin = np.float32(dmin)
    return _least(lambda d2: not bool(_sqrt(d2) < float(dmin)))


def far_d2(cfg: ParticleEnvConfig):
    """The least float32 squared distance from which ``z = -(dist - dmin)
    / margin``, rounded as ``soa_step`` rounds it, is at most ``FAR_Z``:
    at every ``d2 >= far_d2`` the contact term's ``exp`` is 0, so ``pen``
    and the force terms are exactly +-0 (z falls as d2 grows)."""
    k = torch.full((), cfg.contact_margin, dtype=torch.float32)
    dmin = 2 * cfg.agent_size
    return _least(lambda d2: bool(-(_sqrt(d2) - dmin) / k <= FAR_Z))


@functools.cache
def params(cfg: ParticleEnvConfig):
    """The floats of ``ParticleParam`` in the source, in its order: the
    config's constants, then the reset state of ``soa_init`` per field,
    ``MAX_AGENTS`` values each (zero beyond n).  Computed once per
    config."""
    _check_agents(cfg.n_agents)
    s0 = ps.soa_init(cfg, (), device="cpu")
    pad = lambda xs: [float(x) for x in xs] + [0.0] * (MAX_AGENTS - len(xs))
    out = [cfg.dt, 1.0 - cfg.damping, cfg.accel, cfg.contact_force,
           cfg.contact_margin, 2 * cfg.agent_size, ps.REACH,
           float(far_d2(cfg)), float(hit_d2(2 * cfg.agent_size))]
    for field in (s0.px, s0.py, s0.vx, s0.vy, s0.lx, s0.ly):
        out += pad(field)
    return tuple(out)


def _rollout_plain(cfg, batch, n_steps, device, actions_at, observe=None):
    s0 = ps.soa_init(cfg, (batch,), device=device)
    s = s0
    rew = torch.zeros(batch, dtype=torch.float32, device=device)
    ep = torch.zeros(batch, dtype=torch.int32, device=device)
    for t in range(n_steps):
        if observe is not None:
            observe(s)
        s, rs, done = ps.soa_step(cfg, s, actions_at(t))
        total = rs[0]
        for r in rs[1:]:
            total = total + r
        rew = rew + total
        s = ps.select(done, s0, s)
        ep = ep + done.int()
    return rew, ep


def rollout_actions_plain(cfg: ParticleEnvConfig, actions):
    """The kernel's math in plain PyTorch: ``actions`` [T, N, B]."""
    t, n, batch = actions.shape
    return _rollout_plain(cfg, batch, t, actions.device,
                          lambda k: tuple(actions[k, i] for i in range(n)))


def rollout_prng_plain(cfg: ParticleEnvConfig, batch: int, n_steps: int,
                       seed: int, device="cuda", observe=None):
    """The kernel's math in plain PyTorch with Philox draws.
    ``observe(state)``, if given, sees the state before every step
    (``chip_smoke.py`` counts the work the data decide with it)."""
    return _rollout_plain(
        cfg, batch, n_steps, device,
        lambda t: random_actions(seed, t, batch, cfg.n_agents, device),
        observe)


def _call(cfg):
    """The C entry with the config's leading arguments."""
    def call(lib, *args):
        words = params(cfg)
        return lib.cm3_particle_rollout(
            (ctypes.c_float * len(words))(*words), len(words), cfg.n_agents,
            cfg.max_steps, *args)
    return call


def rollout_prng(cfg: ParticleEnvConfig, batch: int, n_steps: int,
                 seed: int, device="cuda"):
    """Random-policy rollout of ``batch`` instances for ``n_steps`` env
    steps from the reset state.  Returns (reward_sum f32 [batch],
    episodes i32 [batch])."""
    _check_agents(cfg.n_agents)
    return _rollout.prng(
        "particle_rollout", rollout_prng,
        lambda dev: rollout_prng_plain(cfg, batch, n_steps, seed, dev),
        _call(cfg), batch, n_steps, seed, device)


def rollout_actions(cfg: ParticleEnvConfig, actions):
    """The test variant: ``actions`` int32 [T, N, batch] drive the
    rollout instead of Philox.  Returns (reward_sum f32 [batch],
    episodes i32 [batch])."""
    _check_agents(cfg.n_agents)
    return _rollout.fed(
        "particle_rollout", rollout_actions,
        lambda a: rollout_actions_plain(cfg, a), _call(cfg), cfg.n_agents,
        actions)


def occupancy(n_agents: int, fed: bool = False):
    """Registers, blocks per SM, threads per block and spill bytes of
    the kernel built for ``n_agents`` (the Philox variant, or the fed
    one); needs the card."""
    return _nvcc.occupancy("cm3_particle_rollout_occupancy", n_agents,
                           int(fed))


rollout_prng.launches = 0
rollout_actions.launches = 0
