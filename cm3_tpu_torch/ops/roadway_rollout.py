"""Fused random-policy roadway rollout: a whole trajectory per thread.

Replaces the Pallas kernel of ``cm3_tpu/ops/roadway_rollout.py``
(``pl.pallas_call`` at line 83 in ``rollout_prng`` and at line 113 in
``rollout_actions``; kernel body ``_body`` at line 46, done select
``_select`` at line 37).  For B instances of the struct-of-arrays
roadway game (``envs/roadway_soa.py``) it runs T control steps of a
uniform random policy, each the time-to-collision filter
``soa_check_actions``, then ``soa_step``, then the reset to
``soa_init`` on done, and returns only the reward sum (float32 [B])
and the episode count (int32 [B]) of each instance: ``bench.py``'s
``roadway_fused_env_steps_per_s`` program.

Kernel: ``cm3_tpu_torch/csrc/roadway_rollout.cu``, CUDA C++ for
``sm_90a``, built by ``ops/_nvcc.py``.

Bound on an H100.  8 bytes out per instance and no input in the Philox
variant: bytes are no limit.  The work is instruction issue.  Counted
are the operations whose results the outputs need, at the steps where
they need them, in single instructions of the card; an IEEE division
is 8 (one MUFU reciprocal, the Newton steps, the range test and its
branch), its fast path as the CUDA math library writes it.  With N = 2
cars and Philox draws:

Every step, 50:

* Philox4x32-10, counter (t, b, 0, 0), key schedule hoisted, output
  words 0 and 1 used: 33 (as in ``ops/checkers_rollout.py``).
* 10: the cars' rewards into the sum 2, done 2, the episode count, the
  reset's branch 2, the loop's increment, compare and branch.
* per car (2): the live test 1, the removed flag's update 2 (OR with
  the car's terminal and the episode's crash): 3 each; the pair's
  both-live test 1.

Per live car (not removed), 62:

* its action ``(w >> 7) % 5`` 4; its lateral position 3 (convert,
  multiply, subtract).
* the TTC filter: against the other car, dx 1, the four tests that
  need no division 5 (ahead, slower, lateral 2, the other's removed
  flag), their conjunction 3, the OR into ``danger`` 1: 10; the five
  feasibility bits 5, their mask 4, the test of the drawn action 3
  (range, shift, bit): 12.
* the controls 20: the acceleration 4 (two compares, two selects), the
  new speed 4 (multiply, add, two clamps), the sublane 6 (two compares,
  subtract, add, two clamps), the move 2 (multiply, add), the step
  count 1, the new lateral position 3.
* the reward 13: at the goal 1 (``(goal_pos - x) / total_length <= 0``
  with ``total_length > 0`` is ``x >= goal_pos``: no division), timed
  out 1, the reward's select chain 3, the overspeed penalty 3 (compare,
  select, subtract: the product of 0.1 and a 0/1 flag is a select),
  terminal 3, the episode-crash term 2.

Per pair of live cars, 42: the overlap test 6 (|dx| 2, |dy| 2,
conjunction 2); per ordered pair (2) fwd 1, near 4 (two compares, two
ANDs), the sublane difference 1, on-left 3 and on-right 3 (two compares
folded into a range test, one AND, one OR each): 12 each; crashed per
car (2): two action compares, two ANDs, two ORs: 6 each.

Per TTC candidate (a live car with the other live, ahead, slower and
in lateral reach), 13, 1 of them MUFU: the relative speed 2 (subtract,
max), the gap 1, the division 8, its test 1, the AND 1.

Per drawn action that the filter rejects, 3: the first feasible action
(find first set, subtract, select).

Per goal reward read (a live car at its goal, not crashed), 15, 1 of
them MUFU: the difference to the goal sublane, its test, absolute
value, convert, division 8, subtract, multiply, select.

Per reset (done), 10: x, sublane, speed, steps and the removed flag of
each car.

A call of B instances and T steps needs ``50 B T + 62 L + 42 P + 13 D
+ 3 F + 15 G + 10 E`` operations and ``D + G`` MUFU operations, with
L live cars, P pairs of live cars, D TTC candidates, F rejected draws,
G goal rewards and E resets counted over the call, and its two limits
are

    issue:  operations / (SMs x 4 warp-instructions per clock x 32 x clock)
    MUFU:   MUFU operations / (SMs x 16 lanes per clock x clock)

with the SM clock from ``nvidia-smi --query-gpu=clocks.max.sm``.
``chip_smoke.py`` counts L, P, D, F and G with the plain version's
``observe`` at the bench call's inputs, E from the kernel's own episode
counts, and computes both limits in each run (``PERF.md`` has the
counts).  The kernel computes every term of both cars every step.

Design.  One instance per thread, its cars in registers: position,
velocity, sublane, step count and the removed flag of each car, the
reward sum and the episode count; the terminal and collided flags of
``SoaState`` never reach an output and are not carried.  The config's
constants and the reset state are kernel arguments, the same for every
instance.  A loop over T inside the thread (``#pragma unroll 1``)
takes the place of the TPU kernel's ``fori_loop``; the car and pair
loops unroll over a compile-time N in {1, 2}.  256 threads per block;
a ragged last block is masked.  Nothing is read or written in the loop
except the fed actions of the test variant (``actions[t, i, b]``,
int32 [T, N, B] as JAX takes them, coalesced over b).  The TTC
filter's feasible actions are a 5-bit mask: the drawn action stands if
its bit is set, else the lowest set bit is the first feasible action,
as the source's select chain gives it.

The reset state is computed once by the port's own
``roadway_soa.soa_init`` (with its populating NOOP step) and passed as
scalars (``params``), so there is one definition of the reset.

Rounding.  Kernel and plain version compute the same float32 values:
the kernel rounds every product and sum apart (``__fmul_rn`` /
``__fadd_rn``, never contracted into a fused multiply-add, as eager
PyTorch runs them: ``vel + dt*acc``, ``x + v*dt`` and ``sublane_res *
sub - total_width``) and divides in IEEE (``__fdiv_rn``; the plain
version divides by tensors, since PyTorch's CUDA division by a Python
scalar multiplies by the reciprocal).  There is no transcendental, so
the plain version on the CPU, the plain version on the card and the
kernel agree to the bit, and so does JAX's ``soa_step`` run op by op.
Compiled XLA contracts ``a*b + c`` into a fused multiply-add and
divides by a constant as a product with its reciprocal, so JAX's
jitted or Pallas-interpreted rollout can differ from them by an ulp of
a position, and then a threshold (ttc <= 2, the goal) can flip.
The rewards are summed in the JAX kernel's order (``rew + (r0 + r1)``).

Random numbers: Philox4x32-10 with key (seed, 0) and counter
(t, b, 0, 0); car i takes word i and the action ``(word >> 7) % 5``,
as in ``roadway_rollout.py:32-34`` (``ops/philox.py``,
``csrc/philox.cuh``).  Kernel and plain version draw the same words;
against JAX's hardware-PRNG variant they agree in distribution.

``rollout_prng`` and ``rollout_actions`` take the plain versions for
CPU tensors, launch the kernel for CUDA tensors (or raise), and raise
for any other device.  ``rollout_prng.launches`` and
``rollout_actions.launches`` count kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from cm3_tpu_torch.core.config import RoadwayEnvConfig
from cm3_tpu_torch.envs import roadway_soa as rs
from cm3_tpu_torch.ops import _nvcc, _rollout
from cm3_tpu_torch.ops.philox import random_actions

CARS = (1, 2)           # the car counts the kernel is built for
MAX_CARS = 2


def _check_cars(n):
    if n not in CARS:
        raise ValueError(f"roadway_rollout: the kernel takes {CARS} cars, "
                         f"not {n}")


@functools.cache
def params(cfg: RoadwayEnvConfig):
    """(floats, ints) in the order of ``RoadwayFloat`` and
    ``RoadwayInt`` in the source: the config's constants, then per car
    its goal and the reset state of ``soa_init``, ``MAX_CARS`` values
    each (zero beyond n).  Computed once per config."""
    n = cfg.n_agents
    _check_cars(n)
    s0 = rs.soa_init(cfg, (), device="cpu")
    pad = lambda xs, cast: [cast(x) for x in xs[:n]] + [cast(0)] * (MAX_CARS - n)
    floats = [cfg.dt, cfg.acc_val, cfg.dec_val, cfg.v_max, cfg.v_min,
              cfg.car_length, cfg.car_width, cfg.ttc_thres, cfg.sublane_res,
              cfg.total_width, cfg.total_length, -cfg.res_forward / 2,
              1.5 * cfg.res_forward, cfg.overspeed, float(cfg.n_sublanes)]
    floats += pad(cfg.goal_pos, float) + pad(s0.x, float) \
        + pad(s0.vel, float)
    goal_sub = [cfg.goal_lane[i] * cfg.sublanes_per_lane
                + cfg.sublanes_per_lane // 2 for i in range(n)]
    ints = [cfg.n_sublanes, cfg.max_step] + pad(goal_sub, int) \
        + pad(s0.sub, int) + pad(s0.steps, int) + pad(s0.rem, int)
    return tuple(floats), tuple(ints)


def _rollout_plain(cfg, batch, n_steps, device, actions_at, observe=None):
    s0 = rs.soa_init(cfg, (batch,), device=device)
    s = s0
    rew = torch.zeros(batch, dtype=torch.float32, device=device)
    ep = torch.zeros(batch, dtype=torch.int32, device=device)
    for t in range(n_steps):
        drawn = actions_at(t)
        acts = rs.soa_check_actions(cfg, s, drawn)
        s2, rws, done = rs.soa_step(cfg, s, acts)
        if observe is not None:
            observe(s, drawn, acts, s2)
        total = rws[0]
        for r in rws[1:]:
            total = total + r
        rew = rew + total
        s = rs.select(done, s0, s2)
        ep = ep + done.int()
    return rew, ep


def rollout_actions_plain(cfg: RoadwayEnvConfig, actions):
    """The kernel's math in plain PyTorch: ``actions`` [T, N, B]."""
    t, n, batch = actions.shape
    return _rollout_plain(cfg, batch, t, actions.device,
                          lambda k: tuple(actions[k, i] for i in range(n)))


def rollout_prng_plain(cfg: RoadwayEnvConfig, batch: int, n_steps: int,
                       seed: int, device="cuda", observe=None):
    """The kernel's math in plain PyTorch with Philox draws.
    ``observe(state, drawn, taken, next_state)``, if given, sees every
    step: the state before it, the drawn and the filtered actions, and
    the state after it before the reset (``chip_smoke.py`` counts the
    work the data decide with it)."""
    return _rollout_plain(
        cfg, batch, n_steps, device,
        lambda t: random_actions(seed, t, batch, cfg.n_agents, device),
        observe)


def _call(cfg):
    """The C entry with the config's leading arguments."""
    def call(lib, *args):
        floats, ints = params(cfg)
        return lib.cm3_roadway_rollout(
            (ctypes.c_float * len(floats))(*floats), len(floats),
            (ctypes.c_int32 * len(ints))(*ints), len(ints), cfg.n_agents,
            *args)
    return call


def rollout_prng(cfg: RoadwayEnvConfig, batch: int, n_steps: int, seed: int,
                 device="cuda"):
    """Random-policy rollout of ``batch`` instances for ``n_steps``
    control steps from the reset state, with the TTC filter and
    auto-reset.  Returns (reward_sum f32 [batch], episodes i32
    [batch])."""
    _check_cars(cfg.n_agents)
    return _rollout.prng(
        "roadway_rollout", rollout_prng,
        lambda dev: rollout_prng_plain(cfg, batch, n_steps, seed, dev),
        _call(cfg), batch, n_steps, seed, device)


def rollout_actions(cfg: RoadwayEnvConfig, actions):
    """The test variant: ``actions`` int32 [T, N, batch] drive the
    rollout instead of Philox.  Returns (reward_sum f32 [batch],
    episodes i32 [batch])."""
    _check_cars(cfg.n_agents)
    return _rollout.fed(
        "roadway_rollout", rollout_actions,
        lambda a: rollout_actions_plain(cfg, a), _call(cfg), cfg.n_agents,
        actions)


def occupancy(n_agents: int, fed: bool = False):
    """Registers, blocks per SM, threads per block and spill bytes of
    the kernel built for ``n_agents`` (the Philox variant, or the fed
    one); needs the card."""
    return _nvcc.occupancy("cm3_roadway_rollout_occupancy", n_agents,
                           int(fed))


rollout_prng.launches = 0
rollout_actions.launches = 0
