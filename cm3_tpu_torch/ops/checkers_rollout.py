"""Fused random-policy Checkers rollout: a whole trajectory per thread.

Replaces the Pallas kernel of ``cm3_tpu/ops/checkers_rollout.py``
(``pl.pallas_call`` at line 75 in ``rollout_prng`` and at line 106 in
``rollout_actions``; kernel body ``_body`` at line 40).  For B
instances of the bit-packed game (``envs/checkers_packed.py``) it runs
T steps of a uniform random policy with auto-reset and returns only
the reward sum (float32 [B]) and the episode count (int32 [B]) of each
instance: ``bench.py``'s ``checkers_fused_env_steps_per_s`` program.

Kernel: ``cm3_tpu_torch/csrc/checkers_rollout.cu``, CUDA C++ for
``sm_90a``, built by ``ops/_nvcc.py``.

Bound on an H100.  The outputs are 8 bytes per instance and there are
no inputs in the Philox variant, so bytes are no limit (8 MB per call
at B = 2^20).  The work is instruction issue.  What one step of one
instance needs (two agents, Philox draws), counted in single
instructions of the card, whatever this build makes of it:

* Philox4x32-10, counter (t, b, 0, 0), key schedule hoisted: 33.  A
  full round is 2 wide multiplies (both halves of a 32x32 product) and
  2 three-input XORs; round 1 is one multiply (the zero words vanish),
  round 2 three (b's product is the same every step), rounds 3-8 four
  each, and only output words 0 and 1 are used, so round 9 takes three
  and round 10 two.
* per agent, 20, branch-free: the action ``(w >> 7) % 5`` 4 (shift,
  multiply-high by the reciprocal, shift, multiply-subtract); the move
  7 (one table load of the action's shift counts and edge mask, two
  shifts for the target, the edge and occupied tests, their
  conjunction, the select of the new position); the pickup 3 (two
  masked tests, one OR into ``collected``); the reward 6 (the invalid
  test, three selects, two adds).
* per step, 13: two reward adds, the step count, the done test (2),
  the episode count, four reset selects, the loop's increment, compare
  and branch.

That is 33 + 2 x 20 + 13 = 86 operations per step, and the least time
of a call is

    86 x B x T / (SMs x 4 warp-instructions per clock x 32 x SM clock),

the SM clock from ``nvidia-smi --query-gpu=clocks.max.sm``;
``chip_smoke.py`` computes it in each run.  On an H100 SXM (132 SMs,
1980 MHz, 700 W) a ``bench.py`` call (B = 2^20, T = 8192) is bound at
22.1 ms.  Nearly all of the work is integer operations, which an H100
runs at half the issue rate (``PERF.md`` has the SASS mix).

Design.  One instance per thread, its whole state in registers: the
agents' one-hot ``uint32`` positions, the collected mask, the step
counter, the reward sum and the episode count; a loop over T inside
the thread (``#pragma unroll 1``, so the SASS loop body is one step)
takes the place of the TPU kernel's ``fori_loop``.  256 threads per
block; a ragged last block is masked.  Nothing is read or written in
the loop except the fed actions of the test variant
(``actions[t, i, b]``, int32 [T, N, B] as JAX takes them, coalesced
over b).  The move is branch-free, since a warp's lanes draw different
actions and a chain of ``a == k ? ... :`` compiles to branches that
every warp walks in full: the four moves are one shift each
(up ``>> width``, down ``<< width``, left ``>> 1``, right ``<< 1``),
so ``move_table`` gives each action (stay included) its edge mask and
its left and right shift counts, the target of p is
``(p << shl) >> shr``, and stay, whose edge mask is 0, never moves.
Each block copies the five entries into shared memory once (16 bytes
each, in distinct banks); a lane reads its action's entry, and lanes
with the same action read the same word, a broadcast.  A per-thread
array indexed by the action would live in local memory, and a
``__constant__`` table read at addresses that differ across a warp
serialises.  The pickup and the reset are selects.  The spec's masks,
start positions and move table are runtime arguments, so one build
serves every spec; the kernel is templated on N in {1, 2}.  The reward
of each step is summed as the JAX kernel sums it (per agent green +
orange + invalid, then ``rew + (r0 + r1)``), so the fed variant
matches the JAX kernel exactly.

Random numbers.  The TPU kernel seeds its hardware generator with
``seed + program_id * 7919``; no CPU or GPU can reproduce that stream.
Here each step draws Philox4x32-10 (``ops/philox.py``,
``csrc/philox.cuh``) with key (seed, 0) and counter (t, b, 0, 0),
agent i takes output word i, and the action is ``(bits >> 7) % 5`` as
in ``checkers_rollout.py:33-37``.  The plain version draws the same
words, so kernel and plain version agree exactly; against JAX the
PRNG variant agrees in distribution.

``rollout_prng`` and ``rollout_actions`` take the plain versions for
CPU tensors, launch the kernel for CUDA tensors (or raise), and raise
for any other device.  ``rollout_prng.launches`` and
``rollout_actions.launches`` count kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from cm3_tpu_torch.envs import checkers_packed as cp
from cm3_tpu_torch.ops import _nvcc, _rollout
from cm3_tpu_torch.ops.philox import random_actions


def move_table(spec: cp.PackedSpec):
    """The kernel's move per action (stay, up, down, left, right): its
    edge mask (the positions from which it may move) and the counts of
    its left and right shifts; the target of position p is
    ``(p << shl) >> shr`` (up ``>> width``, down ``<< width``, left
    ``>> 1``, right ``<< 1``; stay never moves: its edge mask is 0)."""
    w = spec.width
    return ((0, 0, 0), (spec.up_ok, 0, w), (spec.down_ok, w, 0),
            (spec.left_ok, 0, 1), (spec.right_ok, 1, 0))


def spec_words(spec: cp.PackedSpec):
    """The spec as the C entry reads it (``SpecWord`` in the source):
    masks, start positions, goal bits, step cap, then the move table's
    edge masks, left shifts and right shifts, five words each."""
    n = len(spec.init_pos)
    if n not in (1, 2):
        raise ValueError(f"the rollout kernel takes 1 or 2 agents, not {n}")
    init = tuple(spec.init_pos) + (0,) * (2 - n)
    goal_bits = sum(1 << i for i, g in enumerate(spec.goal_green) if g)
    edge, shl, shr = zip(*move_table(spec))
    return (spec.green_mask, spec.orange_mask, spec.full_mask, init[0],
            init[1], goal_bits, spec.max_steps) + edge + shl + shr


def _rollout_plain(spec, batch, n_steps, device, actions_at):
    s = cp.packed_init(spec, (batch,), device=device)
    rew = torch.zeros(batch, dtype=torch.float32, device=device)
    ep = torch.zeros(batch, dtype=torch.int32, device=device)
    for t in range(n_steps):
        s, rs, done = cp.packed_step(spec, s, actions_at(t))
        total = rs[0]
        for r in rs[1:]:
            total = total + r
        rew = rew + total
        ep = ep + done.int()
    return rew, ep


def rollout_actions_plain(spec: cp.PackedSpec, actions):
    """The kernel's math in plain PyTorch: ``actions`` [T, N, B]."""
    t, n, batch = actions.shape
    return _rollout_plain(spec, batch, t, actions.device,
                          lambda k: tuple(actions[k, i] for i in range(n)))


def rollout_prng_plain(spec: cp.PackedSpec, batch: int, n_steps: int,
                       seed: int, device="cuda"):
    n = len(spec.init_pos)
    return _rollout_plain(
        spec, batch, n_steps, device,
        lambda t: random_actions(seed, t, batch, n, device))


def _call(spec):
    """The C entry with the spec's leading arguments."""
    def call(lib, *args):
        words = spec_words(spec)
        return lib.cm3_checkers_rollout(
            (ctypes.c_uint32 * len(words))(*words), len(words),
            len(spec.init_pos), *args)
    return call


def rollout_prng(spec: cp.PackedSpec, batch: int, n_steps: int, seed: int,
                 device="cuda"):
    """Random-policy rollout of ``batch`` instances for ``n_steps`` env
    steps from the start state.  Returns (reward_sum f32 [batch],
    episodes i32 [batch])."""
    return _rollout.prng(
        "checkers_rollout", rollout_prng,
        lambda dev: rollout_prng_plain(spec, batch, n_steps, seed, dev),
        _call(spec), batch, n_steps, seed, device)


def rollout_actions(spec: cp.PackedSpec, actions):
    """The test variant: ``actions`` int32 [T, N, batch] drive the
    rollout instead of Philox.  Returns (reward_sum f32 [batch],
    episodes i32 [batch])."""
    return _rollout.fed(
        "checkers_rollout", rollout_actions,
        lambda a: rollout_actions_plain(spec, a), _call(spec),
        len(spec.init_pos), actions)


def occupancy(n_agents: int, fed: bool = False):
    """Registers, blocks per SM, threads per block and spill bytes of
    the kernel built for ``n_agents`` (the Philox variant, or the fed
    one); needs the card."""
    return _nvcc.occupancy("cm3_checkers_rollout_occupancy", n_agents,
                           int(fed))


rollout_prng.launches = 0
rollout_actions.launches = 0
