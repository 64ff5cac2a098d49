"""The fused rollout kernels' work and the least time of a call on an
H100 SXM, from the kernel notes of ``ops/checkers_rollout.py`` (B2) and
``ops/roadway_rollout.py`` (B4), counted in single instructions of the
card for the work the outputs need, whatever a build makes of it.

The peaks are published figures, not read from the card: 132 SMs, each
issuing 4 warp-instructions of 32 lanes a clock at the 1.98 GHz boost
clock (the rate behind the 67 TFLOP/s of float32 outside the tensor
cores, a fused multiply-add counting 2), 16 MUFU lanes per SM a clock,
and 3.35 TB/s of HBM3.  A call's least time is the largest of its issue,
MUFU and byte bounds."""

from __future__ import annotations

SMS, CLOCK_HZ = 132, 1.98e9
ISSUE_PER_S = SMS * 4 * 32 * CLOCK_HZ        # 3.345e13 operations/s
MUFU_PER_S = SMS * 16 * CLOCK_HZ
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12                     # = 2 x ISSUE_PER_S, rounded

CHECKERS_PER_STEP = 86                        # Philox 33 + 2 x 20 + 13


def checkers_ops(batch: int, n_steps: int) -> int:
    """B2: 86 operations per instance-step (two agents, Philox draws)."""
    return CHECKERS_PER_STEP * batch * n_steps


def roadway_ops(batch, n_steps, live_car, live_pair, ttc_candidate,
                rejected_draw, goal_reward, resets):
    """B4: 50 B T + 62 L + 42 P + 13 D + 3 F + 15 G + 10 E (two cars)."""
    return (50 * batch * n_steps + 62 * live_car + 42 * live_pair
            + 13 * ttc_candidate + 3 * rejected_draw + 15 * goal_reward
            + 10 * resets)


def roadway_mufu(ttc_candidate, goal_reward):
    """B4's MUFU operations: one reciprocal per division, D + G."""
    return ttc_candidate + goal_reward


def output_bytes(batch: int) -> int:
    """Both kernels write a float32 reward sum and an int32 episode count
    per instance and read nothing (the Philox variant)."""
    return 8 * batch


def least_time(ops: float, mufu: float, n_bytes: float):
    """(seconds, the bound that sets them: "issue", "mufu" or "bytes")."""
    bounds = {"issue": ops / ISSUE_PER_S, "mufu": mufu / MUFU_PER_S,
              "bytes": n_bytes / HBM_BYTES_PER_S}
    name = max(bounds, key=bounds.get)
    return bounds[name], name
