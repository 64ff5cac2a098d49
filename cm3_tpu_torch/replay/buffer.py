"""On-device replay ring (``cm3_tpu.replay.buffer``, the plain buffer).

A buffer is a dict of fixed-capacity device tensors plus two host
integers, the insert cursor and the fill.  The host knows both (every
add is E rows), so adds and samples need no device round trip: an add
is one or two slice copies per leaf, a minibatch one gather per leaf.

Sampling is uniform WITH replacement (the reference samples without;
documented in the JAX package): ``sample`` takes the row indices, which
the driver draws from its draw source in [0, max(size, 1)).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from cm3_tpu_torch.core.tree import tree_leaves, tree_map


@dataclasses.dataclass
class ReplayState:
    data: Any        # dict of tensors [capacity, ...]
    insert: int = 0  # cursor
    size: int = 0    # current fill


def init(example_transition, capacity: int) -> ReplayState:
    """``example_transition``: dict of tensors [...] (no batch dim); the
    buffer lives on their device with their dtypes."""
    data = tree_map(
        lambda x: torch.zeros((capacity,) + tuple(x.shape), dtype=x.dtype,
                              device=x.device), example_transition)
    return ReplayState(data=data)


def capacity_of(state: ReplayState) -> int:
    return next(tree_leaves(state.data))[1].shape[0]


def add_batch(state: ReplayState, transitions) -> ReplayState:
    """Append E transitions (leaves [E, ...]) at the cursor, wrapping
    around the ring (replay_buffer.py:11-16); in place."""
    cap = capacity_of(state)
    e = next(tree_leaves(transitions))[1].shape[0]
    if e > cap:
        raise ValueError(f"cannot add {e} rows to a ring of {cap}")
    first = min(e, cap - state.insert)

    def write(buf, rows):
        buf[state.insert:state.insert + first] = rows[:first]
        if first < e:
            buf[:e - first] = rows[first:]

    tree_map(write, state.data, transitions)
    state.insert = (state.insert + e) % cap
    state.size = min(state.size + e, cap)
    return state


def sample(state: ReplayState, idx: torch.Tensor):
    """The rows ``idx`` [B] (replay_buffer.py:28-37), leaves [B, ...]."""
    return tree_map(lambda buf: buf[idx], state.data)
