"""On-device replay ring (``cm3_tpu.replay.buffer``, the plain buffer).

A buffer is a dict of fixed-capacity device tensors plus two host
integers, the insert cursor and the fill.  The host knows both (every
add is E rows), so adds and samples need no device round trip: an add
is one or two slice copies per leaf, a minibatch one gather per leaf.

Seeds in lockstep (``n_seeds``): every leaf is [S, capacity, ...], one
ring per seed.  Each add puts E rows into every seed's ring at once, so
the cursor and the fill are the same for all seeds and stay shared host
integers; a sample takes per-seed indices [S, B].

Sampling is uniform WITH replacement (the reference samples without;
documented in the JAX package): ``sample`` takes the row indices, which
the driver draws from its draw source in [0, max(size, 1)).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from cm3_tpu_torch.core.tree import tree_leaves, tree_map


@dataclasses.dataclass
class ReplayState:
    data: Any        # dict of tensors [capacity, ...] or [S, capacity, ...]
    insert: int = 0  # cursor
    size: int = 0    # current fill
    n_seeds: Optional[int] = None


def init(example_transition, capacity: int,
         n_seeds: Optional[int] = None) -> ReplayState:
    """``example_transition``: dict of tensors [...] (no batch dim); the
    buffer lives on their device with their dtypes, with a leading seed
    axis when ``n_seeds`` is given."""
    lead = (capacity,) if n_seeds is None else (n_seeds, capacity)
    data = tree_map(
        lambda x: torch.zeros(lead + tuple(x.shape), dtype=x.dtype,
                              device=x.device), example_transition)
    return ReplayState(data=data, n_seeds=n_seeds)


def _ring_dim(state: ReplayState) -> int:
    return 0 if state.n_seeds is None else 1


def capacity_of(state: ReplayState) -> int:
    return next(tree_leaves(state.data))[1].shape[_ring_dim(state)]


def add_batch(state: ReplayState, transitions) -> ReplayState:
    """Append E transitions (leaves [E, ...], or [S, E, ...] with seeds)
    at the cursor, wrapping around the ring (replay_buffer.py:11-16);
    in place."""
    d = _ring_dim(state)
    cap = capacity_of(state)
    e = next(tree_leaves(transitions))[1].shape[d]
    if e > cap:
        raise ValueError(f"cannot add {e} rows to a ring of {cap}")
    first = min(e, cap - state.insert)

    def write(buf, rows):
        buf.narrow(d, state.insert, first).copy_(rows.narrow(d, 0, first))
        if first < e:
            buf.narrow(d, 0, e - first).copy_(rows.narrow(d, first,
                                                         e - first))

    tree_map(write, state.data, transitions)
    state.insert = (state.insert + e) % cap
    state.size = min(state.size + e, cap)
    return state


def reset(state: ReplayState) -> ReplayState:
    """Empty the ring (cursor and fill to 0; the rows stay and are
    overwritten), as the on-policy driver discards it after a burst
    (``cm3_tpu/train/onpolicy.py:100-107``); in place."""
    state.insert = state.size = 0
    return state


def sample(state: ReplayState, idx: torch.Tensor):
    """The rows ``idx`` (replay_buffer.py:28-37): [B] -> leaves [B, ...];
    with seeds [S, B] -> leaves [S, B, ...], row idx[s, b] of seed s."""
    if state.n_seeds is None:
        return tree_map(lambda buf: buf[idx], state.data)
    seed = torch.arange(state.n_seeds, device=idx.device)[:, None]
    return tree_map(lambda buf: buf[seed, idx], state.data)
