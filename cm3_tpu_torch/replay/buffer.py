"""On-device replay (``cm3_tpu.replay.buffer``): the plain ring and the
dual bad/good buffer.

The plain ring is a dict of fixed-capacity device tensors plus two host
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

The dual buffer (``init_dual``, ``flush_episodes``, ``sample_dual``,
``reset_dual``; ``buffer.py:101-195``) keeps two such memories, "bad"
(episodes the hooks' predicate routes there: a collision, a return
below the threshold) and "good", and the driver flushes every episode
that ended at a step into one of them whole.  How many rows a flush
adds depends on the data, and differs between the seeds of a lockstep
run.  So each memory's cursor and fill are device int64 tensors, [S]
with seeds or [] for one seed, never host integers: an add packs the
valid rows densely in row order at each seed's cursor (``add_masked``:
the offsets are a prefix sum of the mask) and writes them with one
scatter per leaf into a ring with one spare row past its capacity,
where the invalid rows land (JAX's ``mode="drop"``); the cursors move
by the valid count, on the device.  Keeping host cursors instead would
take a device-to-host sync at every env step, which stalls the host's
launch queue on a path that is bound by launching; only a period row's
``n_bad``/``n_good`` read the fills on the host.  ``sample_dual``
takes its two index draws below the device-held fills (the draw
source's ``randint_below``) and mixes them 50/50 with JAX's fallbacks.
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


# --------------------------------------------------------------------- #
# the dual (bad/good episode) buffer
# --------------------------------------------------------------------- #


@dataclasses.dataclass
class DeviceRing:
    """One memory of the dual buffer: leaves [*P, capacity + 1, ...]
    (P = [] or [S]), whose last row takes the rows an add drops;
    ``insert`` and ``size`` int64 device tensors [*P]."""

    data: Any
    insert: torch.Tensor
    size: torch.Tensor
    n_seeds: Optional[int] = None

    @property
    def capacity(self) -> int:
        return next(tree_leaves(self.data))[1].shape[_ring_dim(self)] - 1


@dataclasses.dataclass
class DualReplayState:
    bad: DeviceRing     # collision / below-threshold episodes
    good: DeviceRing


def _device_ring(example_transition, capacity: int,
                 n_seeds: Optional[int]) -> DeviceRing:
    per_seed = () if n_seeds is None else (n_seeds,)
    data = tree_map(
        lambda x: torch.zeros(per_seed + (capacity + 1,) + tuple(x.shape),
                              dtype=x.dtype, device=x.device),
        example_transition)
    dev = next(tree_leaves(data))[1].device
    zeros = lambda: torch.zeros(per_seed, dtype=torch.int64, device=dev)
    return DeviceRing(data=data, insert=zeros(), size=zeros(),
                      n_seeds=n_seeds)


def init_dual(example_transition, capacity: int,
              n_seeds: Optional[int] = None) -> DualReplayState:
    """Two empty memories of ``capacity`` rows each (per seed)."""
    return DualReplayState(
        bad=_device_ring(example_transition, capacity, n_seeds),
        good=_device_ring(example_transition, capacity, n_seeds))


def _seed_index(ring: DeviceRing, idx: torch.Tensor):
    if ring.n_seeds is None:
        return (idx,)
    seed = torch.arange(ring.n_seeds, device=idx.device)[:, None]
    return (seed.expand_as(idx), idx)


def add_masked(ring: DeviceRing, rows, valid: torch.Tensor) -> DeviceRing:
    """Append the rows of ``rows`` (leaves [*P, R, ...]) where ``valid``
    [*P, R] holds, packed densely in row order at each seed's cursor and
    wrapping around its ring (``buffer.py:47-72``); the other rows go to
    the spare row.  In place, without a host sync.  As in JAX, a flush
    of more valid rows than the capacity overwrites within itself."""
    cap = ring.capacity
    v = valid.long()
    offsets = torch.cumsum(v, dim=-1) - v
    idx = torch.where(valid, (ring.insert[..., None] + offsets) % cap, cap)
    where = _seed_index(ring, idx)
    tree_map(lambda buf, x: buf.index_put_(where, x), ring.data, rows)
    n_added = v.sum(dim=-1)
    ring.insert.copy_((ring.insert + n_added) % cap)
    ring.size.copy_(torch.clamp_max(ring.size + n_added, cap))
    return ring


def flush_episodes(state: DualReplayState, stage, valid: torch.Tensor,
                   is_bad: torch.Tensor) -> DualReplayState:
    """Route the staged transitions of the episodes that just ended
    (``buffer.py:123-138``): ``stage`` leaves [*P, E, T, ...], ``valid``
    [*P, E, T] marking each ended episode's real transitions, ``is_bad``
    [*P, E].  The rows land densely in (env, t) order, in the bad memory
    where ``is_bad``, else in the good one.  In place."""
    lead, (e, t) = valid.shape[:-2], valid.shape[-2:]
    k = len(lead)
    flat = tree_map(lambda x: x.reshape(lead + (e * t,) + x.shape[k + 2:]),
                    stage)
    v = valid.reshape(lead + (e * t,))
    bad = is_bad[..., None].expand(valid.shape).reshape(lead + (e * t,))
    add_masked(state.bad, flat, v & bad)
    add_masked(state.good, flat, v & ~bad)
    return state


def reset_dual(state: DualReplayState) -> DualReplayState:
    """Empty both memories (the on-policy burst's discard,
    ``train_onpolicy.py:372-377``); in place."""
    for ring in (state.bad, state.good):
        ring.insert.zero_()
        ring.size.zero_()
    return state


def sample_dual(state: DualReplayState, idx_bad: torch.Tensor,
                idx_good: torch.Tensor):
    """The 50/50 mix of the two memories with JAX's fallbacks
    (``buffer.py:153-195``): of B rows, the first ``from1`` come from
    the bad memory's rows ``idx_bad`` and the rest from the good one's
    ``idx_good`` ([*P, B] each, drawn below each memory's fill, at least
    1); half from each, the good memory's shortfall made up from the
    bad one, all from one memory when the other is empty."""
    b = idx_bad.shape[-1]
    half = b // 2
    s1, s2 = state.bad.size, state.good.size
    from1 = torch.where(s2 < half, b - s2, half)
    from1 = torch.minimum(from1, torch.clamp_min(s1, 0))
    from1 = torch.where(s2 == 0, b, from1)
    from1 = torch.where(s1 == 0, 0, from1)
    use1 = torch.arange(b, device=idx_bad.device) < from1[..., None]
    w1 = _seed_index(state.bad, idx_bad)
    w2 = _seed_index(state.good, idx_good)

    def pick(b1, b2):
        r1, r2 = b1[w1], b2[w2]
        mask = use1.view(use1.shape + (1,) * (r1.dim() - use1.dim()))
        return torch.where(mask, r1, r2)

    return tree_map(pick, state.bad.data, state.good.data)
