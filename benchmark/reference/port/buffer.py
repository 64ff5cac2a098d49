"""On-device replay (``cm3_tpu.replay.buffer``): the plain ring, the
dual bad/good buffer and shard-local replay.

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

A ring with device cursors (``DeviceRing``): leaves [*P, capacity + 1,
...] and int64 cursor and fill tensors [*P], one ring per index of the
leading shape P.  An add (``add_masked``, which ``add_batch(...,
valid=)`` and ``add_episode`` reach) packs the valid rows densely in
row order at each ring's cursor (the offsets are a prefix sum of the
mask, ``buffer.py:47-72``) and writes them with one scatter per leaf;
the invalid rows land in the spare row past the capacity (JAX's
``mode="drop"``), and the cursors move by the valid count, on the
device.  So how many rows an add puts into each ring may depend on the
data, and no add or sample reads a cursor on the host: keeping host
cursors instead would take a device-to-host sync at every env step,
which stalls the host's launch queue on a path that is bound by
launching (and would freeze a value into a CUDA graph).

The dual buffer (``init_dual``, ``flush_episodes``, ``sample_dual``,
``reset_dual``; ``buffer.py:101-195``) keeps two such rings, "bad"
(episodes the hooks' predicate routes there: a collision, a return
below the threshold) and "good", with P = [] or [S]; the driver flushes
every episode that ended at a step into one of them whole, and only a
period row's ``n_bad``/``n_good`` read the fills on the host.
``sample_dual`` takes its two index draws below the device-held fills
(the draw source's ``randint_below``) and mixes them 50/50 with JAX's
fallbacks.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from .tree import tree_leaves, tree_map


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


def capacity_of(state) -> int:
    if isinstance(state, DeviceRing):
        return state.capacity
    return next(tree_leaves(state.data))[1].shape[_ring_dim(state)]


def add_batch(state, transitions, valid: Optional[torch.Tensor] = None):
    """Append E transitions (leaves [E, ...], or [S, E, ...] with seeds)
    at the cursor, wrapping around the ring (replay_buffer.py:11-16);
    in place.  With ``valid`` ([*P, E] bool) only the valid rows are
    added, packed densely (``buffer.py:47-72``): that needs a ring with
    device cursors (``init_ring``), since the count is the data's."""
    if isinstance(state, DeviceRing):
        return add_masked(state, transitions, valid)
    if valid is not None:
        raise ValueError("a masked add needs device cursors: use a "
                         "DeviceRing (init_ring)")
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


def reset(state):
    """Empty the ring (cursor and fill to 0; the rows stay and are
    overwritten), as the on-policy driver discards it after a burst
    (``cm3_tpu/train/onpolicy.py:100-107``); in place."""
    if isinstance(state, DeviceRing):
        state.insert.zero_()
        state.size.zero_()
    else:
        state.insert = state.size = 0
    return state


def sample(state, idx: torch.Tensor):
    """The rows ``idx`` (replay_buffer.py:28-37): [B] -> leaves [B, ...];
    with seeds [S, B] -> leaves [S, B, ...], row idx[s, b] of seed s
    (a ``DeviceRing``: [*P, B] -> [*P, B, ...])."""
    if isinstance(state, DeviceRing):
        where = _lead_index(state, idx)
        return tree_map(lambda buf: buf[where], state.data)
    if state.n_seeds is None:
        return tree_map(lambda buf: buf[idx], state.data)
    seed = torch.arange(state.n_seeds, device=idx.device)[:, None]
    return tree_map(lambda buf: buf[seed, idx], state.data)


# --------------------------------------------------------------------- #
# rings with device cursors: the dual buffer's memories and the shards
# --------------------------------------------------------------------- #


@dataclasses.dataclass
class DeviceRing:
    """Rings with device cursors: leaves [*P, capacity + 1, ...] (P = []
    one ring, [S] one per seed, [D] shards, [S, D] both), whose last row
    takes the rows an add drops; ``insert`` and ``size`` int64 device
    tensors [*P]."""

    data: Any
    insert: torch.Tensor
    size: torch.Tensor

    @property
    def capacity(self) -> int:
        return next(tree_leaves(self.data))[1].shape[self.insert.dim()] - 1


@dataclasses.dataclass
class DualReplayState:
    bad: DeviceRing     # collision / below-threshold episodes
    good: DeviceRing


def init_ring(example_transition, capacity: int, lead=()) -> DeviceRing:
    """Empty rings of ``capacity`` rows each, one per index of ``lead``,
    on the example's device with its dtypes."""
    lead = tuple(lead)
    data = tree_map(
        lambda x: torch.zeros(lead + (capacity + 1,) + tuple(x.shape),
                              dtype=x.dtype, device=x.device),
        example_transition)
    dev = next(tree_leaves(data))[1].device
    zeros = lambda: torch.zeros(lead, dtype=torch.int64, device=dev)
    return DeviceRing(data=data, insert=zeros(), size=zeros())


def _seeds(n_seeds: Optional[int]):
    return () if n_seeds is None else (n_seeds,)


def init_dual(example_transition, capacity: int,
              n_seeds: Optional[int] = None) -> DualReplayState:
    """Two empty memories of ``capacity`` rows each (per seed)."""
    lead = _seeds(n_seeds)
    return DualReplayState(bad=init_ring(example_transition, capacity, lead),
                           good=init_ring(example_transition, capacity,
                                          lead))


def _lead_index(ring: DeviceRing, idx: torch.Tensor):
    """The index tuple of rows ``idx`` [*P, R]: row idx[p, r] of ring p."""
    lead = tuple(ring.insert.shape)
    out = []
    for i, n in enumerate(lead):
        view = [1] * idx.dim()
        view[i] = n
        out.append(torch.arange(n, device=idx.device).view(view).expand_as(
            idx))
    return tuple(out) + (idx,)


def add_masked(ring: DeviceRing, rows,
               valid: Optional[torch.Tensor] = None) -> DeviceRing:
    """Append the rows of ``rows`` (leaves [*P, R, ...]) where ``valid``
    [*P, R] holds (every row without it), packed densely in row order
    at each ring's cursor and wrapping around it (``buffer.py:47-72``);
    the other rows go to the spare row.  In place, without a host sync.
    As in JAX, an add of more valid rows than the capacity overwrites
    within itself."""
    cap = ring.capacity
    if valid is None:
        r = next(tree_leaves(rows))[1].shape[ring.insert.dim()]
        offsets = torch.arange(r, device=ring.insert.device)
        idx = (ring.insert[..., None] + offsets) % cap
        n_added = r
    else:
        v = valid.long()
        offsets = torch.cumsum(v, dim=-1) - v
        idx = torch.where(valid, (ring.insert[..., None] + offsets) % cap,
                          cap)
        n_added = v.sum(dim=-1)
    where = _lead_index(ring, idx)
    tree_map(lambda buf, x: buf.index_put_(where, x), ring.data, rows)
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
    reset(state.bad)
    reset(state.good)
    return state


def sample_dual(state: DualReplayState, idx_bad: torch.Tensor,
                idx_good: torch.Tensor, first: int = 0,
                batch: Optional[int] = None):
    """The 50/50 mix of the two memories with JAX's fallbacks
    (``buffer.py:153-195``): of B rows, the first ``from1`` come from
    the bad memory's rows ``idx_bad`` and the rest from the good one's
    ``idx_good`` ([*P, B] each, drawn below each memory's fill, at least
    1); half from each, the good memory's shortfall made up from the
    bad one, all from one memory when the other is empty.  Given
    ``batch``, the indices are rows ``first``, ... of a minibatch of
    ``batch`` rows (a rank's block of the run's minibatch), and the mix
    is that minibatch's."""
    r = idx_bad.shape[-1]
    b = r if batch is None else batch
    half = b // 2
    s1, s2 = state.bad.size, state.good.size
    from1 = torch.where(s2 < half, b - s2, half)
    from1 = torch.minimum(from1, torch.clamp_min(s1, 0))
    from1 = torch.where(s2 == 0, b, from1)
    from1 = torch.where(s1 == 0, 0, from1)
    use1 = (torch.arange(first, first + r, device=idx_bad.device)
            < from1[..., None])
    w1 = _lead_index(state.bad, idx_bad)
    w2 = _lead_index(state.good, idx_good)

    def pick(b1, b2):
        r1, r2 = b1[w1], b2[w2]
        mask = use1.view(use1.shape + (1,) * (r1.dim() - use1.dim()))
        return torch.where(mask, r1, r2)

    return tree_map(pick, state.bad.data, state.good.data)
