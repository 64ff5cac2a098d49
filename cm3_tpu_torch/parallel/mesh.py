"""The mesh, placements and collectives (``cm3_tpu.parallel.mesh``) on
``torch.distributed``.

The JAX package scales data-parallel over a 1-axis
``jax.sharding.Mesh``: env rows and replay shards split over the
``data`` axis, the learner replicated, and XLA inserts the gradient and
metric collectives, so its drivers run unchanged.  The port runs one
process per device: a rank holds its block of the env instances and of
the replay shards and a replica of the learner, and the collectives are
explicit (each counted in ``COUNTS``):

- ``grad``: one all-reduce a backward, the mean of the networks'
  flat gradients over the ranks (``algs/base.py``), before the
  optimizer and its clip read them; the losses are means over a rank's
  rows, so that is the global batch's gradient;
- ``all_gather``: one a lockstep env step, each instance's done flag
  and returns (the completed-episode counts, return sums and episode
  log are then the run's, on every rank) and, with one replay ring
  (``replay_shards`` = 1), the step's transitions: every rank keeps the
  whole ring (W copies of ``buffer_size`` rows) and samples its block
  of each minibatch from it (the dual buffer in one ring gathers its
  staging slabs in a second one);
- ``all_reduce``: once a chunk or burst, the last update's metrics
  averaged (each a mean over a rank's rows); ``adv_norm``'s moments
  once an update; a period row's replay fills;
- ``broadcast``: ``replicate``, so that ranks start equal.

With shard-local replay (``replay_shards`` = k x W) a rank holds k of
the shards, which its own instances feed, and samples them alone.  The
placements are ``torch.distributed.tensor``'s ``Shard(0)`` and
``Replicate()``; they describe where a leaf lives and no DTensor runs
on the training path.  A mesh over a single process without
``torch.distributed`` has size 1 and its collectives are the identity.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from cm3_tpu_torch.core.tree import tree_map
from cm3_tpu_torch.parallel import dist as pdist

# collectives issued since the counts were last set to 0, by kind
COUNTS: collections.Counter = collections.Counter()

# RolloutState's running values (per run or per seed, not per instance):
# replicated whatever their leading dimension
_RUNNING = ("acc_ret_local", "acc_ret_global", "episodes", "eplog",
            "eplog_ep")


class Mesh:
    """A 1-axis mesh of one device a process: ``axis`` its name,
    ``size`` its processes, ``rank`` this process's index along it,
    ``device_mesh`` the named 1-D ``DeviceMesh`` and ``group`` its
    process group (both None on a single process without
    ``torch.distributed``)."""

    def __init__(self, axis: str, size: int, rank: int, device_mesh=None,
                 group=None):
        self.axis, self.size, self.rank = axis, size, rank
        self.device_mesh, self.group = device_mesh, group

    @property
    def shape(self):
        return {self.axis: self.size}

    def __repr__(self):
        return f"Mesh({self.axis}={self.size}, rank {self.rank})"


def make_mesh(n_devices: Optional[int] = None, axis: str = "data") -> Mesh:
    """A mesh over ``n_devices`` processes (all of them by default), on
    ``torch.distributed.device_mesh.init_device_mesh``; raises when
    asked for more devices than the run has (``mesh.py:22-27``)."""
    world = pdist.global_device_count()
    n = n_devices or world
    if world < n:
        raise RuntimeError(f"need {n} devices, have {world}")
    if not dist.is_initialized():
        return Mesh(axis, 1, 0)
    from torch.distributed.device_mesh import init_device_mesh
    dm = init_device_mesh(pdist.device().type, (n,), mesh_dim_names=(axis,))
    return Mesh(axis, n, dm.get_local_rank(axis), dm, dm.get_group(axis))


def data_sharding(mesh: Mesh, axis: str = "data"):
    """The placement of a leaf split along its dim 0 over the mesh's
    axis ``axis``; raises when the mesh has no axis of that name, as
    JAX's ``PartitionSpec(axis)`` does."""
    from torch.distributed.tensor import Shard
    if axis != mesh.axis:
        raise ValueError(f"{mesh!r} has no axis {axis!r}")
    return Shard(0)


def replicated(mesh: Mesh):
    """The placement of a leaf every rank holds whole."""
    from torch.distributed.tensor import Replicate
    return Replicate()


def _block(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's block of ``x``'s dim 0."""
    if x.shape[0] % mesh.size:
        raise ValueError(f"dim 0 of {tuple(x.shape)} does not split over "
                         f"{mesh.size} ranks")
    n = x.shape[0] // mesh.size
    return x.narrow(0, mesh.rank * n, n).clone()


def _place(tree, placements, mesh: Mesh):
    """``tree`` with every leaf whose placement is a ``Shard`` cut to
    this rank's block."""
    from torch.distributed.tensor import Shard
    return tree_map(lambda x, p: _block(x, mesh) if isinstance(p, Shard)
                    else x, tree, placements)


def leading_axis_shardings(mesh: Mesh, shapes, leading: int,
                           axis: str = "data"):
    """``shapes`` (a tree of tensors, on any device, ``meta`` included)
    -> a tree of placements: leaves whose leading dim is ``leading``
    split over the mesh, the rest replicated (``mesh.py:101-108``)."""
    data, repl = data_sharding(mesh, axis), replicated(mesh)
    return tree_map(lambda s: data if (isinstance(s, torch.Tensor)
                                       and s.dim() >= 1
                                       and s.shape[0] == leading) else repl,
                    shapes)


def shard_leading_axis(tree, mesh: Mesh, leading: int, axis: str = "data"):
    """This rank's block of every leaf whose leading dim is ``leading``
    (which the mesh size must divide); the other leaves as they are
    (``mesh.py:38-50``)."""
    return _place(tree, leading_axis_shardings(mesh, tree, leading, axis),
                  mesh)


def _tensors(tree) -> List[torch.Tensor]:
    """Every tensor of ``tree`` in a fixed order: dicts (by key), tuples,
    lists and dataclasses, and a network's one flat buffer (``.flat``)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _tensors(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in _tensors(v)]
    if isinstance(getattr(tree, "flat", None), torch.Tensor):
        return [tree.flat]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [t for f in dataclasses.fields(tree)
                for t in _tensors(getattr(tree, f.name))]
    return []


def _bytes(x: torch.Tensor, rows: int) -> torch.Tensor:
    return x.reshape(rows, -1).contiguous().view(torch.uint8)


def replicate(tree, mesh: Mesh):
    """Every tensor of ``tree`` (an algorithm's state included: its
    networks' flat buffers, Adam moments and counts) overwritten with
    rank 0's, in place, in one broadcast; returns ``tree``
    (``mesh.py:53-55``)."""
    if mesh.group is None:
        return tree
    ts = _tensors(tree)
    buf = torch.cat([_bytes(t, 1)[0] for t in ts])
    COUNTS["broadcast"] += 1
    dist.broadcast(buf, dist.get_global_rank(mesh.group, 0),
                   group=mesh.group)
    at = 0
    for t in ts:
        n = t.numel() * t.element_size()
        t.copy_(buf[at:at + n].view(t.dtype).reshape(t.shape))
        at += n
    return tree


def all_gather_rows(tree, mesh: Mesh):
    """Every leaf [n, ...] of ``tree`` gathered over the mesh into
    [size x n, ...], rank-major, in one collective (the leaves packed as
    bytes, whatever their dtypes)."""
    if mesh.group is None:
        return tree
    leaves = []
    tree_map(leaves.append, tree)
    n = leaves[0].shape[0]
    parts = [_bytes(x, n) for x in leaves]
    buf = torch.cat(parts, dim=1)
    outs = [torch.empty_like(buf) for _ in range(mesh.size)]
    COUNTS["all_gather"] += 1
    dist.all_gather(outs, buf, group=mesh.group)
    full = torch.cat(outs)
    cols = iter(torch.split(full, [p.shape[1] for p in parts], dim=1))
    return tree_map(lambda x: next(cols).contiguous().view(x.dtype).reshape(
        (mesh.size * n,) + tuple(x.shape[1:])), tree)


def mean_over(tensors: Sequence[torch.Tensor], mesh: Mesh,
              kind: str = "all_reduce") -> List[torch.Tensor]:
    """The mean over the ranks of each float32 tensor, in one all-reduce
    (a sum, then / size: every rank gets the same bytes)."""
    if mesh.group is None or not tensors:
        return list(tensors)
    buf = torch.cat([t.reshape(-1) for t in tensors])
    COUNTS[kind] += 1
    dist.all_reduce(buf, group=mesh.group)
    buf.div_(mesh.size)
    return [m.view(t.shape) for t, m in zip(
        tensors, torch.split(buf, [t.numel() for t in tensors]))]


def mean_gradients(grads: Sequence[torch.Tensor], mesh: Mesh) -> None:
    """The networks' flat gradients of one backward replaced by their
    mean over the ranks, in one all-reduce."""
    for g, m in zip(grads, mean_over(grads, mesh, "grad")):
        g.copy_(m)


def sum_over(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``x`` summed over the ranks."""
    if mesh.group is None:
        return x
    x = x.clone()
    COUNTS["all_reduce"] += 1
    dist.all_reduce(x, group=mesh.group)
    return x


def moments(x: torch.Tensor, mesh: Mesh):
    """(mean, population standard deviation) of every rank's ``x`` taken
    together, float32, from one all-reduce of (sum, sum of squares,
    count) in float64."""
    x64 = x.double()
    s = torch.stack([x64.sum(), torch.square(x64).sum(),
                     x64.new_tensor(float(x.numel()))])
    s = sum_over(s, mesh)
    mean = s[0] / s[2]
    var = torch.clamp_min(s[1] / s[2] - mean * mean, 0.0)
    return mean.float(), torch.sqrt(var).float()


def driver_state_shardings(mesh: Mesh, shapes, n_envs: int,
                           replay_shards: int = 1):
    """The placements of ``(ts, buf, rs)`` (``mesh.py:111-134``):
    ``ts``'s fields by name, all replicated; ``rs``'s per-instance
    leaves (leading dim ``n_envs``) split and its running values
    replicated; every replay leaf split with shard-local replay
    (``replay_shards`` > 1: the rings and their [D] cursors), and
    replicated with one ring (every rank keeps the whole ring).  A rank
    can build just its blocks from them: ``n_envs`` / size instances,
    ``replay_shards`` / size shards."""
    ts_s, buf_s, rs_s = shapes
    data, repl = data_sharding(mesh), replicated(mesh)
    ts_sh = {f.name: repl for f in dataclasses.fields(ts_s)}
    rs_sh = tree_map(lambda _: repl, rs_s)
    for f in dataclasses.fields(rs_s):
        if f.name not in _RUNNING and f.name != "mesh":
            setattr(rs_sh, f.name, leading_axis_shardings(
                mesh, getattr(rs_s, f.name), n_envs))

    def ring(b):
        return tree_map(lambda _: data if replay_shards > 1 else repl, b)

    if hasattr(buf_s, "bad"):
        buf_sh = dataclasses.replace(buf_s, bad=ring(buf_s.bad),
                                     good=ring(buf_s.good))
    else:
        buf_sh = ring(buf_s)
    return ts_sh, buf_sh, rs_sh


def shard_driver_state(mesh: Mesh, ts, buf, rs, n_envs: int,
                       replay_shards: int = 1):
    """Place a (state, replay, rollout state) triple of the whole run
    for data-parallel training (``mesh.py:58-89``): the learner
    replicated from rank 0, this rank's block of the instances, and of
    the replay shards (``replay_shards`` a multiple of the mesh size),
    or the whole ring (``replay_shards`` = 1); the dual buffer's two
    memories alike.  The rollout state returned carries the mesh, and a
    driver that steps it trains data-parallel over it."""
    ts_sh, buf_sh, rs_sh = driver_state_shardings(mesh, (ts, buf, rs),
                                                  n_envs, replay_shards)
    ts = replicate(ts, mesh)
    buf = _place(buf, buf_sh, mesh)
    rs = _place(rs, rs_sh, mesh)
    rs.mesh = mesh
    return ts, buf, rs
