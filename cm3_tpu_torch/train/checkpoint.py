"""Checkpoints and the two-stage curriculum graft
(``cm3_tpu.train.checkpoint``).

Every stage-2-only branch of a network lives under a module named
``stage2`` (``models/nets.py``), so the curriculum restore of the
reference (a Saver that skips the stage-2 scopes, then Q_global's
weights copied into Q_credit and the targets hard-set to their mains,
``train_offpolicy.py:155-198``, ``alg_credit.py:227-246``) copies
parameters by name:

  * ``graft_params(dst, src)``: every leaf of ``dst`` whose name avoids
    ``stage2`` takes the same-named leaf of ``src``; a shape mismatch
    raises;
  * ``stage2_init_cm3``: stage-1 actor and Q_global into stage 2's,
    the grafted Q_global into Q_credit, every target equal to its main;
    stage 2's fresh optimizer and V (all of it under ``stage2``) stay;
  * ``stage2_init_baseline``: the stage-1 actor, and V where stage 1
    trained one, into stage 2's; the COMA critic (all of it under
    ``stage2``) stays fresh.  QMIX grafts nothing: the JAX runner
    restores its stage-1 checkpoint and keeps the fresh state.

A state is any of the port's algorithm states (``CM3State``,
``BaselineState``, ``QmixState``): every field but ``step`` and the
``opt_<name>`` optimizer states is a network or None.

A network is one flat buffer (``nets.flatten_parameters``) or, with
seeds in lockstep, one [S, n] buffer (``nets.SeedStack``) whose leaves
and gradients are views into it, and which the optimizer updates as one
segment.  So the graft, ``copy_tree``, ``merge_non_opt`` and
``restore`` write into the existing buffers with ``copy_`` and never
rebind a buffer or a leaf: a rebound leaf would leave the optimizer
updating a buffer that the forward pass no longer reads.  Leaves are
cut from the flat buffer in the order of ``nets.ordered_parameters``
(the flax ``ravel_pytree`` order), which is also how stage 2's
``stage2`` leaves sit between the shared ones: a stage-1 buffer's
offsets are not stage 2's, so the graft goes by name, never by offset.

Persistence is torch's own format: ``save(path, state)`` writes a
directory holding one ``torch.save`` file (written under a temporary
name, then ``os.replace``d, since the autosave is rewritten every
period), loaded back with ``weights_only=True``.  It holds, per
network, the leaves by name in torch layout (with a leading [S] for a
seed stack), the Adam ``mu``/``nu`` by the same names, the Adam
``count`` and whether the optimizer clips, and the state's ``step``.
The format does not depend on the parameter layout: ``seed_state``
takes seed ``i`` out of a stack as a one-seed state (what a per-seed
``model_final`` holds) and ``stack_states`` stacks one-seed states.
The replay ring is not saved, as in the JAX package: a resumed run
warms it with policy rollouts first.  A JAX (orbax) checkpoint cannot
be read without JAX; ``convert.state_from_jax`` takes a JAX state
across.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Sequence

import numpy as np
import torch

from cm3_tpu_torch.models import nets

FORMAT = "cm3_tpu_torch.checkpoint/1"
FILE = "state.pt"


# --------------------------------------------------------------------- #
# leaves by name
# --------------------------------------------------------------------- #


def _module(net):
    return net.module if isinstance(net, nets.SeedStack) else net


def named_views(net, flat=None) -> Dict[str, torch.Tensor]:
    """name -> the leaf's view into ``flat`` (the network's parameter
    buffer by default, or an Adam moment of its shape): [*shape], or
    [S, *shape] for a seed stack."""
    flat = net.flat if flat is None else flat
    out, off = {}, 0
    for name, p in nets.ordered_parameters(_module(net)):
        k = p.numel()
        out[name] = flat[..., off:off + k].unflatten(-1, p.shape)
        off += k
    if off != flat.shape[-1]:
        raise ValueError(f"a buffer of {flat.shape[-1]} floats for a "
                         f"network of {off}")
    return out


@torch.no_grad()
def graft_params(dst, src, skip_token: str = "stage2"):
    """Copy into every leaf of the network ``dst`` whose name has no
    component ``skip_token`` the same-named leaf of ``src``, in place;
    leaves that ``src`` lacks stay.  Shapes must match: that is the
    stage-compatibility contract (the reference's Saver fails alike).
    Returns ``dst``."""
    src_v = named_views(src)
    for name, d in named_views(dst).items():
        if skip_token in name.split(".") or name not in src_v:
            continue
        s = src_v[name]
        if s.shape != d.shape:
            raise ValueError(
                f"graft shape mismatch at {nets.flax_path(name)}: "
                f"{tuple(s.shape)} vs {tuple(d.shape)}")
        d.copy_(s)
    return dst


@torch.no_grad()
def copy_tree(dst, src):
    """``dst``'s parameters set equal to ``src``'s, in place."""
    if dst.flat.shape != src.flat.shape:
        raise ValueError(f"copy between buffers of {tuple(src.flat.shape)} "
                         f"and {tuple(dst.flat.shape)}")
    dst.flat.copy_(src.flat)
    return dst


def stage2_init_cm3(ts2, stage1_actor, stage1_qg):
    """The CM3 curriculum restore (``train_offpolicy.py:181-198``), in
    place on the stage-2 state ``ts2``:

      1. stage-1 actor -> stage-2 actor (leaves outside ``stage2``);
      2. stage-1 Q_global -> stage-2 Q_global;
      3. the grafted Q_global -> Q_credit (leaves outside ``stage2``);
      4. every target equal to its main.

    The optimizer states and V stay as ``ts2`` has them.  Returns
    ``ts2``."""
    graft_params(ts2.actor, stage1_actor)
    graft_params(ts2.qg, stage1_qg)
    if ts2.qc is not None:
        graft_params(ts2.qc, ts2.qg)
    for name in ("actor", "qg", "qc"):
        if getattr(ts2, name) is not None:
            copy_tree(getattr(ts2, name + "_tgt"), getattr(ts2, name))
    return ts2


def stage2_init_baseline(ts2, stage1_actor, stage1_v=None):
    """The baselines' curriculum restore (``checkpoint.py:98-110`` of the
    JAX package), in place on the stage-2 state ``ts2``: the stage-1
    actor -> stage 2's (leaves outside ``stage2``), and V likewise when
    both states have one; the actor's target, and V's, set equal to
    their mains.  COMA's critic and every optimizer state stay as
    ``ts2`` has them.  Returns ``ts2``."""
    graft_params(ts2.actor, stage1_actor)
    copy_tree(ts2.actor_tgt, ts2.actor)
    if ts2.v is not None:
        if stage1_v is not None:
            graft_params(ts2.v, stage1_v)
        copy_tree(ts2.v_tgt, ts2.v)
    return ts2


def _nets(ts):
    """(field name, network) of the state's parameter fields."""
    return [(f.name, getattr(ts, f.name)) for f in dataclasses.fields(ts)
            if f.name != "step" and not f.name.startswith("opt_")]


def merge_non_opt(fresh, restored):
    """Every non-optimizer field of ``restored`` (parameters, targets,
    ``step``) copied into ``fresh``, whose optimizer states stay as they
    are; in place, returns ``fresh``.  For a checkpoint whose optimizer
    differs from the configured one (``AlgConfig.grad_clip`` on where it
    was off, or off where it was on): restores at the start of a run
    only consume parameters and targets, and the optimizer starts
    fresh."""
    for name, net in _nets(fresh):
        other = getattr(restored, name)
        if (net is None) != (other is None):
            raise ValueError(f"{name}: present in only one of the states")
        if net is not None:
            copy_tree(net, other)
    fresh.step = restored.step
    return fresh


# --------------------------------------------------------------------- #
# seeds
# --------------------------------------------------------------------- #


@torch.no_grad()
def seed_state(alg, stacked, i: int):
    """Seed ``i`` of the seed-stacked state ``stacked`` as a one-seed
    state of ``alg`` (an algorithm without seeds: ``alg.for_seeds(None)``)."""
    st = alg.empty_state()
    for name, net in _nets(st):
        if net is not None:
            net.flat.copy_(getattr(stacked, name).flat[i])
    for name in alg.net_names():
        o, src = getattr(st, "opt_" + name), getattr(stacked, "opt_" + name)
        o.mu.copy_(src.mu[i])
        o.nu.copy_(src.nu[i])
        o.count, o.clipped = src.count, src.clipped
    st.step = stacked.step
    return st


@torch.no_grad()
def stack_states(alg, states: Sequence):
    """One-seed states (equal step and Adam counts, as seeds in lockstep
    keep) stacked into a state of ``alg`` (built for ``len(states)``
    seeds)."""
    if alg.n_seeds != len(states):
        raise ValueError(f"{len(states)} states for {alg.n_seeds} seeds")
    st = alg.empty_state()
    for i, one in enumerate(states):
        for name, net in _nets(st):
            if net is not None:
                net.flat[i].copy_(getattr(one, name).flat)
        for name in alg.net_names():
            o, src = getattr(st, "opt_" + name), getattr(one, "opt_" + name)
            o.mu[i].copy_(src.mu)
            o.nu[i].copy_(src.nu)
            if i and (o.count, o.clipped) != (src.count, src.clipped):
                raise ValueError(f"opt_{name}: seeds in lockstep share one "
                                 "Adam count")
            o.count, o.clipped = src.count, src.clipped
        if i and st.step != one.step:
            raise ValueError("seeds in lockstep share one step count")
        st.step = one.step
    return st


# --------------------------------------------------------------------- #
# persistence
# --------------------------------------------------------------------- #


def _host(t: torch.Tensor) -> torch.Tensor:
    # a leaf of its own (a view would save the whole flat buffer)
    return t.detach().cpu().clone(memory_format=torch.contiguous_format)


def _pack(ts) -> Dict:
    nets_, opts = {}, {}
    for name, net in _nets(ts):
        if net is None:
            continue
        nets_[name] = {k: _host(v) for k, v in named_views(net).items()}
        opt = getattr(ts, "opt_" + name, None)
        if opt is not None:
            opts[name] = {
                "mu": {k: _host(v) for k, v in named_views(
                    net, opt.mu).items()},
                "nu": {k: _host(v) for k, v in named_views(
                    net, opt.nu).items()},
                "count": int(opt.count), "clipped": bool(opt.clipped)}
    return {"nets": nets_, "opt": opts, "step": int(ts.step)}


def save(path: str, state) -> None:
    """Save an algorithm's state, or a dict ``{"ts": state, "episodes": n}``
    (``n`` an int, or per-seed counts), to the directory ``path``."""
    payload = {"format": FORMAT}
    if isinstance(state, dict):
        payload["ts"] = _pack(state["ts"])
        payload["episodes"] = torch.as_tensor(
            np.asarray(state["episodes"], np.int64))
    else:
        payload["ts"] = _pack(state)
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, FILE + ".tmp")
    torch.save(payload, tmp)
    os.replace(tmp, os.path.join(path, FILE))


@torch.no_grad()
def _copy_leaves(what, views, saved):
    if set(views) != set(saved):
        raise ValueError(f"{what}: the checkpoint's leaves "
                         f"{sorted(saved)} are not {sorted(views)}")
    for k, v in views.items():
        if tuple(saved[k].shape) != tuple(v.shape):
            raise ValueError(f"{what}.{k}: shape {tuple(saved[k].shape)} "
                             f"in the checkpoint, {tuple(v.shape)} here")
        v.copy_(saved[k])


def _unpack(like, d: Dict):
    have = {name for name, net in _nets(like) if net is not None}
    if have != set(d["nets"]):
        raise ValueError(f"the checkpoint holds {sorted(d['nets'])}, the "
                         f"state {sorted(have)}")
    opts = {name: getattr(like, "opt_" + name, None) for name in have}
    for name, opt in opts.items():
        saved = d["opt"][name]["clipped"] if opt is not None else None
        if opt is not None and saved != opt.clipped:
            raise ValueError(
                f"opt_{name}: the checkpoint's optimizer "
                f"{'clips' if saved else 'does not clip'} the global norm, "
                f"this one {'does' if opt.clipped else 'does not'} "
                "(grad_clip)")
    for name, net in _nets(like):
        if net is None:
            continue
        _copy_leaves(name, named_views(net), d["nets"][name])
        opt = opts[name]
        if opt is None:
            continue
        saved = d["opt"][name]
        _copy_leaves("opt_" + name + ".mu", named_views(net, opt.mu),
                     saved["mu"])
        _copy_leaves("opt_" + name + ".nu", named_views(net, opt.nu),
                     saved["nu"])
        opt.count = int(saved["count"])
    like.step = int(d["step"])
    return like


def exists(path: str) -> bool:
    """Whether ``save`` has completed a checkpoint at ``path``."""
    return os.path.isfile(os.path.join(path, FILE))


def restore(path: str, like):
    """Restore what ``save`` wrote at ``path`` into ``like`` (an
    algorithm's state, or ``{"ts": state, "episodes": ...}``) in place,
    its buffers kept; returns it, with ``episodes`` an int or per-seed
    counts.  A
    checkpoint of other networks, shapes or optimizer structure raises
    ``ValueError``."""
    d = torch.load(os.path.join(path, FILE), map_location="cpu",
                   weights_only=True)
    if d.get("format") != FORMAT:
        raise ValueError(f"{path}: not a {FORMAT} checkpoint")
    if not isinstance(like, dict):
        return _unpack(like, d["ts"])
    if "episodes" not in d:
        raise ValueError(f"{path}: a state without an episode count")
    ep = d["episodes"].numpy()
    return {"ts": _unpack(like["ts"], d["ts"]),
            "episodes": int(ep) if ep.ndim == 0 else ep}
