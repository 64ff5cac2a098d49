"""Load the JAX package's algorithm states into the port.

Takes the state as host arrays (``jax.device_get`` of a
``cm3_tpu.algs.cm3.CM3State``, ``baseline.BaselineState`` or
``qmix.QmixState``) and never imports JAX: flax variable
dicts are nested dicts of arrays, and the optimizer states are read by
attribute (``opt_state[0].count``, ``.mu``, ``.nu``).

Layouts.  A flax Dense kernel is [in, out] and becomes
``Linear.weight`` [out, in]; a flax Conv kernel is HWIO and becomes
``Conv2d.weight`` OIHW; ``W_h2``, ``b`` and biases keep their shapes.
The port keeps each network in one flat f32 buffer whose leaves follow
``ravel_pytree``'s order (the sorted-key flatten of the flax dict), each
leaf in torch layout.  The JAX Adam moments are flat vectors in
``ravel_pytree`` order with leaves in flax layout, so they are cut into
leaves, transposed the same way, and joined again.

QMIX's agent net and mixer are one network in the port
(``nets.QmixJoint``): JAX's ``agent`` and ``mixer`` params join under
``agent`` and ``mixer``, whose sorted flatten is ``ravel_pytree`` of
the pair (agent, mixer), the order of JAX's one flat Adam state
``opt``, which loads whole.

A JAX state of seeds in lockstep (``jax.vmap(alg.init_state)``, every
leaf with a leading seed axis) loads into the port's seed-stacked
state (``n_seeds=S``), row by row.

The other way, for the TensorBoard writer (``train/tboard.py``):
``jax_leaves`` gives a port state's float leaves under the names and
in the order that ``jax.tree_util.tree_leaves_with_path`` gives the
JAX state of the same algorithm, each in flax layout (QMIX's joint
network split into ``agent`` / ``mixer``, the Adam moments as JAX's
flat vectors), and ``jax_grad_leaves`` the same for the gradients of
``update(..., with_grads=True)``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from cm3_tpu_torch.core.tree import tree_leaves
from cm3_tpu_torch.models import nets


def _flax_shape(path, torch_shape):
    if path[-1] == "kernel" and len(torch_shape) == 4:   # OIHW -> HWIO
        o, i, h, w = torch_shape
        return (h, w, i, o)
    if path[-1] == "kernel" and len(torch_shape) == 2:   # [out,in] -> [in,out]
        return tuple(reversed(torch_shape))
    return tuple(torch_shape)


def _to_torch_layout(path, arr):
    if path[-1] == "kernel" and arr.ndim == 4:
        return arr.transpose(3, 2, 0, 1)
    if path[-1] == "kernel" and arr.ndim == 2:
        return arr.T
    return arr


def _to_flax_layout(path, arr):
    """``_to_torch_layout``'s inverse."""
    if path[-1] == "kernel" and arr.ndim == 4:           # OIHW -> HWIO
        return arr.transpose(2, 3, 1, 0)
    if path[-1] == "kernel" and arr.ndim == 2:
        return arr.T
    return arr


def flat_to_torch(module, vec) -> torch.Tensor:
    """A flat vector over the flax leaves of ``module``'s network
    (``ravel_pytree`` order, flax layouts) -> the same values in the
    port's flat layout, on the module's device."""
    vec = np.asarray(vec, np.float32).reshape(-1)
    parts, off = [], 0
    for name, p in nets.ordered_parameters(module):
        path = nets.flax_path(name)
        k = p.numel()
        leaf = vec[off:off + k].reshape(_flax_shape(path, tuple(p.shape)))
        parts.append(_to_torch_layout(path, leaf).reshape(-1))
        off += k
    if off != vec.size:
        raise ValueError(f"flat vector has {vec.size} values, the network "
                         f"{off}")
    dev = next(module.parameters()).device
    return torch.from_numpy(np.concatenate(parts)).to(dev)


def params_to_flat(module, variables: Dict) -> torch.Tensor:
    """flax variables ``{"params": ...}`` -> the port's flat layout,
    checking that the leaves are the module's parameters."""
    leaves = list(tree_leaves(variables["params"]))
    want = [nets.flax_path(n) for n, _ in nets.ordered_parameters(module)]
    got = [path for path, _ in leaves]
    if got != want:
        raise ValueError(f"flax leaves {got} do not match the module's "
                         f"{want}")
    return flat_to_torch(module, np.concatenate(
        [np.asarray(x, np.float32).reshape(-1) for _, x in leaves]))


def load_params(module, variables: Dict):
    """Copy flax variables into a flattened module (in place)."""
    module.flat.copy_(params_to_flat(module, variables))
    return module


def _adam(opt_state):
    """The ``ScaleByAdamState`` (count, mu, nu) inside a network's optax
    state, wherever the chain (clip, scale) put it."""
    if hasattr(opt_state, "mu"):
        return opt_state
    for part in opt_state if isinstance(opt_state, tuple) else ():
        found = _adam(part)
        if found is not None:
            return found
    return None


def _seed_slice(tree, s):
    if isinstance(tree, dict):
        return {k: _seed_slice(v, s) for k, v in tree.items()}
    return np.asarray(tree)[s]


def _jax_fields(jts, name):
    """(params, target params, optax state) of the port's network
    ``name`` in the JAX state ``jts``."""
    if name == "qmix":
        join = lambda a, m: {"params": {"agent": a["params"],
                                        "mixer": m["params"]}}
        return (join(jts.agent, jts.mixer),
                join(jts.agent_tgt, jts.mixer_tgt), jts.opt)
    return (getattr(jts, name), getattr(jts, name + "_tgt"),
            getattr(jts, "opt_" + name))


def state_from_jax(alg, jts):
    """A port state of ``alg`` (CM3, Baseline or QMIX) holding the values
    of the JAX ``jts`` (host arrays): parameters, targets, and each
    network's Adam state.  For an algorithm with ``n_seeds`` the JAX
    state carries a leading seed axis on every leaf."""
    st = alg.empty_state()
    seeds = alg.n_seeds
    for name in alg.net_names():
        main, tgt = getattr(st, name), getattr(st, name + "_tgt")
        params, tgt_params, opt_state = _jax_fields(jts, name)
        adam = _adam(opt_state)
        opt = getattr(st, "opt_" + name)
        if seeds is None:
            load_params(main, params)
            load_params(tgt, tgt_params)
            opt.mu.copy_(flat_to_torch(main, adam.mu))
            opt.nu.copy_(flat_to_torch(main, adam.nu))
            opt.count = int(adam.count)
            continue
        tmpl = main.module
        for s in range(seeds):
            for net, tree in ((main, params), (tgt, tgt_params)):
                net.flat[s].copy_(params_to_flat(tmpl, _seed_slice(tree, s)))
            opt.mu[s].copy_(flat_to_torch(tmpl, np.asarray(adam.mu)[s]))
            opt.nu[s].copy_(flat_to_torch(tmpl, np.asarray(adam.nu)[s]))
        counts = np.asarray(adam.count).reshape(-1)
        if (counts != counts[0]).any():
            raise ValueError(f"{name}: seeds in lockstep share one step "
                             f"count, got {counts}")
        opt.count = int(counts[0])
    steps = np.asarray(jts.step).reshape(-1)
    st.step = int(steps[0])
    return st


# --------------------------------------------------------------------- #
# the other way: a port state's values under JAX's names and layouts
# --------------------------------------------------------------------- #

# the networks that JAX's ``update(..., with_grads=True)`` names in
# ``metrics["grads"]``: state field (and QMIX's part of the joint net)
GRAD_NETS = {"Policy": ("actor", None), "Q_global": ("qg", None),
             "Q_credit": ("qc", None), "V": ("v", None), "Q": ("q", None),
             "Agent": ("qmix", "agent"), "Mixer": ("qmix", "mixer")}


def _template(net):
    return net.module if isinstance(net, nets.SeedStack) else net


def _flax_leaves(module, vec, prefix):
    """(tag, leaf in flax layout) of the flat host vector ``vec`` over
    ``module``'s parameters, in ``ravel_pytree`` order."""
    off = 0
    for name, p in nets.ordered_parameters(module):
        k = p.numel()
        path = nets.flax_path(name)
        yield prefix + "/".join(path), _to_flax_layout(
            path, vec[off:off + k].reshape(tuple(p.shape)))
        off += k


def _flax_flat(module, vec):
    """A flat host vector in the port's layout -> the same values in
    flax layout, ``ravel_pytree`` order (JAX's flat Adam moments)."""
    return np.concatenate([leaf.reshape(-1) for _, leaf
                           in _flax_leaves(module, vec, "")])


def _host_rows(tensors, seed):
    """One device -> host copy of ``tensors`` (row ``seed`` of each, if
    given): a list of float32 host vectors."""
    rows = [(t if seed is None else t[seed]).reshape(-1) for t in tensors]
    host = torch.cat(rows).detach().cpu().numpy()
    out, off = [], 0
    for r in rows:
        out.append(host[off:off + r.numel()])
        off += r.numel()
    return out


def _net_fields(ts):
    """(JAX field name, module template, flat buffer) of every network
    and target of ``ts`` in the JAX state's field order (QMIX's joint
    network split into its agent nets and mixer, the fields of JAX's
    ``QmixState``), then (``opt_<name>`` path, template, mu, nu) of
    every Adam state."""
    params, opts = [], []
    if hasattr(ts, "qmix"):
        tmpl = _template(ts.qmix)
        n_agent = tmpl.agent_size()
        for part, sl in (("agent", slice(None, n_agent)),
                         ("mixer", slice(n_agent, None))):
            for suffix in ("", "_tgt"):
                flat = getattr(ts, "qmix" + suffix).flat[..., sl]
                params.append((part + suffix, getattr(tmpl, part), flat))
        opts.append(("opt", tmpl, ts.opt_qmix))
        return params, opts
    names = [f.name for f in dataclasses.fields(ts)
             if f.name != "step" and not f.name.startswith("opt_")
             and not f.name.endswith("_tgt")]
    # JAX's field order: each network then its target, the optimizers
    # after them all (CM3State: actor, qg, qc, v; BaselineState:
    # actor, v, q)
    order = {"actor": 0, "qg": 1, "qc": 2, "v": 3, "q": 4}
    for name in sorted(names, key=order.__getitem__):
        if getattr(ts, name) is None:
            continue
        for suffix in ("", "_tgt"):
            net = getattr(ts, name + suffix)
            params.append((name + suffix, _template(net), net.flat))
    for name in sorted(names, key=order.__getitem__):
        if getattr(ts, name) is not None:
            opts.append(("opt_" + name, _template(getattr(ts, name)),
                         getattr(ts, "opt_" + name)))
    return params, opts


def jax_leaves(ts, seed: Optional[int] = None):
    """(name, host float32 array) of every float leaf that JAX's
    ``jax.tree_util.tree_leaves_with_path`` finds in the JAX state of
    the same algorithm, in its order and under ``tboard.log_train_state``'s
    names: ``actor/params/conv/kernel`` (flax layout), ...,
    ``opt_actor/0/mu`` (``opt_actor/1/0/mu`` with the global-norm clip,
    an optax chain), ...; the int leaves (``step``, the Adam counts)
    are skipped as JAX's writer skips them.  ``seed`` picks one seed of
    a seed-stacked state.  The state is read to the host in one copy."""
    params, opts = _net_fields(ts)
    tensors = [flat for _, _, flat in params]
    for _, _, opt in opts:
        tensors += [opt.mu, opt.nu]
    host = _host_rows(tensors, seed)
    out = []
    for (name, tmpl, _), vec in zip(params, host):
        out += list(_flax_leaves(tmpl, vec, name + "/params/"))
    for i, (name, tmpl, opt) in enumerate(opts):
        idx = "1/0" if opt.clipped else "0"
        mu, nu = host[len(params) + 2 * i:len(params) + 2 * i + 2]
        out.append((f"{name}/{idx}/mu", _flax_flat(tmpl, mu)))
        out.append((f"{name}/{idx}/nu", _flax_flat(tmpl, nu)))
    return out


def jax_grad_leaves(ts, grads, seed: Optional[int] = None):
    """(name, host float32 array in flax layout) of the gradients
    ``grads`` (``metrics["grads"]`` of ``update(..., with_grads=True)``
    of ``ts``'s algorithm: JAX's name -> flat gradient in the port's
    layout, [n] or [S, n]) as JAX's writer names its ``metrics["grads"]``
    leaves, in its sorted-key order: ``Policy/params/conv/kernel``, ...;
    in one host copy."""
    names = sorted(grads)
    host = _host_rows([grads[n] for n in names], seed)
    out = []
    for name, vec in zip(names, host):
        field, part = GRAD_NETS[name]
        tmpl = _template(getattr(ts, field))
        tmpl = tmpl if part is None else getattr(tmpl, part)
        out += list(_flax_leaves(tmpl, vec, name + "/params/"))
    return out
