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
"""

from __future__ import annotations

from typing import Dict

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
