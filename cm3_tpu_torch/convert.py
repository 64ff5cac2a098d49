"""Load the JAX package's CM3 state into the port.

Takes the state as host arrays (``jax.device_get`` of a
``cm3_tpu.algs.cm3.CM3State``) and never imports JAX: flax variable
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
    return torch.from_numpy(np.concatenate(parts)).to(module.flat.device)


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


def state_from_jax(alg, jts):
    """A port ``CM3State`` holding the values of the JAX ``jts`` (host
    arrays): parameters, targets, and each network's Adam state."""
    st = alg.empty_state()
    for name in ("actor", "qg", "qc"):
        main, tgt = getattr(st, name), getattr(st, name + "_tgt")
        load_params(main, getattr(jts, name))
        load_params(tgt, getattr(jts, name + "_tgt"))
        adam = getattr(jts, "opt_" + name)[0]
        opt = getattr(st, "opt_" + name)
        opt.mu.copy_(flat_to_torch(main, adam.mu))
        opt.nu.copy_(flat_to_torch(main, adam.nu))
        opt.count = int(adam.count)
    st.step = int(jts.step)
    return st
