"""A training cell's initial weights, made on the device from the seed.

One generator on the device, one draw per parameter tensor over all S
seeds at once, each network's [S, n] flat buffer in ``ravel_pytree``
order (the layout of the port's flat buffers and seed stacks), drawn as
the configuration's init scheme draws one seed's in the port
(``models/nets.py:init_parameters``: Glorot-uniform kernels, zero
biases, the combination matrices truncated-normal at 0.01).  Program and reference start from
the same buffers; the target networks start equal to their networks."""

from __future__ import annotations

import math

import torch

from benchmark.reference.port import nets, prng


def layout(alg):
    """{network name: [(parameter name, shape, offset)]} of ``alg``'s
    networks in ``ravel_pytree`` order, from the frozen copy's modules."""
    out = {}
    makers = [m for m in alg._makers() if m is not None]
    for name, make in zip(alg.net_names(), makers):
        leaves, off = [], 0
        for pname, p in nets.ordered_parameters(make()):
            leaves.append((pname, tuple(p.shape), off))
            off += p.numel()
        out[name] = leaves
    return out


def _fill(view, pname, shape, gen, scheme):
    """Draw one parameter tensor of every seed into ``view`` [S, *shape]
    as the port's ``init_parameters`` draws one seed's (no FC3 here:
    CM3's nets have none)."""
    leaf = pname.split(".")[-1]
    if leaf == "bias" or (leaf == "b" and scheme != "tf1"):
        view.zero_()
    elif leaf in ("W_h2", "W_concated_h2", "hyper_w_1", "hyper_w_final") \
            or (leaf in ("weight", "hyper_b_1") and scheme == "trunc001"):
        torch.nn.init.trunc_normal_(view, 0.0, 0.01, -0.02, 0.02,
                                    generator=gen)
    elif leaf in ("weight", "hyper_b_1"):
        receptive = math.prod(shape[2:]) if len(shape) > 2 else 1
        fan_in, fan_out = shape[1] * receptive, shape[0] * receptive
        limit = math.sqrt(6.0 / (fan_in + fan_out))
        view.uniform_(-limit, limit, generator=gen)
    elif leaf == "b":
        limit = math.sqrt(3.0 / shape[0])
        view.uniform_(-limit, limit, generator=gen)
    else:
        raise KeyError(f"no initializer for parameter {pname!r}")


@torch.no_grad()
def make_weights(alg, n_seeds: int, seed: int, device):
    """{network name: [S, n] float32 on ``device``} for ``alg``'s
    networks, from ``seed``."""
    gen = prng.generator(prng.for_purpose(prng.root_key(seed), prng.PARAMS),
                         device)
    out = {}
    for name, leaves in layout(alg).items():
        n = sum(math.prod(shape) for _, shape, _ in leaves)
        flat = torch.empty((n_seeds, n), dtype=torch.float32, device=device)
        for pname, shape, off in leaves:
            view = flat[:, off:off + math.prod(shape)]
            _fill(view, pname, shape, gen, alg.cfg.init_scheme)
        out[name] = flat
    return out
