"""Shared algorithm utilities (``cm3_tpu.algs.common``)."""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

# TF1 AdamOptimizer defaults (reference; ``common.adam``): beta1, beta2, eps
B1, B2, EPS = 0.9, 0.999, 1e-8


@dataclasses.dataclass
class AdamState:
    """One network's Adam state over its flat parameter vector: the
    ``optax.flatten(optax.adam)`` state of the JAX package, with flat
    ``mu``/``nu`` in ``ravel_pytree`` order and ``count`` the number of
    steps taken.  ``count`` is a host integer: the host knows it, so the
    bias corrections cost no device round trip."""

    mu: torch.Tensor
    nu: torch.Tensor
    count: int = 0


def adam_init(flat: torch.Tensor) -> AdamState:
    """Zero moments for a flat f32 parameter vector.  One flat buffer
    per network is also what keeps the tree dtype-uniform, which the
    JAX ``common.adam`` asserts."""
    if flat.dtype != torch.float32 or flat.dim() != 1:
        raise TypeError("adam_init wants one flat float32 vector")
    return AdamState(mu=torch.zeros_like(flat), nu=torch.zeros_like(flat))


def soft_update(target: torch.Tensor, main: torch.Tensor, tau: float):
    """Polyak target update t <- tau*m + (1-tau)*t, in place on flat
    buffers (reference alg_credit.py:162-225)."""
    target.copy_(tau * main + (1.0 - tau) * target)
    return target


def one_hot(x, n):
    return F.one_hot(x.long(), n).float()


def others_concat(x):
    """[B, N, D] -> [B, N, (N-1)*D]: row n is the concat of all m != n in
    index order (alg_credit.py:501-557); N > 1."""
    n = x.shape[1]
    return torch.stack(
        [torch.cat([x[:, m] for m in range(n) if m != i], dim=-1)
         for i in range(n)], dim=1)


def others_stack(x):
    """[B, N, ...] -> [B, N, N-1, ...]: per-agent view of the others'
    rows (alg_credit.py:406-443); N > 1."""
    n = x.shape[1]
    return torch.stack(
        [torch.stack([x[:, m] for m in range(n) if m != i], dim=1)
         for i in range(n)], dim=1)


def epsilon_probs(probs, epsilon, n_actions):
    """(1-eps)*pi + eps/A (reference alg_credit.py:121)."""
    return (1.0 - epsilon) * probs + epsilon / float(n_actions)


def sample_actions(probs, gumbel):
    """Categorical sample over the trailing action axis, any leading
    dims: argmax(log(probs + 1e-20) + gumbel), which is what
    ``jax.random.categorical`` computes for the JAX package's
    ``sample_actions`` (reference tf.multinomial(tf.log(probs)),
    alg_credit.py:122).  ``gumbel`` is standard Gumbel noise of
    ``probs``' shape; keep the 1e-20 floor, which decides near-zero
    probabilities."""
    return torch.argmax(torch.log(probs + 1e-20) + gumbel, dim=-1)


def flatten_bn(x):
    """[B, N, ...] -> [B*N, ...]."""
    return x.reshape((x.shape[0] * x.shape[1],) + tuple(x.shape[2:]))
