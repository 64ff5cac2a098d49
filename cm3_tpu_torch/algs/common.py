"""Shared algorithm utilities (``cm3_tpu.algs.common``).

Every function here works on one seed's tensors and, unchanged, on
tensors with a leading seed axis [S, ...]: the optimizer reduces over
the last axis only, and the other helpers are elementwise or index the
trailing axes.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

# TF1 AdamOptimizer defaults (reference; ``common.adam``): beta1, beta2, eps
B1, B2, EPS = 0.9, 0.999, 1e-8


@dataclasses.dataclass
class AdamState:
    """One network's Adam state over its flat parameter vector: the
    ``optax.flatten(optax.adam)`` state of the JAX package, with flat
    ``mu``/``nu`` in ``ravel_pytree`` order ([n], or [S, n] for S seeds
    in lockstep) and ``count`` the number of steps taken.  ``count`` is
    a host integer, the same for every seed: the host knows it, so the
    bias corrections cost no device round trip.  ``clipped`` records
    whether the optimizer clips the global norm first: in the JAX
    package that changes the optax chain's state structure, so a
    checkpoint taken with the clip off does not restore into a state
    with it on, nor the other way round (``train/checkpoint.py``)."""

    mu: torch.Tensor
    nu: torch.Tensor
    count: int = 0
    clipped: bool = False


def adam_init(flat: torch.Tensor, clipped: bool = False) -> AdamState:
    """Zero moments for a flat f32 parameter buffer, [n] or [S, n].  One
    flat buffer per network is also what keeps the tree dtype-uniform,
    which the JAX ``common.adam`` asserts."""
    if flat.dtype != torch.float32 or flat.dim() not in (1, 2):
        raise TypeError("adam_init wants a flat float32 buffer, [n] or "
                        "[S, n]")
    return AdamState(mu=torch.zeros_like(flat), nu=torch.zeros_like(flat),
                     clipped=clipped)


def bias_corrections(count: int):
    """(1 - b1^t, 1 - b2^t) in float32 for the step after ``count``
    steps (t = count + 1), as optax computes them from its incremented
    count."""
    t = np.float32(count + 1)
    one = np.float32(1.0)
    return (float(one - np.power(np.float32(B1), t)),
            float(one - np.power(np.float32(B2), t)))


def ieee_sqrt(x):
    """The correctly rounded float32 square root.  On the card that is
    ``torch.sqrt``; on the CPU PyTorch's vectorized ``sqrt`` misses it
    on ~0.7% of inputs, so there it is the float64 root rounded to
    float32 (53 >= 2 x 24 + 2 bits, so the double rounding is exact)."""
    if x.device.type == "cpu":
        return torch.sqrt(x.double()).float()
    return torch.sqrt(x)


def clip_by_global_norm(g: torch.Tensor, max_norm: float) -> torch.Tensor:
    """``optax.clip_by_global_norm`` over one network's flat gradient:
    g where its norm is below ``max_norm``, else g / norm * max_norm.
    With a seed axis [S, n] each seed has its own norm."""
    norm = torch.sqrt(torch.sum(g * g, dim=-1, keepdim=True))
    return torch.where(norm < max_norm, g, (g / norm) * max_norm)


def adam_apply(st: AdamState, params: torch.Tensor, grads: torch.Tensor,
               lr: float, clip: float = 0.0, lr_scale=None):
    """One ``common.adam(lr, clip)`` step (optax's order and rounding)
    applied to the flat ``params`` in place, advancing ``st`` in place:

        g   <- clip_by_global_norm(g, clip)          (clip > 0 only)
        mu  <- (1-b1)*g + b1*mu ;  nu <- (1-b2)*g**2 + b2*nu
        u   <- -lr * (mu/c1) / (sqrt(nu/c2) + eps) [* lr_scale]
        p   <- p + u

    with c1 = 1-b1^t, c2 = 1-b2^t after the count is incremented.
    ``lr_scale`` (a float32 value, optional) scales the step as the
    JAX update does for the actor's lr anneal.  Plain PyTorch ops; the
    JAX package runs this as plain XLA, not as a kernel."""
    if clip and clip > 0.0:
        grads = clip_by_global_norm(grads, clip)
    mu = (1.0 - B1) * grads + B1 * st.mu
    nu = (1.0 - B2) * (grads * grads) + B2 * st.nu
    c1, c2 = (torch.full((), c, dtype=torch.float32, device=params.device)
              for c in bias_corrections(st.count))
    upd = (mu / c1) / (ieee_sqrt(nu / c2) + EPS)
    upd = (-lr) * upd
    if lr_scale is not None:
        upd = upd * lr_scale
    params.add_(upd)
    st.mu.copy_(mu)
    st.nu.copy_(nu)
    st.count += 1


def soft_update(target: torch.Tensor, main: torch.Tensor, tau: float):
    """Polyak target update t <- tau*m + (1-tau)*t, in place on flat
    buffers (reference alg_credit.py:162-225)."""
    target.copy_(tau * main + (1.0 - tau) * target)
    return target


def one_hot(x, n):
    """float32 one-hot over a new trailing axis of n classes (a compare
    against ``arange``: no range check, so no device sync, and usable
    inside ``torch.func.vmap``)."""
    return (x.long()[..., None]
            == torch.arange(n, device=x.device)).float()


def others_concat(x):
    """[B, N, D] -> [B, N, (N-1)*D]: row n is the concat of all m != n in
    index order (alg_credit.py:501-557); [B, 1, 0] for N = 1."""
    n = x.shape[1]
    if n == 1:
        return x.new_zeros(x.shape[:1] + (1, 0))
    return torch.stack(
        [torch.cat([x[:, m] for m in range(n) if m != i], dim=-1)
         for i in range(n)], dim=1)


def others_stack(x):
    """[B, N, ...] -> [B, N, N-1, ...]: per-agent view of the others'
    rows (alg_credit.py:406-443); [B, 1, 0, ...] for N = 1."""
    n = x.shape[1]
    if n == 1:
        return x.new_zeros(x.shape[:1] + (1, 0) + x.shape[2:])
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
