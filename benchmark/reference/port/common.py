"""Shared algorithm utilities (``cm3_tpu.algs.common``).

Every function here works on one seed's tensors and, unchanged, on
tensors with a leading seed axis [S, ...]: the optimizer reduces over
the last axis only, and the other helpers are elementwise or index the
trailing axes.
"""

from __future__ import annotations

import dataclasses

import torch

# TF1 AdamOptimizer defaults (reference; ``common.adam``): beta1, beta2, eps
B1, B2, EPS = 0.9, 0.999, 1e-8


def counter(value, device) -> torch.Tensor:
    """``value`` (an int, or a tensor) as a 0-dim int32 tensor on
    ``device``, the form of an Adam count and of a state's ``step``: such
    a tensor is returned as it is, anything else converted.  A state on
    the ``meta`` device (shapes only) keeps its counts on the CPU, where
    they can be read.  Counts are never changed in place (an update
    makes a new tensor), so two states may share one."""
    device = torch.device(device)
    if device.type == "meta":
        device = torch.device("cpu")
    if isinstance(value, torch.Tensor):
        if (value.dtype == torch.int32 and value.dim() == 0
                and value.device == device):
            return value
        return value.detach().to(device=device,
                                 dtype=torch.int32).reshape(())
    return torch.full((), int(value), dtype=torch.int32, device=device)


@dataclasses.dataclass
class AdamState:
    """One network's Adam state over its flat parameter vector: the
    ``optax.flatten(optax.adam)`` state of the JAX package, with flat
    ``mu``/``nu`` in ``ravel_pytree`` order ([n], or [S, n] for S seeds
    in lockstep) and ``count`` the number of steps taken, a 0-dim int32
    tensor on the buffers' device, one for every seed (an int assigned
    to it becomes one).  The update advances it on the device, by one or
    by its predicate, into a new tensor, so a gated update needs no host
    round trip and a state that shares the old count keeps it.
    ``clipped`` records whether the optimizer clips the global norm
    first: in the JAX package that changes the optax chain's state
    structure, so a checkpoint taken with the clip off does not restore
    into a state with it on, nor the other way round
    (``train/checkpoint.py``)."""

    mu: torch.Tensor
    nu: torch.Tensor
    count: torch.Tensor = 0
    clipped: bool = False

    def __setattr__(self, name, value):
        if name == "count":
            value = counter(value, self.mu.device)
        object.__setattr__(self, name, value)


def adam_init(flat: torch.Tensor, clipped: bool = False) -> AdamState:
    """Zero moments for a flat f32 parameter buffer, [n] or [S, n].  One
    flat buffer per network is also what keeps the tree dtype-uniform,
    which the JAX ``common.adam`` asserts."""
    if flat.dtype != torch.float32 or flat.dim() not in (1, 2):
        raise TypeError("adam_init wants a flat float32 buffer, [n] or "
                        "[S, n]")
    return AdamState(mu=torch.zeros_like(flat), nu=torch.zeros_like(flat),
                     clipped=clipped)


_BETAS = {}


def _betas(device) -> torch.Tensor:
    """(b1, b2) in float32 on ``device``, made once per device by fills
    (a copy from the host would synchronize)."""
    device = torch.device(device)
    if device not in _BETAS:
        b = torch.full((2,), B1, dtype=torch.float32, device=device)
        b[1] = B2
        _BETAS[device] = b
    return _BETAS[device]


def corrections_at(t: torch.Tensor) -> torch.Tensor:
    """The tile [..., 2] of (1 - b1^t, 1 - b2^t) in float32 on ``t``'s
    device, for the int32 step numbers ``t`` [...]: what the optax
    update and B1's plain version divide the moments by (B1's kernel
    computes the same from the count with CUDA's ``powf``, which
    ``torch.pow`` calls on the card).  PyTorch's float32 power equals
    XLA's here (every t in 1..30,000 on the CPU), as the TPU wrapper
    computes it from its traced count
    (``cm3_tpu/ops/fused_opt.py:84-88``)."""
    return 1.0 - torch.pow(_betas(t.device), t[..., None])


def advance(st: AdamState, apply=None) -> torch.Tensor:
    """Advance ``st.count`` by one, or by the 0-dim predicate ``apply``
    (bool or int32, on the device), and return the bias corrections'
    tile of the step it counts: the update's (c1, c2) where ``apply``
    holds.  Where it does not, the tile belongs to the last step taken
    (0 at count 0, which divides to Inf) and the caller discards what it
    computes: a gated-off update never writes."""
    st.count = st.count + (1 if apply is None else apply)
    return corrections_at(st.count)


def ieee_sqrt(x):
    """The correctly rounded float32 square root.  On the card that is
    ``torch.sqrt``; on the CPU PyTorch's vectorized ``sqrt`` misses it
    on ~0.7% of inputs, so there it is the float64 root rounded to
    float32 (53 >= 2 x 24 + 2 bits, so the double rounding is exact)."""
    if x.device.type == "cpu":
        return torch.sqrt(x.double()).float()
    return torch.sqrt(x)


def adam_apply(st: AdamState, params: torch.Tensor, grads: torch.Tensor,
               lr: float, clip: float = 0.0, lr_scale=None, apply=None):
    """One ``common.adam(lr, clip)`` step (optax's order and rounding)
    applied to the flat ``params`` in place, advancing ``st`` in place:

        mu  <- (1-b1)*g + b1*mu ;  nu <- (1-b2)*g**2 + b2*nu
        u   <- -lr * (mu/c1) / (sqrt(nu/c2) + eps) [* lr_scale]
        p   <- p + u

    with c1 = 1-b1^t, c2 = 1-b2^t after the count is incremented
    (``advance``).  ``lr_scale`` (a float32 value or 0-dim tensor,
    optional) scales the step as the JAX update does for the actor's lr
    anneal.  ``apply`` (a 0-dim bool tensor, optional) gates the step on
    the device: where it is false the params, the moments and the count
    keep their values bit for bit, by selects (the step computed, which
    may be NaN or Inf, is dropped, as JAX's ``jnp.where`` over the
    state drops it).  Plain PyTorch ops; the JAX package runs this as
    plain XLA, not as a kernel."""
    if clip:
        raise ValueError("the reference leaves out the global-norm clip")
    tile = advance(st, apply)
    mu = (1.0 - B1) * grads
    nu = (1.0 - B2) * (grads * grads)
    if apply is None:
        mu = torch.add(mu, B1 * st.mu, out=st.mu)
        nu = torch.add(nu, B2 * st.nu, out=st.nu)
    else:
        mu = mu + B1 * st.mu
        nu = nu + B2 * st.nu
    upd = (mu / tile[0]) / (ieee_sqrt(nu / tile[1]) + EPS)
    upd = (-lr) * upd
    if lr_scale is not None:
        upd = upd * lr_scale
    if apply is None:
        params.add_(upd)
        return
    torch.where(apply, params + upd, params, out=params)
    torch.where(apply, mu, st.mu, out=st.mu)
    torch.where(apply, nu, st.nu, out=st.nu)


def soft_update(target: torch.Tensor, main: torch.Tensor, tau: float,
                apply=None):
    """Polyak target update t <- tau*m + (1-tau)*t, in place on flat
    buffers (reference alg_credit.py:162-225); where the 0-dim predicate
    ``apply`` is false, ``target`` keeps its values (a select)."""
    new = tau * main
    keep = (1.0 - tau) * target
    if apply is None:
        return torch.add(new, keep, out=target)
    return torch.where(apply, new + keep, target, out=target)


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
