"""Fused Adam + parameter apply + Polyak target: one pass per network.

Replaces the Pallas kernel ``_adam_polyak_flat`` of
``cm3_tpu/ops/fused_opt.py`` (``pl.pallas_call`` at line 100; wrapper
``adam_polyak`` at line 112), which the CM3 update calls three times,
once per network, when ``AlgConfig.fused_opt`` is on.  Over one
network's flat f32 parameters it computes

    mu'  = b1*mu + (1-b1)*g
    nu'  = b2*nu + (1-b2)*g^2
    p'   = p - lr * (mu'/c1) / (sqrt(nu'/c2) + eps)
    tgt' = tau*p' + (1-tau)*tgt

with b1=.9, b2=.999, eps=1e-8 (TF1 Adam, the TPU kernel's constants)
and the bias corrections c1 = 1-b1^(count+1), c2 = 1-b2^(count+1).

Bound on an H100.  Per element the pass loads p, tgt, mu, nu, g and
stores p, tgt, mu, nu: 36 bytes against ~16 float32 operations, so it
is bound by memory traffic.  On the main path n is 149,645 (actor),
144,741 (Q_global) and 144,709 (Q_credit): 36 B x n = 5.2-5.4 MB, which
is 1.6 us at 3.35 TB/s.  A kernel launch costs several microseconds,
so on the main path (3 launches per update, 24 per training chunk) the
kernel is launch-bound, not bandwidth-bound.

Design.  A Triton kernel: one masked block of 1024 elements per
program, 4 warps, so each thread moves 8 contiguous floats of each
operand (two 16-byte vector loads); no data reuse, no shared memory,
no tensor cores - the loads and stores hand-written CUDA would do.  It
updates p, tgt, mu and nu in place (the JAX kernel returns new arrays):
each element is read and written by the same thread, so there is no
hazard.  b1, b2 and eps are compile-time constants; lr, 1-tau, tau and
the bias corrections are float32 scalars.  The corrections are computed
on the host in float32 from the host-side step count, as the TPU kernel
computes them on the device from its count: no ``.item()``, no device
round trip.  Triton is imported, and the kernel built, at the first
launch, so importing this module needs no Triton.

``adam_polyak`` takes ``adam_polyak_plain`` (the same math in plain
PyTorch) for tensors on the CPU, launches the kernel for CUDA tensors,
and raises for any other device.  ``adam_polyak.launches`` counts the
kernel launches.
"""

import functools

import numpy as np
import torch

from cm3_tpu_torch.algs.common import B1, B2, EPS, AdamState

BLOCK = 1024
NUM_WARPS = 4

# triton.language, bound by _kernel() at the first launch
tl = None


def bias_corrections(count: int):
    """(c1, c2) for the step after ``count`` steps, in float32 as the
    TPU kernel computes them (``fused_opt.py:86-88``)."""
    c = np.float32(count + 1)
    one = np.float32(1.0)
    return (float(one - np.power(np.float32(B1), c)),
            float(one - np.power(np.float32(B2), c)))


def adam_polyak_plain(p, t, mu, nu, g, c1: float, c2: float, lr: float,
                      tau: float):
    """The kernel's math in plain PyTorch, in place on flat f32 tensors."""
    m2 = B1 * mu + (1.0 - B1) * g
    v2 = B2 * nu + (1.0 - B2) * g * g
    upd = (m2 / c1) / (torch.sqrt(v2 / c2) + EPS)
    p2 = p - lr * upd
    t2 = tau * p2 + (1.0 - tau) * t
    p.copy_(p2)
    t.copy_(t2)
    mu.copy_(m2)
    nu.copy_(v2)


@functools.cache
def _kernel():
    # no ``from __future__ import annotations`` in this module: Triton
    # reads the ``tl.constexpr`` annotations as objects
    global tl
    import triton
    import triton.language as tl

    @triton.jit
    def adam_polyak_kernel(p_ptr, t_ptr, m_ptr, v_ptr, g_ptr, n, c1, c2, lr,
                           tau, keep, B1: tl.constexpr, B2: tl.constexpr,
                           EPS: tl.constexpr, BLOCK: tl.constexpr):
        offs = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
        mask = offs < n
        g = tl.load(g_ptr + offs, mask=mask)
        m = B1 * tl.load(m_ptr + offs, mask=mask) + (1.0 - B1) * g
        v = B2 * tl.load(v_ptr + offs, mask=mask) + (1.0 - B2) * g * g
        upd = tl.div_rn(tl.div_rn(m, c1), tl.sqrt_rn(tl.div_rn(v, c2)) + EPS)
        p = tl.load(p_ptr + offs, mask=mask) - lr * upd
        t = tau * p + keep * tl.load(t_ptr + offs, mask=mask)
        tl.store(p_ptr + offs, p, mask=mask)
        tl.store(t_ptr + offs, t, mask=mask)
        tl.store(m_ptr + offs, m, mask=mask)
        tl.store(v_ptr + offs, v, mask=mask)

    return adam_polyak_kernel


def _check(p, t, mu, nu, g):
    for name, x in (("params", p), ("tgt", t), ("mu", mu), ("nu", nu),
                    ("grads", g)):
        if x.dtype != torch.float32 or x.dim() != 1 or not x.is_contiguous():
            raise ValueError(f"adam_polyak: {name} must be a contiguous "
                             f"1-D float32 tensor, got {x.dtype} "
                             f"{tuple(x.shape)}")
        if x.numel() != p.numel() or x.device != p.device:
            raise ValueError(f"adam_polyak: {name} differs from params in "
                             "size or device")


def adam_polyak(opt_state: AdamState, params, tgt, grads, lr: float,
                tau: float):
    """One Adam step on the flat ``params`` and the Polyak blend of the
    flat target ``tgt`` toward the new params, in place; advances
    ``opt_state`` (in place too).  The port's counterpart of
    ``cm3_tpu.ops.fused_opt.adam_polyak``.  Returns
    (params, tgt, opt_state)."""
    mu, nu = opt_state.mu, opt_state.nu
    _check(params, tgt, mu, nu, grads)
    c1, c2 = bias_corrections(opt_state.count)
    lr, tau = float(lr), float(tau)
    if params.device.type == "cpu":
        adam_polyak_plain(params, tgt, mu, nu, grads, c1, c2, lr, tau)
    elif params.device.type == "cuda":
        n = params.numel()
        with torch.cuda.device(params.device):
            _kernel()[((n + BLOCK - 1) // BLOCK,)](
                params, tgt, mu, nu, grads, n, c1, c2, lr, tau, 1.0 - tau,
                B1=B1, B2=B2, EPS=EPS, BLOCK=BLOCK, num_warps=NUM_WARPS)
        adam_polyak.launches += 1
    else:
        raise RuntimeError(
            f"adam_polyak: no kernel for device {params.device}")
    opt_state.count += 1
    return params, tgt, opt_state


adam_polyak.launches = 0
