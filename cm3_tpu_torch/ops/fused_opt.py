"""Fused Adam + parameter apply + Polyak target: one pass per network, and
one launch for several networks.

Replaces the Pallas kernel ``_adam_polyak_flat`` of
``cm3_tpu/ops/fused_opt.py`` (``pl.pallas_call`` at line 100; wrapper
``adam_polyak`` at line 112), which the CM3 update calls three times,
once per network, when ``AlgConfig.fused_opt`` is on.  Over one
network's flat f32 parameters it computes

    mu'  = b1*mu + (1-b1)*g
    nu'  = b2*nu + ((1-b2)*g)*g
    p'   = p - lr * (mu'/c1) / (sqrt(nu'/c2) + eps)
    tgt' = tau*p' + (1-tau)*tgt

with b1=.9, b2=.999, eps=1e-8 (TF1 Adam, the TPU kernel's constants)
and the bias corrections c1 = 1-b1^(count+1), c2 = 1-b2^(count+1).

Bound on an H100.  Per element the pass loads p, tgt, mu, nu, g and
stores p, tgt, mu, nu: 36 bytes against ~16 float32 operations, so it
is bound by memory traffic.  On the main path n is 149,645 (actor),
144,741 (Q_global) and 144,709 (Q_credit): 5,387,220 B for the actor
and 10,420,200 B for both critics, 1.61 + 3.11 = 4.72 us per CM3
update at 3.35 TB/s.  At these sizes a launch's fixed cost (launch,
the first loads' latency, the tail) is as large as the traffic.

Design (CUDA C++, ``csrc/flat_update.cu``, entry ``cm3_adam_polyak``).
Against the fixed cost: the CM3 update's two critics (adjacent, same
lr) take ONE launch, so an update pays two fixed costs, not three
(``adam_polyak_many``); each thread of a 128-thread block issues the
five 16-byte loads of its four elements before it uses one, with a
block for every 128 such groups (one wave at the main path's sizes,
several blocks on each SM), so the whole working set is in flight at
once and one warp's IEEE divisions overlap another's loads; and the
kernel is lean (32-bit indices, no grid-stride loop, no second path
inside it), which cut 0.05-0.2 us a launch against the first design
(PERF.md).  A launch takes a table of up to ``MAX_SEGMENTS`` segments
by value, each with its pointers (to its step count, its new count and
its predicate among them), size and lr (tau shared); blocks map to
segments through a prefix of block counts.
When any of the pointers is not 16-byte aligned (a view at an odd
offset) the C entry launches a second kernel that takes one float a
thread instead; the aligned kernel's first threads take the n % 4
floats after a segment's last 16-byte group.  A segment holds fewer
than 2^31 floats.  The kernel rounds every product, sum, quotient and
root on its own (``__fmul_rn`` ...  ``__fsqrt_rn``) in the plain
version's order, with the same float32 constants, so it equals
``adam_polyak_plain`` bit for bit, on the card and on the CPU (see the
plain version's docstring).  It updates p, tgt, mu and nu in place
(the JAX kernel returns new arrays): each element is read and written
by the same thread.  The kernel takes each segment's step count from
device memory and computes its bias corrections itself, 1 - powf(b, t)
for t = count + 1, as ``algs/common.advance`` computes the plain
version's (c1, c2) tile with ``torch.pow`` (the same CUDA ``powf`` on
the card; the TPU wrapper computes them on the device from the traced
count and its kernel reads them from a VMEM scalar tile); the
segment's first thread writes the advanced count into a new 0-dim
tensor, which becomes ``opt_state.count``.  Each segment may carry a
device predicate, a bool that the update's gate sets: a block whose
segment's predicate is false writes nothing but the unchanged count.
So an update is one launch, with no value from the host and no other
kernel around it, and a gated-off update (a K-chunk dispatch's fill
chunk, an actor while it is frozen) leaves every buffer and count bit
for bit as it was.  The design variants measured against this one and
their times are in PERF.md.

``adam_polyak`` (one network) and ``adam_polyak_many`` (several) take
``adam_polyak_plain`` (the same math in plain PyTorch) for tensors on
the CPU, launch the kernel for CUDA tensors, and raise for any other
device.  ``adam_polyak.launches`` counts the kernel's launches from
either.
"""

from __future__ import annotations

import ctypes

import torch

from cm3_tpu_torch.algs.common import (B1, B2, EPS, AdamState,  # noqa: F401
                                       advance, bias_corrections, ieee_sqrt)
from cm3_tpu_torch.ops import _nvcc

MAX_SEGMENTS = 4        # networks in one launch (kMaxSegments in the source)


def adam_polyak_plain(p, t, mu, nu, g, c1, c2, lr: float, tau: float,
                      apply=None):
    """The kernel's math in plain PyTorch, in place on flat f32 tensors.
    ``c1`` and ``c2`` are the bias corrections, 0-dim tensors on the
    buffers' device (the tile the kernel reads: ``tile[0]``,
    ``tile[1]``); ``apply`` is the 0-dim predicate (bool or int32) or
    None: where it is false every buffer keeps its values (selects).  It
    divides by the 0-dim tensors (PyTorch's CUDA division by a Python
    scalar multiplies by the reciprocal) and takes ``ieee_sqrt``: IEEE
    divisions and roots on the CPU and on the card alike."""
    m2 = B1 * mu + (1.0 - B1) * g
    v2 = B2 * nu + (1.0 - B2) * g * g
    upd = (m2 / c1) / (ieee_sqrt(v2 / c2) + EPS)
    p2 = p - lr * upd
    t2 = tau * p2 + (1.0 - tau) * t
    if apply is not None:
        on = apply.bool()
        p2, t2, m2, v2 = (torch.where(on, new, old) for new, old in
                          ((p2, p), (t2, t), (m2, mu), (v2, nu)))
    p.copy_(p2)
    t.copy_(t2)
    mu.copy_(m2)
    nu.copy_(v2)


def _check(p, t, mu, nu, g):
    """Each buffer a contiguous float32 tensor of the params' shape: [n],
    or [S, n] for S seeds in lockstep, which is one segment of S x n
    floats (every seed shares the count and lr)."""
    for name, x in (("params", p), ("tgt", t), ("mu", mu), ("nu", nu),
                    ("grads", g)):
        if x.dtype != torch.float32 or x.dim() not in (1, 2) \
                or not x.is_contiguous():
            raise ValueError(f"adam_polyak: {name} must be a contiguous "
                             f"float32 tensor [n] or [S, n], got {x.dtype} "
                             f"{tuple(x.shape)}")
        if x.shape != p.shape or x.device != p.device:
            raise ValueError(f"adam_polyak: {name} differs from params in "
                             "shape or device")


def c_args(items, counts, pred, tau: float):
    """``cm3_adam_polyak``'s arguments but the stream: the segment count,
    the (p, t, mu, nu, g, step count, new step count, predicate) pointers
    of each segment (``counts`` the new counts' 0-dim int32 tensors, the
    predicate a 0-dim bool tensor or None), the sizes, each segment's lr,
    tau and 1 - tau."""
    k = len(items)
    on = None if pred is None else pred.data_ptr()
    ptrs = [v for (st, p, t, g, _), out in zip(items, counts)
            for v in (*(x.data_ptr() for x in (p, t, st.mu, st.nu, g,
                                                st.count, out)), on)]
    return (k, (ctypes.c_void_p * (8 * k))(*ptrs),
            (ctypes.c_longlong * k)(*[p.numel() for _, p, *_ in items]),
            (ctypes.c_float * k)(*[float(lr) for *_, lr in items]), tau,
            1.0 - tau)


def adam_polyak_many(items, tau: float, apply=None):
    """One Adam step and Polyak blend for each of several networks, in
    place: ``items`` is a sequence of (opt_state, params, tgt, grads,
    lr), all on one device.  On the card it is ONE kernel launch over
    all of them (at most ``MAX_SEGMENTS``), each computing the bias
    corrections of its own ``opt_state.count`` on the device; on the CPU
    the plain version per network.  ``apply`` (a 0-dim bool or int32
    tensor on the device, optional) is every segment's predicate: where
    it is false nothing is written.  Advances every count on the device,
    by one or by ``apply``, into a new tensor."""
    items = list(items)
    if not 1 <= len(items) <= MAX_SEGMENTS:
        raise ValueError(f"adam_polyak_many: 1 to {MAX_SEGMENTS} networks, "
                         f"got {len(items)}")
    for st, p, t, g, _ in items:
        _check(p, t, st.mu, st.nu, g)
    device = items[0][1].device
    if any(p.device != device for _, p, *_ in items):
        raise ValueError("adam_polyak_many: networks on different devices")
    if device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"adam_polyak: no kernel for device {device}")
    tau = float(tau)
    if device.type == "cpu":
        for st, p, t, g, lr in items:
            tile = advance(st, apply)
            adam_polyak_plain(p, t, st.mu, st.nu, g, tile[0], tile[1],
                              float(lr), tau, apply)
        return
    pred = None if apply is None else _nvcc.predicate(apply, device,
                                                      "adam_polyak")
    counts = torch.empty(len(items), dtype=torch.int32,
                         device=device).unbind()
    lib = _nvcc.library()
    with torch.cuda.device(device):
        code = lib.cm3_adam_polyak(
            *c_args(items, counts, pred, tau),
            torch.cuda.current_stream(device).cuda_stream)
    _nvcc.check(code, "adam_polyak")
    adam_polyak.launches += 1
    for (st, *_), count in zip(items, counts):
        st.count = count


def adam_polyak(opt_state: AdamState, params, tgt, grads, lr: float,
                tau: float, apply=None):
    """One Adam step on the flat ``params`` and the Polyak blend of the
    flat target ``tgt`` toward the new params, in place, where the 0-dim
    predicate ``apply`` holds (always without one); advances
    ``opt_state`` (in place too).  The port's counterpart of
    ``cm3_tpu.ops.fused_opt.adam_polyak``.  Returns
    (params, tgt, opt_state)."""
    adam_polyak_many([(opt_state, params, tgt, grads, lr)], tau, apply)
    return params, tgt, opt_state


def occupancy():
    """The built kernel's registers, resident blocks per SM, threads per
    block and spill bytes; needs the card."""
    return _nvcc.occupancy("cm3_adam_polyak_occupancy")


adam_polyak.launches = 0
