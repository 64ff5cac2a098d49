"""Soft target update in one pass over a flat buffer.

Replaces the Pallas kernel ``_polyak_flat`` of ``cm3_tpu/ops/polyak.py``
(``pl.pallas_call`` at line 58; wrapper ``polyak_update`` at line 70).
Over one flat float32 target buffer and its main buffer it computes

    t <- tau * m + (1 - tau) * t

in place (the JAX kernel returns a new array).  The reference wires it
into no training path (only ``tests/test_ops.py`` calls it); the port's
networks keep their parameters in one flat buffer each, so a soft
update of a network is one call on ``net.flat``.

Bound on an H100.  Per element it loads t and m and stores t: 12 bytes
against 3 float32 operations, so it is bound by memory traffic: 12 B x
n at 3.35 TB/s, 0.54 us for the actor's n = 149,645.  At that size a
launch costs more than the traffic.

Design.  A Triton kernel, as ``ops/fused_opt.py``: one masked block of
1024 elements per program, 4 warps, so each thread moves 8 contiguous
floats of each operand; no reuse, no shared memory.  tau and 1 - tau
are float32 scalars (1 - tau rounded once on the host, as the JAX code
rounds it).  Floating-point contraction is off, so the kernel rounds
each product and the sum as the plain version does and agrees with it
exactly.  Triton is imported, and the kernel built, at the first
launch.  Its yardstick is ``torch.Tensor.lerp_``, which computes the
same function; the port never calls it.

``polyak_update`` takes ``polyak_update_plain`` for tensors on the
CPU, launches the kernel for CUDA tensors, and raises for any other
device.  ``polyak_update.launches`` counts kernel launches.
"""

import functools

import torch

BLOCK = 1024
NUM_WARPS = 4

# triton.language, bound by _kernel() at the first launch
tl = None


def polyak_update_plain(tgt, main, tau: float):
    """The kernel's math in plain PyTorch, in place on ``tgt``."""
    tgt.copy_(tau * main + (1.0 - tau) * tgt)
    return tgt


@functools.cache
def _kernel():
    # no ``from __future__ import annotations`` in this module: Triton
    # reads the ``tl.constexpr`` annotations as objects
    global tl
    import triton
    import triton.language as tl

    @triton.jit
    def polyak_kernel(t_ptr, m_ptr, n, tau, keep, BLOCK: tl.constexpr):
        offs = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
        mask = offs < n
        m = tl.load(m_ptr + offs, mask=mask)
        t = tl.load(t_ptr + offs, mask=mask)
        tl.store(t_ptr + offs, tau * m + keep * t, mask=mask)

    return polyak_kernel


def polyak_update(tgt, main, tau: float):
    """``tgt <- tau * main + (1 - tau) * tgt`` over flat float32
    tensors, in place.  The port's counterpart of
    ``cm3_tpu.ops.polyak.polyak_update``.  Returns ``tgt``."""
    for name, x in (("tgt", tgt), ("main", main)):
        if x.dtype != torch.float32 or x.dim() != 1 or not x.is_contiguous():
            raise ValueError(f"polyak_update: {name} must be a contiguous "
                             f"1-D float32 tensor, got {x.dtype} "
                             f"{tuple(x.shape)}")
    if main.numel() != tgt.numel() or main.device != tgt.device:
        raise ValueError("polyak_update: main differs from tgt in size or "
                         "device")
    tau = float(tau)
    if tgt.device.type == "cpu":
        return polyak_update_plain(tgt, main, tau)
    if tgt.device.type != "cuda":
        raise RuntimeError(f"polyak_update: no kernel for device {tgt.device}")
    n = tgt.numel()
    with torch.cuda.device(tgt.device):
        _kernel()[((n + BLOCK - 1) // BLOCK,)](
            tgt, main, n, tau, 1.0 - tau, BLOCK=BLOCK, num_warps=NUM_WARPS,
            enable_fp_fusion=False)
    polyak_update.launches += 1
    return tgt


polyak_update.launches = 0
