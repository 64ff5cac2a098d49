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
launch's fixed cost (launch, the first loads' latency, the tail) costs
more than the traffic.

Design (CUDA C++, ``csrc/flat_update.cu``, entry ``cm3_polyak``): as
``ops/fused_opt.py``'s kernel, lean 128-thread blocks whose threads
issue both 16-byte loads of their four elements before using them, a
block for every 128 groups, so the whole buffer is in flight at once;
a buffer whose pointers are not both 16-byte aligned takes a second
kernel, one float a thread, and the first threads take the n % 4
floats after the last 16-byte group.  An optional device predicate
(a bool; the update's gate) turns the launch off where it is false: the
kernel then writes nothing, so a gated-off soft update needs no value
from the host.  tau and 1 - tau are float32 scalars (1 - tau rounded once on the host, as the plain version rounds
it), and each product and the sum round on their own (``__fmul_rn``,
``__fadd_rn``), so the kernel equals the plain version bit for bit.
Its yardstick is ``torch.Tensor.lerp_``, which computes the same
function (with its own rounding); the port never calls it.

``polyak_update`` takes ``polyak_update_plain`` for tensors on the
CPU, launches the kernel for CUDA tensors, and raises for any other
device.  ``polyak_update.launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from cm3_tpu_torch.ops import _nvcc


def polyak_update_plain(tgt, main, tau: float, apply=None):
    """The kernel's math in plain PyTorch, in place on ``tgt``; where the
    0-dim predicate ``apply`` (bool or int32) is false, ``tgt`` keeps
    its values (a select)."""
    new = tau * main + (1.0 - tau) * tgt
    if apply is not None:
        new = torch.where(apply.bool(), new, tgt)
    tgt.copy_(new)
    return tgt


def polyak_update(tgt, main, tau: float, apply=None):
    """``tgt <- tau * main + (1 - tau) * tgt`` over flat float32
    tensors, in place, where the 0-dim device predicate ``apply`` (bool
    or int32; always without one) holds.  The port's counterpart of
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
        return polyak_update_plain(tgt, main, tau, apply)
    if tgt.device.type != "cuda":
        raise RuntimeError(f"polyak_update: no kernel for device {tgt.device}")
    pred = None if apply is None else _nvcc.predicate(apply, tgt.device,
                                                      "polyak_update")
    lib = _nvcc.library()
    with torch.cuda.device(tgt.device):
        stream = torch.cuda.current_stream(tgt.device).cuda_stream
        code = lib.cm3_polyak(tgt.data_ptr(), main.data_ptr(), tgt.numel(),
                              tau, 1.0 - tau,
                              None if pred is None else pred.data_ptr(),
                              stream)
    _nvcc.check(code, "polyak_update")
    polyak_update.launches += 1
    return tgt


def occupancy():
    """The built kernel's registers, resident blocks per SM, threads per
    block and spill bytes; needs the card."""
    return _nvcc.occupancy("cm3_polyak_occupancy")


polyak_update.launches = 0
