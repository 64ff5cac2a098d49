"""Philox4x32-10 in plain PyTorch (Salmon et al., "Parallel random
numbers: as easy as 1, 2, 3", SC 2011; the constants of Random123).

A counter-based generator: four 32-bit counter words and two 32-bit
key words go through ten rounds of two 32x32->64-bit products and
XORs, and come out as four random 32-bit words.  Any element of the
stream is computed from its counter alone, so a kernel thread and this
plain version draw the same bits for the same (counter, key).  The
CUDA twin is ``cm3_tpu_torch/csrc/philox.cuh``; the fused rollouts
take their random actions from it in place of the TPU's hardware
generator.

Words are ``int64`` tensors holding values in [0, 2^32): PyTorch has
no shifts on ``uint32`` on the CPU.  A product of two 32-bit words can
reach 2^64 and would overflow ``int64``, so each product splits the
counter word into 16-bit halves (each partial product < 2^48).
"""

from __future__ import annotations

import torch

M0, M1 = 0xD2511F53, 0xCD9E8D57      # round multipliers
W0, W1 = 0x9E3779B9, 0xBB67AE85      # key schedule (Weyl) increments
MASK32 = 0xFFFFFFFF
ROUNDS = 10


def _mulhilo(m: int, x: torch.Tensor):
    """(high, low) 32-bit words of the 64-bit product m * x."""
    lo_part = m * (x & 0xFFFF)             # < 2^48
    hi_part = m * (x >> 16)                # < 2^48
    mid = ((hi_part & 0xFFFF) << 16) + lo_part   # < 2^49
    return (hi_part >> 16) + (mid >> 32), mid & MASK32


def philox4x32_10(counter, key):
    """``counter``: four int64 tensors (or ints) that broadcast
    together, on the device of the tensors among them; ``key``: two
    ints.  Returns the four output words as
    int64 tensors in [0, 2^32)."""
    dev = next((c.device for c in counter if isinstance(c, torch.Tensor)),
               None)
    c0, c1, c2, c3 = (torch.as_tensor(c, dtype=torch.int64, device=dev)
                      & MASK32 for c in counter)
    c0, c1, c2, c3 = torch.broadcast_tensors(c0, c1, c2, c3)
    k0, k1 = key[0] & MASK32, key[1] & MASK32
    for _ in range(ROUNDS):
        hi0, lo0 = _mulhilo(M0, c0)
        hi1, lo1 = _mulhilo(M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + W0) & MASK32, (k1 + W1) & MASK32
    return c0, c1, c2, c3


