"""Device dispatch of the fused rollouts' wrappers.

``checkers_rollout``, ``particle_rollout`` and ``roadway_rollout`` each
have a Philox wrapper and a fed-actions wrapper with the same rules:
CPU tensors go to the plain version, CUDA tensors launch the CUDA C++
kernel (or raise), any other device raises; there is no fallback.  A
launch allocates the outputs (reward sums float32 [B], episodes int32
[B]), calls the module's C entry on the current stream and adds one to
the wrapper's ``launches`` (none for an empty batch).  A module passes
its plain version and ``call(lib, actions, batch, n_steps, seed, rew,
ep, stream)``, which calls its C entry with its own leading arguments.
"""

from __future__ import annotations

import torch

from cm3_tpu_torch.ops import _nvcc
from cm3_tpu_torch.ops.philox import MASK32


def _cuda(name, device):
    if device.type != "cuda":
        raise RuntimeError(f"{name}: no kernel for device {device}")


def _launch(name, wrapper, call, actions, batch, n_steps, seed, device):
    if not 0 <= batch < 2 ** 31 or not 0 <= n_steps < 2 ** 31:
        raise ValueError(f"{name}: batch {batch} or n_steps {n_steps} out "
                         "of range")
    lib = _nvcc.library()
    rew = torch.empty(batch, dtype=torch.float32, device=device)
    ep = torch.empty(batch, dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        code = call(lib, None if actions is None else actions.data_ptr(),
                    batch, n_steps, seed & MASK32, rew.data_ptr(),
                    ep.data_ptr(), stream)
    _nvcc.check(code, name)
    wrapper.launches += batch > 0
    return rew, ep


def prng(name, wrapper, plain, call, batch, n_steps, seed, device):
    """The Philox variant on ``device``: ``plain(device)`` on the CPU."""
    device = torch.device(device)
    if device.type == "cpu":
        return plain(device)
    _cuda(name, device)
    return _launch(name, wrapper, call, None, batch, n_steps, seed, device)


def fed(name, wrapper, plain, call, n_agents, actions):
    """The fed variant: ``actions`` int32 [T, n_agents, B] on the device
    of the run; ``plain(actions)`` on the CPU."""
    if actions.dim() != 3 or actions.shape[1] != n_agents:
        raise ValueError(f"{name}: actions must be [T, N, batch] with N = "
                         f"{n_agents}, got {tuple(actions.shape)}")
    if actions.device.type == "cpu":
        return plain(actions)
    _cuda(name, actions.device)
    if actions.dtype != torch.int32 or not actions.is_contiguous():
        raise ValueError(f"{name}: actions must be contiguous int32, got "
                         f"{actions.dtype}")
    t, _, batch = actions.shape
    return _launch(name, wrapper, call, actions, batch, t, 0, actions.device)

